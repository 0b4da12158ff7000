"""Read-only BoltDB (bbolt) file reader.

The reference's vulnerability DB, Java index DB, and scan cache are bbolt
files (pkg/db/db.go, pkg/javadb/client.go, pkg/fanal/cache/fs.go).  This
module reads that exact on-disk format so a real `trivy.db` artifact drops
in unchanged — pure Python, no bbolt dependency, no write support (the
scanner only ever Gets).

bbolt layout (stable since boltdb v1):

  page      = id(u64) flags(u16) count(u16) overflow(u32) payload...
  meta      = magic(0xED0CDAED u32) version(2 u32) pageSize(u32) flags(u32)
              root{pgid u64, sequence u64} freelist(u64) pgid(u64)
              txid(u64) checksum(u64 = fnv64a of the 56 bytes before it)
  branchElem= pos(u32) ksize(u32) pgid(u64); key at elemOffset+pos
  leafElem  = flags(u32) pos(u32) ksize(u32) vsize(u32); key+value at
              elemOffset+pos; flags&1 -> value is a child bucket
  bucket val= root(u64) sequence(u64) [+ inline leaf page iff root == 0]

Pages 0 and 1 are alternating meta pages; the valid one with the higher
txid wins.  A page spans (1 + overflow) * pageSize bytes.

Copied from `trivy_tpu/db/bolt.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

MAGIC = 0xED0CDAED
_PAGE_HDR = struct.Struct("<QHHI")  # id, flags, count, overflow
_META = struct.Struct("<IIIIQQQQQQ")
_BRANCH_ELEM = struct.Struct("<IIQ")
_LEAF_ELEM = struct.Struct("<IIII")

FLAG_BRANCH = 0x01
FLAG_LEAF = 0x02
FLAG_META = 0x04
FLAG_FREELIST = 0x10
BUCKET_LEAF = 0x01


class BoltError(RuntimeError):
    pass


def fnv64a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class _Page:
    """A view over one (possibly overflowing) page's bytes."""

    __slots__ = ("buf", "flags", "count")

    def __init__(self, buf: memoryview):
        _id, self.flags, self.count, _overflow = _PAGE_HDR.unpack_from(buf, 0)
        self.buf = buf


class Bucket:
    """Read-only bucket: mapping-style access plus sub-bucket traversal."""

    def __init__(self, db: "Bolt", root: int, inline: memoryview | None):
        self._db = db
        self._root = root
        self._inline = inline

    def _root_page(self) -> _Page:
        if self._inline is not None:
            return _Page(self._inline)
        return self._db._page(self._root)

    # -- iteration ---------------------------------------------------------

    def _iter_leaf_elems(
        self, page: _Page
    ) -> Iterator[tuple[int, bytes, memoryview]]:
        for i in range(page.count):
            off = 16 + i * _LEAF_ELEM.size
            flags, pos, ksize, vsize = _LEAF_ELEM.unpack_from(page.buf, off)
            kstart = off + pos
            key = bytes(page.buf[kstart : kstart + ksize])
            val = page.buf[kstart + ksize : kstart + ksize + vsize]
            yield flags, key, val

    def _walk(self, pgid: int) -> Iterator[tuple[int, bytes, memoryview]]:
        page = self._db._page(pgid)
        if page.flags & FLAG_BRANCH:
            for i in range(page.count):
                off = 16 + i * _BRANCH_ELEM.size
                _pos, _ksize, child = _BRANCH_ELEM.unpack_from(page.buf, off)
                yield from self._walk(child)
        elif page.flags & FLAG_LEAF:
            yield from self._iter_leaf_elems(page)
        else:
            raise BoltError(f"page {pgid}: unexpected flags {page.flags:#x}")

    def _items_raw(self) -> Iterator[tuple[int, bytes, memoryview]]:
        if self._inline is not None:
            yield from self._iter_leaf_elems(_Page(self._inline))
        else:
            yield from self._walk(self._root)

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        """Plain key/value pairs (sub-buckets excluded), key order."""
        for flags, key, val in self._items_raw():
            if not flags & BUCKET_LEAF:
                yield key, bytes(val)

    def keys(self) -> list[bytes]:
        return [k for k, _ in self.items()]

    def buckets(self) -> Iterator[tuple[bytes, "Bucket"]]:
        for flags, key, val in self._items_raw():
            if flags & BUCKET_LEAF:
                yield key, self._open_child(val)

    def _open_child(self, val: memoryview) -> "Bucket":
        if len(val) < 16:
            raise BoltError("bucket value shorter than its header")
        root = struct.unpack_from("<Q", val, 0)[0]
        if root == 0:  # inline bucket: header is followed by a leaf page
            return Bucket(self._db, 0, val[16:])
        return Bucket(self._db, root, None)

    # -- point lookups -----------------------------------------------------

    def _seek(self, key: bytes) -> tuple[int, memoryview] | None:
        """(leaf element flags, value) for `key`, descending branch pages
        by last-separator <= key (bbolt cursor semantics)."""
        if self._inline is not None:
            page = _Page(self._inline)
        else:
            page = self._db._page(self._root)
        while page.flags & FLAG_BRANCH:
            child = None
            for i in range(page.count):
                off = 16 + i * _BRANCH_ELEM.size
                pos, ksize, pgid = _BRANCH_ELEM.unpack_from(page.buf, off)
                sep = bytes(page.buf[off + pos : off + pos + ksize])
                if i == 0 or sep <= key:
                    child = pgid
                else:
                    break
            if child is None:
                return None
            page = self._db._page(child)
        for flags, k, val in self._iter_leaf_elems(page):
            if k == key:
                return flags, val
        return None

    def get(self, key: bytes) -> bytes | None:
        hit = self._seek(key)
        if hit is None or hit[0] & BUCKET_LEAF:
            return None
        return bytes(hit[1])

    def bucket(self, key: bytes) -> "Bucket | None":
        hit = self._seek(key)
        if hit is None or not hit[0] & BUCKET_LEAF:
            return None
        return self._open_child(hit[1])


class Bolt:
    """A bbolt database file, opened read-only over one buffer (mmap via
    open(): point lookups fault in only the touched pages)."""

    def __init__(self, data):
        if len(data) < 0x2000:
            raise BoltError("file too small for two meta pages")
        self._data = memoryview(data)
        # Meta 0 is at offset 0; meta 1 is at offset pageSize, which only
        # the metas themselves record.  Meta 0 names the page size when
        # valid; a torn/stale meta 0 is recovered by probing the common
        # sizes for a valid meta 1.
        m0 = self._try_meta(0)
        candidates = (
            [m0[2]] if m0 is not None
            else [4096, 8192, 16384, 32768, 65536]
        )
        m1 = None
        for ps in candidates:
            m1 = self._try_meta(ps)
            if m1 is not None:
                break
        meta = None
        for m in (m0, m1):
            if m is not None and (meta is None or m[5] > meta[5]):
                meta = m
        if meta is None:
            raise BoltError("no valid meta page (not a bbolt file?)")
        (_magic, _version, self.page_size, _flags, self._root_pgid,
         _txid) = meta
        self._root = Bucket(self, self._root_pgid, None)

    @classmethod
    def open(cls, path: str) -> "Bolt":
        import mmap

        with open(path, "rb") as f:
            try:
                return cls(mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ))
            except (ValueError, OSError):  # empty file / no-mmap fs
                return cls(f.read())

    def _try_meta(self, base: int):
        if base + 16 + _META.size > len(self._data):
            return None
        try:
            (magic, version, page_size, flags, root, _seq, _freelist,
             _pgid, txid, checksum) = _META.unpack_from(self._data, base + 16)
        except struct.error:
            return None
        if magic != MAGIC or version != 2:
            return None
        if fnv64a(bytes(self._data[base + 16 : base + 16 + 56])) != checksum:
            return None
        return magic, version, page_size, flags, root, txid

    def _page(self, pgid: int) -> _Page:
        start = pgid * self.page_size
        if start + 16 > len(self._data):
            raise BoltError(f"page {pgid} out of bounds")
        _id, flags, count, overflow = _PAGE_HDR.unpack_from(self._data, start)
        end = start + (1 + overflow) * self.page_size
        return _Page(self._data[start : min(end, len(self._data))])

    # -- root access -------------------------------------------------------

    def bucket(self, *names: bytes) -> Bucket | None:
        b: Bucket | None = self._root
        for name in names:
            if b is None:
                return None
            b = b.bucket(name)
        return b

    def buckets(self) -> Iterator[tuple[bytes, Bucket]]:
        return self._root.buckets()
