"""Berkeley DB hash-database reader (read-only, from scratch).

The legacy rpmdb (`/var/lib/rpm/Packages` on RHEL/CentOS <= 8, Amazon
Linux 2) is a BDB hash database; the reference reads it through
go-rpmdb's pkg/bdb.  This is the same minimal subset, in pure Python:

* metadata page 0: magic 0x00061561 at byte 12 (either endianness — the
  file is written in its creator's byte order), page size at byte 20,
  last page number at byte 32;
* page header (26 bytes): next-page at 16, entry count at 20, free-area
  offset at 22, page type at byte 25;
* hash pages (type 2 unsorted / 13 sorted): entry-count u16 slot indices
  follow the header, alternating key/value entries.  Inline values are
  H_KEYDATA (type byte 1, data to the next-higher slot boundary);
  large values are H_OFFPAGE (type byte 3): a {pgno, tlen} pointer to a
  chain of overflow pages (type 7) whose data regions concatenate to
  tlen bytes.

rpm's Packages db stores one rpm header blob per value; keys are record
numbers and are ignored here.  Soundness bias: malformed structure
raises BdbError — a package DB that cannot be read must be loud, never
an empty inventory.

Copied from `trivy_tpu/db/bdb.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import struct
from typing import Iterator

HASH_MAGIC = 0x00061561

_P_OVERFLOW = 7
_P_HASH_UNSORTED = 2
_P_HASH = 13
_H_KEYDATA = 1
_H_OFFPAGE = 3
_PAGE_HEADER = 26


class BdbError(RuntimeError):
    pass


class BdbHashReader:
    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 512:
            raise BdbError("bdb: file too small")
        magic_le = struct.unpack_from("<I", data, 12)[0]
        magic_be = struct.unpack_from(">I", data, 12)[0]
        if magic_le == HASH_MAGIC:
            self._e = "<"
        elif magic_be == HASH_MAGIC:
            self._e = ">"
        else:
            raise BdbError("bdb: not a hash database (bad magic)")
        self.pagesize = struct.unpack_from(self._e + "I", data, 20)[0]
        if not 512 <= self.pagesize <= 65536:
            raise BdbError(f"bdb: implausible page size {self.pagesize}")
        self.last_pgno = self._u32(0, 32)

    # -- field readers (db-endian) -------------------------------------

    def _page(self, pgno: int) -> bytes:
        off = pgno * self.pagesize
        if off + self.pagesize > len(self.data):
            raise BdbError(f"bdb: page {pgno} out of range")
        return self.data[off : off + self.pagesize]

    def _u32(self, pgno: int, off: int) -> int:
        return struct.unpack_from(
            self._e + "I", self.data, pgno * self.pagesize + off
        )[0]

    def _u16(self, page: bytes, off: int) -> int:
        return struct.unpack_from(self._e + "H", page, off)[0]

    # -- value iteration ------------------------------------------------

    def values(self) -> Iterator[bytes]:
        """Every stored value, in page order."""
        npages = min(self.last_pgno + 1, len(self.data) // self.pagesize)
        for pgno in range(1, npages):
            page = self._page(pgno)
            if page[25] not in (_P_HASH_UNSORTED, _P_HASH):
                continue
            n = self._u16(page, 20)
            if _PAGE_HEADER + 2 * n > self.pagesize:
                raise BdbError(f"bdb: page {pgno} entry count {n} overflows")
            slots = [
                self._u16(page, _PAGE_HEADER + 2 * i) for i in range(n)
            ]
            bounds = sorted(o for o in slots if o)
            for vi in slots[1::2]:  # entries alternate key, value
                if not _PAGE_HEADER <= vi < self.pagesize:
                    raise BdbError(f"bdb: page {pgno} slot {vi} out of range")
                etype = page[vi]
                if etype == _H_KEYDATA:
                    nxt = next(
                        (b for b in bounds if b > vi), self.pagesize
                    )
                    yield bytes(page[vi + 1 : nxt])
                elif etype == _H_OFFPAGE:
                    if vi + 12 > self.pagesize:
                        raise BdbError("bdb: truncated H_OFFPAGE entry")
                    opgno = struct.unpack_from(self._e + "I", page, vi + 4)[0]
                    tlen = struct.unpack_from(self._e + "I", page, vi + 8)[0]
                    yield self._overflow(opgno, tlen)
                else:
                    raise BdbError(
                        f"bdb: unsupported entry type {etype} on page {pgno}"
                    )

    def _overflow(self, pgno: int, tlen: int) -> bytes:
        out = bytearray()
        seen: set[int] = set()
        while pgno != 0 and len(out) < tlen:
            if pgno in seen:
                raise BdbError("bdb: overflow chain cycle")
            seen.add(pgno)
            page = self._page(pgno)
            if page[25] != _P_OVERFLOW:
                raise BdbError(
                    f"bdb: page {pgno} in overflow chain is type {page[25]}"
                )
            nxt = struct.unpack_from(self._e + "I", page, 16)[0]
            if nxt:
                out += page[_PAGE_HEADER:]
            else:
                used = self._u16(page, 22)
                out += page[_PAGE_HEADER : _PAGE_HEADER + used]
            pgno = nxt
        if len(out) < tlen:
            raise BdbError("bdb: overflow chain shorter than declared length")
        return bytes(out[:tlen])


def is_bdb_hash(content: bytes) -> bool:
    if len(content) < 16:
        return False
    le, be = struct.unpack_from("<I", content, 12)[0], struct.unpack_from(
        ">I", content, 12
    )[0]
    return HASH_MAGIC in (le, be)
