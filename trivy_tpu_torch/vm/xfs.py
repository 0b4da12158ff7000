"""XFS (v5) filesystem reader, from scratch — read-only walk.

The reference walks XFS root volumes via go-xfs-filesystem
(pkg/fanal/walker/vm.go); Amazon Linux 2 AMIs default to an XFS root, so
detect-and-skip loses whole images.  This reader covers the structures a
package/secret walk needs:

* superblock (magic "XFSB"): geometry (blocksize, agblocks, agblklog,
  inodesize, inopblog, dirblklog) and the root inode number;
* inode location is ARITHMETIC — ino decomposes into
  (agno << (agblklog+inopblog)) | (agbno << inopblog) | offset — so no
  AGI/allocation btrees are consulted;
* inode core v2/v3 (magic "IN"): mode, size, data-fork format;
* data forks: local (short-form dirs, inline symlink targets), extent
  lists (the 128-bit packed records); btree forks raise XfsError loudly
  rather than walking partially;
* directories: short-form (inode literal area), single-block ("XDB3",
  with the block-tail leaf region excluded) and multi-block data blocks
  ("XDD3") — leaf/node/freeindex blocks are hash lookup acceleration
  and are skipped; the data blocks alone carry every entry.  v4 dir
  blocks (no guaranteed ftype byte) are rejected loudly.

Malformed structure raises XfsError (an OSError): per-file failures ride
the analyzer pipeline's per-file tolerance, walk-level failures are
caught and logged by the VM artifact — loud, never silently green.

Copied from `trivy_tpu/vm/xfs.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Iterator

XFS_MAGIC = 0x58465342  # "XFSB"
_INODE_MAGIC = 0x494E  # "IN"
_DIR3_BLOCK_MAGIC = 0x58444233  # "XDB3" single-block dir, v5
_DIR3_DATA_MAGIC = 0x58444433  # "XDD3" multi-block dir data, v5

_FMT_LOCAL = 1
_FMT_EXTENTS = 2
_FMT_BTREE = 3

S_IFMT = 0o170000
S_IFDIR = 0o040000
S_IFREG = 0o100000


class XfsError(OSError):
    """OSError subclass so per-file failures hit the analyzer pipeline's
    existing per-file tolerance (opener errors are caught as OSError);
    structural failures during the walk itself are caught by the VM
    artifact and logged per-partition."""


@dataclass
class XfsEntry:
    path: str  # relative, slash-separated
    size: int
    mode: int
    opener: Callable[[], bytes]


def is_xfs(img, offset: int = 0) -> bool:
    img.seek(offset)
    head = img.read(4)
    return len(head) == 4 and struct.unpack(">I", head)[0] == XFS_MAGIC


class XfsReader:
    """One XFS filesystem inside `img` at byte `offset`."""

    def __init__(self, img, offset: int = 0):
        self.img = img
        self.offset = offset
        sb = self._read_at(0, 264)
        if struct.unpack_from(">I", sb, 0)[0] != XFS_MAGIC:
            raise XfsError("not an XFS filesystem")
        self.block_size = struct.unpack_from(">I", sb, 4)[0]
        if not 512 <= self.block_size <= 65536:
            raise XfsError(f"implausible block size {self.block_size}")
        self.rootino = struct.unpack_from(">Q", sb, 56)[0]
        self.agblocks = struct.unpack_from(">I", sb, 84)[0]
        self.agcount = struct.unpack_from(">I", sb, 88)[0]
        self.inode_size = struct.unpack_from(">H", sb, 104)[0]
        self.inopblog = sb[123]
        self.agblklog = sb[124]
        self.dirblklog = sb[192]
        self.dir_block_size = self.block_size << self.dirblklog

    # -- low-level ------------------------------------------------------

    def _read_at(self, off: int, n: int) -> bytes:
        self.img.seek(self.offset + off)
        data = self.img.read(n)
        if len(data) != n:
            raise XfsError(f"short read at {off}")
        return data

    def _fsblock_byte(self, fsbno: int) -> int:
        """Absolute byte of a packed (agno | agbno) filesystem block."""
        agno = fsbno >> self.agblklog
        agbno = fsbno & ((1 << self.agblklog) - 1)
        if agno >= self.agcount or agbno >= self.agblocks:
            raise XfsError(f"fsblock {fsbno} out of range")
        return (agno * self.agblocks + agbno) * self.block_size

    def _read_inode(self, ino: int) -> bytes:
        agno = ino >> (self.agblklog + self.inopblog)
        agbno = (ino >> self.inopblog) & ((1 << self.agblklog) - 1)
        idx = ino & ((1 << self.inopblog) - 1)
        if agno >= self.agcount or agbno >= self.agblocks:
            raise XfsError(f"inode {ino} out of range")
        byte = (
            (agno * self.agblocks + agbno) * self.block_size
            + idx * self.inode_size
        )
        raw = self._read_at(byte, self.inode_size)
        if struct.unpack_from(">H", raw, 0)[0] != _INODE_MAGIC:
            raise XfsError(f"inode {ino}: bad magic")
        return raw

    @staticmethod
    def _inode_fields(raw: bytes) -> tuple[int, int, int, int, int]:
        """(mode, version, format, size, literal_off)."""
        mode = struct.unpack_from(">H", raw, 2)[0]
        version = raw[4]
        fmt = raw[5]
        size = struct.unpack_from(">Q", raw, 56)[0]
        literal = 176 if version >= 3 else 100
        return mode, version, fmt, size, literal

    @staticmethod
    def _extents(raw: bytes, literal: int) -> list[tuple[int, int, int]]:
        """Data-fork extent records: (fileoff_blocks, fsbno, count)."""
        nextents = struct.unpack_from(">I", raw, 76)[0]
        out = []
        for i in range(nextents):
            base = literal + i * 16
            l0, l1 = struct.unpack_from(">QQ", raw, base)
            startoff = (l0 >> 9) & ((1 << 54) - 1)
            startblock = ((l0 & 0x1FF) << 43) | (l1 >> 21)
            blockcount = l1 & ((1 << 21) - 1)
            out.append((startoff, startblock, blockcount))
        return out

    def _read_fork(self, raw: bytes) -> bytes:
        """Whole data fork of a regular file / directory inode."""
        _mode, _v, fmt, size, literal = self._inode_fields(raw)
        if fmt == _FMT_LOCAL:
            return bytes(raw[literal : literal + size])
        if fmt != _FMT_EXTENTS:
            raise XfsError(f"unsupported data fork format {fmt} (btree)")
        bs = self.block_size
        out = bytearray(size)
        for fileoff, fsbno, count in self._extents(raw, literal):
            byte0 = self._fsblock_byte(fsbno)
            data = self._read_at(byte0, count * bs)
            dst = fileoff * bs
            if dst >= size:
                continue
            chunk = data[: max(0, size - dst)]
            out[dst : dst + len(chunk)] = chunk
        return bytes(out)

    # -- directories ----------------------------------------------------

    def _dir_entries(self, raw: bytes) -> Iterator[tuple[int, str]]:
        """(child ino, name) pairs of a directory inode."""
        _mode, _v, fmt, size, literal = self._inode_fields(raw)
        if fmt == _FMT_LOCAL:
            yield from self._sf_entries(raw[literal : literal + size])
            return
        if fmt != _FMT_EXTENTS:
            raise XfsError(f"unsupported dir fork format {fmt}")
        bs = self.block_size
        dbs = self.dir_block_size
        blocks_per_dirblock = dbs // bs
        # Directory address space: data blocks live below the leaf offset
        # (32GB); collect them dirblock-by-dirblock from the extent map.
        leaf_start_fo = (32 << 30) // bs
        for fileoff, fsbno, count in self._extents(raw, literal):
            if fileoff >= leaf_start_fo:
                continue  # leaf/node/freeindex: lookup metadata only
            for db in range(0, count, blocks_per_dirblock):
                block = self._read_at(
                    self._fsblock_byte(fsbno + db), dbs
                )
                yield from self._data_block_entries(block)

    @staticmethod
    def _sf_entries(sf: bytes) -> Iterator[tuple[int, str]]:
        """Short-form directory in the inode literal area."""
        if len(sf) < 2:
            return
        count, i8count = sf[0], sf[1]
        isize = 8 if i8count else 4
        pos = 2 + isize  # header + parent ino
        n = count or i8count
        for _ in range(n):
            if pos + 3 > len(sf):
                raise XfsError("short-form dir truncated")
            namelen = sf[pos]
            name = sf[pos + 3 : pos + 3 + namelen].decode("utf-8", "replace")
            pos += 3 + namelen
            ftype_skip = 1  # dir ftype feature (always set on v5)
            pos += ftype_skip
            if pos + isize > len(sf):
                raise XfsError("short-form dir truncated")
            if isize == 8:
                ino = struct.unpack_from(">Q", sf, pos)[0]
            else:
                ino = struct.unpack_from(">I", sf, pos)[0]
            pos += isize
            yield ino, name

    def _data_block_entries(self, block: bytes) -> Iterator[tuple[int, str]]:
        magic = struct.unpack_from(">I", block, 0)[0]
        if magic in (_DIR3_BLOCK_MAGIC, _DIR3_DATA_MAGIC):
            data_start = 64  # xfs_dir3_data_hdr
        else:
            # v4 magics (XD2B/XD2D) lack the guaranteed ftype byte this
            # parser assumes; v4 filesystems are out of the v5 scope and
            # must fail loudly rather than misparse entry strides.
            raise XfsError(f"unsupported dir block magic {magic:#x}")
        end = len(block)
        if magic == _DIR3_BLOCK_MAGIC:
            # single-block form: a leaf region + tail sit at the block end
            count = struct.unpack_from(">I", block, end - 8)[0]
            end = end - 8 - count * 8
        pos = data_start
        while pos < end - 2:
            if struct.unpack_from(">H", block, pos)[0] == 0xFFFF:
                length = struct.unpack_from(">H", block, pos + 2)[0]
                if length < 8:
                    raise XfsError("corrupt unused dir entry")
                pos += length
                continue
            if pos + 9 > end:
                break
            ino = struct.unpack_from(">Q", block, pos)[0]
            namelen = block[pos + 8]
            if namelen == 0:
                raise XfsError("corrupt dir entry (zero name)")
            name = block[pos + 9 : pos + 9 + namelen].decode(
                "utf-8", "replace"
            )
            # entry: ino(8) + namelen(1) + name + ftype(1) + tag(2), 8-aligned
            pos += (8 + 1 + namelen + 1 + 2 + 7) & ~7
            if name not in (".", ".."):
                yield ino, name

    # -- walk -----------------------------------------------------------

    def walk(self) -> Iterator[XfsEntry]:
        """Every regular file, depth-first from the root."""
        stack: list[tuple[int, str]] = [(self.rootino, "")]
        seen: set[int] = set()
        while stack:
            ino, prefix = stack.pop()
            if ino in seen:
                continue
            seen.add(ino)
            raw = self._read_inode(ino)
            for child, name in self._dir_entries(raw):
                path = f"{prefix}{name}"
                craw = self._read_inode(child)
                mode, _v, _fmt, size, _lit = self._inode_fields(craw)
                kind = mode & S_IFMT
                if kind == S_IFDIR:
                    stack.append((child, path + "/"))
                elif kind == S_IFREG:
                    yield XfsEntry(
                        path=path,
                        size=size,
                        mode=mode & 0o777,
                        opener=lambda c=child: self._read_fork(
                            self._read_inode(c)
                        ),
                    )
