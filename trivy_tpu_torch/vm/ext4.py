"""Read-only ext2/3/4 filesystem walker.

The VM artifact needs to read files out of disk partitions without
mounting (the reference links go-ext4-filesystem).  This implements the
on-disk format from scratch: superblock, (64-bit capable) block-group
descriptors, inodes with either the ext4 extent tree or the classic
ext2 direct/indirect block map, and linear directory traversal.

Out of scope, documented: journal replay (images are scanned as-is; a
cleanly-created image needs none), inline-data inodes, and encryption.

Copied from `trivy_tpu/vm/ext4.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Iterator

EXT_MAGIC = 0xEF53
ROOT_INODE = 2
EXTENTS_FL = 0x80000
INCOMPAT_64BIT = 0x80
EXTENT_MAGIC = 0xF30A

S_IFMT = 0xF000
S_IFDIR = 0x4000
S_IFREG = 0x8000
S_IFLNK = 0xA000


class Ext4Error(ValueError):
    pass


@dataclass
class Ext4Entry:
    path: str  # relative, slash-separated
    size: int
    mode: int
    opener: Callable[[], bytes]


class Ext4Reader:
    """One ext filesystem inside `img` at byte `offset`."""

    def __init__(self, img, offset: int = 0):
        self.img = img
        self.offset = offset
        sb = self._read_at(1024, 264)
        magic = struct.unpack_from("<H", sb, 56)[0]
        if magic != EXT_MAGIC:
            raise Ext4Error("not an ext filesystem")
        self.block_size = 1024 << struct.unpack_from("<I", sb, 24)[0]
        self.inodes_per_group = struct.unpack_from("<I", sb, 40)[0]
        self.feature_incompat = struct.unpack_from("<I", sb, 96)[0]
        self.inode_size = struct.unpack_from("<H", sb, 88)[0] or 128
        if self.feature_incompat & INCOMPAT_64BIT:
            self.desc_size = struct.unpack_from("<H", sb, 254)[0] or 64
        else:
            self.desc_size = 32
        # descriptor table follows the superblock's block
        self._gd_block = 2 if self.block_size == 1024 else 1

    # -- low-level ---------------------------------------------------------

    def _read_at(self, off: int, n: int) -> bytes:
        self.img.seek(self.offset + off)
        data = self.img.read(n)
        if len(data) != n:
            raise Ext4Error(f"short read at {off}")
        return data

    def _read_block(self, block: int) -> bytes:
        return self._read_at(block * self.block_size, self.block_size)

    def _inode_table_block(self, group: int) -> int:
        off = self._gd_block * self.block_size + group * self.desc_size
        desc = self._read_at(off, self.desc_size)
        lo = struct.unpack_from("<I", desc, 8)[0]
        hi = 0
        if self.desc_size >= 64:
            hi = struct.unpack_from("<I", desc, 40)[0]
        return (hi << 32) | lo

    def _read_inode(self, ino: int) -> bytes:
        group, index = divmod(ino - 1, self.inodes_per_group)
        table = self._inode_table_block(group)
        off = table * self.block_size + index * self.inode_size
        return self._read_at(off, min(self.inode_size, 160))

    # -- block resolution --------------------------------------------------

    def _extent_blocks(self, node: bytes) -> Iterator[tuple[int, int, int]]:
        """Yields (logical_block, count, physical_block) from an extent
        tree node (depth-first)."""
        magic, entries, _max, depth = struct.unpack_from("<HHHH", node, 0)
        if magic != EXTENT_MAGIC:
            raise Ext4Error("bad extent magic")
        for i in range(entries):
            e = node[12 + i * 12 : 24 + i * 12]
            if depth == 0:
                lblock, raw_len, hi, lo = struct.unpack("<IHHI", e)
                # ee_len > 0x8000 marks an UNWRITTEN (preallocated) extent
                # of raw_len - 0x8000 blocks: it must read as zeros, never
                # as on-disk bytes.  Exactly 0x8000 is an initialized
                # 32768-block extent (ext4 disk layout docs).
                if raw_len > 0x8000:
                    continue  # unwritten -> stays a hole (zeros)
                count = raw_len
                yield lblock, count, (hi << 32) | lo
            else:
                _lblock, lo, hi, _u = struct.unpack("<IIHH", e)
                child = self._read_block((hi << 32) | lo)
                yield from self._extent_blocks(child)

    def _file_blocks(self, inode: bytes, nblocks: int) -> list[int]:
        """Physical block per logical block (0 = hole) for the first
        `nblocks` logical blocks."""
        flags = struct.unpack_from("<I", inode, 32)[0]
        i_block = inode[40:100]
        out = [0] * nblocks
        if flags & EXTENTS_FL:
            for lblock, count, pblock in self._extent_blocks(i_block):
                for k in range(count):
                    if lblock + k < nblocks:
                        out[lblock + k] = pblock + k
            return out
        # classic ext2 map
        per = self.block_size // 4
        direct = struct.unpack("<12I", i_block[:48])
        for i in range(min(12, nblocks)):
            out[i] = direct[i]

        def indirect(block: int, level: int, start: int) -> None:
            if block == 0 or start >= nblocks:
                return
            ptrs = struct.unpack(f"<{per}I", self._read_block(block))
            span = per ** (level - 1)
            for i, p in enumerate(ptrs):
                lb = start + i * span
                if lb >= nblocks:
                    break
                if level == 1:
                    out[lb] = p
                else:
                    indirect(p, level - 1, lb)

        ind, dind, tind = struct.unpack("<3I", i_block[48:60])
        indirect(ind, 1, 12)
        indirect(dind, 2, 12 + per)
        indirect(tind, 3, 12 + per + per * per)
        return out

    def _read_file(self, ino: int) -> bytes:
        inode = self._read_inode(ino)
        size = self._file_size(inode)
        nblocks = -(-size // self.block_size) if size else 0
        chunks = []
        for pblock in self._file_blocks(inode, nblocks):
            if pblock == 0:
                chunks.append(b"\x00" * self.block_size)
            else:
                chunks.append(self._read_block(pblock))
        return b"".join(chunks)[:size]

    @staticmethod
    def _file_size(inode: bytes) -> int:
        lo = struct.unpack_from("<I", inode, 4)[0]
        hi = struct.unpack_from("<I", inode, 108)[0] if len(inode) >= 112 else 0
        return (hi << 32) | lo

    # -- directory walk ----------------------------------------------------

    def _dir_entries(self, ino: int) -> Iterator[tuple[int, int, str]]:
        """(child_inode, file_type, name) of a directory."""
        data = self._read_file(ino)
        off = 0
        while off + 8 <= len(data):
            child, rec_len, name_len, ftype = struct.unpack_from(
                "<IHBB", data, off
            )
            if rec_len < 8:
                break
            if child != 0 and name_len:
                name = data[off + 8 : off + 8 + name_len].decode(
                    "utf-8", "replace"
                )
                if name not in (".", ".."):
                    yield child, ftype, name
            off += rec_len

    def walk(self) -> Iterator[Ext4Entry]:
        """Every regular file, depth-first from the root."""
        stack: list[tuple[int, str]] = [(ROOT_INODE, "")]
        seen: set[int] = set()
        while stack:
            ino, prefix = stack.pop()
            if ino in seen:
                continue
            seen.add(ino)
            for child, _ftype, name in self._dir_entries(ino):
                path = f"{prefix}{name}"
                inode = self._read_inode(child)
                mode = struct.unpack_from("<H", inode, 0)[0]
                kind = mode & S_IFMT
                if kind == S_IFDIR:
                    stack.append((child, path + "/"))
                elif kind == S_IFREG:
                    yield Ext4Entry(
                        path=path,
                        size=self._file_size(inode),
                        mode=mode & 0o777,
                        opener=lambda c=child: self._read_file(c),
                    )
