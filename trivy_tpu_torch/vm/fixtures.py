"""VM disk fixtures: file systems, partition tables, LVM2, VMDK and an
in-process EBS endpoint.

Builders for the port's tests and `chip_smoke.py`; the scanner never
imports this module.  Each writes its format from the format's own layout,
independently of the readers under `vm/`, so a mistake on either side fails
a round trip instead of cancelling out:

- `build_ext4(root, path[, gpt=True])`: an ext2/3/4 image of a directory
  tree through `mke2fs -d` (e2fsprogs), sized from the tree, bare or as
  the one partition of a GPT disk;
- `wrap_mbr` / `wrap_gpt`: a one-partition MBR or GPT disk around a file
  system's bytes; `wrap_mbr_logical` puts the partition in an extended
  partition's EBR chain;
- `build_pv_image(fs)`: an LVM2 physical volume whose one linear logical
  volume holds `fs` (the lvm2 format_text layout);
- `write_monolithic_sparse` / `write_stream_optimized`: the two VMDK
  sparse-extent variants (grain directory and tables per the VMDK spec);
- `build_xfs(files)`: a single-AG XFS v5 image (short-form, single-block
  and multi-block directories, extent-list files);
- `serve_ebs(image)`: the EBS direct API (ListSnapshotBlocks,
  GetSnapshotBlock) and EC2 DescribeImages over one snapshot, on localhost.

The LVM, VMDK and EBS writers follow `tests/test_vm.py` and
`tests/test_vm_sources.py`; `build_xfs` is `tests/xfs_fixture.py`'s.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import subprocess
import threading
import uuid
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

SECTOR = 512
PART_START_LBA = 2048  # 1 MiB alignment, as fdisk and sgdisk place the first partition
LINUX_FS_GUID = "0fc63daf-8483-4772-8e79-3d69d8477de4"


# -- ext2/3/4 -------------------------------------------------------------


def mke2fs_path() -> str | None:
    """e2fsprogs' `mke2fs`, or None where it is not installed."""
    for cand in (shutil.which("mke2fs"), "/usr/sbin/mke2fs", "/sbin/mke2fs"):
        if cand and os.path.exists(cand):
            return cand
    return None


def _tree_size(root: str) -> tuple[int, int]:
    """(4 KiB blocks the tree's files and directories take, entries)."""
    blocks = entries = 0
    for dirpath, dirnames, filenames in os.walk(root):
        entries += 1 + len(filenames)
        blocks += 1 + sum(-(-os.path.getsize(os.path.join(dirpath, f)) // 4096)
                          for f in filenames)
    return blocks, entries


def build_ext4(root: str, path: str, ext: str = "ext4", block: int = 4096,
               size_kb: int | None = None, gpt: bool = False) -> str:
    """`mke2fs -d root` into a new image at `path`; raises FileNotFoundError
    without e2fsprogs.  The file system is the tree's blocks, its inodes
    and a journal, with a quarter more room.  With `gpt`, `path` is a GPT
    disk whose one partition (LBA 2048) mke2fs writes in place
    (`-E offset`), so a large tree is never copied."""
    mke2fs = mke2fs_path()
    if mke2fs is None:
        raise FileNotFoundError("mke2fs (e2fsprogs) is not installed")
    blocks, entries = _tree_size(root)
    inodes = entries + 64
    if size_kb is None:
        data_kb = blocks * 4 + inodes * 256 // 1024
        size_kb = max(4096, int(data_kb * 1.25) + (32 << 10 if ext != "ext2" else 1024))
    if os.path.exists(path):
        os.unlink(path)
    extra = []
    if gpt:
        part = size_kb * 1024 // SECTOR
        n_sectors = PART_START_LBA + part + 33
        with open(path, "wb") as f:
            f.truncate(n_sectors * SECTOR)
        extra = ["-E", f"offset={PART_START_LBA * SECTOR}"]
    subprocess.run(
        [mke2fs, "-q", "-F", "-t", ext, "-b", str(block), "-N", str(inodes), *extra,
         "-d", root, path, f"{size_kb}k"],
        check=True, capture_output=True,
    )
    if gpt:
        primary, entries_, backup = _gpt_tables(n_sectors, part, LINUX_FS_GUID)
        with open(path, "r+b") as f:
            f.write(primary)
            f.seek((PART_START_LBA + part) * SECTOR)
            f.write(entries_ + backup)
    return path


# -- partition tables -------------------------------------------------------


def _mbr(entries: list[tuple[int, int, int]]) -> bytes:
    """A boot sector with (type, first LBA, sectors) entries."""
    table = b"".join(struct.pack("<8B II", 0, 0, 0, 0, ptype, 0, 0, 0, start, count)
                     for ptype, start, count in entries)
    return b"\x00" * 446 + table.ljust(64, b"\x00") + b"\x55\xaa"


def _sectors(nbytes: int) -> int:
    return -(-nbytes // SECTOR)


def wrap_mbr(fs: bytes, ptype: int = 0x83) -> bytes:
    """One-partition MBR disk: the boot sector, alignment, the partition."""
    mbr = _mbr([(ptype, PART_START_LBA, _sectors(len(fs)))])
    return mbr.ljust(PART_START_LBA * SECTOR, b"\x00") + fs.ljust(
        _sectors(len(fs)) * SECTOR, b"\x00")


def wrap_mbr_logical(fs: bytes, ptype: int = 0x83) -> bytes:
    """MBR disk whose one extended partition (type 0x05) holds a logical
    partition behind an EBR; the EBR's offsets are relative to it."""
    n = _sectors(len(fs))
    ext_start = PART_START_LBA
    ebr = _mbr([(ptype, PART_START_LBA, n)])  # the logical partition, EBR-relative
    ext_len = PART_START_LBA + n
    mbr = _mbr([(0x05, ext_start, ext_len)])
    out = bytearray(mbr.ljust(ext_start * SECTOR, b"\x00"))
    out += ebr.ljust(PART_START_LBA * SECTOR, b"\x00")
    out += fs.ljust(n * SECTOR, b"\x00")
    return bytes(out)


def _gpt_tables(n_sectors: int, part_sectors: int, type_guid: str) -> tuple[bytes, bytes, bytes]:
    """(protective MBR + primary header + entries, backup entries, backup
    header) of a one-partition GPT disk of `n_sectors` sectors, CRCs set."""
    n_entries, entry_size = 128, 128
    table_sectors = n_entries * entry_size // SECTOR
    first, last = PART_START_LBA, PART_START_LBA + part_sectors - 1
    # the disk's and the partition's GUIDs follow from its size: the same
    # file system always wraps to the same bytes
    part_guid = uuid.uuid5(uuid.NAMESPACE_OID, f"partition-{n_sectors}-{part_sectors}")
    entry = (uuid.UUID(type_guid).bytes_le + part_guid.bytes_le
             + struct.pack("<QQQ", first, last, 0) + "root".encode("utf-16-le").ljust(72, b"\x00"))
    entries = entry.ljust(n_entries * entry_size, b"\x00")
    disk_guid = uuid.uuid5(uuid.NAMESPACE_OID, f"disk-{n_sectors}").bytes_le

    def header(my_lba: int, alt_lba: int, entries_lba: int) -> bytes:
        fields = [b"EFI PART", 0x00010000, 92, 0, 0, my_lba, alt_lba,
                  2 + table_sectors, n_sectors - 2 - table_sectors, disk_guid,
                  entries_lba, n_entries, entry_size, zlib.crc32(entries)]
        fmt = "<8sIIIIQQQQ16sQIII"
        crc = zlib.crc32(struct.pack(fmt, *fields))
        fields[3] = crc
        return struct.pack(fmt, *fields).ljust(SECTOR, b"\x00")

    pmbr = _mbr([(0xEE, 1, min(n_sectors - 1, 0xFFFFFFFF))])
    primary = pmbr + header(1, n_sectors - 1, 2) + entries
    backup_hdr = header(n_sectors - 1, 1, n_sectors - 1 - table_sectors)
    return primary, entries, backup_hdr


def wrap_gpt(fs: bytes, type_guid: str = LINUX_FS_GUID) -> bytes:
    """One-partition GPT disk: protective MBR, primary header and entries,
    the partition at LBA 2048, backup entries and header at the end."""
    part = _sectors(len(fs))
    n_sectors = PART_START_LBA + part + 33
    primary, entries, backup = _gpt_tables(n_sectors, part, type_guid)
    return (primary.ljust(PART_START_LBA * SECTOR, b"\x00") + fs.ljust(part * SECTOR, b"\x00")
            + entries + backup)


# -- LVM2 -------------------------------------------------------------------


def build_pv_image(fs: bytes, vg: str = "vg0", lv: str = "root") -> bytes:
    """A single-PV LVM2 image: the label in sector 1, the pv_header, one
    metadata area holding the VG's text, and `fs` as the one linear LV
    starting at pe_start (sector 2048, 1 MiB extents)."""
    pe_start = 2048  # sectors
    extent_sectors = 2048  # 1 MiB extents
    extents = max(1, -(-len(fs) // (extent_sectors * SECTOR)))
    total = pe_start * SECTOR + extents * extent_sectors * SECTOR
    img = bytearray(total)
    text = f"""{vg} {{
id = "aaaaaa-0000"
seqno = 1
status = ["RESIZEABLE", "READ", "WRITE"]
extent_size = {extent_sectors}
max_lv = 0
max_pv = 0
physical_volumes {{
pv0 {{
id = "bbbbbb-0000"
device = "/dev/loop0"
status = ["ALLOCATABLE"]
pe_start = {pe_start}
pe_count = {extents}
}}
}}
logical_volumes {{
{lv} {{
id = "cccccc-0000"
status = ["READ", "WRITE", "VISIBLE"]
segment_count = 1
segment1 {{
start_extent = 0
extent_count = {extents}
type = "striped"
stripe_count = 1
stripes = [
"pv0", 0
]
}}
}}
}}
}}
""".encode()
    # the metadata area: sectors 8..pe_start, its header then the text
    mda_off, mda_size = 4096, pe_start * SECTOR - 4096
    mda = bytearray(SECTOR)
    mda[4:20] = b" LVM2 x[5A%r0N*>"
    struct.pack_into("<I", mda, 20, 1)  # version
    struct.pack_into("<QQ", mda, 24, mda_off, mda_size)
    struct.pack_into("<QQII", mda, 40, SECTOR, len(text), 0, 0)  # raw_locn 0
    img[mda_off:mda_off + SECTOR] = mda
    img[mda_off + SECTOR:mda_off + SECTOR + len(text)] = text
    label = bytearray(SECTOR)
    label[0:8] = b"LABELONE"
    struct.pack_into("<Q", label, 8, 1)
    struct.pack_into("<I", label, 20, 32)  # pv_header offset
    label[24:32] = b"LVM2 001"
    hdr = b"P" * 32  # pv uuid
    hdr += struct.pack("<Q", total)  # device size
    hdr += struct.pack("<QQ", pe_start * SECTOR, extents * extent_sectors * SECTOR)
    hdr += struct.pack("<QQ", 0, 0)  # end of data areas
    hdr += struct.pack("<QQ", mda_off, mda_size)
    hdr += struct.pack("<QQ", 0, 0)  # end of metadata areas
    label[32:32 + len(hdr)] = hdr
    img[SECTOR:2 * SECTOR] = label
    img[pe_start * SECTOR:pe_start * SECTOR + len(fs)] = fs
    return bytes(img)


# -- VMDK -------------------------------------------------------------------

GRAIN_SECTORS = 128
GRAIN_BYTES = GRAIN_SECTORS * SECTOR
GTES_PER_GT = 512


def _vmdk_header(gd_offset: int, capacity_sectors: int, flags: int = 0,
                 compress: int = 0) -> bytes:
    hdr = struct.pack(
        "<4sIIQQQQIQQQB4sH",
        b"KDMV", 1, flags, capacity_sectors, GRAIN_SECTORS,
        1, 1, GTES_PER_GT, 0, gd_offset, 0, 0, b"\n \r\n", compress,
    )
    return hdr.ljust(SECTOR, b"\x00")


def write_monolithic_sparse(path: str, flat: bytes) -> str:
    """Header, descriptor, grain directory, grain tables, then the grains;
    all-zero grains are holes."""
    cap_sectors = _sectors(len(flat))
    grains_total = -(-cap_sectors // GRAIN_SECTORS)
    n_gt = -(-grains_total // GTES_PER_GT)
    gd_sector = 2
    gt_sector0 = gd_sector + max(1, -(-n_gt * 4 // SECTOR))
    gt_sectors = -(-GTES_PER_GT * 4 // SECTOR)
    cursor = gt_sector0 + n_gt * gt_sectors
    gtes, grains = [], []
    for gi in range(grains_total):
        grain = flat[gi * GRAIN_BYTES:(gi + 1) * GRAIN_BYTES]
        if not grain.strip(b"\x00"):
            gtes.append(0)
            continue
        gtes.append(cursor)
        grains.append((cursor, grain.ljust(GRAIN_BYTES, b"\x00")))
        cursor += GRAIN_SECTORS
    with open(path, "wb") as f:
        f.write(_vmdk_header(gd_sector, cap_sectors))
        f.write(b"# Disk DescriptorFile".ljust(SECTOR, b"\x00"))
        gd = [gt_sector0 + i * gt_sectors for i in range(n_gt)]
        f.write(struct.pack(f"<{n_gt}I", *gd).ljust((gt_sector0 - gd_sector) * SECTOR, b"\x00"))
        padded = gtes + [0] * (n_gt * GTES_PER_GT - len(gtes))
        f.write(struct.pack(f"<{len(padded)}I", *padded))
        for sector, grain in grains:
            f.seek(sector * SECTOR)
            f.write(grain)
    return path


def write_stream_optimized(path: str, flat: bytes) -> str:
    """The header with the GD-at-end sentinel, deflated grain markers, the
    grain tables and directory after them, the footer and end of stream."""
    cap_sectors = _sectors(len(flat))
    grains_total = -(-cap_sectors // GRAIN_SECTORS)
    n_gt = -(-grains_total // GTES_PER_GT)
    flags = (1 << 16) | (1 << 17)  # compressed grains, markers
    with open(path, "wb") as f:
        f.write(_vmdk_header(0xFFFFFFFFFFFFFFFF, cap_sectors, flags=flags, compress=1))
        # the descriptor sector keeps grain sectors >= 2 (a GTE of 1 is the
        # spec's zero-grain sentinel, never a data offset)
        f.write(b"# Disk DescriptorFile".ljust(SECTOR, b"\x00"))
        gtes = []
        for gi in range(grains_total):
            grain = flat[gi * GRAIN_BYTES:(gi + 1) * GRAIN_BYTES]
            if not grain.strip(b"\x00"):
                gtes.append(0)
                continue
            sector = _sectors(f.tell())
            f.seek(sector * SECTOR)
            gtes.append(sector)
            blob = zlib.compress(grain.ljust(GRAIN_BYTES, b"\x00"))
            f.write(struct.pack("<QI", gi * GRAIN_SECTORS, len(blob)))
            f.write(blob)
        gt_secs = []
        for t in range(n_gt):
            sector = _sectors(f.tell())
            f.seek(sector * SECTOR)
            gt_secs.append(sector)
            chunk = gtes[t * GTES_PER_GT:(t + 1) * GTES_PER_GT]
            chunk += [0] * (GTES_PER_GT - len(chunk))
            f.write(struct.pack(f"<{GTES_PER_GT}I", *chunk))
        gd_sector = _sectors(f.tell())
        f.seek(gd_sector * SECTOR)
        f.write(struct.pack(f"<{n_gt}I", *gt_secs))
        f.seek(_sectors(f.tell()) * SECTOR)
        f.write(b"\x00" * SECTOR)  # footer marker
        f.write(_vmdk_header(gd_sector, cap_sectors, flags=flags, compress=1))
        f.write(b"\x00" * SECTOR)  # end of stream
    return path


# -- XFS (single AG, v5) ------------------------------------------------------

XFS_BLOCK = 4096
XFS_INODE_SIZE = 512
XFS_INOPBLOG = 3  # 8 inodes per 4 KiB block
XFS_AGBLOCKS = 256  # a 1 MiB AG
XFS_AGBLKLOG = 8
XFS_ROOTINO = 64  # agbno 8, index 0


class _XfsImage:
    def __init__(self):
        self.buf = bytearray(XFS_AGBLOCKS * XFS_BLOCK)
        self.next_ino = XFS_ROOTINO
        self.next_block = 16  # data blocks from here; inodes at 8..15
        self.is_dir: dict[int, bool] = {}

    def alloc_ino(self) -> int:
        ino = self.next_ino
        self.next_ino += 1
        return ino

    def alloc_blocks(self, n: int) -> int:
        b = self.next_block
        self.next_block += n
        if self.next_block > XFS_AGBLOCKS:
            raise ValueError("the files do not fit the fixture's 1 MiB AG")
        return b

    def write_block(self, bno: int, data: bytes) -> None:
        assert len(data) <= XFS_BLOCK
        self.buf[bno * XFS_BLOCK:bno * XFS_BLOCK + len(data)] = data

    def write_inode(self, ino: int, mode: int, fmt: int, size: int, fork: bytes,
                    nextents: int = 0) -> None:
        if (ino >> XFS_INOPBLOG) >= 16:
            raise ValueError("the files do not fit the fixture's inode blocks")
        raw = bytearray(XFS_INODE_SIZE)
        struct.pack_into(">H", raw, 0, 0x494E)  # "IN"
        struct.pack_into(">H", raw, 2, mode)
        raw[4] = 3  # version 3
        raw[5] = fmt
        struct.pack_into(">Q", raw, 56, size)
        struct.pack_into(">I", raw, 76, nextents)
        raw[176:176 + len(fork)] = fork
        off = (ino >> XFS_INOPBLOG) * XFS_BLOCK + (ino & ((1 << XFS_INOPBLOG) - 1)) * XFS_INODE_SIZE
        self.buf[off:off + XFS_INODE_SIZE] = raw


def _xfs_extent(fileoff: int, fsbno: int, count: int) -> bytes:
    l0 = (fileoff << 9) | (fsbno >> 43)
    l1 = ((fsbno & ((1 << 43) - 1)) << 21) | count
    return struct.pack(">QQ", l0, l1)


def _xfs_sf_dir(img: _XfsImage, parent: int, entries: list[tuple[str, int]]) -> bytes:
    out = bytearray([len(entries), 0])  # count, i8count (4-byte inode numbers)
    out += struct.pack(">I", parent)
    for name, ino in entries:
        nb = name.encode()
        out.append(len(nb))
        out += b"\x00\x00"  # offset (a hash-order hint reads ignore)
        out += nb
        out.append(2 if img.is_dir.get(ino) else 1)  # ftype
        out += struct.pack(">I", ino)
    return bytes(out)


def _xfs_data_entries(img: _XfsImage, entries: list[tuple[str, int]], start: int,
                      end: int) -> bytes:
    out = bytearray()
    for name, ino in entries:
        nb = name.encode()
        elen = (8 + 1 + len(nb) + 1 + 2 + 7) & ~7
        rec = bytearray(elen)
        struct.pack_into(">Q", rec, 0, ino)
        rec[8] = len(nb)
        rec[9:9 + len(nb)] = nb
        rec[9 + len(nb)] = 2 if img.is_dir.get(ino) else 1
        struct.pack_into(">H", rec, elen - 2, start + len(out))
        out += rec
    free = end - start - len(out)
    if free >= 8:
        unused = bytearray(free)
        struct.pack_into(">H", unused, 0, 0xFFFF)
        struct.pack_into(">H", unused, 2, free)
        out += unused
    return bytes(out)


def build_xfs(files: dict[str, bytes]) -> bytes:
    """files: path -> content, each at the root or one level under `etc/`
    or `opt/`.  / is short-form, /etc a single-block (XDB3) directory, /opt
    a multi-block (XDD3) directory with a leaf extent; a file of several
    blocks takes two extents."""
    img = _XfsImage()
    root_ino, etc_ino, opt_ino = img.alloc_ino(), img.alloc_ino(), img.alloc_ino()
    img.is_dir.update({root_ino: True, etc_ino: True, opt_ino: True})
    groups: dict[str, list[tuple[str, int]]] = {"": [], "etc": [], "opt": []}
    contents: dict[int, bytes] = {}
    for path, content in files.items():
        top, _, rest = path.partition("/")
        ino = img.alloc_ino()
        contents[ino] = content
        if rest and top in ("etc", "opt"):
            groups[top].append((rest, ino))
        else:
            groups[""].append((path, ino))
    for ino, content in contents.items():
        nblocks = max(1, -(-len(content) // XFS_BLOCK))
        if nblocks > 1:
            b1, b2 = img.alloc_blocks(1), img.alloc_blocks(nblocks - 1)
            img.write_block(b1, content[:XFS_BLOCK])
            for k in range(nblocks - 1):
                img.write_block(b2 + k, content[(k + 1) * XFS_BLOCK:(k + 2) * XFS_BLOCK])
            fork = _xfs_extent(0, b1, 1) + _xfs_extent(1, b2, nblocks - 1)
            img.write_inode(ino, 0o100644, 2, len(content), fork, nextents=2)
        else:
            b = img.alloc_blocks(1)
            img.write_block(b, content)
            img.write_inode(ino, 0o100644, 2, len(content), _xfs_extent(0, b, 1), nextents=1)
    # /etc: single-block directory (header, entries, leaf and tail at the end)
    etc_block = img.alloc_blocks(1)
    blk = bytearray(XFS_BLOCK)
    struct.pack_into(">I", blk, 0, 0x58444233)  # XDB3
    n = len(groups["etc"]) + 2
    data_end = XFS_BLOCK - (n * 8 + 8)
    ents = [(".", etc_ino), ("..", root_ino)] + groups["etc"]
    blk[64:data_end] = _xfs_data_entries(img, ents, 64, data_end)[:data_end - 64]
    struct.pack_into(">I", blk, XFS_BLOCK - 8, n)  # tail count
    img.write_block(etc_block, blk)
    img.write_inode(etc_ino, 0o040755, 2, XFS_BLOCK, _xfs_extent(0, etc_block, 1), nextents=1)
    # /opt: two XDD3 data blocks and a leaf block at the leaf offset
    d1, d2, leafb = img.alloc_blocks(1), img.alloc_blocks(1), img.alloc_blocks(1)
    half = len(groups["opt"]) // 2
    for bno, ents in ((d1, [(".", opt_ino), ("..", root_ino)] + groups["opt"][:half]),
                      (d2, groups["opt"][half:])):
        blk = bytearray(XFS_BLOCK)
        struct.pack_into(">I", blk, 0, 0x58444433)  # XDD3
        blk[64:] = _xfs_data_entries(img, ents, 64, XFS_BLOCK)[:XFS_BLOCK - 64]
        img.write_block(bno, blk)
    img.write_block(leafb, b"\x00" * XFS_BLOCK)
    fork = (_xfs_extent(0, d1, 1) + _xfs_extent(1, d2, 1)
            + _xfs_extent((32 << 30) // XFS_BLOCK, leafb, 1))
    img.write_inode(opt_ino, 0o040755, 2, 2 * XFS_BLOCK, fork, nextents=3)
    sf = _xfs_sf_dir(img, root_ino, [("etc", etc_ino), ("opt", opt_ino)] + groups[""])
    img.write_inode(root_ino, 0o040755, 1, len(sf), sf)
    sb = bytearray(512)
    struct.pack_into(">I", sb, 0, 0x58465342)  # XFSB
    struct.pack_into(">I", sb, 4, XFS_BLOCK)
    struct.pack_into(">Q", sb, 56, XFS_ROOTINO)
    struct.pack_into(">I", sb, 84, XFS_AGBLOCKS)
    struct.pack_into(">I", sb, 88, 1)  # agcount
    struct.pack_into(">H", sb, 104, XFS_INODE_SIZE)
    struct.pack_into(">H", sb, 106, 1 << XFS_INOPBLOG)
    sb[123] = XFS_INOPBLOG
    sb[124] = XFS_AGBLKLOG
    sb[192] = 0  # dirblklog
    img.buf[:len(sb)] = sb
    return bytes(img.buf)


# -- EBS direct API and EC2 DescribeImages ------------------------------------


def serve_ebs(image: bytes, snapshot_id: str = "snap-test", ami_id: str = "ami-0123456789abcdef0",
              block_size: int = 65536) -> ThreadingHTTPServer:
    """A localhost endpoint serving `image` as EBS snapshot `snapshot_id`
    (ListSnapshotBlocks lists its non-zero blocks, GetSnapshotBlock returns
    one) and EC2 DescribeImages naming it as `ami_id`'s root snapshot.
    Point `AWS_ENDPOINT_URL` at `http://127.0.0.1:<port>`; call
    `shutdown()` and `server_close()` when done."""
    n_blocks = -(-len(image) // block_size)
    nonzero = [i for i in range(n_blocks)
               if image[i * block_size:(i + 1) * block_size].strip(b"\x00")]
    volume_gib = max(1, -(-len(image) // (1 << 30)))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, status: int, body: bytes) -> None:
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            path, _, query = self.path.partition("?")
            prefix = f"/snapshots/{snapshot_id}/blocks"
            if path == prefix:
                # VolumeSize is GiB, as the real API gives it; holes past
                # the last listed block read as zeros
                body = {"BlockSize": block_size, "VolumeSize": volume_gib,
                        "Blocks": [{"BlockIndex": i, "BlockToken": f"tok{i}"} for i in nonzero]}
                return self._send(200, json.dumps(body).encode())
            if path.startswith(prefix + "/"):
                idx = int(path.rsplit("/", 1)[1])
                if f"blockToken=tok{idx}" not in query:
                    return self._send(400, b"bad block token")
                return self._send(200, image[idx * block_size:(idx + 1) * block_size])
            if path == "/" and "Action=DescribeImages" in query:
                if f"ImageId.1={ami_id}" not in query:
                    return self._send(200, b"<DescribeImagesResponse><imagesSet/>"
                                           b"</DescribeImagesResponse>")
                body = ("<DescribeImagesResponse><imagesSet><item>"
                        f"<imageId>{ami_id}</imageId><blockDeviceMapping><item>"
                        "<deviceName>/dev/xvda</deviceName><ebs>"
                        f"<snapshotId>{snapshot_id}</snapshotId></ebs></item>"
                        "</blockDeviceMapping></item></imagesSet></DescribeImagesResponse>")
                return self._send(200, body.encode())
            return self._send(404, b"")

        do_POST = do_GET

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
