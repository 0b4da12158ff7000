"""Disk image partition parsing (pkg/fanal/walker/vm.go partition side).

Raw disk images carry an MBR or GPT partition table; each partition maps
to an (offset, size) window over the image.  `is_lvm` detects an LVM2
physical volume, whose linear volumes `lvm.py` maps.  Bare filesystems
(no table) yield a single whole-image partition.

Copied from `trivy_tpu/vm/disk.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

SECTOR = 512
_GPT_SIGNATURE = b"EFI PART"
_EXT_MAGIC = 0xEF53
_LVM_MAGIC = b"LABELONE"


@dataclass
class Partition:
    index: int
    offset: int  # bytes
    size: int  # bytes
    type_tag: str = ""  # mbr type byte hex or gpt type guid


_EXTENDED_TYPES = (0x05, 0x0F, 0x85)


def _mbr_entries(sector: bytes):
    for i in range(4):
        entry = sector[446 + i * 16 : 446 + (i + 1) * 16]
        ptype = entry[4]
        lba_start, lba_count = struct.unpack("<II", entry[8:16])
        if ptype and lba_count:
            yield ptype, lba_start, lba_count


def _mbr_partitions(img) -> list[Partition]:
    img.seek(0)
    sector = img.read(SECTOR)
    if len(sector) < SECTOR or sector[510:512] != b"\x55\xaa":
        return []
    out = []
    index = 0
    for ptype, lba_start, lba_count in _mbr_entries(sector):
        if ptype in _EXTENDED_TYPES:
            # Walk the EBR chain: logical partitions (sda5...) live inside
            # the extended container; offsets in EBRs are relative.
            ext_base = lba_start
            ebr_lba = lba_start
            for _ in range(128):  # chain-loop guard
                img.seek(ebr_lba * SECTOR)
                ebr = img.read(SECTOR)
                if len(ebr) < SECTOR or ebr[510:512] != b"\x55\xaa":
                    break
                entries = list(_mbr_entries(ebr))
                logical = next(
                    (e for e in entries if e[0] not in _EXTENDED_TYPES), None
                )
                if logical is not None:
                    index += 1
                    lptype, lstart, lcount = logical
                    out.append(
                        Partition(
                            index=index + 4,
                            offset=(ebr_lba + lstart) * SECTOR,
                            size=lcount * SECTOR,
                            type_tag=f"{lptype:#04x}",
                        )
                    )
                nxt = next(
                    (e for e in entries if e[0] in _EXTENDED_TYPES), None
                )
                if nxt is None:
                    break
                ebr_lba = ext_base + nxt[1]
            continue
        index += 1
        out.append(
            Partition(
                index=index,
                offset=lba_start * SECTOR,
                size=lba_count * SECTOR,
                type_tag=f"{ptype:#04x}",
            )
        )
    return out


def _gpt_partitions(img) -> list[Partition]:
    img.seek(SECTOR)
    header = img.read(92)
    if len(header) < 92 or header[:8] != _GPT_SIGNATURE:
        return []
    entries_lba, n_entries, entry_size = struct.unpack_from("<QII", header, 72)
    # Bound table size against corrupt/crafted headers (n_entries is
    # attacker-controlled in a scanned image).
    if not (1 <= n_entries <= 4096 and 128 <= entry_size <= 4096):
        return []
    img.seek(entries_lba * SECTOR)
    table = img.read(n_entries * entry_size)
    out = []
    for i in range(n_entries):
        e = table[i * entry_size : (i + 1) * entry_size]
        if len(e) < 128 or e[:16] == b"\x00" * 16:
            continue
        first, last = struct.unpack_from("<QQ", e, 32)
        if last < first:
            continue
        out.append(
            Partition(
                index=i + 1,
                offset=first * SECTOR,
                size=(last - first + 1) * SECTOR,
                type_tag=e[:16].hex(),
            )
        )
    return out


def is_lvm(img, offset: int) -> bool:
    """LVM PV label lives in one of the first 4 sectors (vm.go:195)."""
    for s in range(4):
        img.seek(offset + s * SECTOR)
        if img.read(8) == _LVM_MAGIC:
            return True
    return False


def is_ext(img, offset: int) -> bool:
    img.seek(offset + 1024 + 56)
    raw = img.read(2)
    return len(raw) == 2 and struct.unpack("<H", raw)[0] == _EXT_MAGIC


def list_partitions(img, image_size: int) -> list[Partition]:
    """GPT first (its protective MBR would confuse the MBR path), then MBR,
    then the whole image as one bare-filesystem partition."""
    parts = _gpt_partitions(img)
    if not parts:
        parts = _mbr_partitions(img)
        # a protective MBR (type 0xee) guards a GPT we failed to read
        parts = [p for p in parts if p.type_tag != "0xee"]
    if not parts:
        parts = [Partition(index=1, offset=0, size=image_size)]
    return parts
