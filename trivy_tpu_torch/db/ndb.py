"""rpm ndb database reader (SUSE's Packages.db), read-only, from scratch.

The third and last rpmdb on-disk format (rpm's lib/backend/ndb/rpmpkg.c;
the reference reads it via go-rpmdb's pkg/ndb): SLE 15 and openSUSE
Tumbleweed ship it as /var/lib/rpm/Packages.db.  Layout (little-endian):

* header (32 bytes — two slot widths): magic "RpmP", version,
  generation, slot-page count, next pkg index, pad;
* slot area: from byte 32, `SlotNPages` 4096-byte pages of 16-byte slot
  entries {magic "Slot", pkg index, blk offset, blk count}; EVERY slot
  carries the magic (free slots have pkg index 0) — a slot without it is
  a torn/corrupt database and errors hard, like go-rpmdb;
* blobs: at blk offset * 16 — a 16-byte blob header {magic "BlbS", pkg
  index, generation, blob length} followed by the rpm header blob.

Malformed structure raises NdbError — a package DB that cannot be read
must be loud, never an empty inventory.

Copied from `trivy_tpu/db/ndb.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import struct
from typing import Iterator

NDB_HEADER_MAGIC = 0x506D7052  # "RpmP"
NDB_SLOT_MAGIC = 0x746F6C53  # "Slot"
NDB_BLOB_MAGIC = 0x53626C42  # "BlbS"
_SLOT_PAGE = 4096
_BLK = 16


class NdbError(RuntimeError):
    pass


def is_ndb(content: bytes) -> bool:
    return (
        len(content) >= 4
        and struct.unpack_from("<I", content, 0)[0] == NDB_HEADER_MAGIC
    )


class NdbReader:
    def __init__(self, data: bytes):
        if len(data) < 16:
            raise NdbError("ndb: file too small")
        magic, self.version, self.generation, self.slot_npages = (
            struct.unpack_from("<IIII", data, 0)
        )
        if magic != NDB_HEADER_MAGIC:
            raise NdbError("ndb: bad header magic")
        if not 0 < self.slot_npages <= 1 << 20:
            raise NdbError(f"ndb: implausible slot page count {self.slot_npages}")
        self.data = data

    def values(self) -> Iterator[bytes]:
        """Every stored rpm header blob, in slot order."""
        slots_end = self.slot_npages * _SLOT_PAGE
        if slots_end > len(self.data):
            raise NdbError("ndb: slot area beyond EOF")
        # The 32-byte header occupies the first two slot widths of page 0.
        for off in range(32, slots_end, 16):
            smagic, index, blkoff, blkcnt = struct.unpack_from(
                "<IIII", self.data, off
            )
            if smagic != NDB_SLOT_MAGIC:
                raise NdbError(
                    f"ndb: bad slot magic at {off} (torn database?)"
                )
            if index == 0:
                continue  # free slot
            byte0 = blkoff * _BLK
            if byte0 + 16 > len(self.data):
                raise NdbError(f"ndb: slot {index} blob beyond EOF")
            bmagic, bindex, _bgen, blen = struct.unpack_from(
                "<IIII", self.data, byte0
            )
            if bmagic != NDB_BLOB_MAGIC:
                raise NdbError(f"ndb: slot {index}: bad blob magic")
            if bindex != index:
                raise NdbError(
                    f"ndb: slot {index} points at blob of package {bindex}"
                )
            if byte0 + 16 + blen > len(self.data):
                raise NdbError(f"ndb: blob {index} truncated")
            if 16 + blen > blkcnt * _BLK:  # span includes the blob header
                raise NdbError(f"ndb: blob {index} longer than its blocks")
            yield bytes(self.data[byte0 + 16 : byte0 + 16 + blen])
