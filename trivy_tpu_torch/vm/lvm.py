"""LVM2 physical-volume reader: linear logical volumes -> file-like views.

The reference scans LVM-carved disks through go-lvm (pkg/fanal/walker/
vm.go:195); this is the from-scratch analogue.  Scope: single-PV volume
groups with linear ("striped", stripe_count 1) segments — the layout every
default `lvcreate` produces.  RAID/thin/cache segment types are detected
and skipped loudly.

On-disk format (lvm2 format_text):

  sector 0-3   PV label: "LABELONE" + sector# + crc + offset + "LVM2 001";
               pv_header at `offset` within the label sector: uuid[32],
               device_size, data areas (u64 offset,size pairs, zero-
               terminated), then metadata areas (same encoding).
  mda area     mda_header at the metadata area offset: crc[4],
               magic " LVM2 x[5A%r0N*>", version, start, size, then
               raw_locn slots {offset, size, checksum, flags} — slot 0
               points at the current metadata TEXT (offset relative to the
               mda area, circular buffer).
  metadata     the VG described in lvm.conf syntax:
               vg0 { extent_size = 8192 physical_volumes { pv0 {
               pe_start = 2048 } } logical_volumes { root { segment1 {
               start_extent = 0 extent_count = 2 type = "striped"
               stripes = [ "pv0", 0 ] } } } }

Copied from `trivy_tpu/vm/lvm.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field

SECTOR = 512
_LABEL = b"LABELONE"
_LVM2_TYPE = b"LVM2 001"
_MDA_MAGIC = b" LVM2 x[5A%r0N*>"


class LvmError(RuntimeError):
    pass


# -- lvm.conf-syntax parser ------------------------------------------------

_TOKEN_RE = re.compile(
    r'"(?:[^"\\]|\\.)*"|\[|\]|\{|\}|=|,|[^\s"\[\]{}=,#]+|#[^\n]*'
)


def parse_lvm_config(text: str) -> dict:
    """The metadata text -> nested dicts (sections), values are
    str/int/list."""
    toks = [
        t for t in _TOKEN_RE.findall(text) if not t.startswith("#")
    ]
    pos = 0

    def value(tok):
        if tok.startswith('"'):
            return tok[1:-1]
        try:
            return int(tok)
        except ValueError:
            return tok

    def block() -> dict:
        nonlocal pos
        out: dict = {}
        while pos < len(toks):
            tok = toks[pos]
            if tok == "}":
                pos += 1
                return out
            name = tok
            pos += 1
            if pos >= len(toks):
                break
            if toks[pos] == "{":
                pos += 1
                out[name] = block()
            elif toks[pos] == "=":
                pos += 1
                if toks[pos] == "[":
                    pos += 1
                    arr = []
                    while toks[pos] != "]":
                        if toks[pos] != ",":
                            arr.append(value(toks[pos]))
                        pos += 1
                    pos += 1
                    out[name] = arr
                else:
                    out[name] = value(toks[pos])
                    pos += 1
        return out

    return block()


# -- PV / metadata discovery -----------------------------------------------


def _read(img, offset: int, n: int) -> bytes:
    img.seek(offset)
    return img.read(n)


def find_label(img, base: int) -> tuple[int, int] | None:
    """(label_sector_offset, pv_header_offset) or None."""
    for s in range(4):
        sec = _read(img, base + s * SECTOR, SECTOR)
        if sec[:8] == _LABEL and sec[24:32] == _LVM2_TYPE:
            (hdr_off,) = struct.unpack_from("<I", sec, 20)
            return base + s * SECTOR, base + s * SECTOR + hdr_off
    return None


def _area_list(buf: bytes, pos: int) -> tuple[list[tuple[int, int]], int]:
    areas = []
    while True:
        off, size = struct.unpack_from("<QQ", buf, pos)
        pos += 16
        if off == 0 and size == 0:
            return areas, pos
        areas.append((off, size))


def read_metadata_text(img, base: int) -> str:
    """The current VG metadata text of the PV whose label starts at
    `base` (byte offset of the partition)."""
    label = find_label(img, base)
    if label is None:
        raise LvmError("no LVM2 label")
    _sec, hdr = label
    buf = _read(img, hdr, SECTOR * 2)
    pos = 32 + 8  # uuid + device size
    _data_areas, pos = _area_list(buf, pos)
    mda_areas, _pos = _area_list(buf, pos)
    if not mda_areas:
        raise LvmError("no metadata areas")
    mda_off, mda_size = mda_areas[0]
    mda = _read(img, base + mda_off, SECTOR)
    if mda[4:20] != _MDA_MAGIC:
        raise LvmError("bad mda header magic")
    pos = 40  # crc(4)+magic(16)+version(4)+start(8)+size(8)
    raw_off, raw_size = struct.unpack_from("<QQ", mda, pos)
    if raw_off == 0 or raw_size == 0:
        raise LvmError("empty metadata slot")
    start = base + mda_off + raw_off
    end_space = mda_size - raw_off
    if raw_size <= end_space:
        text = _read(img, start, raw_size)
    else:  # circular wrap: tail continues after the mda header
        text = _read(img, start, end_space) + _read(
            img, base + mda_off + 512, raw_size - end_space
        )
    return text.decode("utf-8", "replace")


@dataclass
class LinearLV:
    """A linear logical volume mapped onto one PV."""

    name: str
    vg_name: str
    # (lv_byte_offset, image_byte_offset, byte_length), sorted by lv off
    extents: list[tuple[int, int, int]] = field(default_factory=list)

    @property
    def size(self) -> int:
        return sum(e[2] for e in self.extents)


def logical_volumes(img, base: int) -> list[LinearLV]:
    """Linear LVs of the PV at `base`; non-linear segment types are
    skipped (raising only when nothing is readable at all is the walker's
    call — it logs per-LV).  Corrupt metadata of ANY shape — unparseable
    text OR parseable text with junk values (stripes = ["pv0", "x"]) —
    surfaces as LvmError so the VM walker can warn-and-skip."""
    try:
        return _logical_volumes_unchecked(img, base)
    except LvmError:
        raise
    except (
        IndexError, KeyError, ValueError, TypeError, struct.error, OSError
    ) as e:
        raise LvmError(f"corrupt LVM metadata: {e!r}") from e


def _logical_volumes_unchecked(img, base: int) -> list[LinearLV]:
    cfg = parse_lvm_config(read_metadata_text(img, base))
    vgs = [(k, v) for k, v in cfg.items() if isinstance(v, dict)]
    out: list[LinearLV] = []
    for vg_name, vg in vgs:
        extent_size = int(vg.get("extent_size", 0)) * SECTOR
        if not extent_size:
            continue
        pvs = vg.get("physical_volumes") or {}
        pe_starts = {
            name: int(pv.get("pe_start", 0)) * SECTOR
            for name, pv in pvs.items()
            if isinstance(pv, dict)
        }
        for lv_name, lv in (vg.get("logical_volumes") or {}).items():
            if not isinstance(lv, dict):
                continue
            vol = LinearLV(name=lv_name, vg_name=vg_name)
            ok = True
            for seg_name, seg in sorted(lv.items()):
                if not (
                    isinstance(seg, dict) and seg_name.startswith("segment")
                ):
                    continue
                stype = seg.get("type", "")
                stripes = seg.get("stripes") or []
                if stype != "striped" or seg.get("stripe_count", 1) != 1 \
                        or len(stripes) != 2:
                    ok = False  # raid/thin/multi-stripe: unsupported
                    break
                pv_name, start_pe = stripes[0], int(stripes[1])
                if pv_name not in pe_starts:
                    ok = False
                    break
                lv_off = int(seg.get("start_extent", 0)) * extent_size
                img_off = (
                    base
                    + pe_starts[pv_name]
                    + start_pe * extent_size
                )
                length = int(seg.get("extent_count", 0)) * extent_size
                vol.extents.append((lv_off, img_off, length))
            if ok and vol.extents:
                vol.extents.sort()
                out.append(vol)
    return out


class LVReader:
    """File-like view of a linear LV over the backing image."""

    def __init__(self, img, lv: LinearLV):
        self._img = img
        self._lv = lv
        self._pos = 0

    def seek(self, pos: int, whence: int = 0):
        if whence == 0:
            self._pos = pos
        elif whence == 1:
            self._pos += pos
        else:
            self._pos = self._lv.size + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = max(self._lv.size - self._pos, 0)
        out = bytearray()
        while n > 0:
            chunk = self._read_at(self._pos, n)
            if not chunk:
                break
            out += chunk
            self._pos += len(chunk)
            n -= len(chunk)
        return bytes(out)

    def _read_at(self, pos: int, n: int) -> bytes:
        for lv_off, img_off, length in self._lv.extents:
            if lv_off <= pos < lv_off + length:
                within = pos - lv_off
                take = min(n, length - within)
                self._img.seek(img_off + within)
                return self._img.read(take)
        return b""
