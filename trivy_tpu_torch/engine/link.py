"""Link codec: bit-packed H2D transcoding + compacted D2H fetches.

The port of `trivy_tpu/engine/link.py`, in two halves.

**Numpy half** (a copy): the sieve only distinguishes bytes that appear as
kept value bytes in some gram, so the host maps each raw byte to a small
class id (0 = "cannot match") and packs 2 symbols per byte (4-bit codec) or
4 symbols in 3 bytes (6-bit codec); gram constants are rewritten into the
same class space.  When the alphabet exceeds 15 classes the 4-bit codec
merges values, which can only ADD sieve hits (the exact confirm rejects
them).  Class ids stay <= 63 < 'A', so the kernels' case fold is a no-op on
coded symbols.

**Torch half**: `LinkCodec.unpack` (the twin of `make_unpack`) decodes on
the device ahead of the sieve, and `fetch_rows_compact` fetches only the
nonzero rows of a device result (a row bitmap first, then a gather of a
power-of-two padded index), with the reference's `(raw_bytes,
fetched_bytes)` accounting; `fetch_mask_packed` fetches a packed verdict
mask (the megakernel's, or the fused verify's keep bits), and
`fetch_stream_packed` the verify stream's flag map, compacted by lane.  All
are plain tensor code, as the reference's are XLA programs and not Pallas
kernels.

**Link economics**: `probe_link` measures the link once a process,
`gate_terms` prices it with `effective_link_rate` and the ratios, and
`record_gate` writes the priced decision to the gate log: the cost model of
the all-device engine's megakernel gate (`engine/device.py`
`_price_mega_gate`), copied with the reference's constants.

`TRIVY_TPU_LINK_CODEC` (off | auto | 4 | 6, default auto) selects the mode,
the same variable the JAX package reads.
"""

from __future__ import annotations

import hashlib
import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from trivy_tpu_torch import lockcheck
from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.engine.grams import fold_byte
from trivy_tpu_torch.engine.probes import _FREQ
from trivy_tpu_torch.mesh.plan import Sharded
from trivy_tpu_torch.obs import gatelog

# D2H compaction thresholds: tiny results fit one fetch anyway, and dense
# results (bitmap says > this fraction of rows hit) pay for the extra
# round-trip without saving bytes.
MIN_COMPACT_ROWS = 64
COMPACT_MAX_FRAC = 0.25

# Effective-rate model of `gate_terms`, the reference's constants: D2H_SHARE is d2h bytes as a fraction of h2d bytes
# on the device verify stream, STREAM_D2H_RATIO the post-compaction d2h
# fraction on sparse-hit corpora, FUSED_MASK_D2H_RATIO the fused path's one
# keep bit per lane against the flag map, and FUSED_REUPLOAD_RATIO the
# fused walk's marginal h2d (rows stay resident, only lane tables ship).
D2H_SHARE = 0.5
STREAM_D2H_RATIO = 0.15
FUSED_MASK_D2H_RATIO = 0.01
FUSED_REUPLOAD_RATIO = 0.0

# 4-bit codec: 15 non-other classes (ids 1..15); 6-bit: 63 (ids 1..63).
_CLASS_CAP = {4: 15, 6: 63}
# auto takes the merged 4-bit codec only when every gram keeps at least this
# much selectivity (bits) in class space.
MIN_MERGED_GRAM_BITS = 8.0


def codec_mode() -> str:
    """TRIVY_TPU_LINK_CODEC: off | auto | 4 | 6 (default auto)."""
    v = os.environ.get("TRIVY_TPU_LINK_CODEC", "auto").strip().lower()
    if v in ("off", "0", "raw", "none"):
        return "off"
    if v in ("4", "6"):
        return v
    return "auto"


def d2h_compaction_enabled() -> bool:
    """D2H compaction engages in every codec mode but `off` (it is lossless
    and needs no alphabet)."""
    return codec_mode() != "off"


@dataclass
class LinkAlphabet:
    """Every kept value byte of every compiled gram, plus the canonical
    exact class map (id = 1 + rank in sorted value order, else 0)."""

    values: np.ndarray  # sorted distinct folded value bytes, uint8
    class_map: np.ndarray  # [256] uint8

    @property
    def size(self) -> int:
        return int(len(self.values))


def canonical_class_map(values: np.ndarray) -> np.ndarray:
    """[256] uint8: raw byte -> 1 + rank of its folded value, else 0."""
    cm = np.zeros(256, dtype=np.uint8)
    rank = {int(v): i + 1 for i, v in enumerate(values)}
    for b in range(256):
        cm[b] = rank.get(fold_byte(b), 0)
    return cm


def derive_alphabet(gset) -> LinkAlphabet:
    """Collect the kept value bytes of every gram (`gset.masks/vals`)."""
    masks = np.asarray(gset.masks, dtype=np.uint32)
    vals = np.asarray(gset.vals, dtype=np.uint32)
    if len(masks) == 0:
        empty = np.zeros(0, dtype=np.uint8)
        return LinkAlphabet(values=empty, class_map=np.zeros(256, np.uint8))
    shifts = np.uint32(8) * np.arange(4, dtype=np.uint32)
    mb = (masks[:, None] >> shifts) & np.uint32(0xFF)
    vb = (vals[:, None] >> shifts) & np.uint32(0xFF)
    values = np.unique(vb[mb == 0xFF]).astype(np.uint8)
    return LinkAlphabet(values=values, class_map=canonical_class_map(values))


def _merge_values(values: np.ndarray, n_classes: int) -> dict[int, int]:
    """Frequency-balanced merge of `values` into classes 1..n_classes
    (longest-processing-time assignment by corpus frequency)."""
    totals = [0.0] * n_classes
    assign: dict[int, int] = {}
    for v in sorted(values.tolist(), key=lambda b: -float(_FREQ[b])):
        c = min(range(n_classes), key=lambda i: totals[i])
        totals[c] += float(_FREQ[v])
        assign[int(v)] = c + 1
    return assign


def _min_gram_bits(gset, assign: dict[int, int]) -> float:
    """Worst-case per-gram selectivity (bits) under a class assignment."""
    cls_prob: dict[int, float] = {}
    for v, c in assign.items():
        cls_prob[c] = cls_prob.get(c, 0.0) + float(_FREQ[v])
    masks = np.asarray(gset.masks, dtype=np.uint32)
    vals = np.asarray(gset.vals, dtype=np.uint32)
    worst = float("inf")
    for m, v in zip(masks, vals):
        bits = 0.0
        for k in range(4):
            if (int(m) >> (8 * k)) & 0xFF:
                b = (int(v) >> (8 * k)) & 0xFF
                bits += -math.log2(max(cls_prob[assign[b]], 1e-12))
        worst = min(worst, bits)
    return worst


@dataclass
class LinkCodec:
    """One selected transcoding: a [256] class map and a symbol width."""

    sym_bits: int  # 4 or 6
    class_map: np.ndarray  # [256] uint8
    num_classes: int  # non-other classes in use
    exact: bool

    def __post_init__(self) -> None:
        # keys resident rows: coded rows of another codec never alias
        self.codec_id = hashlib.blake2b(
            bytes([self.sym_bits]) + self.class_map.tobytes(), digest_size=4
        ).hexdigest()

    def coded_len(self, length: int) -> int:
        if self.sym_bits == 4:
            return -(-length // 2)
        return -(-length // 4) * 3

    @property
    def ratio(self) -> float:
        """Coded bytes per raw byte (asymptotic)."""
        return 0.5 if self.sym_bits == 4 else 0.75

    def encode_rows(self, rows: np.ndarray) -> np.ndarray:
        """[T, L] uint8 raw rows -> [T, coded_len(L)] uint8 packed ids."""
        t, length = rows.shape
        p = self.class_map[rows]
        if self.sym_bits == 4:
            if length % 2:
                p = np.concatenate(
                    [p, np.zeros((t, 1), dtype=np.uint8)], axis=1
                )
            q = p.reshape(t, -1, 2)
            return np.ascontiguousarray(q[..., 0] | (q[..., 1] << 4))
        pad = (-length) % 4
        if pad:
            p = np.concatenate(
                [p, np.zeros((t, pad), dtype=np.uint8)], axis=1
            )
        q = p.reshape(t, -1, 4)
        s0, s1, s2, s3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        b0 = s0 | ((s1 & 0x3) << 6)
        b1 = (s1 >> 2) | ((s2 & 0xF) << 4)
        b2 = (s2 >> 4) | (s3 << 2)
        return np.ascontiguousarray(
            np.stack([b0, b1, b2], axis=-1).reshape(t, -1)
        )

    def unpack(self, coded: torch.Tensor, out_len: int) -> torch.Tensor:
        """Packed [T, coded_len(out_len)] uint8 -> class-id rows
        [T, out_len] uint8, on `coded`'s device (shifts and masks only)."""
        return unpack_symbols(coded, self.sym_bits, out_len)

    def encode_grams(
        self, masks: np.ndarray, vals: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Gram constants in class space: each kept value byte becomes its
        class id; masks are unchanged."""
        masks = np.asarray(masks, dtype=np.uint32)
        vals = np.asarray(vals, dtype=np.uint32)
        shifts = np.uint32(8) * np.arange(4, dtype=np.uint32)
        mb = (masks[:, None] >> shifts) & np.uint32(0xFF)
        vb = ((vals[:, None] >> shifts) & np.uint32(0xFF)).astype(np.uint8)
        cb = np.where(mb == 0xFF, self.class_map[vb], 0).astype(np.uint32)
        cvals = (cb << shifts[None, :]).sum(axis=1, dtype=np.uint32)
        return masks.copy(), cvals


def unpack_symbols(
    coded: torch.Tensor, sym_bits: int | None, out_len: int
) -> torch.Tensor:
    """Codec bytes [T, Cc] uint8 -> symbol rows [T, out_len] uint8: 4-bit
    symbol 2i is the low nibble of byte i and 2i+1 the high one; 6-bit takes
    3 bytes to 4 symbols; `sym_bits=None` is raw bytes, returned as they are."""
    t = coded.shape[0]
    if sym_bits is None:
        return coded
    if sym_bits == 4:
        full = torch.stack([coded & 0x0F, coded >> 4], dim=-1)
        return full.reshape(t, -1)[:, :out_len]
    b = coded.reshape(t, -1, 3)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    s0 = b0 & 0x3F
    s1 = (b0 >> 6) | ((b1 & 0x0F) << 2)
    s2 = (b1 >> 4) | ((b2 & 0x03) << 4)
    s3 = b2 >> 2
    full = torch.stack([s0, s1, s2, s3], dim=-1)
    return full.reshape(t, -1)[:, :out_len]


def select_codec(alphabet: LinkAlphabet, mode: str, gset=None) -> LinkCodec | None:
    """Pick a codec for this alphabet, or None (raw rows).

    `auto`: exact 4-bit when the alphabet fits 15 classes; else a merged
    4-bit codec when every gram keeps MIN_MERGED_GRAM_BITS of class-space
    selectivity (needs `gset`); else exact 6-bit when it fits 63; else raw.
    Forced `4`/`6` use that width, merging if needed."""
    if mode == "off" or alphabet.size == 0:
        return None

    def exact(bits: int) -> LinkCodec:
        return LinkCodec(
            sym_bits=bits,
            class_map=alphabet.class_map.copy(),
            num_classes=alphabet.size,
            exact=True,
        )

    def merged(bits: int) -> LinkCodec:
        cap = _CLASS_CAP[bits]
        assign = _merge_values(alphabet.values, cap)
        cm = np.zeros(256, dtype=np.uint8)
        inv = {i + 1: v for i, v in enumerate(alphabet.values.tolist())}
        for b in range(256):
            c = int(alphabet.class_map[b])
            if c:
                cm[b] = assign[int(inv[c])]
        return LinkCodec(
            sym_bits=bits, class_map=cm, num_classes=cap, exact=False
        )

    if mode == "4":
        return exact(4) if alphabet.size <= _CLASS_CAP[4] else merged(4)
    if mode == "6":
        return exact(6) if alphabet.size <= _CLASS_CAP[6] else merged(6)
    if alphabet.size <= _CLASS_CAP[4]:
        return exact(4)
    if gset is not None and len(gset.masks):
        assign = _merge_values(alphabet.values, _CLASS_CAP[4])
        if _min_gram_bits(gset, assign) >= MIN_MERGED_GRAM_BITS:
            return merged(4)
    if alphabet.size <= _CLASS_CAP[6]:
        return exact(6)
    return None


_PACK_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _row_flags(out: torch.Tensor) -> torch.Tensor:
    """[ceil(T/8)] uint8 nonzero-row bitmap, MSB-first (np.packbits)."""
    t = out.shape[0]
    nz = (out.reshape(t, -1) != 0).any(dim=1).to(torch.int32)
    pad = (-t) % 8
    if pad:
        nz = torch.cat([nz, nz.new_zeros(pad)])
    w = torch.tensor(_PACK_WEIGHTS, dtype=torch.int32, device=out.device)
    return (nz.reshape(-1, 8) * w).sum(dim=1).to(torch.uint8)


def _demux_shards(out) -> np.ndarray:
    """Host copy of a (possibly) sharded device result: each lane ships
    only its own slice, and the host lays the slices at their global
    indices.  Shard order is index order, so the buffer is byte-identical
    to an unmeshed fetch; a plain tensor takes the plain fetch."""
    if isinstance(out, Sharded):
        return out.numpy()
    return out.cpu().numpy()


def fetch_rows_compact(out) -> tuple[np.ndarray, int, int]:
    """Fetch a device tensor whose leading axis is rows, compacting to the
    nonzero rows: (host array, raw_bytes, fetched_bytes).

    raw_bytes is what a plain full fetch moves; fetched_bytes counts
    everything that crossed the link (bitmap D2H + index H2D + gathered
    rows D2H, or the full fetch when the result is small or dense).  A
    row-sharded result compacts lane by lane, each lane fetching only its
    rows, and the host joins them in row order."""
    if isinstance(out, Sharded):
        if out.axis != 0:
            raise ValueError("compacted fetches take results sharded by rows")
        parts = [fetch_rows_compact(s) for s in out.shards]
        return (np.concatenate([p[0] for p in parts]), sum(p[1] for p in parts),
                sum(p[2] for p in parts))
    shape = tuple(out.shape)
    t = shape[0]
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * out.element_size()
    raw = t * row_bytes
    if t < MIN_COMPACT_ROWS:
        return out.cpu().numpy(), raw, raw
    flags = _row_flags(out).cpu().numpy()
    got = flags.nbytes
    nz = np.flatnonzero(np.unpackbits(flags)[:t])
    k = len(nz)
    host_dtype = out[:0].cpu().numpy().dtype
    if k == 0:
        return np.zeros(shape, dtype=host_dtype), raw, got
    if k > t * COMPACT_MAX_FRAC:
        return out.cpu().numpy(), raw, raw + got
    kpad = 1 << (k - 1).bit_length()
    idx = np.zeros(kpad, dtype=np.int32)
    idx[:k] = nz
    rows = out.index_select(0, torch.from_numpy(idx).to(out.device)).cpu().numpy()
    got += idx.nbytes + rows.nbytes
    full = np.zeros(shape, dtype=host_dtype)
    full[nz] = rows[:k]
    return full, raw, got


def fetch_mask_packed(out: torch.Tensor, raw_bytes: int) -> tuple[np.ndarray, int, int]:
    """Fetch the megakernel's packed verdict mask [Fp, mask_bytes] uint8, its
    only D2H.  Returns (flat bool lane mask, raw_bytes, fetched_bytes):
    `raw_bytes` is what the staged path's [Fp, R] uint8 candidate fetch
    would have moved for the same batch (the caller computes it), so the
    fetch accounting stays comparable across paths.  No bitmap round-trip:
    the mask is already one bit per lane.  A sharded mask is fetched per
    lane and demuxed in index order (`_demux_shards`)."""
    packed = _demux_shards(out)
    return np.unpackbits(packed).astype(bool), int(raw_bytes), packed.nbytes


def fetch_stream_packed(out: torch.Tensor) -> tuple[np.ndarray, int, int]:
    """Compacted fetch of the verify stream's packed flag map [P, rows, Lo]
    uint8 (`ops/nfa_verify.py` layout): the lanes (rows) are the sparse
    axis, so the device lays it out lane-major [rows, P * Lo], only the
    nonzero lanes cross the link, and the host lays them back.  Returns
    (packed host array [P, rows, Lo], raw_bytes, fetched_bytes); the byte
    counts equal the reference's for the same flags (its [P, Lo, G, Bg] map
    compacts over the same G * Bg lanes)."""
    p, rows, lo = (int(d) for d in out.shape)
    lanes2d, raw, got = fetch_rows_compact(out.permute(1, 0, 2).reshape(rows, p * lo))
    packed = np.ascontiguousarray(lanes2d.reshape(rows, p, lo).transpose(1, 0, 2))
    return packed, raw, got


def effective_link_rate(
    mb_s: float,
    h2d_ratio: float = 1.0,
    d2h_ratio: float = 1.0,
    reupload_ratio: float = 1.0,
) -> float:
    """Post-codec effective link rate: the rate at which raw payload bytes
    are serviced when h2d bytes shrink by `h2d_ratio` and d2h bytes by
    `d2h_ratio`, with 1 unit of h2d per D2H_SHARE units of d2h sharing one
    link:

        effective = mb_s * (1 + D2H_SHARE)
                / (reupload_ratio * h2d_ratio + D2H_SHARE * d2h_ratio)

    All ratios 1.0 give `mb_s`.  `reupload_ratio` scales the h2d term for
    paths that reuse device-resident bytes; the denominator floor keeps a
    fully resident, fully compacted path finite."""
    denom = reupload_ratio * h2d_ratio + D2H_SHARE * d2h_ratio
    return mb_s * (1.0 + D2H_SHARE) / max(denom, 1e-9)


# Process-wide link measurements, one per TRIVY_TPU_LINK value (and device
# for a real probe), so engines built again never re-measure the link.
_LINK_PROBE_LOCK = lockcheck.make_lock("engine.link.probe")
_LINK_PROBE: dict[str, tuple[float, float]] = {}  # owner: _LINK_PROBE_LOCK


def probe_link(device: str | torch.device = DEFAULT_DEVICE, size: int = 8 << 20,
               attempts: int = 3) -> tuple[float, float]:
    """(MB/s, round-trip s) of the host-to-`device` link, measured once per
    process as the best of `attempts` copies of `size` incompressible bytes
    to the device and back of one byte, less the best round trip of an
    8-byte copy.  TRIVY_TPU_LINK=wide|relay overrides with the reference's
    figures (tests, known deployments).  A failed probe raises."""
    override = os.environ.get("TRIVY_TPU_LINK", "")
    if override in ("wide", "relay"):
        key = override
    else:
        device = resolve_device(device)
        key = f"{override}@{device}"
    with _LINK_PROBE_LOCK:
        cached = _LINK_PROBE.get(key)
        if cached is not None:
            return cached
        if override == "wide":
            result = (10_000.0, 1e-4)
        elif override == "relay":
            result = (50.0, 0.1)
        else:
            buf = torch.from_numpy(
                np.random.default_rng(0).integers(0, 256, size=size, dtype=np.uint8)
            )
            buf[:8].to(device)[:1].cpu()  # wake the path
            best_dt = best_rtt = float("inf")
            for _ in range(attempts):
                t0 = time.perf_counter()
                buf.to(device)[:1].cpu()
                best_dt = min(best_dt, time.perf_counter() - t0)
                t0 = time.perf_counter()
                buf[:8].to(device)[:1].cpu()
                best_rtt = min(best_rtt, time.perf_counter() - t0)
            result = (size / max(best_dt - best_rtt, 1e-6) / 1e6, best_rtt)
        _LINK_PROBE[key] = result
        return result


# The reference's gate constants, unchanged (priced on its TPU links):
# effective post-codec rate and dispatch RTT the link must clear before
# verify goes to the device; the fused path's looser RTT bar (O(1)
# dispatches a batch); the megakernel's measured exec-rate floor.
GATE_EFF_MB_S = 1000.0
GATE_RTT_S = 0.01
FUSED_GATE_RTT_S = 0.25
MEGA_GATE_EXEC_MB_S = 500.0


def gate_terms(
    h2d_ratio: float = 1.0, d2h_ratio: float = 1.0,
    profile: str = "stream", devices: int = 1,
    exec_mb_s: float | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> dict:
    """Measure the link (`probe_link`) and price it against the device
    bar; returns every term of the decision (the gate log's record body).

    `profile`: "stream" (every verify byte crosses the link, d2h at the
    compaction ratio), "fused" (rows stay resident: zero re-upload and the
    FUSED_GATE_RTT_S bar), "mesh" (the fused model at `devices` cards) or
    "mega" (the fused model at `devices` cards plus the measured
    `exec_mb_s` against MEGA_GATE_EXEC_MB_S).  `margin` is the signed
    distance from the flip point, the worst term as a fraction of its
    threshold; positive = cleared."""
    mb_s, rtt = probe_link(device)
    devices = max(int(devices), 1)
    fused_model = profile in ("fused", "mesh", "mega")
    reupload = FUSED_REUPLOAD_RATIO if fused_model else 1.0
    rtt_bar = FUSED_GATE_RTT_S if fused_model else GATE_RTT_S
    eff = effective_link_rate(mb_s, h2d_ratio, d2h_ratio, reupload_ratio=reupload)
    if profile in ("mesh", "mega"):
        eff *= devices
    wide = eff >= GATE_EFF_MB_S and rtt < rtt_bar
    margin = min(eff / GATE_EFF_MB_S - 1.0, 1.0 - rtt / rtt_bar)
    out = {
        "profile": profile,
        "devices": devices,
        "link_mb_per_sec": mb_s,
        "link_rtt_s": rtt,
        "h2d_ratio": h2d_ratio,
        "d2h_ratio": d2h_ratio,
        "eff_mb_per_sec": eff,
        "eff_threshold_mb_per_sec": GATE_EFF_MB_S,
        "rtt_threshold_s": rtt_bar,
        "codec": codec_mode(),
        "wide": wide,
        "margin": margin,
    }
    if profile == "mega" and exec_mb_s is not None:
        out["exec_mb_per_sec"] = exec_mb_s
        out["exec_threshold_mb_per_sec"] = MEGA_GATE_EXEC_MB_S
        out["wide"] = wide and exec_mb_s >= MEGA_GATE_EXEC_MB_S
        out["margin"] = min(margin, exec_mb_s / MEGA_GATE_EXEC_MB_S - 1.0)
    return out


def record_gate(requested: str, backend: str, reason: str, terms: dict) -> dict:
    """Record a priced decision in the gate log with every link term."""
    return gatelog.record(
        requested=requested, backend=backend, reason=reason,
        profile=terms["profile"], devices=terms["devices"],
        link_mb_per_sec=terms["link_mb_per_sec"], link_rtt_s=terms["link_rtt_s"],
        h2d_ratio=terms["h2d_ratio"], d2h_ratio=terms["d2h_ratio"],
        eff_mb_per_sec=terms["eff_mb_per_sec"],
        eff_threshold_mb_per_sec=terms["eff_threshold_mb_per_sec"],
        rtt_threshold_s=terms["rtt_threshold_s"],
        codec=terms["codec"], margin=terms["margin"],
    )
