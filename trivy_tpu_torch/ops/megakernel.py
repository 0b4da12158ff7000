"""The megakernel: packed link bytes -> per-file gram counts -> verdict bits.

The port of `trivy_tpu/ops/megakernel.py`.  Where the staged path
(`engine/device.py`) unpacks, sieves and derives in separate steps with the
hit words in device memory between them, this module runs the whole chain in
one call whose only output is the packed verdict mask:

* **K3**, `MegaGramSieve.__call__` (the twin of `_invoke(emit="mask")`):
  coded rows [T, Cc] uint8, lo/hi [1, Fp] int32 inclusive file row ranges
  (hi < lo marks padding and empty files), valid [Fp, 1] int8 -> mask
  [Fp, ceil(R/8)] uint8, MSB-first (np.packbits order).  Per row it unpacks
  the link codec, runs the bitplane sieve's semantics (K1: whole-byte pair
  tests, row-tail wrap, case fold of raw bytes only), adds the row's
  distinct-pair hits into the counts of every file whose range holds it, and
  once every row is counted derives the verdicts (`derive_counts_to_mask`).
* **K4**, `MegaGramSieve.acc` (the twin of `_invoke(emit="acc")`): K3
  stopped at the [Fp, D] int32 counts, row ids offset by `base` [1, 1], the
  shard's global row offset.
* `MegaGramSieve.epilogue`: derive + pack alone, after `make_sharded_megakernel`
  has summed the shards' counts.  Counts add across shards and booleans do
  not (a file's two windows may land in different shards), so no partial
  count is ever thresholded.

Each launches the hand-written kernels of `csrc/megakernel.cu` for CUDA
tensors and counts the launch in `gram_sieve.LAUNCHES` ("mega", "mega_acc",
"mega_epilogue"); for CPU tensors it runs the plain PyTorch version beside it
(`megakernel_plain`, `megakernel_acc_plain`, `derive_counts_to_mask_plain`,
`pack_mask_bits_plain`).  Everything is integer arithmetic: counts are exact
sums (int32 atomics on the card, int64 in the plain version).  The plain
derive sums every int8 x int8 product exactly; the kernel reads the 0/1
derive constants packed as bit rows (`pack_derive_bits`) and takes each
product sum as the popcount of an AND, which is the same integer, so both
equal the TPU kernel's int8 MXU arithmetic bit for bit.  The kernels read
the pairs as a pair-set table (`gram_sieve.sieve_table`).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.engine.link import unpack_symbols
from trivy_tpu_torch.mesh.plan import Sharded, sharding_for
from trivy_tpu_torch.mesh.topology import Mesh
from trivy_tpu_torch.ops.gram_sieve import (
    DEFAULT_BLOCK_ROWS,
    LAUNCHES,
    as_int32_bits,
    byte_test_constants,
    dedupe_grams,
    gram_sieve_bitplane_plain,
    sieve_table,
)

# Files per single-call batch, kept from the reference so that both engines
# take the same path on the same batch.  On the card it is an envelope
# choice, not a memory limit: the [Fp, D] int32 counts live in device memory
# ([2048, <= 256] is <= 2 MB against a 50 MB L2), and the count kernel lists a
# row's files in 4 bytes of shared memory per file.  Raising it is a later,
# measured change.
MEGA_MAX_FILES = 2048

# (name in csrc/megakernel.cu, ctypes argument kinds): p = pointer, i = int.
_SIGNATURES = {
    "mega_count": "piiiipppipipp",
    "mega_epilogue": "ppiipipipppippipipp",
    "mega_mask": "piiiipppipippipipppippipipp",
}


def _kernel_fn(name: str):
    from trivy_tpu_torch.ops import _build

    return _build.function("megakernel", name, _SIGNATURES[name])


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors, tests, and the on-card comparison)
# ---------------------------------------------------------------------------


def _idot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[F, M] 0/1 x [M, N] int8 -> [F, N] int64, summed exactly (in file
    chunks of at most 2^24 products)."""
    b = b.to(torch.int64)
    step = max(1, (1 << 24) // max(1, b.numel()))
    parts = [
        (a[i : i + step, :, None].to(torch.int64) * b[None]).sum(dim=1)
        for i in range(0, len(a), step)
    ]
    if not parts:
        return torch.zeros((0, b.shape[1]), dtype=torch.int64, device=a.device)
    return torch.cat(parts)


def derive_counts_to_mask_plain(acc, valid_col, dw, pm, pw, ng, gm, ga, cm, ca,
                                k: int) -> torch.Tensor:
    """Per-file gram counts -> candidate booleans, the twin of
    `derive_counts_to_mask`: acc [Fp, D] counts, valid_col [Fp, 1] int8,
    dw [D, W], pm [W, P], pw [1, P] int32, ng [1, P], gm [P, R], ga [1, R],
    cm [P, R*K] (conjunct k of rule r at column r*K + k), ca [K, R] ->
    [Fp, R] bool."""
    valid = valid_col > 0
    gh = (acc > 0) & valid
    win = _idot(gh, dw) > 0
    ph = (_idot(win, pm) >= pw) | (ng > 0)
    gate_ok = (ga == 0) | (_idot(ph, gm) > 0)
    cj = _idot(ph, cm)
    conj_ok = torch.ones_like(gate_ok)
    for kk in range(k):
        conj_ok &= (ca[kk : kk + 1] == 0) | (cj[:, kk::k] > 0)
    return gate_ok & conj_ok & valid


def pack_bit_rows(a: np.ndarray) -> np.ndarray:
    """0/1 matrix [M, N] -> its columns as bit rows [N, ceil(M/32)] uint32:
    bit i % 32 of word [j, i // 32] is a[i, j]."""
    m, n = a.shape
    words = max(1, -(-m // 32))
    bits = np.zeros((n, words * 32), dtype=bool)
    bits[:, :m] = np.asarray(a).T != 0
    return np.packbits(bits, axis=1, bitorder="little").view("<u4").astype(np.uint32)


def pack_derive_bits(dw, pm, gm, cm) -> dict[str, np.ndarray]:
    """The 0/1 derive constants as the epilogue kernel reads them: dw [D, W]
    -> [W][ceil(D/32)], pm [W, P] -> [P][ceil(W/32)], gm [P, R] ->
    [R][ceil(P/32)], cm [P, R*K] -> [R*K][ceil(P/32)] (row r*K + k is
    conjunct k of rule r)."""
    return {"dwb": pack_bit_rows(dw), "pmb": pack_bit_rows(pm),
            "gmb": pack_bit_rows(gm), "cmb": pack_bit_rows(cm)}


_PACK_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_mask_bits_plain(cand: torch.Tensor) -> torch.Tensor:
    """[Fp, R] bool -> [Fp, ceil(R/8)] uint8, MSB-first within each byte."""
    fp, r = cand.shape
    rb = -(-r // 8)
    c = torch.zeros((fp, rb * 8), dtype=torch.int32, device=cand.device)
    c[:, :r] = cand.to(torch.int32)
    w = torch.tensor(_PACK_WEIGHTS, dtype=torch.int32, device=cand.device)
    return (c.reshape(fp, rb, 8) * w).sum(dim=-1).to(torch.uint8)


def megakernel_acc_plain(mega: "MegaGramSieve", coded, lo, hi, base) -> torch.Tensor:
    """Plain K4: per-file distinct-pair counts [Fp, D] int32 of the rows
    [base, base + T), summed exactly in int64."""
    c = mega._consts(coded.device)
    rows = unpack_symbols(coded, mega.sym_bits, mega.row_len)
    words = gram_sieve_bitplane_plain(rows, c["bmasks"], c["bvals"], mega.n_words)
    t = rows.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=coded.device)
    bits = ((words.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(t, -1)
    csum = torch.cat([
        torch.zeros((1, mega.num_distinct), dtype=torch.int64, device=coded.device),
        torch.cumsum(bits[:, : mega.num_distinct], dim=0),
    ])
    b = base.reshape(()).to(torch.int64)
    first = (lo.reshape(-1).to(torch.int64) - b).clamp(0, t)
    stop = (hi.reshape(-1).to(torch.int64) - b + 1).clamp(0, t)
    return (csum[stop] - csum[first]).clamp(min=0).to(torch.int32)


def megakernel_plain(mega: "MegaGramSieve", coded, lo, hi, valid) -> torch.Tensor:
    """Plain K3: counts over every row, then derive and pack."""
    zero = torch.zeros((1, 1), dtype=torch.int32, device=coded.device)
    return mega.epilogue_plain(megakernel_acc_plain(mega, coded, lo, hi, zero), valid)


# ---------------------------------------------------------------------------
# The sieve object and its kernel wrappers
# ---------------------------------------------------------------------------


class MegaGramSieve:
    """The fused unpack -> sieve -> count -> derive -> verdict call.

    Built from the same material as the reference's `MegaGramSieve`, it bakes
    the same constants (`_dw` with `gram_expand` folded in, `_pm`, `_pw`,
    `_ng`, `_gm`, `_ga`, `_cm`, `_ca`) and the same `kernel_id`, so the two
    ids are equal for the same ruleset and codec.  `device` (default "cuda")
    is where the constants live first; calls take tensors on any CPU or CUDA
    device and keep one copy of the constants per device.
    """

    def __init__(
        self,
        masks: np.ndarray,
        vals: np.ndarray,
        *,
        wmember: np.ndarray,
        pmember: np.ndarray,
        pwindows: np.ndarray,
        probe_has_gram: np.ndarray,
        gate_member: np.ndarray,
        gate_any: np.ndarray,
        conj_member: np.ndarray,
        conj_any: np.ndarray,
        num_conjuncts: int,
        row_len: int,
        sym_bits: int | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        if row_len < 256 or row_len & (row_len - 1):
            raise ValueError(
                f"megakernel row length must be a power of two >= 256, "
                f"got {row_len}"
            )
        if sym_bits not in (None, 4, 6):
            raise ValueError(f"unsupported codec width: {sym_bits}")
        masks = np.asarray(masks, dtype=np.uint32)
        vals = np.asarray(vals, dtype=np.uint32)
        dmasks, dvals, self.gram_expand = dedupe_grams(masks, vals)
        self.num_distinct = len(dmasks)
        if self.num_distinct == 0:
            raise ValueError("megakernel needs at least one gram")
        self.device = resolve_device(device)
        self.row_len = row_len
        self.sym_bits = sym_bits
        self.coded_cols = (
            row_len if sym_bits is None
            else row_len // 2 if sym_bits == 4
            else row_len // 4 * 3
        )
        self.block_rows = DEFAULT_BLOCK_ROWS
        self.n_words = max(1, -(-self.num_distinct // 32))

        # Derive constants, int8/int32, built as the reference builds them.
        # gram_expand folds into the window membership so the distinct-pair
        # counts map straight to windows (an OR over duplicate grams is exact
        # because the window threshold is count > 0).
        g, w = np.asarray(wmember).shape
        dw = np.zeros((self.num_distinct, max(w, 1)), np.int8)
        for gi in range(g):
            di = int(self.gram_expand[gi]) if len(self.gram_expand) else gi
            np.maximum(dw[di], wmember[gi].astype(np.int8), out=dw[di])
        p = np.asarray(pmember).shape[1]
        r = np.asarray(gate_member).shape[1]
        k = max(int(num_conjuncts), 1)
        self._dw = dw
        self._pm = np.asarray(pmember).astype(np.int8)
        self._pw = np.asarray(pwindows).astype(np.int32).reshape(1, p)
        self._ng = (~np.asarray(probe_has_gram)).astype(np.int8).reshape(1, p)
        self._gm = np.asarray(gate_member).astype(np.int8)
        self._ga = np.asarray(gate_any).astype(np.int8).reshape(1, r)
        cm = np.asarray(conj_member)
        if cm.size:
            self._cm = cm.astype(np.int8)
            self._ca = np.ascontiguousarray(
                np.asarray(conj_any).astype(np.int8).T
            )  # [K, R]
        else:
            self._cm = np.zeros((p, r * k), np.int8)
            self._ca = np.zeros((k, r), np.int8)
        self._k = k
        self.num_rules = r
        self.mask_bytes = -(-r // 8)
        # The epilogue kernel takes each int8 dot as the popcount of an AND,
        # which is exact only for 0/1 membership matrices.
        for name, a in (("wmember", self._dw), ("pmember", self._pm),
                        ("gate_member", self._gm), ("conj_member", self._cm)):
            if not np.isin(a, (0, 1)).all():
                raise ValueError(f"{name} must hold only 0 and 1")

        h = hashlib.blake2b(digest_size=8)
        h.update(b"mega1")
        h.update(np.uint32(row_len).tobytes())
        h.update(np.int32(-1 if sym_bits is None else sym_bits).tobytes())
        h.update(np.uint32(self.block_rows).tobytes())
        for arr in (
            dmasks, dvals, self._dw, self._pm, self._pw, self._ng,
            self._gm, self._ga, self._cm, self._ca,
        ):
            h.update(np.ascontiguousarray(arr).tobytes())
        self.kernel_id = h.hexdigest()

        # The kernels read whole-byte pairs, as K1 does, as a pair-set table
        # over the symbols the unpack yields, and the derive constants as
        # bit rows.
        self._bmasks, self._bvals = byte_test_constants(dmasks, dvals)
        self.table_symbols = 256 if sym_bits is None else 1 << sym_bits
        self._table = sieve_table(self._bmasks, self._bvals, self.n_words,
                                  self.table_symbols)
        self._bits = pack_derive_bits(self._dw, self._pm, self._gm, self._cm)
        self._dev: dict[torch.device, dict[str, torch.Tensor]] = {}
        self._consts(self.device)

    def _consts(self, device: torch.device) -> dict[str, torch.Tensor]:
        """The constants as tensors on `device`, made once per device."""
        if device not in self._dev:
            def t(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)

            self._dev[device] = {
                "bmasks": t(as_int32_bits(self._bmasks)),
                "bvals": t(as_int32_bits(self._bvals)),
                "table": t(as_int32_bits(self._table)),
                "dw": t(self._dw), "pm": t(self._pm), "pw": t(self._pw),
                "ng": t(self._ng), "gm": t(self._gm), "ga": t(self._ga),
                "cm": t(self._cm), "ca": t(self._ca),
                **{n: t(as_int32_bits(a)) for n, a in self._bits.items()},
            }
        return self._dev[device]

    def _derive_consts(self, device: torch.device) -> list[torch.Tensor]:
        c = self._consts(device)
        return [c[n] for n in ("dw", "pm", "pw", "ng", "gm", "ga", "cm", "ca")]

    def _epilogue_args(self, device: torch.device) -> list[int]:
        """The epilogue's constant arguments after (acc, valid, fp, d)."""
        c = self._consts(device)
        return [
            c["dwb"].data_ptr(), self._dw.shape[1], c["pmb"].data_ptr(),
            self._pm.shape[1], c["pw"].data_ptr(), c["ng"].data_ptr(),
            c["gmb"].data_ptr(), self.num_rules, c["ga"].data_ptr(),
            c["cmb"].data_ptr(), self._k, c["ca"].data_ptr(), self.mask_bytes,
        ]

    # -- input checks --------------------------------------------------------

    @staticmethod
    def _want(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
              device: torch.device) -> None:
        if (x.dtype != dtype or tuple(x.shape) != shape or x.device != device
                or not x.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape {shape} "
                f"on {device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )

    def _check_rows(self, coded, lo, hi) -> int:
        if coded.dim() != 2 or coded.shape[1] != self.coded_cols:
            raise ValueError(
                f"coded rows must be [T, {self.coded_cols}], got "
                f"{tuple(coded.shape)}"
            )
        if coded.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {coded.device}")
        self._want("coded", coded, torch.uint8, tuple(coded.shape), coded.device)
        if coded.device.type == "cuda" and coded.data_ptr() % 16:
            # the kernel loads 16 symbols a lane with aligned vector loads
            raise ValueError("coded rows must start 16-byte aligned")
        if lo.dim() != 2:
            raise ValueError(f"lo must be [1, Fp], got {tuple(lo.shape)}")
        fp = lo.shape[1]
        self._want("lo", lo, torch.int32, (1, fp), coded.device)
        self._want("hi", hi, torch.int32, (1, fp), coded.device)
        return fp

    # -- K3, K4 and the epilogue ---------------------------------------------

    def __call__(self, coded, lo, hi, valid) -> torch.Tensor:
        """K3: coded rows -> packed verdict mask [Fp, mask_bytes] uint8."""
        fp = self._check_rows(coded, lo, hi)
        self._want("valid", valid, torch.int8, (fp, 1), coded.device)
        if coded.device.type == "cpu":
            return megakernel_plain(self, coded, lo, hi, valid)
        table = self._consts(coded.device)["table"]
        acc = torch.zeros((fp, self.num_distinct), dtype=torch.int32,
                          device=coded.device)
        out = torch.empty((fp, self.mask_bytes), dtype=torch.uint8,
                          device=coded.device)
        with torch.cuda.device(coded.device):
            err = _kernel_fn("mega_mask")(
                coded.data_ptr(), coded.shape[0], self.coded_cols, self.row_len,
                self.sym_bits or 0, lo.data_ptr(), hi.data_ptr(),
                valid.data_ptr(), fp, table.data_ptr(), self.num_distinct,
                acc.data_ptr(),
                *self._epilogue_args(coded.device), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"mega_mask launch failed: cudaError {err}")
        LAUNCHES["mega"] += 1
        return out

    def acc(self, coded, lo, hi, base) -> torch.Tensor:
        """K4: the per-file distinct-pair counts [Fp, D] int32 of these rows,
        whose global row ids start at `base` [1, 1] int32."""
        fp = self._check_rows(coded, lo, hi)
        self._want("base", base, torch.int32, (1, 1), coded.device)
        if coded.device.type == "cpu":
            return megakernel_acc_plain(self, coded, lo, hi, base)
        table = self._consts(coded.device)["table"]
        # zeros, not empty: the kernel adds into it
        acc = torch.zeros((fp, self.num_distinct), dtype=torch.int32,
                          device=coded.device)
        with torch.cuda.device(coded.device):
            err = _kernel_fn("mega_count")(
                coded.data_ptr(), coded.shape[0], self.coded_cols, self.row_len,
                self.sym_bits or 0, lo.data_ptr(), hi.data_ptr(),
                base.data_ptr(), fp, table.data_ptr(), self.num_distinct,
                acc.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"mega_count launch failed: cudaError {err}")
        LAUNCHES["mega_acc"] += 1
        return acc

    def epilogue_plain(self, acc, valid) -> torch.Tensor:
        cand = derive_counts_to_mask_plain(
            acc, valid, *self._derive_consts(acc.device), self._k
        )
        return pack_mask_bits_plain(cand)

    def epilogue(self, acc, valid) -> torch.Tensor:
        """Final counts [Fp, D] int32 -> packed verdict mask (derive + pack)."""
        if acc.dim() != 2:
            raise ValueError(f"acc must be [Fp, D], got {tuple(acc.shape)}")
        fp = acc.shape[0]
        if acc.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {acc.device}")
        self._want("acc", acc, torch.int32, (fp, self.num_distinct), acc.device)
        self._want("valid", valid, torch.int8, (fp, 1), acc.device)
        if acc.device.type == "cpu":
            return self.epilogue_plain(acc, valid)
        out = torch.empty((fp, self.mask_bytes), dtype=torch.uint8,
                          device=acc.device)
        with torch.cuda.device(acc.device):
            err = _kernel_fn("mega_epilogue")(
                acc.data_ptr(), valid.data_ptr(), fp, self.num_distinct,
                *self._epilogue_args(acc.device), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"mega_epilogue launch failed: cudaError {err}")
        LAUNCHES["mega_epilogue"] += 1
        return out


def make_sharded_megakernel(devices, mega: MegaGramSieve):
    """The megakernel over `len(devices)` equal row shards, the twin of the
    reference's meshed megakernel: shard i runs K4 on its rows with `base` =
    its first global row, the int32 partial counts are summed on
    `devices[0]` BEFORE any threshold, and the epilogue runs there.  The mask
    is byte-identical to the unsharded K3's at every shard count.  `devices`
    (a `Mesh` or a device list) may repeat one device (a split on one card);
    `coded` may be a tensor, split here, or a `Sharded` staged lane by lane."""
    mesh = devices if isinstance(devices, Mesh) else Mesh(devices)
    place = sharding_for(mesh, "coded_rows")
    devs = mesh.devices

    def fused(coded, lo, hi, valid):
        if not isinstance(coded, Sharded):
            coded = place.split(coded)
        parts = list(coded.shards)
        if len(parts) != len(devs):
            raise ValueError(f"{len(parts)} shards for {len(devs)} devices")
        total = None
        start = 0
        for part, dev in zip(parts, devs):
            base = torch.full((1, 1), start, dtype=torch.int32, device=dev)
            acc = mega.acc(part.contiguous(), lo.to(dev), hi.to(dev), base).to(devs[0])
            total = acc if total is None else total + acc
            start += part.shape[0]
        return mega.epilogue(total, valid.to(devs[0]))

    return fused
