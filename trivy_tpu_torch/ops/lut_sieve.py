"""The packed shift-AND (LUT) probe sieve: tiles [T, L] uint8 -> probe-hit
words [T, Pw].

The port of `trivy_tpu/ops/sieve.py` `sieve_tiles` (B6), the sieve of the
reference engine's `sieve="lut"`:

    acc[t, i] = AND_{j < J} lut[j, tiles[t, i + j]]   for i < L - J + 1,
    hits[t]   = OR_i acc[t, i],

with lut [J, 256, Pw] uint32 from `ProbeSet.build_lut` (bit p of word w:
probe 32 w + p accepts the byte at offset j; all ones past a probe's
length).  `lut_sieve` launches the hand-written CUDA kernel of
`csrc/lut_sieve.cu` for a CUDA tensor and counts the launch in
`gram_sieve.LAUNCHES["lut"]`; for a CPU tensor it runs `lut_sieve_plain`.
The kernel reads the LUT as word-major slices of 8 words (`lut_table`), the
plain version reads it as it is; `lut_consts` builds both at once as one
`LutConsts`, which `LutSieve` keeps on its device.  Words are int32 tensors
holding the uint32 bit patterns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.ops.gram_sieve import LAUNCHES, as_int32_bits

SLICE_WORDS = 8  # probe words a kernel pass keeps (`kSliceWords`)
PLAIN_ROWS = 64  # tiles the plain version sieves at once


class LutConsts(NamedTuple):
    """One LUT in both forms, int32 bit patterns on one device: `lut` [J,
    256, Pw] for the plain version and `table` [ceil(Pw / 8), J, 8, 256]
    for the kernel."""

    lut: torch.Tensor
    table: torch.Tensor


def lut_table(lut: np.ndarray) -> np.ndarray:
    """LUT [J, 256, Pw] uint32 -> the kernel's word-major slices
    [ceil(Pw / 8), J, 8, 256] uint32, words past Pw zero."""
    j, s, pw = lut.shape
    n_slices = -(-pw // SLICE_WORDS)
    padded = np.zeros((j, s, n_slices * SLICE_WORDS), dtype=np.uint32)
    padded[:, :, :pw] = lut
    table = padded.reshape(j, s, n_slices, SLICE_WORDS).transpose(2, 0, 3, 1)
    return np.ascontiguousarray(table)


def lut_consts(lut: np.ndarray, device: str | torch.device) -> LutConsts:
    """LUT [J, 256, Pw] uint32 -> its `LutConsts` on `device`."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(as_int32_bits(a).copy()).to(device)

    lut = np.asarray(lut, dtype=np.uint32)
    return LutConsts(dev(lut), dev(lut_table(lut)))


def _or_reduce(a: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over dim 1 (torch has no OR reduction): halve and OR."""
    while a.shape[1] > 1:
        half = a.shape[1] // 2
        rest = a[:, 2 * half :]
        a = a[:, :half] | a[:, half : 2 * half]
        if rest.shape[1]:
            a = torch.cat([a[:, :1] | rest, a[:, 1:]], dim=1)
    return a[:, 0]


def lut_sieve_plain(tiles: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Plain B6: the reference's J gathers and ANDs, PLAIN_ROWS tiles at a
    time so the [rows, L - J + 1, Pw] intermediate stays bounded."""
    t, length = tiles.shape
    jmax, _, pw = lut.shape
    lv = length - jmax + 1
    idx = tiles.long()
    out = torch.zeros((t, pw), dtype=torch.int32, device=tiles.device)
    for r0 in range(0, t, PLAIN_ROWS):
        rows = idx[r0 : r0 + PLAIN_ROWS]
        acc = lut[0][rows[:, :lv]]
        for j in range(1, jmax):
            acc &= lut[j][rows[:, j : j + lv]]
        out[r0 : r0 + PLAIN_ROWS] = _or_reduce(acc)
    return out


def _kernel_fn():
    from trivy_tpu_torch.ops import _build

    return _build.function("lut_sieve", "lut_sieve", "piipiipp")


def _check(tiles: torch.Tensor, consts: LutConsts) -> None:
    if tiles.dtype != torch.uint8 or tiles.dim() != 2:
        raise ValueError(f"tiles must be a 2-D uint8 tensor, got {tiles.dtype} "
                         f"{tuple(tiles.shape)}")
    lut, table = consts
    if lut.dtype != torch.int32 or lut.dim() != 3 or lut.shape[1] != 256:
        raise ValueError(f"lut must be [J, 256, Pw] int32, got {lut.dtype} "
                         f"{tuple(lut.shape)}")
    jmax, _, pw = lut.shape
    shape = (-(-pw // SLICE_WORDS), jmax, SLICE_WORDS, 256)
    if tuple(table.shape) != shape or table.dtype != torch.int32 \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous int32 tensor of shape {shape}")
    if not 1 <= jmax <= tiles.shape[1]:
        raise ValueError(f"tiles of {tiles.shape[1]} bytes are shorter than J={jmax}")
    for name, c in (("lut", lut), ("table", table)):
        if c.device != tiles.device:
            raise ValueError(f"{name} on {c.device}, tiles on {tiles.device}")


def lut_sieve(tiles: torch.Tensor, consts: LutConsts) -> torch.Tensor:
    """B6 on `tiles`' device: the CUDA kernel on a card (which reads
    `consts.table`), the plain version on the CPU (`consts.lut`)."""
    _check(tiles, consts)
    if tiles.device.type == "cpu":
        return lut_sieve_plain(tiles, consts.lut)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    tiles = tiles.contiguous()
    t, length = tiles.shape
    jmax, _, pw = consts.lut.shape
    out = torch.empty((t, pw), dtype=torch.int32, device=tiles.device)
    with torch.cuda.device(tiles.device):
        err = _kernel_fn()(
            tiles.data_ptr(), t, length, consts.table.data_ptr(), jmax, pw,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lut_sieve launch failed: cudaError {err}")
    LAUNCHES["lut"] += 1
    return out


def blocks_per_sm(jmax: int, length: int) -> int:
    """Blocks of the LUT sieve one SM of the current card holds at once."""
    from trivy_tpu_torch.ops import _build

    got = _build.function("lut_sieve", "lut_sieve_blocks_per_sm", "ii")(jmax, length)
    if got < 0:
        raise RuntimeError("occupancy query for lut_sieve failed")
    return got


class LutSieve:
    """Callable LUT sieve: tiles [T, L] uint8 -> probe-hit words [T, Pw]
    int32, over the LUT of `ProbeSet.build_lut`."""

    def __init__(self, lut: np.ndarray, device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.consts = lut_consts(lut, self.device)
        self.jmax, _, self.n_words = lut.shape

    def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
        if tiles.device != self.device:
            raise ValueError(f"tiles on {tiles.device}, sieve on {self.device}")
        return lut_sieve(tiles, self.consts)
