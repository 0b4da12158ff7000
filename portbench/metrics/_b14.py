"""The license similarity product B14 (`license/classifier.py` `_matmul`):
`[F, D] x [D, L]` in float32, F candidate texts a call, D histogram buckets,
L corpus texts; its operations, its bytes and the least time an H100 takes
for them (NVIDIA's data sheet, SXM: 3.35 TB/s of HBM, 67 TFLOP/s float32
outside the tensor cores, at the 700 W limit)."""

from portbench.reference.license_scan import DIM, corpus

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def corpus_size() -> int:
    return len(corpus())


def flops(rows: float, texts: int) -> float:
    """2 D L a row: one multiply and one add per bucket and corpus text."""
    return 2.0 * DIM * texts * rows


def bytes_moved(rows: float, calls: float, texts: int) -> float:
    """Each input read once and the output written once, float32: the
    fingerprints (D a row), the corpus matrix (L D a call), the scores (L a
    row)."""
    return 4.0 * (DIM * rows + calls * texts * DIM + texts * rows)


def bound_s(rows: float, calls: float, texts: int) -> float:
    """The larger of the bytes at HBM speed and the operations at the float32
    peak."""
    return max(bytes_moved(rows, calls, texts) / HBM_BYTES_PER_S,
               flops(rows, texts) / FP32_FLOPS)
