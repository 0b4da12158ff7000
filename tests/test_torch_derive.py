"""The port's on-device candidate derive (`GpuSecretEngine.derive`) against the
reference staged fused engine's jitted `_derive_fn` on random hit words.

Inputs cover files that span several rows, empty files (hi = lo - 1) and
padded files (hi = -1 < lo = 0), in raw and class-space gram order.
Tolerance: exact (the [Fp, R] uint8 candidate lanes are equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trivy_tpu.engine.device import TpuSecretEngine
from trivy_tpu_torch.engine.device import GpuSecretEngine

_ENGINES: dict = {}


def _engines(mode: str, monkeypatch):
    if mode not in _ENGINES:
        monkeypatch.setenv("TRIVY_TPU_LINK_CODEC", mode)
        ref = TpuSecretEngine(kernel="pallas", fused=True, megakernel=False)
        port = GpuSecretEngine(device="cpu")
        _ENGINES[mode] = (ref, port)
    return _ENGINES[mode]


def _intervals(rng, t: int, fp: int, f: int):
    """Row ranges for f real files packed in order (some empty), then
    fp - f padded files."""
    lo = np.zeros(fp, np.int32)
    hi = np.full(fp, -1, np.int32)
    row = 0
    for i in range(f):
        span = 0 if i % 7 == 3 else int(rng.integers(1, 9))  # 0: empty file
        lo[i] = row
        hi[i] = min(row + span, t) - 1
        row = max(row, hi[i])  # the next file may share the seam row
    return lo, hi, hi >= lo


@pytest.mark.parametrize("density", [0.002, 0.02, 0.3])
@pytest.mark.parametrize("mode", ["off", "auto"])
def test_derive_matches_reference(mode, density, monkeypatch):
    ref, port = _engines(mode, monkeypatch)
    n_words = port._pallas_obj.n_words
    assert n_words == ref._pallas_obj.n_words
    np.testing.assert_array_equal(port._pallas_obj.gram_expand, ref._pallas_obj.gram_expand)
    rng = np.random.default_rng(int(density * 1000) + len(mode))
    t, fp, f = 128, 32, 27
    bits = rng.random((t, n_words * 32)) < density
    words = (bits.reshape(t, n_words, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    lo, hi, valid = _intervals(rng, t, fp, f)
    assert (~valid[:f]).any() and (hi[:f] - lo[:f] >= 2).any()

    want = np.asarray(ref._derive_fn()(
        jnp.asarray(words), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(valid)))
    got = port.derive(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(lo),
        torch.from_numpy(hi), torch.from_numpy(valid))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[f:].any(), "padded files derive no candidates"
    if density >= 0.02:
        assert want.any()
