"""The port's link codec (trivy_tpu_torch/engine/link.py) against the JAX
package's: the torch `unpack` against `LinkCodec.make_unpack`, and the torch
`fetch_rows_compact` against the jitted one, on both sides of its
`MIN_COMPACT_ROWS` and `COMPACT_MAX_FRAC` thresholds.  Tolerance: exact
(byte-identical arrays and byte counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trivy_tpu.engine import link as ref_link
from trivy_tpu_torch.compiled import CompiledRules
from trivy_tpu_torch.engine import link
from trivy_tpu_torch.rules.model import build_ruleset


@pytest.fixture(scope="module")
def compiled():
    return CompiledRules.build(build_ruleset(None))


@pytest.mark.parametrize("length", [512, 131, 6])
@pytest.mark.parametrize("mode", ["4", "6", "auto"])
def test_unpack_round_trips_against_reference(compiled, mode, length):
    codec = link.select_codec(link.derive_alphabet(compiled), mode, compiled)
    ref = ref_link.select_codec(ref_link.derive_alphabet(compiled), mode, compiled)
    assert (codec.sym_bits, codec.exact, codec.num_classes) == (
        ref.sym_bits, ref.exact, ref.num_classes)
    rng = np.random.default_rng(length)
    rows = rng.integers(0, 256, size=(9, length), dtype=np.uint8)
    coded = codec.encode_rows(rows)
    np.testing.assert_array_equal(coded, ref.encode_rows(rows))
    assert coded.shape == (9, codec.coded_len(length))
    got = codec.unpack(torch.from_numpy(coded), length)
    want = np.asarray(ref.make_unpack(length)(jnp.asarray(coded)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codec.class_map[rows])


@pytest.mark.parametrize("mode", ["off", "auto", "4", "6", "bogus"])
def test_codec_mode_and_selection_match_reference(compiled, mode, monkeypatch):
    monkeypatch.setenv("TRIVY_TPU_LINK_CODEC", mode)
    assert link.codec_mode() == ref_link.codec_mode()
    alpha = link.derive_alphabet(compiled)
    ref_alpha = ref_link.derive_alphabet(compiled)
    np.testing.assert_array_equal(alpha.values, ref_alpha.values)
    np.testing.assert_array_equal(alpha.class_map, ref_alpha.class_map)
    got = link.select_codec(alpha, link.codec_mode(), compiled)
    want = ref_link.select_codec(ref_alpha, ref_link.codec_mode(), compiled)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.sym_bits == want.sym_bits and got.exact == want.exact
        np.testing.assert_array_equal(got.class_map, want.class_map)


def _result(t: int, nonzero_rows: int, width: int = 11, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.zeros((t, width), np.uint8)
    idx = rng.choice(t, size=nonzero_rows, replace=False)
    out[idx] = rng.integers(1, 256, size=(nonzero_rows, width), dtype=np.uint8)
    return out


@pytest.mark.parametrize(
    "t,nonzero",
    [
        (link.MIN_COMPACT_ROWS - 1, 5),  # below MIN_COMPACT_ROWS: full fetch
        (link.MIN_COMPACT_ROWS, 0),  # all-zero: bitmap only
        (link.MIN_COMPACT_ROWS, 16),  # exactly COMPACT_MAX_FRAC: gathered
        (link.MIN_COMPACT_ROWS, 17),  # just over: dense, full fetch
        (1000, 3),  # sparse, index padded to a power of two
        (1003, 251),  # sparse, T not a multiple of 8
    ],
)
def test_fetch_rows_compact_matches_reference(t, nonzero):
    assert link.MIN_COMPACT_ROWS == ref_link.MIN_COMPACT_ROWS
    assert link.COMPACT_MAX_FRAC == ref_link.COMPACT_MAX_FRAC
    host = _result(t, nonzero, seed=t + nonzero)
    got, raw, moved = link.fetch_rows_compact(torch.from_numpy(host))
    want, ref_raw, ref_moved = ref_link.fetch_rows_compact(jnp.asarray(host))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    assert got.dtype == want.dtype
    assert (raw, moved) == (ref_raw, ref_moved)


def test_fetch_rows_compact_int32_rows():
    """Byte accounting follows the element size, as for hit words."""
    host = _result(200, 7).astype(np.int32) * 1000
    got, raw, moved = link.fetch_rows_compact(torch.from_numpy(host))
    want, ref_raw, ref_moved = ref_link.fetch_rows_compact(jnp.asarray(host))
    np.testing.assert_array_equal(got, want)
    assert (raw, moved) == (ref_raw, ref_moved)
