"""`make_sharded_megakernel` of the port against its unsharded megakernel and
against the JAX package's meshed megakernel on the virtual CPU devices.

Tolerance: exact (bits and integer counts).  Each shard counts its rows
against global row ids (`base` = shard index x rows per shard) and the int32
partials are summed before the epilogue thresholds them, so the mask is
byte-identical to the one-call K3 at every shard count.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_megakernel import ROWS, batch_inputs, mega_kwargs, port_mega, torch_inputs
from trivy_tpu.mesh import topology as mesh_topology
from trivy_tpu.ops import megakernel as ref_mega
from trivy_tpu_torch.compiled import CompiledRules
from trivy_tpu_torch.ops import megakernel as mk
from trivy_tpu_torch.rules.model import build_ruleset

SHARDS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def compiled():
    return CompiledRules.build(build_ruleset(None))


@pytest.fixture
def fresh_mesh():
    mesh_topology.clear_cache()
    yield mesh_topology.get_mesh
    mesh_topology.clear_cache()


@pytest.mark.parametrize("mode", ["off", "4", "6"])
def test_split_equals_unsharded_at_every_shard_count(compiled, mode):
    """1, 2, 4 and 8 shards on the CPU (one device repeated) give K3's mask,
    and the shards' K4 counts sum to the unsharded counts."""
    codec, mega = port_mega(compiled, mode)
    _, coded, lo, hi, valid = batch_inputs(codec)
    tc, tlo, thi, tvalid, tbase = torch_inputs(coded, lo, hi, valid,
                                               np.zeros((1, 1), np.int32))
    want = mega(tc, tlo, thi, tvalid)
    want_acc = mega.acc(tc, tlo, thi, tbase)
    assert want.any()
    for n in SHARDS:
        got = mk.make_sharded_megakernel(["cpu"] * n, mega)(tc, tlo, thi, tvalid)
        assert torch.equal(got, want), n
        per = ROWS // n
        parts = [
            mega.acc(tc[i * per : (i + 1) * per], tlo, thi,
                     torch.full((1, 1), i * per, dtype=torch.int32))
            for i in range(n)
        ]
        assert torch.equal(sum(parts), want_acc), n
        if n > 1:
            # a shard alone sees only its rows: thresholding it would differ
            assert not torch.equal(parts[0], want_acc)
    with pytest.raises(ValueError, match="shards"):
        mk.make_sharded_megakernel(["cpu"] * 3, mega)(tc, tlo, thi, tvalid)


@pytest.mark.parametrize("n", SHARDS)
def test_split_equals_reference_meshed_megakernel(compiled, fresh_mesh, n):
    """Codec off: the port's split equals the reference
    `make_sharded_megakernel` over an n-device mesh (interpret mode; the
    reference blocks its shards in 8-row blocks so 64 rows split 8 ways)."""
    _, mega = port_mega(compiled, "off")
    _, coded, lo, hi, valid = batch_inputs(None)
    ref = ref_mega.MegaGramSieve(compiled.masks, compiled.vals,
                                 **mega_kwargs(compiled), block_rows=8,
                                 interpret=True)
    mesh = fresh_mesh(override=str(n))
    if mesh is None:  # the topology gives no mesh for one device
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    with jax.set_mesh(mesh):
        want = np.asarray(ref_mega.make_sharded_megakernel(mesh, ref)(
            coded, lo, hi, valid))
    got = mk.make_sharded_megakernel(["cpu"] * n, mega)(
        *torch_inputs(coded, lo, hi, valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
