"""The partition plan: engine tensor family -> placement over the mesh.

The port of `trivy_tpu/mesh/plan.py`: one table answers "how does this
tensor lie across the mesh" for every family the device path moves.  The
families and their templates are the reference's (its `plan_table` JSON is
byte-equal to this one's):

  coded_rows     [T, L] packed content tiles / class-id rows: split the row
                 axis; a tile never spans lanes, so the sieve needs no
                 exchange between them.
  hit_bitmaps    [T, Pw] sieve output: the same row split as its input.
  lane_tables    [N] per-lane dispatch vectors of the fused verify: split
                 the lane axis.
  stream_bytes   [rows, pipe, G, block] verify stream bytes: split the
                 group axis (the port's stream rows are [G * 64, L], so its
                 groups are contiguous runs of 64 rows).
  padded_classes [L, G, Bg] padded-path class tensors: split the group
                 axis (the port's are [G, Bg, L]).
  vstack_rules   stacked per-rule NFA tensors: replicate.
  gram_constants sieve masks/vals: replicate.
  probe_constants LUT/probe tables: replicate.
  mega_rowfile   [Fp, Dg] megakernel partial per-file gram counts: each
                 row shard's counts, summed before any threshold
                 (ops/megakernel.make_sharded_megakernel).

Where the reference builds a `NamedSharding`, the port builds a
`Placement` (`sharding_for`): the tensor axis to split, or "replicate".
A split tensor is a `Sharded`: its shards in lane order, each on its
lane's device, which `gather` joins back in index order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from trivy_tpu_torch.mesh.topology import DATA_AXIS

# family -> spec template, the reference's; DATA_AXIS marks the split axis.
PLAN: dict[str, tuple[Any, ...]] = {
    "coded_rows": (DATA_AXIS, None),
    "hit_bitmaps": (DATA_AXIS, None),
    "lane_tables": (DATA_AXIS,),
    "stream_bytes": (None, None, DATA_AXIS, None),
    "padded_classes": (None, DATA_AXIS, None),
    "vstack_rules": (),
    "gram_constants": (),
    "probe_constants": (),
    "mega_rowfile": (DATA_AXIS, None),
}

CONSTANT_FAMILIES = frozenset(
    {"vstack_rules", "gram_constants", "probe_constants"}
)

# The axis the port's own tensor of a family splits on, where its layout
# differs from the reference's template (stream rows are [G * 64, L],
# padded classes [G, Bg, L]: the group axis leads).
_PORT_AXIS = {"stream_bytes": 0, "padded_classes": 0}


def spec_for(family: str, mesh=None) -> tuple[int, ...]:
    """The split axis of `family`'s port tensor as a 1-tuple, or () for a
    replicated family; an unknown family raises KeyError."""
    template = PLAN[family]
    if DATA_AXIS not in template:
        return ()
    return (_PORT_AXIS.get(family, template.index(DATA_AXIS)),)


def lane_bounds(size: int, lanes: int) -> list[tuple[int, int]] | None:
    """[(lo, hi)] of an axis of `size` cut into `lanes` equal contiguous
    shards, lane i's the i-th; None when `size` does not split evenly."""
    if size % lanes:
        return None
    per = size // lanes
    return [(i * per, (i + 1) * per) for i in range(lanes)]


@dataclass(frozen=True)
class Placement:
    """How one family lies on `mesh`: split along `axis`, or replicated
    (`axis` None) once per distinct device."""

    mesh: Any
    family: str
    axis: int | None

    @property
    def replicated(self) -> bool:
        return self.axis is None

    def split(self, t: torch.Tensor) -> Sharded:
        """`t` cut into equal contiguous shards along `axis`, shard i on
        lane i's device."""
        if self.axis is None:
            raise ValueError(f"{self.family} is replicated, not split")
        n = self.mesh.size
        size = t.shape[self.axis]
        bounds = lane_bounds(size, n)
        if bounds is None:
            raise ValueError(f"{self.family}: {size} does not split into {n} equal shards")
        return Sharded(
            tuple(t.narrow(self.axis, lo, hi - lo).to(d)
                  for (lo, hi), d in zip(bounds, self.mesh.devices)),
            self.axis, self.mesh.tags,
        )

    def replicate(self, make) -> dict[torch.device, Any]:
        """{device: make(device)} for each distinct device of the mesh."""
        return {d: make(d) for d in self.mesh.distinct_devices()}


def sharding_for(mesh, family: str) -> Placement | None:
    """The `Placement` of `family` on `mesh` (None mesh -> None: the
    unmeshed path passes plain tensors)."""
    if mesh is None:
        return None
    spec = spec_for(family, mesh)
    return Placement(mesh, family, spec[0] if spec else None)


class Sharded:
    """A tensor split along `axis` into `shards`, one per lane in lane order
    (shard i on lane i's device, tagged `tags[i]`)."""

    def __init__(self, shards, axis: int = 0, tags=()):
        self.shards = tuple(shards)
        self.axis = axis
        self.tags = tuple(tags) or tuple(str(s.device) for s in self.shards)

    @property
    def shape(self) -> tuple[int, ...]:
        s = list(self.shards[0].shape)
        s[self.axis] = sum(int(p.shape[self.axis]) for p in self.shards)
        return tuple(s)

    @property
    def device(self) -> torch.device:
        """The first lane's device."""
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.shards)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (default the first lane's), shards
        joined in index order."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in self.shards], dim=self.axis)

    def numpy(self) -> np.ndarray:
        """Host copy: each lane ships only its own shard, joined in index
        order (the reference's `_demux_shards`)."""
        return np.concatenate([p.cpu().numpy() for p in self.shards], axis=self.axis)


def plan_table(mesh=None) -> dict[str, dict[str, Any]]:
    """JSON-able plan (the reference's `GET /debug/mesh` table): family ->
    spec + role."""
    return {
        family: {"spec": list(template), "replicated": family in CONSTANT_FAMILIES}
        for family, template in PLAN.items()
    }
