"""Mesh execution plane: one shared answer to "which devices, and how is
each engine tensor laid out across them", the port of `trivy_tpu/mesh/`.

`topology.py` owns mesh DISCOVERY: the single `get_mesh()` every layer
(the sieves, the derive, the verify, the gate) consults, and the per-lane
occupancy ledger.  `plan.py` owns the PARTITION PLAN: the tensor family ->
placement table (rows split over the `data` axis, constants replicate) and
the `Sharded` tensors the meshed kernels take and return.
"""

from trivy_tpu_torch.mesh import plan, topology

__all__ = ["plan", "topology"]
