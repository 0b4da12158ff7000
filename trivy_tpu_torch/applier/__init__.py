"""Copied from `trivy_tpu/applier/__init__.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from trivy_tpu_torch.applier.apply import Applier, apply_layers

__all__ = ["Applier", "apply_layers"]
