"""Copied from `trivy_tpu/misconf/__init__.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from trivy_tpu_torch.misconf.types import Misconfiguration, MisconfFinding

__all__ = ["Misconfiguration", "MisconfFinding"]
