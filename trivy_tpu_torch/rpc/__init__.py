"""Copied from `trivy_tpu/rpc/__init__.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

