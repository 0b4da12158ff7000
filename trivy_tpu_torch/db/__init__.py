"""The vulnerability DB readers: the JSON-bucket `VulnDB`, the bbolt
`trivy.db` reader and the rpmdb formats.

Copied from `trivy_tpu/db/__init__.py`; the port imports nothing from the
JAX package, so it keeps its own copy of this jax-free module.
"""

from trivy_tpu_torch.db.vulndb import Advisory, VulnDB, build_db, load_db

__all__ = ["Advisory", "VulnDB", "build_db", "load_db"]
