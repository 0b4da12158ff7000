"""The artifact and result cache planes, copied from `trivy_tpu/cache/`
(the port imports nothing from the JAX package): memory and FS stores,
the tiered chain and the fleet result cache.  The remote redis and s3
tiers wait for ROADMAP A13c.
"""

from trivy_tpu_torch.cache.store import ArtifactCache, FSCache, MemoryCache
from trivy_tpu_torch.cache.tiered import TieredCache
from trivy_tpu_torch.cache.results import ScanResultCache, content_digest, result_key


def build_cache(
    backend: str = "", cache_dir: str = "", ttl_seconds: int = 0
) -> ArtifactCache:
    """Construct the artifact-cache chain a backend spec names — the ONE
    place the CLI scan path and the server agree on what `--cache-backend`
    means.  "" picks FS when a cache dir exists, else memory.  Raises
    ValueError on an unknown spec and on the remote specs (redis://,
    s3://) the port lacks (callers wrap it in their own error type)."""
    if backend.startswith(("redis://", "rediss://", "s3://")):
        # The remote tiers (cache/redis.py, cache/s3.py) wait for ROADMAP
        # A13c; the local chain below is the whole port for now.
        raise ValueError(
            f"cache backend {backend!r} is not ported yet (ROADMAP A13c)"
        )
    if backend == "fs":
        if not cache_dir:
            raise ValueError("cache backend 'fs' requires a cache dir")
        return TieredCache([MemoryCache(), FSCache(cache_dir)])
    if backend == "memory":
        return MemoryCache()
    if backend == "":
        return FSCache(cache_dir) if cache_dir else MemoryCache()
    raise ValueError(
        f"unknown cache backend {backend!r} "
        "(memory | fs | redis://... | s3://...)"
    )


__all__ = [
    "ArtifactCache",
    "FSCache",
    "MemoryCache",
    "TieredCache",
    "ScanResultCache",
    "build_cache",
    "content_digest",
    "result_key",
]
