"""The artifact and result cache planes, copied from `trivy_tpu/cache/`
(the port imports nothing from the JAX package): memory and FS stores,
the tiered chain, the fleet result cache, and the remote redis and s3
tiers (`cache/redis.py`, `cache/s3.py`, standard library only).
"""

from trivy_tpu_torch.cache.store import ArtifactCache, FSCache, MemoryCache
from trivy_tpu_torch.cache.tiered import TieredCache
from trivy_tpu_torch.cache.results import ScanResultCache, content_digest, result_key


def build_cache(
    backend: str = "", cache_dir: str = "", ttl_seconds: int = 0
) -> ArtifactCache:
    """Construct the artifact-cache chain a backend spec names — the ONE
    place the CLI scan path and the server agree on what `--cache-backend`
    means.  Remote specs (redis://, s3://) sit behind local tiers (memory
    always, FS when a cache dir is configured): reads promote inward,
    remote writes ride the write-behind thread, and remote errors degrade
    to the local tiers instead of failing the scan.  "" picks FS when a
    cache dir exists, else memory.  Raises ValueError on an unknown spec
    (callers wrap it in their own error type)."""
    if backend.startswith(("redis://", "rediss://")):
        from trivy_tpu_torch.cache.redis import RedisCache

        local: list[ArtifactCache] = [MemoryCache()]
        if cache_dir:
            local.append(FSCache(cache_dir))
        return TieredCache(
            local
            + [RedisCache(backend, ttl_seconds=ttl_seconds, timeout=5.0)]
        )
    if backend.startswith("s3://"):
        from trivy_tpu_torch.cache.s3 import S3Cache

        local = [MemoryCache()]
        if cache_dir:
            local.append(FSCache(cache_dir))
        return TieredCache(local + [S3Cache(backend, timeout=10.0)])
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
