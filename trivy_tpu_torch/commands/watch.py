"""`trivy-tpu watch` — the continuous-scanning plane on a local engine.

Polls the configured event sources (registry tag lists, JSONL feeds),
dispatches only genuinely novel blobs through a local secret engine,
and publishes verdict deltas to the configured stream sinks.  The same
plane a server embeds via `--watch-config` (see GET /debug/watch), but
self-contained: useful for a single-box sidecar next to a registry, or
`--once` as a cron/smoke entry that runs one poll cycle and prints the
JSON summary.

Re-verification sweeps here re-scan on the (hot-reloaded-in-place)
local engine — build_watch_service's default sweep path; servers route
sweeps through the scheduler's per-digest lanes instead.

Copied from `trivy_tpu/commands/watch.py`; the port imports nothing from
the JAX package.  The local engine is the port's `make_secret_engine` on
`--device` (default cuda; it raises without a card).
"""

from __future__ import annotations

import json
import sys
import time

from trivy_tpu_torch.device import DEFAULT_DEVICE


def run_watch(args) -> int:
    from trivy_tpu_torch.cache import build_cache
    from trivy_tpu_torch.cache.results import ScanResultCache
    from trivy_tpu_torch.watch import (
        WatchConfigError,
        build_watch_service,
        load_watch_config,
    )

    cfg_path = getattr(args, "watch_config", "") or ""
    if not cfg_path:
        print("watch: --watch-config is required", file=sys.stderr)
        return 2
    try:
        config = load_watch_config(cfg_path)
    except WatchConfigError as e:
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2
    try:
        cache = build_cache(
            getattr(args, "cache_backend", "") or "",
            getattr(args, "cache_dir", "") or "",
            getattr(args, "cache_ttl", 0) or 0,
        )
    except ValueError as e:
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2
    result_cache = ScanResultCache(cache)

    from trivy_tpu_torch.engine.hybrid import make_secret_engine
    from trivy_tpu_torch.registry.digest import engine_digest
    from trivy_tpu_torch.registry.store import resolve_rules_cache_dir
    from trivy_tpu_torch.rules.model import load_config

    secret_config = getattr(args, "secret_config", "") or ""
    engine = make_secret_engine(
        config=load_config(secret_config) if secret_config else None,
        backend="auto",
        device=getattr(args, "device", DEFAULT_DEVICE),
        rules_cache_dir=resolve_rules_cache_dir(
            getattr(args, "rules_cache_dir", "")
        ),
    )
    service = build_watch_service(
        config,
        result_cache,
        scan_fn=engine.scan_batch,
        ruleset_digest_fn=lambda: engine_digest(engine),
        artifact_cache=cache,
    )
    if getattr(args, "once", False):
        cycle = service.poll_once()
        snap = service.snapshot()
        service.close()
        print(json.dumps({"cycle": cycle, "watch": snap}, indent=2))
        return 0
    service.start()
    print(
        f"trivy-tpu watch: polling {len(service.sources)} source(s) "
        f"every {config.poll_interval_s:g}s (ctrl-c to stop)"
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
    return 0
