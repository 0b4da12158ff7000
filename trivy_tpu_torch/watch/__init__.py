"""Continuous scanning plane.

Registry-event-driven delta dispatch: event sources observe image
changes, the delta planner proves which blobs are genuinely novel
before any bytes move, the re-verification sweeper re-earns exactly
the verdicts a ruleset push invalidated, and the verdict-delta stream
publishes what changed.  See each module's docstring; the composition
root is service.build_watch_service.

This package is also a lint boundary: graftlint GL015 ("watch-seam")
requires event-source I/O and webhook emission to happen only inside
trivy_tpu_torch/watch/ — serve/rpc/engine code reaches the plane through
build_watch_service, never by constructing pollers or emitters
directly on a scheduler thread.

Copied from `trivy_tpu/watch/`; the port imports nothing from the JAX
package.  Novel blobs are scanned by the caller's `scan_fn`: a server's
scheduler onto its engines, or the `watch` command's local engine.
"""

from trivy_tpu_torch.watch.config import (
    SourceConfig,
    StreamConfig,
    WatchConfig,
    WatchConfigError,
    load_watch_config,
    parse_watch_config,
)
from trivy_tpu_torch.watch.planner import ContentStore, DeltaPlanner
from trivy_tpu_torch.watch.service import (
    WatchService,
    build_watch_service,
    registry_resolver,
)
from trivy_tpu_torch.watch.sources import (
    ChangeRecord,
    EventSource,
    FeedTailer,
    RegistryTagPoller,
    build_sources,
)
from trivy_tpu_torch.watch.stream import (
    VerdictDeltaStream,
    WebhookEmitter,
    diff_findings,
)
from trivy_tpu_torch.watch.sweeper import ReverifySweeper

__all__ = [
    "ChangeRecord",
    "ContentStore",
    "DeltaPlanner",
    "EventSource",
    "FeedTailer",
    "RegistryTagPoller",
    "ReverifySweeper",
    "SourceConfig",
    "StreamConfig",
    "VerdictDeltaStream",
    "WatchConfig",
    "WatchConfigError",
    "WatchService",
    "WebhookEmitter",
    "build_sources",
    "build_watch_service",
    "diff_findings",
    "load_watch_config",
    "parse_watch_config",
    "registry_resolver",
]
