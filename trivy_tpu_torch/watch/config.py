"""Watch-plane configuration: sources, stream sinks, poll cadence.

One YAML document (``--watch-config`` / ``trivy-tpu watch --config``)
declares everything the continuous-scanning plane needs:

    watch:
      poll_interval_s: 30
      sources:
        - type: registry           # tag-list poller (image/registry.py)
          reference: localhost:5000/team/app
          insecure: true
        - type: feed               # JSONL event feed (file path or URL)
          path: /var/run/registry-events.jsonl
      stream:
        jsonl: /var/log/trivy-tpu/verdict-deltas.jsonl
        webhook: http://alerts.internal:9000/hooks/trivy
        webhook_queue: 256
        webhook_attempts: 5
      content_store_mb: 64

The ``watch:`` nesting is optional (mirroring fleet config: the same
file can carry both planes).  Validation is all-up-front with typed
errors — a watch daemon that silently polls nothing is worse than one
that refuses to start.
"""

from __future__ import annotations

from dataclasses import dataclass, field

DEFAULT_POLL_INTERVAL_S = 30.0
DEFAULT_WEBHOOK_QUEUE = 256
DEFAULT_WEBHOOK_ATTEMPTS = 5
DEFAULT_CONTENT_STORE_MB = 64

SOURCE_KINDS = ("registry", "feed")


class WatchConfigError(ValueError):
    pass


@dataclass(frozen=True)
class SourceConfig:
    """One event source: a registry repository to poll tags on, or a
    JSONL change feed to tail (local file or HTTP URL)."""

    kind: str  # "registry" | "feed"
    reference: str = ""  # registry kind: repo reference (host/repo[:tag])
    path: str = ""  # feed kind: file path or http(s):// URL
    insecure: bool = False  # registry kind: plain-http registry

    @property
    def label(self) -> str:
        return self.reference or self.path


@dataclass(frozen=True)
class StreamConfig:
    """Where verdict deltas go: an ordered JSONL sink and/or an
    at-least-once webhook endpoint."""

    jsonl_path: str = ""
    webhook_url: str = ""
    webhook_queue: int = DEFAULT_WEBHOOK_QUEUE
    webhook_attempts: int = DEFAULT_WEBHOOK_ATTEMPTS


@dataclass(frozen=True)
class WatchConfig:
    sources: tuple[SourceConfig, ...] = ()
    stream: StreamConfig = field(default_factory=StreamConfig)
    poll_interval_s: float = DEFAULT_POLL_INTERVAL_S
    programs: tuple[str, ...] = ("secret",)
    content_store_mb: int = DEFAULT_CONTENT_STORE_MB


def parse_watch_config(doc: dict) -> WatchConfig:
    """Validate one parsed watch YAML document (top-level or nested
    under a `watch:` key)."""
    if not isinstance(doc, dict):
        raise WatchConfigError("watch config must be a mapping")
    if isinstance(doc.get("watch"), dict):
        doc = doc["watch"]
    raw_sources = doc.get("sources")
    if not isinstance(raw_sources, list) or not raw_sources:
        raise WatchConfigError("watch config needs a non-empty sources list")
    sources: list[SourceConfig] = []
    for i, entry in enumerate(raw_sources):
        if not isinstance(entry, dict):
            raise WatchConfigError(f"sources[{i}] must be a mapping")
        kind = str(entry.get("type") or entry.get("kind") or "")
        if kind not in SOURCE_KINDS:
            raise WatchConfigError(
                f"sources[{i}].type must be one of {', '.join(SOURCE_KINDS)}"
            )
        reference = str(entry.get("reference") or "")
        path = str(entry.get("path") or entry.get("url") or "")
        if kind == "registry" and not reference:
            raise WatchConfigError(f"sources[{i}] (registry) needs reference")
        if kind == "feed" and not path:
            raise WatchConfigError(f"sources[{i}] (feed) needs path or url")
        sources.append(
            SourceConfig(
                kind=kind,
                reference=reference,
                path=path,
                insecure=bool(entry.get("insecure", False)),
            )
        )
    raw_stream = doc.get("stream") or {}
    if not isinstance(raw_stream, dict):
        raise WatchConfigError("watch stream must be a mapping")
    try:
        stream = StreamConfig(
            jsonl_path=str(
                raw_stream.get("jsonl") or raw_stream.get("jsonl_path") or ""
            ),
            webhook_url=str(
                raw_stream.get("webhook")
                or raw_stream.get("webhook_url")
                or ""
            ),
            webhook_queue=int(
                raw_stream.get("webhook_queue", DEFAULT_WEBHOOK_QUEUE)
            ),
            webhook_attempts=int(
                raw_stream.get("webhook_attempts", DEFAULT_WEBHOOK_ATTEMPTS)
            ),
        )
    except (TypeError, ValueError):
        raise WatchConfigError(
            "stream webhook_queue/webhook_attempts must be integers"
        ) from None
    if stream.webhook_queue < 1 or stream.webhook_attempts < 1:
        raise WatchConfigError(
            "stream webhook_queue/webhook_attempts must be >= 1"
        )
    try:
        interval = float(
            doc.get("poll_interval_s", DEFAULT_POLL_INTERVAL_S)
        )
    except (TypeError, ValueError):
        raise WatchConfigError("poll_interval_s must be a number") from None
    if interval <= 0:
        raise WatchConfigError("poll_interval_s must be > 0")
    programs = tuple(
        str(p) for p in (doc.get("programs") or ["secret"])
    )
    if not programs:
        raise WatchConfigError("programs must be a non-empty list")
    try:
        store_mb = int(doc.get("content_store_mb", DEFAULT_CONTENT_STORE_MB))
    except (TypeError, ValueError):
        raise WatchConfigError("content_store_mb must be an integer") from None
    if store_mb < 1:
        raise WatchConfigError("content_store_mb must be >= 1")
    return WatchConfig(
        sources=tuple(sources),
        stream=stream,
        poll_interval_s=interval,
        programs=programs,
        content_store_mb=store_mb,
    )


def load_watch_config(path: str) -> WatchConfig:
    """Read and validate a watch YAML file (--watch-config)."""
    import yaml

    with open(path, encoding="utf-8") as f:
        doc = yaml.safe_load(f)
    return parse_watch_config(doc or {})
