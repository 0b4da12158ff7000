"""Event sources: where the watch plane learns that an image changed.

A source's whole job is to answer ``poll()`` with the ``(repo, tag,
digest)`` change records since its last call.  Two implementations:

- :class:`RegistryTagPoller` — lists a repository's tags over the
  Distribution API (image/registry.py transport, so auth/token flows
  and plain-http test registries come for free) and resolves each tag
  to its current manifest digest;
- :class:`FeedTailer` — tails a JSONL event feed (a local file fed by
  a registry's notification webhook, or an HTTP endpoint serving the
  same lines), one ``{"repo":…, "tag":…, "digest":…}`` object per line.

Dedupe lives in the shared base: a record is emitted only when the
digest for its (repo, tag) differs from the last one this source saw,
so an unchanged tag list costs zero downstream work and a re-push under
the same tag (new digest) surfaces exactly once.

Every poll crosses the ``watch.poll`` fault seam before any I/O.  A
poll that faults (injected or real) emits nothing AND updates nothing:
the last-seen map only advances on success, so the change is simply
picked up by the next healthy poll — the at-least-once half of the
delta pipeline starts here.
"""

from __future__ import annotations

import json
import time
import urllib.request
from dataclasses import dataclass

from trivy_tpu_torch import faults


@dataclass(frozen=True)
class ChangeRecord:
    """One observed image change: `repo:tag` now points at `digest`."""

    repo: str
    tag: str
    digest: str
    source: str = ""

    @property
    def image(self) -> str:
        return f"{self.repo}:{self.tag}"


class EventSource:
    """Base source: dedupe + stats; subclasses implement `_poll_raw`."""

    kind = "base"

    def __init__(self, name: str):
        self.name = name
        self._last_seen: dict[tuple[str, str], str] = {}
        self.polls = 0
        self.errors = 0
        self.emitted = 0
        self.deduped = 0
        self.last_poll_ts = 0.0
        self.last_error = ""

    def _poll_raw(self) -> list[tuple[str, str, str]]:
        raise NotImplementedError

    def poll(self) -> list[ChangeRecord]:
        """Change records since the last successful poll.  Failures are
        absorbed (counted, remembered in `last_error`) and yield [] —
        the poll loop must outlive any single flaky registry."""
        self.polls += 1
        try:
            faults.fire("watch.poll")
            raw = self._poll_raw()
        except Exception as e:
            self.errors += 1
            self.last_error = f"{type(e).__name__}: {e}"
            return []
        self.last_poll_ts = time.time()
        out: list[ChangeRecord] = []
        for repo, tag, digest in raw:
            key = (repo, tag)
            if self._last_seen.get(key) == digest:
                self.deduped += 1
                continue
            self._last_seen[key] = digest
            out.append(
                ChangeRecord(repo=repo, tag=tag, digest=digest,
                             source=self.name)
            )
        self.emitted += len(out)
        return out

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "polls": self.polls,
            "errors": self.errors,
            "emitted": self.emitted,
            "deduped": self.deduped,
            "tracked_tags": len(self._last_seen),
            "last_poll_ts": self.last_poll_ts,
            "last_error": self.last_error,
        }


class RegistryTagPoller(EventSource):
    """Poll one repository's tag list and resolve each tag's digest.

    Reuses the RegistryClient transport (Bearer/Basic auth, insecure
    local registries) — `client` is injectable for tests."""

    kind = "registry"

    def __init__(self, reference: str, insecure: bool = False, client=None):
        super().__init__(name=reference)
        from trivy_tpu_torch.image.registry import RegistryClient, parse_reference

        self.ref = parse_reference(reference)
        self.client = client or RegistryClient(insecure=insecure)

    def _poll_raw(self) -> list[tuple[str, str, str]]:
        from trivy_tpu_torch.image.registry import Reference

        # Records carry the fully-qualified repo (registry host included)
        # so the planner's resolver can re-parse them without this
        # source's context.
        repo = f"{self.ref.registry}/{self.ref.repository}"
        out: list[tuple[str, str, str]] = []
        for tag in self.client.list_tags(self.ref):
            digest = self.client.subject_digest(
                Reference(
                    registry=self.ref.registry,
                    repository=self.ref.repository,
                    tag=tag,
                )
            )
            out.append((repo, tag, digest))
        return out


class FeedTailer(EventSource):
    """Tail a JSONL change feed: one {"repo","tag","digest"} per line.

    File feeds track a byte offset (only new bytes are read each poll);
    HTTP feeds re-GET the body and skip the lines already consumed.
    Malformed lines are counted and skipped, never fatal — a webhook
    relay that wrote a torn line must not wedge the plane."""

    kind = "feed"

    def __init__(self, path: str):
        super().__init__(name=path)
        self.path = path
        self._is_url = path.startswith(("http://", "https://"))
        self._offset = 0  # file: byte offset; url: consumed line count
        self.malformed = 0

    def _read_new_lines(self) -> list[str]:
        if self._is_url:
            with urllib.request.urlopen(self.path, timeout=30) as resp:
                lines = resp.read().decode("utf-8", "replace").splitlines()
            fresh = lines[self._offset:]
            self._offset = len(lines)
            return fresh
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            chunk = f.read()
        # Only consume complete lines; a partial trailing line stays in
        # the file for the next poll (the writer may still be appending).
        head, sep, _tail = chunk.rpartition(b"\n")
        if not sep:
            return []
        self._offset += len(head) + 1
        return head.decode("utf-8", "replace").splitlines()

    def _poll_raw(self) -> list[tuple[str, str, str]]:
        out: list[tuple[str, str, str]] = []
        for line in self._read_new_lines():
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
                repo = str(doc["repo"])
                tag = str(doc.get("tag") or "latest")
                digest = str(doc["digest"])
            except (ValueError, KeyError, TypeError):
                self.malformed += 1
                continue
            out.append((repo, tag, digest))
        return out

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["malformed"] = self.malformed
        return snap


def build_sources(configs) -> list[EventSource]:
    """SourceConfig list -> constructed sources (config.py kinds)."""
    out: list[EventSource] = []
    for sc in configs:
        if sc.kind == "registry":
            out.append(
                RegistryTagPoller(sc.reference, insecure=sc.insecure)
            )
        else:
            out.append(FeedTailer(sc.path))
    return out
