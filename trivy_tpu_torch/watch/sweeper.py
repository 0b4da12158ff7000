"""Re-verification sweeper: a ruleset push invalidates exactly its own
cached verdicts, and the sweeper re-earns them.

When `rules push` / SIGHUP changes the active ruleset digest from OLD
to NEW, every cached verdict keyed under OLD is stale — and *only*
those.  The sweeper walks the result cache's per-(ruleset digest,
program id) reverse index (cache/results.py `indexed_blobs`), so the
candidate set is precisely the invalidated entries: verdicts under
other digests (other tenants' pinned rulesets, other programs) are
never touched, which is what `sweep_touched_ratio < 1` on a mixed
corpus measures.

Per candidate blob:
- already re-verdicted under NEW (a scan raced the sweep) -> skip,
  drop the OLD entry;
- bytes present in the content store -> re-scan under NEW, store the
  verdict (byte-identical to a cold scan of the same bytes — same
  engine, same stable blob-digest path), publish the OLD->NEW delta,
  drop the OLD entry;
- bytes evicted from the content store -> count as missing-content and
  drop the OLD entry anyway (a later change event will re-scan it as
  novel; keeping a stale verdict would be worse).

Failures are absorbed per blob (counted + flight-captured with reason
"watch-sweep"), never fatal — one unscannable blob must not leave the
rest of the corpus stale.
"""

from __future__ import annotations

import time

from trivy_tpu_torch import lockcheck


class ReverifySweeper:
    def __init__(
        self,
        result_cache,
        scan_fn,
        content_store,
        programs: tuple[str, ...] = ("secret",),
        on_verdict=None,
        flight=None,
    ):
        self.result_cache = result_cache
        # scan_fn(items, ruleset_digest): re-verdicts must run under the
        # NEW ruleset, not whatever lane is default — on a server this
        # routes through the scheduler's per-digest lanes.
        self.scan_fn = scan_fn
        self.content_store = content_store
        self.programs = tuple(programs) or ("secret",)
        # on_verdict(blob_digest, old_verdict, new_verdict): stream seam.
        self.on_verdict = on_verdict
        self.flight = flight
        self._lock = lockcheck.make_lock("watch.sweeper")
        self.sweeps_total = 0  # owner: _lock
        self._progress: dict = {"state": "idle"}  # owner: _lock

    def sweep(self, old_digest: str, new_digest: str) -> dict:
        """Re-verify everything OLD invalidated; returns the summary
        (also retained as `progress()` for /debug/watch)."""
        if not old_digest or not new_digest or old_digest == new_digest:
            return {"state": "skipped", "old": old_digest,
                    "new": new_digest, "total": 0, "touched": 0}
        t0 = time.perf_counter()
        prog = {
            "state": "running",
            "old": old_digest,
            "new": new_digest,
            "started_ts": round(time.time(), 3),
            "total": 0,
            "touched": 0,
            "skipped_current": 0,
            "missing_content": 0,
            "failures": 0,
        }
        with self._lock:
            self.sweeps_total += 1
            self._progress = prog
        for pid in self.programs:
            candidates = self.result_cache.indexed_blobs(old_digest, pid)
            prog["total"] += len(candidates)
            for blob_digest in candidates:
                try:
                    self._reverify(blob_digest, old_digest, new_digest,
                                   pid, prog)
                except Exception as e:
                    prog["failures"] += 1
                    self._capture(blob_digest, e)
        prog["state"] = "done"
        prog["elapsed_s"] = round(time.perf_counter() - t0, 3)
        prog["touched_ratio"] = (
            prog["touched"] / prog["total"] if prog["total"] else 0.0
        )
        return dict(prog)

    def _reverify(
        self,
        blob_digest: str,
        old_digest: str,
        new_digest: str,
        pid: str,
        prog: dict,
    ) -> None:
        if self.result_cache.exists(blob_digest, new_digest, pid):
            prog["skipped_current"] += 1
            self.result_cache.remove(blob_digest, old_digest, pid)
            return
        data = self.content_store.get(blob_digest)
        if data is None:
            prog["missing_content"] += 1
            self.result_cache.remove(blob_digest, old_digest, pid)
            return
        old_verdict = self.result_cache.get(
            blob_digest, old_digest, path=blob_digest, program_id=pid
        )
        new_verdict = self.scan_fn([(blob_digest, data)], new_digest)[0]
        self.result_cache.put(
            blob_digest, new_digest, new_verdict, program_id=pid
        )
        prog["touched"] += 1
        if self.on_verdict is not None:
            self.on_verdict(blob_digest, old_verdict, new_verdict)
        self.result_cache.remove(blob_digest, old_digest, pid)

    def _capture(self, blob_digest: str, e: Exception) -> None:
        if self.flight is None:
            return
        self.flight.capture(
            method="watch.sweep",
            reason=f"watch-sweep: {type(e).__name__}: {e}"[:200],
            trace_id=f"watch-{blob_digest[:24]}",
        )

    def progress(self) -> dict:
        with self._lock:
            return dict(self._progress)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "sweeps_total": self.sweeps_total,
                "progress": dict(self._progress),
            }
