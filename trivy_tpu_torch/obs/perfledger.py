"""Bench ledger: append-only performance history with a regression gate.

bench.py's contract is ONE JSON line per run — great for the harness's
stdout tail, useless for trajectory: by the next run the previous line is
gone and "did the pipeline get slower since the codec landed?" needs an
archaeologist.  The ledger closes that gap the cheapest way that works:
every bench run appends one JSONL entry — the same compact payload the
bench printed, wrapped with the provenance that makes runs comparable
(git sha, device platform, ruleset digest, exit status, timestamp).  The
file is append-only; nothing in this module ever rewrites or truncates
it.

Three consumers, all via `trivy-tpu perf`:

  report  render the recent trajectory of the headline metrics;
  diff    per-metric deltas between two runs (dotted paths into the
          bench payload, numeric leaves only);
  gate    compare the latest run against a checked-in baseline
          (tools/perfgate/baseline.json) and exit non-zero when any
          metric regresses past its per-metric tolerance — the CI hook
          (`make perf-gate`) that turns the ledger from a diary into a
          tripwire.

Ledger writes must never break the bench: append() is called from
bench._emit after the stdout line is flushed, swallows OSError, and
prints nothing (the single-line stdout contract is bench.py's, not
ours to spoil).

Copied from `trivy_tpu/obs/perfledger.py`; the port imports nothing from
the JAX package.  An entry's `platform` is the port's
`mesh.topology.platform()`: "cuda" when a card is usable, else "cpu".
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SCHEMA = 1
DEFAULT_LEDGER = "BENCH_LEDGER.jsonl"


def ledger_path(explicit: str = "") -> str:
    """Resolve the ledger file: explicit arg > BENCH_LEDGER_FILE env >
    the default.  An explicitly-empty env var disables the ledger."""
    if explicit:
        return explicit
    return os.environ.get("BENCH_LEDGER_FILE", DEFAULT_LEDGER)


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        return out.stdout.strip() if out.returncode == 0 else ""
    except Exception:
        return ""


def _platform() -> str:
    try:
        from trivy_tpu_torch.mesh import topology as mesh_topology

        return mesh_topology.platform()
    except Exception:
        return sys.platform


def append(payload: dict, *, rc: int = 0, path: str = "") -> dict | None:
    """Append one run to the ledger; returns the entry, or None when the
    ledger is disabled or unwritable.  Never raises, never prints."""
    try:
        p = ledger_path(path)
        if not p:
            return None
        entry = {
            "schema": SCHEMA,
            "ts": time.time(),
            "git_sha": _git_sha(),
            "platform": _platform(),
            "ruleset_digest": (payload or {}).get("ruleset_digest", ""),
            "rc": int(rc),
            "bench": payload or {},
        }
        line = json.dumps(entry, separators=(",", ":"), default=str)
        with open(p, "a") as f:
            f.write(line + "\n")
        return entry
    except Exception:
        return None


def read(path: str = "") -> list[dict]:
    """All ledger entries, oldest first.  Malformed lines are skipped
    (a truncated tail from a killed run must not poison history)."""
    p = ledger_path(path)
    entries: list[dict] = []
    try:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(obj, dict) and "bench" in obj:
                    entries.append(obj)
    except OSError:
        pass
    return entries


def flatten(entry: dict) -> dict[str, float]:
    """Numeric leaves of the entry's bench payload as dotted paths
    ("detail.files_per_sec" -> 1234.5).  Bools and strings are skipped;
    lists are skipped (their per-element identity is not stable run to
    run)."""
    out: dict[str, float] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(node, bool):
            return
        elif isinstance(node, (int, float)):
            out[prefix] = float(node)

    walk("", entry.get("bench") or {})
    return out


def diff(base: dict, head: dict) -> list[dict]:
    """Per-metric deltas between two ledger entries, sorted by |pct|
    descending so the biggest movers lead.  Metrics present in only one
    run are reported with the other side null."""
    b, h = flatten(base), flatten(head)
    rows: list[dict] = []
    for metric in sorted(set(b) | set(h)):
        bv, hv = b.get(metric), h.get(metric)
        row: dict = {"metric": metric, "base": bv, "head": hv}
        if bv is not None and hv is not None:
            row["delta"] = round(hv - bv, 6)
            if bv:
                row["pct"] = round((hv - bv) / abs(bv) * 100.0, 2)
        rows.append(row)
    rows.sort(key=lambda r: abs(r.get("pct") or 0.0), reverse=True)
    return rows


def load_baseline(path: str) -> dict:
    """Baseline JSON: {"schema": 1, "metrics": {"<dotted.path>":
    {"baseline": X, "tolerance": 0.5, "direction": "higher"|"lower"}}}.
    direction names which way is GOOD: "higher" gates on drops below
    baseline*(1-tolerance), "lower" on rises above
    baseline*(1+tolerance)."""
    with open(path) as f:
        base = json.load(f)
    if not isinstance(base, dict) or "metrics" not in base:
        raise ValueError(f"{path}: not a perf baseline (no 'metrics' key)")
    return base


def gate(entry: dict, baseline: dict) -> tuple[list[dict], list[dict]]:
    """Check one ledger entry against a baseline; returns (failures,
    checked).  A metric absent from the run is skipped, not failed —
    sections are env-gated and a baseline must not force every section
    on.  A non-zero bench rc is itself a failure: a crashed run proves
    nothing about performance."""
    failures: list[dict] = []
    checked: list[dict] = []
    if entry.get("rc"):
        failures.append({
            "metric": "rc",
            "value": entry.get("rc"),
            "reason": "bench run exited non-zero",
            "error": (entry.get("bench") or {}).get("error", ""),
        })
    values = flatten(entry)
    for metric, spec in sorted((baseline.get("metrics") or {}).items()):
        value = values.get(metric)
        if value is None:
            continue
        base = float(spec["baseline"])
        tol = float(spec.get("tolerance", 0.25))
        direction = spec.get("direction", "higher")
        if direction == "higher":
            bound = base * (1.0 - tol)
            ok = value >= bound
        else:
            bound = base * (1.0 + tol)
            ok = value <= bound
        row = {
            "metric": metric, "value": round(value, 6),
            "baseline": base, "bound": round(bound, 6),
            "direction": direction,
        }
        checked.append(row)
        if not ok:
            failures.append({**row, "reason": "outside tolerance"})
    return failures, checked
