"""`trivy-tpu perf` — the performance observatory's read side.

report  recent bench-ledger trajectory: one row per run (sha, platform,
        headline files/s, vs-oracle multiple, exit status)
diff    per-metric deltas between two ledger runs, biggest movers first
gate    latest run vs tools/perfgate/baseline.json: exit 1 when any
        metric regresses past its per-metric tolerance (the CI tripwire
        behind `make perf-gate`)

Exit codes: 0 ok, 1 regression (gate only), 2 usage / missing inputs.

Copied from `trivy_tpu/commands/perf.py`; the port imports nothing from
the JAX package.
"""

from __future__ import annotations

import sys
import time

from trivy_tpu_torch.obs import perfledger


def _entries(args) -> list[dict]:
    path = perfledger.ledger_path(getattr(args, "ledger", "") or "")
    entries = perfledger.read(path)
    if not entries:
        print(f"trivy-tpu perf: no ledger entries at {path}", file=sys.stderr)
    return entries


def _stamp(entry: dict) -> str:
    try:
        return time.strftime(
            "%Y-%m-%d %H:%M:%S", time.localtime(float(entry.get("ts", 0)))
        )
    except (ValueError, OverflowError):
        return "?"


def _report(args) -> int:
    entries = _entries(args)
    if not entries:
        return 2
    limit = max(1, int(getattr(args, "limit", 10) or 10))
    rows = entries[-limit:]
    print(
        f"{'WHEN':19}  {'SHA':12}  {'PLATFORM':8}  {'FILES/S':>10}  "
        f"{'VS_ORACLE':>9}  RC"
    )
    for e in rows:
        bench = e.get("bench") or {}
        value = bench.get("value")
        vs = bench.get("vs_baseline")
        print(
            f"{_stamp(e):19}  {str(e.get('git_sha', ''))[:12]:12}  "
            f"{str(e.get('platform', ''))[:8]:8}  "
            f"{value if value is not None else '-':>10}  "
            f"{vs if vs is not None else '-':>9}  {e.get('rc', '?')}"
        )
    return 0


def _pick(entries: list[dict], index: int) -> dict | None:
    try:
        return entries[index]
    except IndexError:
        return None


def _diff(args) -> int:
    entries = _entries(args)
    if not entries:
        return 2
    base = _pick(entries, int(getattr(args, "base", -2)))
    head = _pick(entries, int(getattr(args, "head", -1)))
    if base is None or head is None:
        print(
            f"trivy-tpu perf: ledger has {len(entries)} runs; "
            f"--base/--head out of range",
            file=sys.stderr,
        )
        return 2
    print(
        f"base {str(base.get('git_sha', '?'))[:12]} ({_stamp(base)})  ->  "
        f"head {str(head.get('git_sha', '?'))[:12]} ({_stamp(head)})"
    )
    rows = perfledger.diff(base, head)
    if not rows:
        print("no numeric metrics in common")
        return 0
    for r in rows:
        pct = r.get("pct")
        pct_s = f"{pct:+.2f}%" if pct is not None else "-"
        print(
            f"{r['metric']:56}  {r.get('base', '-')!s:>12}  ->  "
            f"{r.get('head', '-')!s:>12}  {pct_s:>9}"
        )
    return 0


def _gate(args) -> int:
    baseline_path = getattr(args, "baseline", "") or ""
    if not baseline_path:
        print("trivy-tpu perf gate: --baseline is required", file=sys.stderr)
        return 2
    try:
        baseline = perfledger.load_baseline(baseline_path)
    except (OSError, ValueError) as e:
        print(f"trivy-tpu perf gate: {e}", file=sys.stderr)
        return 2
    entries = _entries(args)
    if not entries:
        return 2
    latest = entries[-1]
    failures, checked = perfledger.gate(latest, baseline)
    print(
        f"gating {str(latest.get('git_sha', '?'))[:12]} ({_stamp(latest)}) "
        f"against {baseline_path}: {len(checked)} metrics checked"
    )
    for row in checked:
        mark = "FAIL" if any(
            f.get("metric") == row["metric"] for f in failures
        ) else "ok"
        op = ">=" if row["direction"] == "higher" else "<="
        print(
            f"  {mark:4}  {row['metric']:48}  {row['value']} "
            f"{op} {row['bound']}  (baseline {row['baseline']})"
        )
    for f in failures:
        if f["metric"] == "rc":
            print(
                f"  FAIL  rc = {f['value']}: {f['reason']}"
                + (f" ({f['error']})" if f.get("error") else "")
            )
    if failures:
        print(f"perf gate: {len(failures)} regression(s)", file=sys.stderr)
        return 1
    print("perf gate: ok")
    return 0


def run_perf(args) -> int:
    cmd = getattr(args, "perf_command", None)
    if cmd == "report":
        return _report(args)
    if cmd == "diff":
        return _diff(args)
    if cmd == "gate":
        return _gate(args)
    print(
        "trivy-tpu perf: expected a subcommand (report | diff | gate)",
        file=sys.stderr,
    )
    return 2
