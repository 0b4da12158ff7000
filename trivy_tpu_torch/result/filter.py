"""Result filtering: severity, ignore files.

Mirrors pkg/result/filter.go:39 Filter — severity filtering per finding class
and `.trivyignore` / `.trivyignore.yaml` suppression (filter.go:115-177).
VEX and OPA ignore-policy hooks keep the same call shape and land later.

Copied from `trivy_tpu/result/filter.py`; the port imports nothing from the
JAX package.  The `--ignore-policy` hook evaluates rego through the port's
copy of the interpreter (`iac/rego.py`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import yaml

from trivy_tpu_torch.ftypes import Report, Result

SEVERITIES = ["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]


@dataclass
class IgnoreFinding:
    """One .trivyignore(.yaml) entry (pkg/result/ignore.go)."""

    id: str
    paths: list[str] = field(default_factory=list)


@dataclass
class IgnoreConfig:
    vulnerabilities: list[IgnoreFinding] = field(default_factory=list)
    misconfigurations: list[IgnoreFinding] = field(default_factory=list)
    secrets: list[IgnoreFinding] = field(default_factory=list)
    licenses: list[IgnoreFinding] = field(default_factory=list)

    def match(self, kind: str, finding_id: str, path: str) -> bool:
        entries = getattr(self, kind)
        for e in entries:
            if e.id != finding_id:
                continue
            if not e.paths:
                return True
            import fnmatch

            if any(fnmatch.fnmatch(path, p) for p in e.paths):
                return True
        return False


def parse_ignore_file(path: str) -> IgnoreConfig:
    """Parses both the flat .trivyignore (one ID per line, # comments) and the
    YAML .trivyignore.yaml schema (ignore.go)."""
    cfg = IgnoreConfig()
    if not path or not os.path.exists(path):
        return cfg
    if path.endswith((".yml", ".yaml")):
        with open(path, encoding="utf-8") as f:
            raw = yaml.safe_load(f) or {}
        for kind in ("vulnerabilities", "misconfigurations", "secrets", "licenses"):
            for item in raw.get(kind) or []:
                getattr(cfg, kind).append(
                    IgnoreFinding(
                        id=item.get("id", ""), paths=list(item.get("paths") or [])
                    )
                )
        return cfg
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fid = line.split()[0]
            # The flat file applies to every finding class.
            for kind in ("vulnerabilities", "misconfigurations", "secrets", "licenses"):
                getattr(cfg, kind).append(IgnoreFinding(id=fid))
    return cfg


@dataclass
class FilterOptions:
    severities: list[str] = field(default_factory=lambda: list(SEVERITIES))
    ignore_file: str = ""
    include_non_failures: bool = False
    vex_path: str = ""
    ignore_policy: str = ""  # --ignore-policy rego file (filter.go:242)


def filter_report(report: Report, options: FilterOptions) -> Report:
    """result.Filter (filter.go:39)."""
    if options.vex_path:
        from trivy_tpu_torch.result.vex import apply_vex, load_vex

        apply_vex(report, load_vex(options.vex_path))
    ignore = parse_ignore_file(options.ignore_file)
    allowed = set(options.severities)
    policy = (
        _load_ignore_policy(options.ignore_policy)
        if options.ignore_policy
        else None
    )
    for result in report.results:
        _filter_result(result, allowed, ignore, options)
        if policy is not None:
            _apply_ignore_policy(result, policy)
    return report


def _load_ignore_policy(path: str):
    """--ignore-policy: a rego module whose boolean `ignore` rule decides
    per finding (filter.go:242-343, query data.trivy.ignore)."""
    from trivy_tpu_torch.iac.rego import RegoError, parse_module

    try:
        with open(path, encoding="utf-8") as f:
            src = f.read()
    except OSError as e:
        raise RegoError(f"cannot read ignore policy {path!r}: {e}") from e
    mod = parse_module(src, source_path=path)
    if "ignore" not in mod.rules:
        raise RegoError(f"ignore policy {path!r} defines no 'ignore' rule")
    return mod


def _policy_ignores(mod, finding_json: dict) -> bool:
    from trivy_tpu_torch.iac.rego import _Evaluator, _Undefined

    ev = _Evaluator(finding_json, mod.rules)
    try:
        return bool(ev.eval_complete_rule("ignore"))
    except _Undefined:
        # Undefined result => not ignored (filter.go evaluate: undefined
        # handled as false).  Evaluator ERRORS (unknown builtin, step
        # limit) propagate — a broken policy must not read as "nothing
        # ignored" (the reference fails the run).
        return False


def _apply_ignore_policy(result: Result, mod) -> None:
    result.vulnerabilities = [
        v for v in result.vulnerabilities if not _policy_ignores(mod, v.to_json())
    ]
    result.misconfigurations = [
        m
        for m in result.misconfigurations
        if not _policy_ignores(mod, m.to_json())
    ]
    result.secrets = [
        s for s in result.secrets if not _policy_ignores(mod, s.to_json())
    ]
    result.licenses = [
        l
        for l in result.licenses
        if not _policy_ignores(
            mod, l.to_json() if hasattr(l, "to_json") else {}
        )
    ]


def _filter_result(
    result: Result,
    allowed: set[str],
    ignore: IgnoreConfig,
    options: FilterOptions,
) -> None:
    result.vulnerabilities = [
        v
        for v in result.vulnerabilities
        if (getattr(v, "severity", "UNKNOWN") or "UNKNOWN") in allowed
        and not ignore.match(
            "vulnerabilities",
            getattr(v, "vulnerability_id", ""),
            result.target,
        )
    ]
    result.secrets = [
        s
        for s in result.secrets
        if (s.severity or "UNKNOWN") in allowed
        and not ignore.match("secrets", s.rule_id, result.target)
    ]
    result.misconfigurations = [
        m
        for m in result.misconfigurations
        if (getattr(m, "severity", "UNKNOWN") or "UNKNOWN") in allowed
        and (options.include_non_failures or getattr(m, "status", "FAIL") == "FAIL")
        and not ignore.match(
            "misconfigurations",
            getattr(m, "check_id", "") or getattr(m, "id", ""),
            result.target,
        )
    ]
    result.licenses = [
        l
        for l in result.licenses
        if (getattr(l, "severity", "UNKNOWN") or "UNKNOWN") in allowed
        and not ignore.match("licenses", getattr(l, "name", ""), result.target)
    ]
