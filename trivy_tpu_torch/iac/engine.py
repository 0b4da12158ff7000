"""IaC scan engine: rego checks over structured file inputs.

The policy-as-code half of the misconf façade (reference:
pkg/misconf/scanner.go routing + pkg/iac/rego driving the trivy-checks
bundle).  Builtin checks ship as .rego sources in trivy_tpu_torch/iac/checks/;
user checks load from extra directories (--config-check), exactly like the
reference's custom-policy flow — both run through the same evaluator
(iac/rego.py).

Check metadata carries id/severity/title (METADATA comment block or
__rego_metadata__); the package path routes the check to its input type:
``builtin.dockerfile.*`` / ``<ns>.dockerfile.*`` -> dockerfile inputs, and
likewise for kubernetes and terraform.

Copied from `trivy_tpu/iac/engine.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

from trivy_tpu_torch.iac.inputs import (
    detect_type,
    dockerfile_input,
    kubernetes_inputs,
    terraform_input,
)
from trivy_tpu_torch.iac.rego import RegoError, RegoModule, parse_module, _Evaluator
from trivy_tpu_torch.misconf.types import MisconfFinding, Misconfiguration

_CHECK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checks")


@dataclass
class Check:
    module: RegoModule
    check_id: str
    title: str
    description: str
    severity: str
    resolution: str
    input_type: str  # dockerfile | kubernetes | terraform | cloud | ...
    # package -> module for every module loaded alongside this check —
    # `import data.lib.kubernetes` helper libraries resolve through it.
    registry: dict = None  # type: ignore[assignment]
    # selector subtypes for cloud checks: [{"provider": "aws",
    # "service": "s3"}, ...] — the applicability gate.
    subtypes: list = None  # type: ignore[assignment]
    # METADATA related_resources URLs -> finding references.
    references: list = None  # type: ignore[assignment]


def _input_type_of(package: str) -> str | None:
    parts = package.split(".")
    for t in (
        "dockerfile",
        "kubernetes",
        "terraform",
        "cloudformation",
        "json",
        "yaml",
        "toml",
    ):
        if t in parts:
            return t
    if "azure" in parts or "arm" in parts:
        return "azure-arm"
    return None


def load_checks(extra_dirs: list[str] | None = None) -> list[Check]:
    """Parse every .rego under the check dirs (recursively — bundles nest
    checks in per-service subtrees).  Modules without a deny rule or a
    recognizable input type (e.g. `lib.*` helper libraries) load into the
    shared registry so checks can `import data.lib.kubernetes` them, but
    produce no Check rows themselves."""
    checks: list[Check] = []
    registry: dict[str, RegoModule] = {}
    dirs = [_CHECK_DIR] + list(extra_dirs or [])
    modules: list[RegoModule] = []
    for d in dirs:
        if not os.path.isdir(d):
            continue
        for root, _sub, files in sorted(os.walk(d)):
            for name in sorted(files):
                if not name.endswith(".rego") or name.endswith("_test.rego"):
                    continue
                path = os.path.join(root, name)
                with open(path, "r", encoding="utf-8") as f:
                    src = f.read()
                mod = parse_module(src, source_path=path)
                registry[mod.package] = mod
                modules.append(mod)
    for mod in modules:
        md = mod.metadata or {}
        custom = md.get("custom") or {}
        # The METADATA input selector is authoritative (the real bundle's
        # cloud checks live under packages like builtin.aws.s3.* that the
        # path heuristic can't route); the package path is the fallback
        # for selector-less checks.
        selectors = (custom.get("input") or {}).get("selector") or []
        sel_types = [
            s.get("type") for s in selectors if isinstance(s, dict)
        ]
        subtypes = [
            st
            for s in selectors
            if isinstance(s, dict)
            for st in s.get("subtypes") or []
            if isinstance(st, dict)
        ]
        itype = None
        if "cloud" in sel_types:
            itype = "cloud"
        elif sel_types and sel_types[0] in (
            "dockerfile",
            "kubernetes",
            "terraform",
            "cloudformation",
            "json",
            "yaml",
            "toml",
        ):
            itype = sel_types[0]
        if itype is None:
            itype = _input_type_of(mod.package)
        if itype is None or "deny" not in mod.rules:
            continue
        checks.append(
            Check(
                module=mod,
                check_id=custom.get("id", mod.package.rsplit(".", 1)[-1]),
                title=md.get("title", ""),
                description=md.get("description", ""),
                severity=str(custom.get("severity", "MEDIUM")).upper(),
                resolution=custom.get("recommended_action", ""),
                input_type=itype,
                registry=registry,
                subtypes=subtypes,
                references=[
                    str(u) for u in md.get("related_resources") or []
                ],
            )
        )
    return checks


_shared: IacScanner | None = None
_shared_extra_dirs: list[str] = []
_shared_trace: bool = False


def configure_shared_scanner(
    extra_check_dirs: list[str], trace: bool = False
) -> None:
    """Set custom-check directories (--config-check) before the first scan;
    resets the cached scanner so new checks load."""
    global _shared, _shared_extra_dirs, _shared_trace
    _shared_extra_dirs = list(extra_check_dirs)
    _shared_trace = trace
    _shared = None


def shared_scanner() -> "IacScanner":
    """Process-wide scanner with the builtin checks (compiled once)."""
    global _shared
    if _shared is None:
        _shared = IacScanner(
            extra_check_dirs=_shared_extra_dirs, trace=_shared_trace
        )
    return _shared


class IacScanner:
    """Routes config files to rego checks; one instance caches compiled
    checks for the whole scan (pkg/misconf/scanner.go role)."""

    def __init__(
        self,
        extra_check_dirs: list[str] | None = None,
        trace: bool = False,
    ):
        self.checks = load_checks(extra_check_dirs)
        # --trace (misconf.ScannerOption.Trace, scanner.go:51): per-check
        # evaluation traces attached to findings.
        self.trace = trace

    def scan(self, file_path: str, content: bytes) -> Misconfiguration | None:
        ftype = detect_type(file_path, content)
        if ftype is None:
            return None
        if ftype in ("json", "yaml", "toml") and not any(
            c.input_type == ftype for c in self.checks
        ):
            # Generic config types only matter when custom checks target
            # them (scanner.go:82-112 gates these scanners the same way) —
            # don't parse every config file in the tree for nothing.
            return None
        if ftype == "dockerfile":
            inputs: list[Any] = [dockerfile_input(content)]
        elif ftype == "kubernetes":
            inputs = kubernetes_inputs(content)
        elif ftype == "cloudformation":
            from trivy_tpu_torch.iac.inputs import cloudformation_input

            doc = cloudformation_input(content)
            inputs = [doc] if doc else []
        elif ftype == "tfplan":
            from trivy_tpu_torch.iac.inputs import tfplan_input

            doc = tfplan_input(content)
            inputs = [doc] if doc else []
            ftype = "terraform"  # plans run the terraform check corpus
        elif ftype == "azure-arm":
            from trivy_tpu_torch.iac.inputs import azure_arm_input

            doc = azure_arm_input(content)
            inputs = [doc] if doc else []
        elif ftype == "yaml":
            import yaml as _yaml

            try:
                inputs = [
                    d
                    for d in _yaml.safe_load_all(
                        content.decode("utf-8", "replace")
                    )
                    if isinstance(d, (dict, list))
                ]
            except _yaml.YAMLError:
                return None
        elif ftype == "toml":
            from trivy_tpu_torch.compat import tomllib

            if tomllib is None:  # no TOML parser in this interpreter
                import logging

                logging.getLogger(__name__).warning(
                    "toml checks need tomllib or tomli; %s skipped", file_path
                )
                return None
            try:
                inputs = [tomllib.loads(content.decode("utf-8", "replace"))]
            except (tomllib.TOMLDecodeError, ValueError):
                return None
        elif ftype == "json":
            import json as _json

            try:
                doc = _json.loads(content)
            except ValueError:
                return None
            inputs = [doc] if isinstance(doc, (dict, list)) else []
        elif file_path.endswith(".tf.json"):
            import json as _json

            try:
                doc = _json.loads(content)
            except ValueError:
                return None
            inputs = [doc] if isinstance(doc, dict) else []
        else:
            try:
                inputs = [terraform_input(content.decode("utf-8", "replace"))]
            except Exception:
                import logging

                logging.getLogger(__name__).warning(
                    "terraform parse failed for %s; file skipped", file_path
                )
                return None
        if not inputs:
            return None
        return self.evaluate(file_path, ftype, inputs)

    def evaluate(
        self, file_path: str, ftype: str, inputs: list[Any]
    ) -> Misconfiguration:
        """Run every ftype-matching check over pre-built input documents
        (the seam the terraform module post-analyzer and cloud adapters
        use to evaluate docs that never existed as a single file)."""
        mc = Misconfiguration(file_type=ftype, file_path=file_path)
        for check in self.checks:
            if check.input_type != ftype:
                continue
            self._run_check(check, inputs, file_path, mc)
        if ftype in ("terraform", "cloudformation"):
            self._evaluate_cloud(file_path, ftype, inputs, mc)
        return mc

    def _evaluate_cloud(
        self,
        file_path: str,
        ftype: str,
        inputs: list[Any],
        mc: Misconfiguration,
    ) -> None:
        """Adapt the raw parse into typed provider state and run the
        cloud-selector checks over it (pkg/iac/rego isPolicyApplicable +
        the adapters/terraform lowering).  `cloud.tf.json` documents the
        aws live scan synthesizes flow through here identically, so both
        scan paths share one typed check corpus."""
        cloud_checks = [c for c in self.checks if c.input_type == "cloud"]
        if not cloud_checks:
            return
        try:
            if ftype == "terraform":
                from trivy_tpu_torch.iac.adapters.terraform import adapt_terraform

                state = adapt_terraform(
                    [d for d in inputs if isinstance(d, dict)],
                    filename=file_path,
                )
            else:
                from trivy_tpu_torch.iac.adapters.cloudformation import (
                    adapt_cloudformation,
                )

                state = adapt_cloudformation(
                    inputs[0] if inputs and isinstance(inputs[0], dict)
                    else {},
                    filename=file_path,
                )
        except Exception as e:  # noqa: BLE001 — adaptation must not
            # take down the raw-schema findings already collected
            import logging

            logging.getLogger(__name__).warning(
                "typed-state adaptation failed for %s: %s", file_path, e
            )
            return
        doc = state.to_rego()
        for check in cloud_checks:
            subtypes = check.subtypes or []
            applicable = not subtypes or any(
                state.service_has_resources(
                    str(st.get("provider", "")), str(st.get("service", ""))
                )
                for st in subtypes
            )
            if not applicable:
                continue
            self._run_check(check, [doc], file_path, mc)

    def _run_check(
        self,
        check: Check,
        inputs: list[Any],
        file_path: str,
        mc: Misconfiguration,
    ) -> None:
        failures = []
        traces: list[str] = []
        broken = False
        for di, doc in enumerate(inputs):
            ev = _Evaluator(
                doc, check.module.rules,
                registry=check.registry,
                imports=check.module.imports,
            )
            try:
                denies = ev.eval_set_rule("deny")
            except Exception as e:  # noqa: BLE001 — any check crash
                # A policy that cannot evaluate — RegoError or a builtin
                # crashing on unexpected input shapes — must not read as
                # green (PASS) nor abort the file's other checks; log
                # and record nothing for this check.
                import logging

                logging.getLogger(__name__).warning(
                    "check %s failed to evaluate on %s: %s",
                    check.check_id, file_path, e,
                )
                broken = True
                continue
            if self.trace:
                traces.append(
                    f"input[{di}] package {check.module.package}: "
                    f"deny produced {len(denies)} result(s)"
                )
            for d in denies:
                if isinstance(d, dict):
                    msg = str(d.get("msg", ""))
                    start = int(d.get("startline", 0) or 0)
                    end = int(d.get("endline", 0) or start)
                else:
                    msg, start, end = str(d), 0, 0
                failures.append(
                    MisconfFinding(
                        check_id=check.check_id,
                        title=check.title,
                        description=check.description,
                        message=msg,
                        resolution=check.resolution,
                        severity=check.severity,
                        status="FAIL",
                        start_line=start,
                        end_line=end or start,
                        references=list(check.references or []),
                    )
                )
        if self.trace:
            for f in failures:
                f.traces = list(traces)
        if failures:
            mc.failures.extend(failures)
        elif broken:
            pass  # neither PASS nor FAIL: the check did not evaluate
        else:
            mc.successes.append(
                MisconfFinding(
                    check_id=check.check_id,
                    title=check.title,
                    description=check.description,
                    resolution=check.resolution,
                    severity=check.severity,
                    status="PASS",
                    traces=list(traces),
                    references=list(check.references or []),
                )
            )
