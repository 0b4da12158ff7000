"""Config (IaC) analyzers: route files into the misconf scanners.

Mirrors pkg/fanal/analyzer/config/* + the pkg/misconf façade routing
(scanner.go:82-112).

Copied from `trivy_tpu/analyzer/config.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

from trivy_tpu_torch.analyzer.core import (
    AnalysisInput,
    AnalysisResult,
    Analyzer,
    PostAnalyzer,
    register_analyzer,
    register_post_analyzer,
)
from trivy_tpu_torch.misconf.dockerfile import scan_dockerfile
from trivy_tpu_torch.misconf.kubernetes import scan_kubernetes


class DockerfileAnalyzer(Analyzer):
    def type(self) -> str:
        return "dockerfile"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        name = file_path.rsplit("/", 1)[-1].lower()
        return (
            name == "dockerfile"
            or name.startswith("dockerfile.")
            or name.endswith(".dockerfile")
        )

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        mc = scan_dockerfile(inp.file_path, inp.content)
        if not mc.failures and not mc.successes:
            return None
        return AnalysisResult(misconfigs=[mc])


class KubernetesYamlAnalyzer(Analyzer):
    def type(self) -> str:
        return "kubernetes"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path.endswith((".yaml", ".yml")) and size < 1 << 20

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        mc = scan_kubernetes(inp.file_path, inp.content)
        if mc is None or (not mc.failures and not mc.successes):
            return None
        return AnalysisResult(misconfigs=[mc])


def _scan_with_engine(inp: AnalysisInput) -> AnalysisResult | None:
    """Shared routing body: content-sniffing engine scan, dropping empty
    results (used by every engine-backed config analyzer)."""
    from trivy_tpu_torch.iac.engine import shared_scanner

    mc = shared_scanner().scan(inp.file_path, inp.content)
    if mc is None or (not mc.failures and not mc.successes):
        return None
    return AnalysisResult(misconfigs=[mc])


class TerraformAnalyzer(Analyzer):
    """Route .tf files through the rego engine (the reference's terraform
    scanner seat, pkg/misconf/scanner.go:82-112)."""

    def type(self) -> str:
        return "terraform"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path.endswith((".tf", ".tf.json")) and size < 1 << 20

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        return _scan_with_engine(inp)


class ConfigJsonAnalyzer(Analyzer):
    """Route JSON config files (CloudFormation templates, Azure ARM,
    terraform plans, k8s JSON, generic custom-check json) through the
    shared engine, which content-sniffs the concrete type
    (pkg/iac/detection)."""

    def type(self) -> str:
        return "config-json"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        # .tf.json belongs to TerraformAnalyzer; claiming it here would
        # scan the file twice and duplicate every finding.
        return (
            file_path.endswith((".json", ".template"))
            and not file_path.endswith(".tf.json")
            and size < 1 << 20
        )

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        return _scan_with_engine(inp)


class TomlConfigAnalyzer(Analyzer):
    """Generic TOML routing; only fires when custom toml-namespace checks
    are loaded (the engine gates parsing)."""

    def type(self) -> str:
        return "config-toml"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return file_path.endswith(".toml") and size < 1 << 20

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        return _scan_with_engine(inp)


class HelmPostAnalyzer(PostAnalyzer):
    """Helm chart scanning (pkg/iac/scanners/helm scanner.go): claims
    Chart.yaml + values.yaml + templates/** into the composite FS, renders
    each chart after the walk, and routes the manifests through the
    kubernetes checks.  Needs the post-analyzer seat because rendering
    requires the whole chart, not one file."""

    def type(self) -> str:
        return "helm"

    def version(self) -> int:
        return 1

    def required(self, file_path: str, size: int, mode: int) -> bool:
        if size >= 1 << 20:  # everything claimed here lands in MapFS whole
            return False
        name = file_path.rsplit("/", 1)[-1]
        if name in ("Chart.yaml", "values.yaml"):
            return True
        return "templates/" in file_path and name.endswith(
            (".yaml", ".yml", ".tpl")
        )

    def post_analyze(self, fs) -> AnalysisResult | None:
        from trivy_tpu_torch.iac.engine import shared_scanner
        from trivy_tpu_torch.iac.helm import HelmError, find_charts, render_chart

        charts = find_charts(fs.paths())
        if not charts:
            return None
        misconfigs = []
        for root, members in charts.items():
            prefix = root + "/" if root else ""
            files = {p[len(prefix) :]: fs.read(p) for p in members}
            try:
                rendered = render_chart(files, chart_root=root)
            except HelmError as e:
                import logging

                logging.getLogger(__name__).warning(
                    "helm chart %s failed to render: %s", root or ".", e
                )
                continue
            for rel_path, text in rendered.items():
                full = prefix + rel_path
                mc = shared_scanner().scan(full, text.encode())
                if mc is not None and (mc.failures or mc.successes):
                    mc.file_type = "helm"
                    misconfigs.append(mc)
        if not misconfigs:
            return None
        return AnalysisResult(misconfigs=misconfigs)


def _is_tfvars(name: str) -> bool:
    """Auto-loaded variable files (terraform's own load set)."""
    return name == "terraform.tfvars" or name.endswith(".auto.tfvars")


_INIT_MANIFEST = ".terraform/modules/modules.json"


def _is_init_manifest(path: str) -> bool:
    # Component-exact: a dir literally named "x.terraform" must not match.
    return path == _INIT_MANIFEST or path.endswith("/" + _INIT_MANIFEST)


class TerraformModulePostAnalyzer(PostAnalyzer):
    """Terraform module expansion (pkg/iac/scanners/terraform executor):
    a `module` block with a local relative source evaluates the child
    directory's merged files with the caller's arguments overriding the
    child's variable defaults.  Needs the post-analyzer seat — the child
    dir and the caller are different files.

    The module-aware result is emitted under the child's file path; the
    applier's last-write-wins merge lets it override the per-file
    defaults-only scan of the same file."""

    def type(self) -> str:
        return "terraform-module"

    def version(self) -> int:
        return 4  # v4: terraform-init manifest module resolution

    def required(self, file_path: str, size: int, mode: int) -> bool:
        # .tf only: the expansion below reads HCL syntax (module calls in
        # .tf.json are out of scope, so those files are not buffered).
        # terraform.tfvars / *.auto.tfvars join the composite FS so root
        # directories evaluate with their variable assignments, and
        # `terraform init` module manifests join so registry/git module
        # calls resolve to their downloaded directories.
        if _is_tfvars(file_path.rsplit("/", 1)[-1]):
            return size < 1 << 20
        if _is_init_manifest(file_path):
            return size < 1 << 20
        return file_path.endswith(".tf") and size < 1 << 20

    @staticmethod
    def _resolved_calls(
        docs: list[dict], overrides: dict | None = None
    ) -> dict[str, dict]:
        """Module blocks with arguments resolved in the CALLER's scope.

        Caller-side expressions (encrypt = var.secure) must resolve
        against the caller's variables/locals, never leak as raw
        reference strings into the child (a junk truthy string would
        flip checks).  Still-unresolved references are dropped so the
        child keeps its own default."""
        import re

        from trivy_tpu_torch.iac.hcl import terraform_docs_input

        resolved = terraform_docs_input(docs, overrides)
        calls: dict[str, dict] = {}
        for name, blk in (resolved.get("module") or {}).items():
            if not isinstance(blk, dict):
                continue
            calls[name] = {
                k: v
                for k, v in blk.items()
                if not (
                    isinstance(v, str)
                    and re.match(r"^(var|local|module|data)\.", v)
                )
            }
        return calls

    def post_analyze(self, fs) -> AnalysisResult | None:
        import logging
        import posixpath

        from trivy_tpu_torch.iac.engine import shared_scanner
        from trivy_tpu_torch.iac.hcl import parse_hcl, terraform_docs_input
        from trivy_tpu_torch.misconf.types import Misconfiguration

        logger = logging.getLogger(__name__)

        def norm_child(parent: str, source: str) -> str:
            d = posixpath.normpath(posixpath.join(parent, source))
            return "" if d == "." else d

        def manifest_child(parent_dir: str, call_name: str) -> str:
            """Downloaded dir for a registry/git call: top-level calls use
            the bare manifest key; calls made from inside a downloaded
            module use the dotted key ("vol.child")."""
            entries = manifests.get(parent_dir)
            if entries is not None:
                return entries.get(call_name, "")
            rk = manifest_dirs.get(parent_dir)
            if rk is not None:
                root, key = rk
                return manifests.get(root, {}).get(
                    f"{key}.{call_name}", ""
                )
            return ""

        by_dir: dict[str, dict[str, dict]] = {}  # dir -> path -> parsed doc
        tfvars_files: dict[str, list[str]] = {}  # dir -> tfvars paths
        # `terraform init` manifests: root dir -> {module key -> module dir},
        # plus the reverse dir -> (root, key) index so calls made FROM a
        # downloaded module resolve their nested registry children through
        # the dotted manifest keys ("vol.child").  This is how registry/git
        # module sources resolve offline — the reference evaluates the
        # downloaded .terraform/modules tree the same way
        # (pkg/iac/scanners/terraform); no network fetch here.
        import json as _json

        manifests: dict[str, dict[str, str]] = {}
        manifest_dirs: dict[str, tuple[str, str]] = {}
        for path in fs.paths():
            if _is_init_manifest(path):
                root = path[: -len(_INIT_MANIFEST)].rstrip("/")
                try:
                    doc = _json.loads(fs.read(path).decode("utf-8", "replace"))
                    entries = {}
                    for m in doc.get("Modules") or []:
                        key, mdir = m.get("Key", ""), m.get("Dir", "")
                        if key and mdir and mdir not in (".", ""):
                            full = posixpath.normpath(
                                posixpath.join(root, mdir)
                            )
                            entries[key] = full
                            manifest_dirs[full] = (root, key)
                    if entries:
                        manifests[root] = entries
                except Exception:
                    pass
                continue
            if _is_tfvars(path.rsplit("/", 1)[-1]):
                tfvars_files.setdefault(posixpath.dirname(path), []).append(
                    path
                )
                continue
            if not path.endswith(".tf"):
                continue
            try:
                doc = parse_hcl(fs.read(path).decode("utf-8", "replace"))
            except Exception:
                continue
            by_dir.setdefault(posixpath.dirname(path), {})[path] = doc

        # Terraform's variable precedence: terraform.tfvars loads first,
        # then *.auto.tfvars in lexical order (later wins).
        tfvars_by_dir: dict[str, dict] = {}
        for d, paths in tfvars_files.items():
            merged: dict = {}
            for path in sorted(
                paths,
                key=lambda p: (
                    0 if p.rsplit("/", 1)[-1] == "terraform.tfvars" else 1,
                    p,
                ),
            ):
                try:
                    doc = parse_hcl(fs.read(path).decode("utf-8", "replace"))
                except Exception:
                    continue
                merged.update(
                    {k: v for k, v in doc.items() if not k.startswith("__")}
                )
            if merged:
                tfvars_by_dir[d] = merged

        # Two passes over module calls.  Pass A: resolve WITHOUT tfvars to
        # learn which dirs are module sources (module `source` must be a
        # literal, so tfvars cannot change the topology).  Pass B:
        # re-resolve ROOT dirs only with their tfvars — terraform loads
        # tfvars for the root module alone, so a stray tfvars inside a
        # referenced child dir must influence neither its own evaluation
        # nor its grandchild module arguments.
        calls_by_dir: dict[str, dict[str, dict]] = {}
        child_dirs: set[str] = set()
        for parent_dir, docs_by_path in sorted(by_dir.items()):
            try:
                calls = self._resolved_calls(list(docs_by_path.values()))
            except Exception:
                calls = {}
            calls_by_dir[parent_dir] = calls
            for cname, blk in calls.items():
                source = str(blk.get("source", ""))
                if source.startswith(("./", "../")):
                    child_dirs.add(norm_child(parent_dir, source))
                elif source:
                    mdir = manifest_child(parent_dir, cname)
                    if mdir:
                        child_dirs.add(mdir)
        for parent_dir, values in sorted(tfvars_by_dir.items()):
            if parent_dir in child_dirs or parent_dir not in by_dir:
                continue
            try:
                calls_by_dir[parent_dir] = self._resolved_calls(
                    list(by_dir[parent_dir].values()), overrides=values
                )
            except Exception:
                pass

        misconfigs = []
        # child dir -> list of per-instantiation evaluated Misconfigurations
        per_child: dict[str, list] = {}
        # Root dirs with tfvars evaluate PER FILE with the dir-wide
        # variable scope + tfvars (ScannerWithTFVarsPaths): findings keep
        # their own file's Target instead of migrating to main.tf.
        for d, values in sorted(tfvars_by_dir.items()):
            if d not in by_dir or d in child_dirs:
                continue
            dir_vars: dict = {}
            for doc in by_dir[d].values():
                for vname, blk in (doc.get("variable") or {}).items():
                    if isinstance(blk, dict) and "default" in blk:
                        dir_vars[vname] = blk["default"]
            dir_vars.update(
                {k: v for k, v in values.items() if not k.startswith("__")}
            )
            for p in sorted(by_dir[d]):
                try:
                    doc = terraform_docs_input(
                        [by_dir[d][p]], overrides=dir_vars
                    )
                except Exception as e:
                    logger.warning(
                        "tfvars evaluation failed for %s: %s", p, e
                    )
                    continue
                mc = shared_scanner().evaluate(p, "terraform", [doc])
                if mc.failures or mc.successes:
                    misconfigs.append(mc)
        # Worklist over module instantiations so caller arguments flow
        # through CHAINS (root -> vol -> child): evaluating a child under
        # its effective arguments also re-resolves the child's own module
        # calls under those arguments and enqueues the grandchildren.
        # Dedup on (child dir, effective args) bounds recursion/cycles.
        work: list[tuple[str, str, dict]] = []
        for parent_dir, calls in sorted(calls_by_dir.items()):
            for name, blk in sorted(calls.items()):
                work.append((parent_dir, name, blk))
        seen_inst: set = set()
        budget = 2048  # runaway-cycle backstop
        while work and budget > 0:
            budget -= 1
            parent_dir, name, blk = work.pop(0)
            source = str(blk.get("source", ""))
            if source.startswith(("./", "../")):
                child_dir = norm_child(parent_dir, source)
            else:
                # Registry/git sources resolve through the
                # `terraform init` manifest (incl. dotted keys for
                # nested calls); without an entry (no init, or never
                # downloaded) the call is skipped — module downloads
                # are never performed here.
                child_dir = manifest_child(parent_dir, name)
                if not child_dir:
                    continue
            child_docs = by_dir.get(child_dir)
            if not child_docs:
                continue
            inst_key = (
                child_dir,
                tuple(sorted((k, repr(v)) for k, v in blk.items())),
            )
            if inst_key in seen_inst:
                continue
            seen_inst.add(inst_key)
            docs_sorted = [child_docs[p] for p in sorted(child_docs)]
            try:
                doc = terraform_docs_input(docs_sorted, overrides=blk)
            except Exception as e:
                logger.warning(
                    "module %s (%s) failed to evaluate: %s",
                    name, child_dir, e,
                )
                continue
            mc = shared_scanner().evaluate(
                child_dir or ".", "terraform", [doc]
            )
            per_child.setdefault(child_dir, []).append(mc)
            try:
                sub_calls = self._resolved_calls(docs_sorted, overrides=blk)
            except Exception:
                sub_calls = {}
            for sname, sblk in sorted(sub_calls.items()):
                work.append((child_dir, sname, sblk))

        for child_dir, mcs in sorted(per_child.items()):
            child_paths = sorted(by_dir.get(child_dir, {}))
            if not child_paths:
                continue
            report_path = next(
                (
                    p
                    for p in child_paths
                    if posixpath.basename(p) == "main.tf"
                ),
                child_paths[0],
            )
            # Merge across instantiations: any FAIL survives (two callers
            # of the same module must not mask each other), a check
            # PASSes only when every instantiation passed.
            merged = Misconfiguration(
                file_type="terraform", file_path=report_path
            )
            seen_failures = set()
            for mc in mcs:
                for f in mc.failures:
                    key = (f.check_id, f.message)
                    if key not in seen_failures:
                        seen_failures.add(key)
                        merged.failures.append(f)
            failed_ids = {f.check_id for f in merged.failures}
            seen_pass = set()
            for mc in mcs:
                for s in mc.successes:
                    if s.check_id not in failed_ids | seen_pass:
                        seen_pass.add(s.check_id)
                        merged.successes.append(s)
            misconfigs.append(merged)
            # The instantiated evaluation supersedes the defaults-only
            # per-file scans of EVERY child file; empty entries clear the
            # stale ones under the applier's last-write-wins merge.
            for p in child_paths:
                if p != report_path:
                    misconfigs.append(
                        Misconfiguration(file_type="terraform", file_path=p)
                    )
        if not misconfigs:
            return None
        return AnalysisResult(misconfigs=misconfigs)


register_analyzer(DockerfileAnalyzer)
register_analyzer(ConfigJsonAnalyzer)
register_analyzer(TomlConfigAnalyzer)
register_post_analyzer(HelmPostAnalyzer)
register_post_analyzer(TerraformModulePostAnalyzer)
register_analyzer(KubernetesYamlAnalyzer)
register_analyzer(TerraformAnalyzer)
