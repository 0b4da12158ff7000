"""Analyzer plugin layer: registry, group, batched dispatch.

Mirrors pkg/fanal/analyzer/analyzer.go (registry :26-27, interfaces :71-83,
group construction :315-370, AnalyzeFile fan-out :396-448, result merge :245)
— with one deliberate architectural change: the reference dispatches a
goroutine per (file × analyzer); here the group first *collects* the files
each analyzer claims, then hands batch-capable analyzers (the device secret
engine) the whole batch at once so the TPU sees large, padded, data-parallel
input instead of file-at-a-time calls.

Copied from `trivy_tpu/analyzer/core.py`; the port imports nothing from the
JAX package.  `AnalyzerOptions` and `SecretScannerOption` gain `device`
(default "cuda"), where the analyzers' engines run.  Left out: the module
manager's extension analyzers (ROADMAP A13d), the unused `parallel` and
`cache_key_extra`, which only the rekor SBOM source sets (ROADMAP A13d;
the reference hashes it into the image keys, where "" adds nothing).
`analyze_entries` keeps the reference's per-layer `disabled` seam (an
image's base layers skip the secret analyzer).  The builtin
registry holds every analyzer of the reference but its misconfig `config`
analyzers (ROADMAP A13d): secret, license-file, dpkg-license, the OS and
language package analyzers, binaries, embedded SBOMs, `executable`, the
Red Hat build info and python-pkg.  Unlike the reference, a failing batch
analyzer (the secret and license-file analyzers, whose engines run the
card's kernels) fails the scan instead of logging a warning and dropping
its files: a quiet clean report would hide the card.  Per-file analyzers
keep the reference's per-file tolerance.  Each analyzer's files run under
the host span `analyze.<type>`.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable

logger = logging.getLogger("trivy_tpu_torch.analyzer")

from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.ftypes import Secret
from trivy_tpu_torch.walker.fs import FileEntry

# ---------------------------------------------------------------------------
# Analyzer type constants (pkg/fanal/analyzer/const.go)
# ---------------------------------------------------------------------------

TYPE_SECRET = "secret"
TYPE_LICENSE_FILE = "license-file"
TYPE_OS_RELEASE = "os-release"
TYPE_APK = "apk"
TYPE_DPKG = "dpkg"
TYPE_RPM = "rpm"


@dataclass
class AnalyzerOptions:
    """analyzer.AnalyzerOptions (analyzer.go:55-66)."""

    group: str = ""
    disabled_analyzers: list[str] = field(default_factory=list)
    secret_scanner_option: "SecretScannerOption" = None  # type: ignore[assignment]
    file_patterns: dict[str, list[re.Pattern[str]]] = field(default_factory=dict)
    sbom_sources: list = field(default_factory=list)  # --sbom-sources
    # Where the analyzers' engines run ("cuda" raises without a card).
    device: str = DEFAULT_DEVICE

    def __post_init__(self) -> None:
        if self.secret_scanner_option is None:
            self.secret_scanner_option = SecretScannerOption()


@dataclass
class SecretScannerOption:
    """analyzer.SecretScannerOption."""

    config_path: str = ""
    # "auto" (hybrid: host sieve + cost-gated device verify — the product
    # default), "tpu" (all-device
    # sieve), "cpu" (oracle), "server" (raw items ship to the scan server's
    # continuous cross-request batcher — trivy_tpu_torch/serve/).
    backend: str = "auto"
    # backend == "server": where the engine lives and how to authenticate.
    server_addr: str = ""
    server_token: str = ""
    # Forwarded as the request TimeoutMs so server-side tickets inherit the
    # client's --timeout.  0 = unbounded.
    timeout_s: float = 0.0
    # Compiled-ruleset registry directory ("" = the default cache dir,
    # "off"/"none" = disabled).  Warm-started local engines skip regex
    # compilation entirely — see trivy_tpu_torch/registry/.
    rules_cache_dir: str = ""
    # Link tuning forwarded to local engines (None = engine defaults /
    # TRIVY_TPU_PIPELINE_DEPTH / TRIVY_TPU_RESIDENT_CHUNKS).
    pipeline_depth: int | None = None
    resident_chunks: int | None = None
    # backend == "server": digest of a pushed ruleset every request should
    # scan under ("" = the server's default) — per-tenant ruleset pinning
    # against the server's resident pool (trivy_tpu_torch/tenancy/).
    ruleset_select: str = ""
    # backend == "server": ask for the per-phase timing breakdown on every
    # batch response (--explain) — trivy_tpu_torch/obs/.
    explain: bool = False
    # Where a local engine runs ("cuda" raises without a card).
    device: str = DEFAULT_DEVICE


@dataclass
class AnalysisInput:
    """analyzer.AnalysisInput (analyzer.go:128-134)."""

    dir: str
    file_path: str
    size: int
    mode: int
    content: bytes


@dataclass
class AnalysisResult:
    """analyzer.AnalysisResult (analyzer.go:152-184) — merge + canonical sort."""

    os: object | None = None
    package_infos: list = field(default_factory=list)
    applications: list = field(default_factory=list)
    secrets: list[Secret] = field(default_factory=list)
    licenses: list = field(default_factory=list)
    misconfigs: list = field(default_factory=list)
    configs: list = field(default_factory=list)
    system_installed_files: list[str] = field(default_factory=list)
    build_info: dict | None = None  # Red Hat buildinfo (content sets, nvr)

    def merge(self, other: "AnalysisResult | None") -> None:
        """AnalysisResult.Merge (analyzer.go:245-313)."""
        if other is None:
            return
        if other.os is not None:
            self.os = _merge_os(self.os, other.os)
        self.package_infos.extend(other.package_infos)
        self.applications.extend(other.applications)
        self.secrets.extend(other.secrets)
        self.licenses.extend(other.licenses)
        self.misconfigs.extend(other.misconfigs)
        self.configs.extend(other.configs)
        self.system_installed_files.extend(other.system_installed_files)
        if other.build_info:
            merged = dict(self.build_info or {})
            merged.update(other.build_info)
            self.build_info = merged

    def sort(self) -> None:
        """AnalysisResult.Sort (analyzer.go:186-243); secrets :219-229."""
        self.package_infos.sort(key=lambda p: p.file_path)
        self.applications.sort(key=lambda a: a.file_path)
        for secret in self.secrets:
            secret.findings.sort(
                key=lambda f: (f.rule_id, f.start_line, f.end_line)
            )
        self.secrets.sort(key=lambda s: s.file_path)
        self.licenses.sort(key=lambda l: getattr(l, "file_path", ""))
        self.misconfigs.sort(key=lambda m: getattr(m, "file_path", ""))

    def is_empty(self) -> bool:
        return not (
            self.os
            or self.package_infos
            or self.applications
            or self.secrets
            or self.licenses
            or self.misconfigs
            or self.configs
            or self.system_installed_files
        )


def _merge_os(base, new):
    """types.OS merge semantics (pkg/fanal/types/artifact.go OS.Merge)."""
    if base is None:
        return new
    if new is None:
        return base
    merged = base
    if getattr(new, "family", ""):
        merged.family = new.family
    if getattr(new, "name", ""):
        merged.name = new.name
    if getattr(new, "extended_support", False):
        merged.extended_support = True
    return merged


class Analyzer:
    """Per-file analyzer interface (analyzer.go:71-77)."""

    def type(self) -> str:
        raise NotImplementedError

    def version(self) -> int:
        raise NotImplementedError

    def required(self, file_path: str, size: int, mode: int) -> bool:
        raise NotImplementedError

    def init(self, options: AnalyzerOptions) -> None:  # analyzer.Initializer
        pass

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        raise NotImplementedError


class BatchAnalyzer(Analyzer):
    """Batch-capable analyzer: receives every claimed file at once.

    TPU-native extension point: the secret engine implements this so blobs are
    packed/padded/tiled as one device batch instead of per-file calls.
    """

    def analyze_batch(self, inputs: list[AnalysisInput]) -> AnalysisResult | None:
        raise NotImplementedError

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        return self.analyze_batch([inp])


class PostAnalyzer:
    """analyzer.PostAnalyzer (analyzer.go:78-83): claims files during the
    walk (copied into its composite FS) and analyzes them together after
    the walk, with cross-file context (composite_fs.go / mapfs)."""

    def init(self, options: "AnalyzerOptions") -> None:
        pass

    def type(self) -> str:
        raise NotImplementedError

    def version(self) -> int:
        raise NotImplementedError

    def required(self, file_path: str, size: int, mode: int) -> bool:
        raise NotImplementedError

    def post_analyze(self, fs) -> "AnalysisResult | None":
        raise NotImplementedError


_REGISTRY: list[Callable[[], Analyzer]] = []
_POST_REGISTRY: list[Callable[[], PostAnalyzer]] = []


def register_analyzer(factory: Callable[[], Analyzer]) -> None:
    """analyzer.RegisterAnalyzer (analyzer.go:93)."""
    _REGISTRY.append(factory)


def register_post_analyzer(factory: Callable[[], PostAnalyzer]) -> None:
    """analyzer.RegisterPostAnalyzer (analyzer.go:102)."""
    _POST_REGISTRY.append(factory)


def registered_analyzers() -> list[Callable[[], Analyzer]]:
    return list(_REGISTRY)


def _ensure_builtin_registered() -> None:
    # Import modules whose import side-effect registers analyzers (mirrors the
    # reference's `_ "…/analyzer/all"` blank imports), in the reference's
    # order, which fixes the order of applications in a report; the
    # reference's `config` (misconfig, ROADMAP A13d) is left out.
    from trivy_tpu_torch.analyzer import binary as _binary  # noqa: F401
    from trivy_tpu_torch.analyzer import java as _java  # noqa: F401
    from trivy_tpu_torch.analyzer import lang as _lang  # noqa: F401
    from trivy_tpu_torch.analyzer import lang_extra as _lang_extra  # noqa: F401
    from trivy_tpu_torch.analyzer import license as _license  # noqa: F401
    from trivy_tpu_torch.analyzer import misc as _misc  # noqa: F401
    from trivy_tpu_torch.analyzer import os_release as _os  # noqa: F401
    from trivy_tpu_torch.analyzer import pkg_apk as _apk  # noqa: F401
    from trivy_tpu_torch.analyzer import pkg_dpkg as _dpkg  # noqa: F401
    from trivy_tpu_torch.analyzer import pkg_rpm as _rpm  # noqa: F401
    from trivy_tpu_torch.analyzer import secret as _secret  # noqa: F401


class AnalyzerGroup:
    """analyzer.AnalyzerGroup (analyzer.go:315-370, 396-448)."""

    def __init__(self, options: AnalyzerOptions | None = None):
        self.options = options or AnalyzerOptions()
        _ensure_builtin_registered()
        self.analyzers: list[Analyzer] = []
        for factory in _REGISTRY:
            a = factory()
            if a.type() in self.options.disabled_analyzers:
                continue
            a.init(self.options)
            self.analyzers.append(a)
        self.post_analyzers: list[PostAnalyzer] = []
        for factory in _POST_REGISTRY:
            p = factory()
            if p.type() in self.options.disabled_analyzers:
                continue
            p.init(self.options)
            self.post_analyzers.append(p)
        self._post_fs: list = [None] * len(self.post_analyzers)

    def _file_pattern_match(self, analyzer_type: str, file_path: str) -> bool:
        """--file-patterns type:regex claim override (analyzer.go
        filePatternMatch): a matching path is handed to that analyzer even
        when its own required() declines the name."""
        patterns = self.options.file_patterns.get(analyzer_type)
        return bool(patterns) and any(p.search(file_path) for p in patterns)

    def analyzer_versions(self) -> dict[str, int]:
        """AnalyzerVersions (analyzer.go:372-381) — cache-key component."""
        versions = {a.type(): a.version() for a in self.analyzers}
        versions.update({p.type(): p.version() for p in self.post_analyzers})
        for t in self.options.disabled_analyzers:
            versions.setdefault(t, 0)
        return versions

    def post_analyze(self) -> "AnalysisResult":
        """PostAnalyze over each post-analyzer's composite FS
        (analyzer.go:506 PostAnalyzerFS); clears the collected FSes so the
        group can be reused per layer."""
        result = AnalysisResult()
        for i, p in enumerate(self.post_analyzers):
            fs = self._post_fs[i]
            self._post_fs[i] = None
            if fs is None or len(fs) == 0:
                continue
            try:
                res = p.post_analyze(fs)
            except Exception:
                # One malformed tree must not abort the scan — the same
                # tolerance analyze_entries gives per-file analyzers.
                logger.warning(
                    "post-analyzer %s failed", p.type(), exc_info=True
                )
                continue
            if res is not None:
                result.merge(res)
        return result

    def analyze_entries(
        self,
        dir: str,
        entries: Iterable[FileEntry],
        disabled: set[str] | None = None,
    ) -> AnalysisResult:
        """Claim pass + batched dispatch (replaces AnalyzeFile fan-out).

        `disabled`: analyzer types suppressed for THIS call only — the
        per-layer disabling seam (base layers skip secret scanning,
        image.go:209-213)."""
        from trivy_tpu_torch import deadline
        from trivy_tpu_torch.obs import trace as obs_trace

        claims: dict[int, list[FileEntry]] = {i: [] for i in range(len(self.analyzers))}
        with obs_trace.span("analyzer.walk"):
            entries = list(entries)  # metadata + lazy openers only
        with obs_trace.span("analyzer.claim", files=len(entries)):
            self._claim(entries, claims, disabled)
        result = AnalysisResult()
        for i, a in enumerate(self.analyzers):
            deadline.check()
            batch = claims[i]
            if not batch:
                continue
            if isinstance(a, BatchAnalyzer):
                # Bound resident bytes: contents are read slice-by-slice so a
                # huge tree never sits fully in host memory (the reference
                # streams per file; we stream per device-batch).
                for slice_entries in _byte_bounded(batch, MAX_BATCH_BYTES):
                    with obs_trace.span("analyzer.read", files=len(slice_entries)):
                        inputs = _read_inputs(dir, slice_entries)
                    # No per-slice tolerance here (module docstring): an
                    # engine that fails, on the card or in its build, fails
                    # the scan with its error.
                    with obs_trace.span(f"analyze.{a.type()}", files=len(inputs)):
                        result.merge(a.analyze_batch(inputs))
            else:
                with obs_trace.span(f"analyze.{a.type()}", files=len(batch)):
                    self._analyze_each(a, dir, batch, result)
        result.sort()
        return result

    @staticmethod
    def _analyze_each(a: Analyzer, dir: str, batch: list[FileEntry],
                      result: AnalysisResult) -> None:
        for entry in batch:
            inputs = _read_inputs(dir, [entry])
            if not inputs:
                continue
            try:
                result.merge(a.analyze(inputs[0]))
            except Exception:
                # One malformed file must not abort the scan
                # (analyzer.go:415-417 tolerates per-file errors).
                logger.warning(
                    "analyzer %s failed on %s",
                    a.type(),
                    entry.path,
                    exc_info=True,
                )

    def _claim(self, entries: list[FileEntry], claims: dict[int, list[FileEntry]],
               disabled: set[str] | None = None) -> None:
        """The claim pass: each analyzer's claimed entries into `claims`,
        each post-analyzer's files into its composite FS; the `disabled`
        types claim nothing."""
        from trivy_tpu_torch import deadline

        # Analyzers exposing required_batch (the secret analyzer: batched
        # allow-path regex) answer the claim pass for all entries at once.
        batch_req: dict[int, list[bool]] = {}
        for i, a in enumerate(self.analyzers):
            if disabled and a.type() in disabled:
                continue
            rb = getattr(a, "required_batch", None)
            if rb is not None:
                batch_req[i] = rb([(e.path, e.size) for e in entries])
        for k, entry in enumerate(entries):
            deadline.check()
            for i, a in enumerate(self.analyzers):
                if disabled and a.type() in disabled:
                    continue
                br = batch_req.get(i)
                if self._file_pattern_match(a.type(), entry.path) or (
                    br[k]
                    if br is not None
                    else a.required(entry.path, entry.size, entry.mode)
                ):
                    claims[i].append(entry)
            for j, p in enumerate(self.post_analyzers):
                if disabled and p.type() in disabled:
                    continue
                if not (
                    self._file_pattern_match(p.type(), entry.path)
                    or p.required(entry.path, entry.size, entry.mode)
                ):
                    continue
                # Copy into the post-analyzer's composite FS
                # (analyzer.go:506 + composite_fs.go): the file is read now
                # — the walk's opener may not outlive this pass (layer tars).
                if self._post_fs[j] is None:
                    from trivy_tpu_torch.mapfs import MapFS

                    self._post_fs[j] = MapFS()
                try:
                    self._post_fs[j].write_file(entry.path, entry.opener())
                except OSError:
                    continue


MAX_BATCH_BYTES = 256 << 20  # per device-batch host residency cap
# Entries above this analyze in their own singleton slice: a near-100MiB
# file must not stack on top of a quarter-gigabyte of batchmates (the
# fanal cached-file role, pkg/fanal/walker/cached_file.go — the spill
# itself lives at the source layer here: registry blobs arrive as
# disk-backed SpooledTemporaryFiles, daemon exports as temp tars, and
# layer/fs openers re-read lazily from those seekable stores, so slices
# are the only place whole contents are resident).
BIG_ENTRY_BYTES = 32 << 20


def _byte_bounded(entries: list[FileEntry], max_bytes: int):
    group: list[FileEntry] = []
    total = 0
    for e in entries:
        if e.size > BIG_ENTRY_BYTES:
            # Big entries slice alone; the in-progress small-file group
            # keeps accumulating (results are merged+sorted, so yield
            # order is not load-bearing, and fragmenting small batches
            # around each big file would waste per-batch dispatch).
            yield [e]
            continue
        if group and total + e.size > max_bytes:
            yield group
            group, total = [], 0
        group.append(e)
        total += e.size
    if group:
        yield group


def _read_inputs(dir: str, entries: list[FileEntry]) -> list[AnalysisInput]:
    inputs = []
    for entry in entries:
        try:
            content = entry.opener()
        except OSError:
            continue  # per-file errors tolerated (analyzer.go:415-417)
        inputs.append(
            AnalysisInput(
                dir=dir,
                file_path=entry.path,
                size=entry.size,
                mode=entry.mode,
                content=content,
            )
        )
    return inputs
