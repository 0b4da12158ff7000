"""Artifact runner: scan lifecycle orchestration.

Mirrors pkg/commands/artifact/run.go — Runner lifecycle (:116 NewRunner, :394
Run): cache init → scan → filter → report → exit code — minus the Go DI
ceremony; scanner wiring is plain constructors (the wire_gen.go equivalent is
`_build_scanner`).

Copied from `trivy_tpu/commands/run.py`; the port imports nothing from the
JAX package.  `Options.device` (default "cuda") is where the analyzers'
engines run.  `--profile-dir` opens a `torch.profiler` window around the
scan (CPU ops of every thread and, on a card, CUDA kernels), exported as a
Chrome trace into the directory with the host spans beside it.  The port
adds host spans (`artifact.scan`, `filter`, `write`, and the analyzer's and
artifact's) for the stage split of a run.  `Options` keeps the knobs the
port honours; a target, scanner or source that waits for another ROADMAP
item raises `NotPortedError` before the scan starts (`_check_ported`): the
protobuf wire (A13c), misconfig, `--sbom-sources rekor` and the `vm`
target (A13d).  The flags of the reference that wait for an item are
refused by the CLI (`__main__.NOT_PORTED_FLAGS`).  The `image` target
resolves an archive path, an OCI layout or a reference through the
daemon -> containerd -> podman -> registry chain (`image.resolve_image`,
under the host span `image.pull`); the `sbom` target decodes a CycloneDX
or SPDX document.  The vulnerability scanner reads a local DB (`--db-dir`,
else `<--cache-dir>/db`), pulled first from `--db-repository` and
`--java-db-repository` when they are set (the spans `db.pull`,
`javadb.pull`), under the host span `scan.vuln`.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

from trivy_tpu_torch.analyzer.core import AnalyzerOptions, SecretScannerOption
from trivy_tpu_torch.cache.store import ArtifactCache
from trivy_tpu_torch.deadline import ScanTimeoutError
from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.ftypes import ArtifactType, Report
from trivy_tpu_torch.report.writer import check_format, write_report
from trivy_tpu_torch.result.filter import SEVERITIES, FilterOptions, filter_report
from trivy_tpu_torch.scanner.service import LocalDriver, Scanner, ScanOptions
from trivy_tpu_torch.walker.fs import WalkOption

TARGET_FILESYSTEM = "fs"
TARGET_ROOTFS = "rootfs"
TARGET_IMAGE = "image"
TARGET_REPOSITORY = "repo"
TARGET_SBOM = "sbom"
TARGET_VM = "vm"

# Targets and scanners of the reference the port lacks, and the ROADMAP item
# each waits for.
NOT_PORTED_TARGETS = {TARGET_VM: "A13d"}
NOT_PORTED_SCANNERS = {"misconfig": "A13d"}
NOT_PORTED_SBOM_SOURCES = {"rekor": "A13d"}


class CacheConfigError(ValueError):
    pass


class OptionsError(ValueError):
    """Malformed flag value (the reference's xerrors out of flag parse)."""


class NotPortedError(ValueError):
    """A target, scanner, flag or format the port does not have yet."""


@dataclass
class Options:
    """The flag.Options megastruct analogue (pkg/flag/options.go:323) — only
    the knobs the port currently honors."""

    target: str = ""
    scanners: list[str] = field(default_factory=lambda: ["secret"])
    severities: list[str] = field(default_factory=lambda: list(SEVERITIES))
    format: str = "table"
    output: str = ""
    exit_code: int = 0
    cache_dir: str = ""
    cache_backend: str = "memory"
    cache_ttl: int = 0
    skip_files: list[str] = field(default_factory=list)
    skip_dirs: list[str] = field(default_factory=list)
    file_patterns: list[str] = field(default_factory=list)  # type:regex
    secret_config: str = "trivy-secret.yaml"
    secret_backend: str = "auto"  # the hybrid engine
    # --secret-backend server: pushed-ruleset digest every request scans
    # under ("" = server default) — see trivy_tpu_torch/tenancy/.
    ruleset_select: str = ""
    # Compiled-ruleset registry dir ("" = default ~/.cache/trivy-tpu/rulesets,
    # "off" disables warm starts) — trivy_tpu_torch/registry/.
    rules_cache_dir: str = ""
    # Device-link tuning (None = engine defaults / TRIVY_TPU_PIPELINE_DEPTH /
    # TRIVY_TPU_RESIDENT_CHUNKS): stage-ahead chunk count and the
    # device-resident chunk LRU capacity — trivy_tpu_torch/engine/pipeline.py.
    pipeline_depth: int | None = None
    resident_chunks: int | None = None
    ignore_file: str = ""
    server_addr: str = ""  # non-empty => client mode (remote driver)
    server_wire: str = "json"  # Twirp wire format: json (protobuf: A13c)
    token: str = ""
    db_dir: str = ""  # vulnerability DB directory (trivy-db analogue)
    list_all_packages: bool = False
    skip_db_update: bool = False
    template: str = ""  # --template for --format template
    sbom_sources: list[str] = field(default_factory=list)  # --sbom-sources (oci)
    insecure_registry: bool = False  # plain-http registry pulls
    username: str = ""  # private-registry basic/bearer credentials
    password: str = ""
    db_repository: str = ""  # OCI ref for the vuln DB (--db-repository)
    java_db_repository: str = ""  # OCI ref for the Java index DB
    vex_path: str = ""  # --vex document
    include_non_failures: bool = False
    timeout: float = 300.0  # --timeout seconds (reference default 5m)
    profile_dir: str = ""  # --profile-dir (torch.profiler trace of the scan)
    trace_out: str = ""  # --trace-out (host span Chrome-trace JSON path)
    explain: bool = False  # --explain (server-side per-phase batch timings)
    device: str = DEFAULT_DEVICE  # where the analyzers' engines run
    # repo: what a remote URL's clone checks out
    branch: str = ""
    tag: str = ""
    commit: str = ""


def _check_ported(options: Options, target_kind: str) -> None:
    """Raise NotPortedError naming the ROADMAP item for the first target,
    scanner, SBOM source or wire the port lacks; OptionsError for an
    unknown format."""
    if target_kind in NOT_PORTED_TARGETS:
        raise NotPortedError(
            f"{target_kind}: not ported yet (ROADMAP {NOT_PORTED_TARGETS[target_kind]})"
        )
    for scanner in options.scanners:
        if scanner in NOT_PORTED_SCANNERS:
            raise NotPortedError(
                f"--scanners {scanner} is not ported yet "
                f"(ROADMAP {NOT_PORTED_SCANNERS[scanner]})"
            )
    for source in options.sbom_sources:
        if source in NOT_PORTED_SBOM_SOURCES:
            raise NotPortedError(
                f"--sbom-sources {source} is not ported yet "
                f"(ROADMAP {NOT_PORTED_SBOM_SOURCES[source]})"
            )
    if options.server_wire != "json":
        raise NotPortedError(
            f"--server-wire {options.server_wire} is not ported yet (ROADMAP A13c)"
        )
    try:
        check_format(options.format)
    except ValueError as e:
        raise OptionsError(str(e)) from None


def init_cache(options: Options) -> ArtifactCache:
    if options.server_addr:
        # Client mode (run.go:349-350): analysis blobs upload to the server's
        # cache; the server owns the applier and detectors.
        from trivy_tpu_torch.rpc.client import RemoteCache

        return RemoteCache(options.server_addr, options.token, wire=options.server_wire)
    from trivy_tpu_torch.cache import build_cache

    # One backend grammar shared with the server path (cache/__init__.py).
    try:
        return build_cache(
            options.cache_backend, options.cache_dir, options.cache_ttl
        )
    except ValueError as e:
        raise CacheConfigError(str(e)) from None


def _parse_file_patterns(raw: list[str]) -> dict:
    """--file-patterns type:regex -> {type: [compiled]}  (analyzer.go
    CreateAnalyzerGroup's filePatterns parse; bad entries are hard errors,
    matching the reference's xerrors on an invalid pattern)."""
    import re

    out: dict[str, list] = {}
    for spec in raw or []:
        atype, sep, pattern = spec.partition(":")
        if not sep or not atype or not pattern:
            raise OptionsError(
                f"invalid file pattern {spec!r} (want type:regex)"
            )
        try:
            compiled = re.compile(pattern)
        except re.error as e:
            raise OptionsError(
                f"invalid file pattern regex {pattern!r}: {e}"
            ) from e
        out.setdefault(atype, []).append(compiled)
    return out


def _analyzer_options(options: Options) -> AnalyzerOptions:
    disabled = []
    # run.go:458 disabledAnalyzers: per-target analyzer disabling policy —
    # scanners not requested disable their analyzers.
    if "secret" not in options.scanners:
        disabled.append("secret")
    if "license" not in options.scanners:
        disabled.extend(["license-file", "dpkg-license"])
    # The reference's misconfig analyzers (ROADMAP A13d): the port has none,
    # but a disabled type keys the blob cache (`analyzer_versions`) as it
    # does there.
    disabled.extend(
        [
            "dockerfile",
            "kubernetes",
            "terraform",
            "config-json",
            "config-toml",
            "helm",
            "terraform-module",
        ]
    )
    # Executable digesting only serves Rekor lookups (--sbom-sources rekor,
    # ROADMAP A13d); disabled here, it stays out of the blob cache key.
    disabled.append("executable")
    return AnalyzerOptions(
        disabled_analyzers=disabled,
        secret_scanner_option=SecretScannerOption(
            config_path=options.secret_config,
            backend=options.secret_backend,
            ruleset_select=options.ruleset_select,
            server_addr=options.server_addr,
            server_token=options.token,
            timeout_s=options.timeout,
            rules_cache_dir=options.rules_cache_dir,
            pipeline_depth=options.pipeline_depth,
            resident_chunks=options.resident_chunks,
            explain=options.explain,
            device=options.device,
        ),
        file_patterns=_parse_file_patterns(options.file_patterns),
        sbom_sources=list(options.sbom_sources),
        device=options.device,
    )


def _build_scanner(options: Options, target_kind: str, cache: ArtifactCache) -> Scanner:
    """initializeFilesystemScanner etc. (wire_gen.go) without DI codegen."""
    walk_option = WalkOption(skip_files=options.skip_files, skip_dirs=options.skip_dirs)
    if target_kind in (TARGET_FILESYSTEM, TARGET_ROOTFS):
        from trivy_tpu_torch.artifact.local import LocalArtifact

        artifact = LocalArtifact(
            options.target,
            cache,
            analyzer_options=_analyzer_options(options),
            walk_option=walk_option,
            artifact_type=ArtifactType.FILESYSTEM,
        )
    elif target_kind == TARGET_IMAGE:
        from trivy_tpu_torch.artifact.image import ImageArtifact

        source = None
        if not os.path.exists(options.target):
            # Not an archive path: resolve through the daemon -> containerd
            # -> podman -> registry chain (image.go:26).
            from trivy_tpu_torch.image import resolve_image
            from trivy_tpu_torch.obs import trace as obs_trace

            with obs_trace.span("image.pull"):
                source = resolve_image(
                    options.target,
                    insecure_registry=options.insecure_registry,
                    username=options.username,
                    password=options.password,
                )
        artifact = ImageArtifact(
            options.target,
            cache,
            analyzer_options=_analyzer_options(options),
            source=source,
        )
    elif target_kind == TARGET_SBOM:
        from trivy_tpu_torch.artifact.sbom import SbomArtifact

        artifact = SbomArtifact(options.target, cache)
    elif target_kind == TARGET_REPOSITORY:
        from trivy_tpu_torch.artifact.repo import RepositoryArtifact

        artifact = RepositoryArtifact(
            options.target,
            cache,
            analyzer_options=_analyzer_options(options),
            walk_option=walk_option,
            branch=options.branch,
            tag=options.tag,
            commit=options.commit,
        )
    else:
        raise ValueError(f"unsupported target kind: {target_kind}")

    if options.server_addr:
        from trivy_tpu_torch.rpc.client import RemoteDriver

        driver = RemoteDriver(
            options.server_addr, options.token, wire=options.server_wire,
            timeout_s=options.timeout,
        )
    else:
        driver = LocalDriver(cache, vuln_detector=_init_vuln_scanner(options))
    return Scanner(artifact=artifact, driver=driver)


def _init_vuln_scanner(options: Options):
    """operation.DownloadDB analogue (operation.go:114): gate on NeedsUpdate,
    pull the OCI-distributed DB when stale (`--db-repository`; with
    --skip-db-update, check the local DB's metadata as the reference does:
    a missing or old-schema DB is a `DBError`), pull the Java index
    (`--java-db-repository`), then open the local DB."""
    from trivy_tpu_torch.obs import trace as obs_trace
    from trivy_tpu_torch.scanner.vuln import init_vuln_scanner

    if options.db_repository or options.skip_db_update:
        from trivy_tpu_torch.db.client import DEFAULT_REPOSITORY, DBClient

        # Resolve the directory the same way init_vuln_scanner will, so
        # --db-repository with only --cache-dir downloads into the dir the
        # scanner then opens.
        db_dir = options.db_dir or (
            os.path.join(options.cache_dir, "db")
            if options.cache_dir
            else os.path.expanduser("~/.cache/trivy-tpu/db")
        )
        options.db_dir = db_dir  # the scanner must open the same directory
        with obs_trace.span("db.pull"):
            DBClient(
                db_dir=db_dir,
                repository=options.db_repository or DEFAULT_REPOSITORY,
                insecure=options.insecure_registry,
            ).ensure(skip=options.skip_db_update)
    if options.java_db_repository:
        from trivy_tpu_torch import javadb

        jdir = os.path.join(
            options.db_dir
            or options.cache_dir
            or os.path.expanduser("~/.cache/trivy-tpu"),
            "java-db",
        )
        with obs_trace.span("javadb.pull"):
            javadb.ensure_javadb(
                jdir,
                repository=options.java_db_repository,
                insecure=options.insecure_registry,
            )
        javadb.set_default_javadb_dir(jdir)
    with obs_trace.span("db.open"):
        return init_vuln_scanner(options.db_dir, options.cache_dir)


def run(options: Options, target_kind: str) -> int:
    """artifact.Run (run.go:394): scan → filter → report → exit code,
    bounded by --timeout (run.go:395-402 context deadline).
    With --profile-dir, the whole scan runs inside a torch.profiler window
    (`_run_profiled`) and the host spans land beside its trace.

    The worker also arms a cooperative deadline (trivy_tpu_torch/deadline.py)
    that the analyzer dispatch checks, so the scan aborts shortly after the
    timeout instead of running on (and writing reports) in the background."""
    from trivy_tpu_torch.obs import trace as obs_trace

    _check_ported(options, target_kind)
    if options.trace_out or options.profile_dir:
        obs_trace.enable()
    if obs_trace.enabled():
        with obs_trace.span("scan", target_kind=target_kind):
            rc = _run_profiled(options, target_kind)
        if options.trace_out:
            obs_trace.dump(options.trace_out)
        if options.profile_dir:
            # Host spans land beside the device profile so Perfetto can
            # load both into one timeline.
            obs_trace.dump_into_profile_dir(options.profile_dir)
    else:
        rc = _run_profiled(options, target_kind)
    _print_explains(options)
    return rc


def _print_explains(options: Options) -> None:
    """--explain: pretty-print the per-batch phase breakdowns the server
    echoed back.  The engine instance lives deep inside the analyzer, so
    the client module accumulates them (rpc.client.LAST_EXPLAINS); stderr
    keeps the report stream (stdout / --output) machine-parseable."""
    if not options.explain:
        return
    from trivy_tpu_torch.rpc import client as rpc_client

    explains = list(rpc_client.LAST_EXPLAINS)
    if not explains:
        print("trivy-tpu: --explain: no server batches recorded "
              "(is --secret-backend server in effect?)", file=sys.stderr)
        return
    print(f"trivy-tpu: --explain: {len(explains)} server batch(es)",
          file=sys.stderr)
    for exp in explains:
        print(rpc_client.format_explain(exp), file=sys.stderr)


def _run_profiled(options: Options, target_kind: str) -> int:
    if not options.profile_dir:
        return _run_with_timeout(options, target_kind)
    # Profiling must never break the scan — and a scan error must never
    # read as a profiler error.  Start and stop (with the export) are
    # guarded SEPARATELY: either failing degrades to an unprofiled result
    # while scan exceptions pass through untouched.
    import logging
    import time

    log = logging.getLogger(__name__)
    prof = None
    try:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.device(options.device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=activities,
            # the scan runs on the timeout worker thread
            experimental_config=torch.profiler._ExperimentalConfig(
                profile_all_threads=True
            ),
        )
        prof.start()
    except Exception as e:
        log.warning("profiler start failed (%s); running unprofiled", e)
        prof = None
    try:
        return _run_with_timeout(options, target_kind)
    finally:
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(options.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    options.profile_dir,
                    f"torch-trace-{os.getpid()}-{time.time_ns()}.json",
                ))
            except Exception as e:
                log.warning("profiler stop failed: %s", e)


def _run_with_timeout(options: Options, target_kind: str) -> int:
    if options.timeout and options.timeout > 0:
        import contextvars
        import threading

        from trivy_tpu_torch import deadline as _deadline

        box: dict = {}

        def _worker() -> None:
            _deadline.set_deadline(options.timeout)
            try:
                box["rc"] = _run_inner(options, target_kind)
            except BaseException as e:  # surfaced in the caller
                box["err"] = e
            finally:
                _deadline.clear()

        # copy_context: the worker inherits the ambient trace context, so
        # engine spans nest under run()'s root `scan` span.
        ctx = contextvars.copy_context()
        t = threading.Thread(target=lambda: ctx.run(_worker), daemon=True)
        t.start()
        t.join(options.timeout)
        if t.is_alive():
            raise ScanTimeoutError(
                f"scan timed out after {options.timeout:g}s (--timeout)"
            )
        if "err" in box:
            raise box["err"]
        return box["rc"]
    return _run_inner(options, target_kind)


def _run_inner(options: Options, target_kind: str) -> int:
    from trivy_tpu_torch import deadline as _dl
    from trivy_tpu_torch.obs import trace as obs_trace

    if options.format in ("cyclonedx", "spdx", "spdx-json"):
        # SBOM outputs list every package (run.go format handling).
        options.list_all_packages = True
    if options.format == "template" and not options.template:
        print(
            "trivy-tpu: '--format template' requires '--template'",
            file=sys.stderr,
        )
        return 2
    cache = None
    try:
        cache = init_cache(options)
        scanner = _build_scanner(options, target_kind, cache)
        with obs_trace.span("artifact.scan"):
            report = scanner.scan_artifact(
                ScanOptions(
                    scanners=list(options.scanners),
                    list_all_packages=options.list_all_packages,
                )
            )
        with obs_trace.span("filter"):
            report = filter_report(
                report,
                FilterOptions(
                    severities=options.severities,
                    ignore_file=options.ignore_file,
                    vex_path=options.vex_path,
                    include_non_failures=options.include_non_failures,
                ),
            )
        _dl.check()  # a timed-out worker must not write the report
        with obs_trace.span("write"):
            _write(report, options)
        return _exit_code(report, options)
    finally:
        if cache is not None:
            cache.close()


def _write(report: Report, options: Options) -> None:
    template = options.template
    if template.startswith("@"):  # template.go `@/path/to/tpl` form
        with open(template[1:], encoding="utf-8") as f:
            template = f.read()
    if options.output:
        with open(options.output, "w", encoding="utf-8") as f:
            write_report(report, options.format, f, template=template)
    else:
        write_report(report, options.format, sys.stdout, template=template)


def _exit_code(report: Report, options: Options) -> int:
    """operation.Exit (run.go:455): non-zero exit when findings exist."""
    if options.exit_code == 0:
        return 0
    for result in report.results:
        if not result.is_empty():
            return options.exit_code
    return 0
