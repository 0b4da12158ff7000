"""`python -m trivy_tpu_torch fs|rootfs|repository <target>`: a scan through
the artifact runner (`commands/run.py`, the reference's `trivy_tpu/cli.py`
scan commands): the walker, the analyzer group (secret, license-file,
dpkg-license and the package analyzers), the local artifact and its blob
cache, the applier, the vulnerability scanner over a local DB (`--db-dir`,
else `<--cache-dir>/db`; no DB means no vulnerabilities, as in the
reference), result filtering and the report writers
(`-f table|json|sarif|cyclonedx|spdx|spdx-json|template|github|cosign-vuln`),
with the reference's flags (`_add_scan_flags`),
each bound to TRIVY_TPU_<FLAG> and to `--config trivy.yaml`, plus
`--device` (default cuda; `--device cpu` runs the plain versions).
`--scanners` defaults to the reference's: `vuln,secret` for `fs`, `repo`
and `image`, `vuln` for `rootfs` and `sbom`.  `image [--input PATH | REF]`
scans a docker archive, an OCI layout, or an image resolved through the
docker, containerd, podman and registry sources (`--insecure`,
`--username`, `--password`; `--sbom-sources oci` takes a referrer SBOM
instead of walking the layers); `sbom PATH` scans a CycloneDX or SPDX
document.  `--db-repository` and `--java-db-repository` pull the DBs over
OCI before the scan.  The secret analyzer's engine is the one
`engine/hybrid.py` `make_secret_engine` builds for `--secret-backend`
(default `auto`: the hybrid engine), started from the compiled-rules
registry (`--rules-cache-dir`, default `TRIVY_TPU_RULES_CACHE_DIR`, else
`~/.cache/trivy-tpu/rulesets`; "off" compiles every start); with
`--secret-backend server` the files go to a running server's batcher, and
`--server` alone is client mode (the blob goes to the server's cache, the
server applies it).  `--mesh` (default `TRIVY_TPU_MESH`) is validated and
seated in `TRIVY_TPU_MESH`, where every engine's `topology.get_mesh()`
reads it, as the reference's is; a bad spec exits 2.  A target, scanner,
flag or format that waits for a ROADMAP item exits 2 naming it
(`commands/run.py` `NOT_PORTED`), as does the `vm` command.

`python -m trivy_tpu_torch rules compile|ls|verify|push` maintains the
registry (`commands/rules.py`; `push` installs a ruleset into a running
server).  `python -m trivy_tpu_torch server [--device cuda|cpu] ...` runs
the scan server (`rpc/server.py`: the cross-request batcher, its
failure-domain ladder, tenancy, hot reload, the debug routes) with the
reference's flags (`trivy_tpu/cli.py` `server`), on the card by default.
"""

from __future__ import annotations

import argparse
import os
import sys

from trivy_tpu_torch.device import DEFAULT_DEVICE

# The reference CLI's backends (trivy_tpu/cli.py).
SECRET_BACKENDS = ("auto", "hybrid", "tpu", "cpu", "native", "server")
# What the port lacks of the reference CLI's server, and the ROADMAP item
# it waits for.
NOT_PORTED = {"--fleet-config": "A13c", "--watch-config": "A13c"}
# The reference's scan flags whose feature waits for a ROADMAP item: they
# parse as the reference's and, set, make the scan exit 2 naming the item.
NOT_PORTED_FLAGS = {
    "fleet-config": "A13c", "ignore-policy": "A13d", "checks-bundle-repository": "A13d",
    "config-check": "A13d", "compliance": "A13d", "module-dir": "A13d",
    "rekor-url": "A13d", "trace": "A13d",
}
SEVERITIES = ["UNKNOWN", "LOW", "MEDIUM", "HIGH", "CRITICAL"]

# Config-file layer (the viper config file, pkg/flag/*): values from
# trivy.yaml (or --config FILE) sit under env vars, which sit under explicit
# CLI flags — flag > env > config file > built-in default.
_CONFIG_FILE: dict[str, object] = {}


class ConfigFileError(ValueError):
    pass


def _load_config_file(argv) -> None:
    """Pre-pass: find --config (default ./trivy.yaml) and flatten it.

    Nested groups flatten with dashes ({"db": {"repository": R}} ->
    "db-repository"), matching the reference's dotted config keys."""
    global _CONFIG_FILE
    _CONFIG_FILE = {}
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument(
        "--config", default=os.environ.get("TRIVY_TPU_CONFIG", "trivy.yaml")
    )
    known, _ = pre.parse_known_args(argv)
    if not os.path.exists(known.config):
        return
    import yaml

    try:
        with open(known.config, encoding="utf-8") as f:
            doc = yaml.safe_load(f) or {}
    except (OSError, yaml.YAMLError) as e:
        # A broken config file must fail the run, not silently fall back to
        # defaults (the reference's viper load is a hard error).
        raise ConfigFileError(f"bad config file {known.config}: {e}") from e
    flat: dict[str, object] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}-", v)
        else:
            flat[prefix[:-1]] = node

    walk("", doc if isinstance(doc, dict) else {})
    _CONFIG_FILE = flat


def _env_default(name: str, default):
    """TRIVY_TPU_<NAME> when set, else the config file's value, else
    `default`."""
    env = os.environ.get(f"TRIVY_TPU_{name.upper().replace('-', '_')}")
    if env is not None:
        return env
    val = _CONFIG_FILE.get(name)
    if val is None:
        return default
    if isinstance(val, list):
        return ",".join(str(v) for v in val)
    return val


def _env_num(name: str, default, kind=float):
    """`_env_default` parsed as `kind` (the reference's `_float_default`
    and `_int_default`)."""
    val = _env_default(name, default)
    try:
        return kind(val)
    except (TypeError, ValueError) as e:
        raise ConfigFileError(
            f"{name} must be a number, got {val!r} (env/config)"
        ) from e


def _opt_int_default(name: str) -> int | None:
    """Like `_env_num` but with no built-in fallback: None means "flag
    absent, let the engine pick its own default"."""
    val = _env_default(name, None)
    if val is None or val == "":
        return None
    return _env_num(name, val, int)


def _bool_default(name: str, default: bool = False) -> bool:
    val = _env_default(name, default)
    if isinstance(val, bool):
        return val
    return str(val).strip().lower() in ("1", "true", "yes", "on")


def _list_default(name: str) -> list[str]:
    return [s for s in str(_env_default(name, "")).split(",") if s]


def _parse_duration(s) -> float:
    """"300", "300s", "5m", "1h30m" -> seconds (flag.DurationFlag)."""
    if isinstance(s, (int, float)):
        return float(s)
    total = 0.0
    num = ""
    units = {"s": 1, "m": 60, "h": 3600}
    for ch in str(s).strip():
        if ch.isdigit() or ch == ".":
            num += ch
        elif ch in units and num:
            total += float(num) * units[ch]
            num = ""
        else:
            raise ValueError(f"bad duration: {s!r}")
    if num:
        total += float(num)
    return total


def _add_scan_flags(p: argparse.ArgumentParser, default_scanners: str,
                    target_nargs: str | None = None) -> None:
    """The reference's scan flags (`trivy_tpu/cli.py` `_add_scan_flags`),
    plus `--device`.  Flags whose feature waits for a ROADMAP item parse as
    the reference's do and make the run exit 2 naming the item."""
    p.add_argument("target", nargs=target_nargs)
    p.add_argument(
        "--scanners", default=_env_default("scanners", default_scanners),
        help="comma-separated: vuln,secret,license (misconfig: ROADMAP A13d)",
    )
    p.add_argument("--severity", default=_env_default("severity", ",".join(SEVERITIES)),
                   help="comma-separated severities to report")
    p.add_argument("-f", "--format", default=_env_default("format", "table"),
                   help="table (default), json, sarif, cyclonedx, spdx, spdx-json, "
                   "template, github or cosign-vuln")
    p.add_argument("-o", "--output", default=_env_default("output", ""))
    p.add_argument("--exit-code", type=int, default=_env_num("exit-code", 0, int))
    for flag in ("skip-files", "skip-dirs"):
        p.add_argument(f"--{flag}", action="append", default=_list_default(flag))
    p.add_argument(
        "--file-patterns", action="append", default=_list_default("file-patterns"),
        help="analyzer file-name override, repeatable: type:regex "
        "(e.g. secret:.*\\.conf)",
    )
    p.add_argument("--secret-config",
                   default=_env_default("secret-config", "trivy-secret.yaml"))
    p.add_argument(
        "--secret-backend", choices=SECRET_BACKENDS,
        default=_env_default("secret-backend", "auto"),
        help="auto = hybrid (host pre-sieve + verify on the device + confirm), "
        "tpu = the all-device sieve engine, native = the device engine over "
        "the C++ host row sieve, cpu = oracle engine, server = ship raw "
        "items to the scan server's batcher (requires --server)",
    )
    p.add_argument("--device", default=_env_default("device", DEFAULT_DEVICE),
                   help="where the engines run: cuda (default) or cpu")
    p.add_argument("--ruleset", default=_env_default("ruleset", ""),
                   help="with --secret-backend server: digest of a pushed ruleset")
    p.add_argument(
        "--rules-cache-dir", default=_env_default("rules-cache-dir", ""),
        help="compiled-ruleset registry directory (default "
        "~/.cache/trivy-tpu/rulesets; 'off' disables warm starts)",
    )
    p.add_argument("--pipeline-depth", type=int, default=_opt_int_default("pipeline-depth"),
                   help="chunks staged ahead in the device upload pipeline")
    p.add_argument("--resident-chunks", type=int,
                   default=_opt_int_default("resident-chunks"),
                   help="device-resident chunk LRU capacity: repeated chunks "
                   "skip the host-device link (default 32)")
    p.add_argument(
        "--mesh", default=_env_default("mesh", ""),
        help="device mesh for data-parallel scans: N or NxM devices, 'auto' "
        "(mesh only on a host with several cards), 'none' to force "
        "single-device (default auto; TRIVY_TPU_MESH)",
    )
    p.add_argument("--ignorefile", default=_env_default("ignorefile", ".trivyignore"))
    for flag in ("debug", "quiet", "no-color"):
        p.add_argument(f"--{flag}", *(["-q"] if flag == "quiet" else []),
                       action="store_true", default=_bool_default(flag))
    p.add_argument("--profile-dir", default=_env_default("profile-dir", ""),
                   help="write a torch.profiler trace of the scan (CUDA kernels "
                   "on a card) and the host spans to this directory")
    p.add_argument("--trace-out", default=_env_default("trace-out", ""),
                   help="write host span timeline (Chrome-trace JSON) to this path")
    p.add_argument("--explain", action="store_true", default=_bool_default("explain"),
                   help="with --secret-backend server: print each batch's "
                   "per-phase timing breakdown after the scan")
    p.add_argument("--log-format", choices=("console", "json"),
                   default=_env_default("log-format", "console"))
    p.add_argument("--cache-dir", default=_env_default("cache-dir", ""))
    p.add_argument("--cache-backend", default=_env_default("cache-backend", "memory"),
                   help="memory | fs (redis and s3: ROADMAP A13c)")
    p.add_argument("--cache-ttl", type=int, default=_env_num("cache-ttl", 0, int))
    p.add_argument("--server", default=_env_default("server", ""),
                   help="server address (client mode)")
    p.add_argument("--token", default=_env_default("token", ""), help="server auth token")
    p.add_argument("--server-wire", default=_env_default("server-wire", "json"),
                   choices=["json", "protobuf"],
                   help="Twirp wire format for client mode (protobuf: ROADMAP A13c)")
    p.add_argument("--db-dir", default=_env_default("db-dir", ""),
                   help="vulnerability DB directory (default <cache-dir>/db)")
    p.add_argument("--list-all-pkgs", action="store_true",
                   default=_bool_default("list-all-pkgs"))
    p.add_argument("--skip-db-update", action="store_true",
                   default=_bool_default("skip-db-update"))
    p.add_argument("--vex", default=_env_default("vex", ""),
                   help="OpenVEX/CycloneDX/CSAF VEX document")
    p.add_argument("--include-non-failures", action="store_true",
                   default=_bool_default("include-non-failures"))
    p.add_argument("--timeout", default=_env_default("timeout", "5m"),
                   help="scan timeout, e.g. 300s / 5m / 1h (default 5m)")
    p.add_argument("--config", default=os.environ.get("TRIVY_TPU_CONFIG", "trivy.yaml"),
                   help="YAML config file merged under flags and env vars")
    p.add_argument("--template", default=_env_default("template", ""),
                   help="template for -f template (@FILE reads it from a file)")
    p.add_argument("--db-repository", default=_env_default("db-repository", ""),
                   help="OCI reference to pull the vulnerability DB from")
    p.add_argument("--java-db-repository", default=_env_default("java-db-repository", ""),
                   help="OCI reference to pull the Java index DB from")
    p.add_argument("--sbom-sources", action="append", default=_list_default("sbom-sources"),
                   help="external SBOM sources: oci (rekor: ROADMAP A13d)")
    p.add_argument("--insecure", action="store_true", default=_bool_default("insecure"),
                   help="allow plain-http registry access (images and DB pulls)")
    p.add_argument("--username", default=_env_default("username", ""),
                   help="private registry username (TRIVY_TPU_USERNAME)")
    p.add_argument("--password", default=_env_default("password", ""),
                   help="private registry password (prefer the env var)")
    for flag in NOT_PORTED_FLAGS:
        if flag == "config-check":
            p.add_argument(f"--{flag}", action="append", default=_list_default(flag))
        elif flag == "trace":
            p.add_argument(f"--{flag}", action="store_true", default=_bool_default(flag))
        else:
            p.add_argument(f"--{flag}", default=_env_default(flag, ""))


def _options_from_args(args: argparse.Namespace):
    from trivy_tpu_torch.commands.run import Options

    return Options(
        target=getattr(args, "input", "") or args.target,
        scanners=[s for s in args.scanners.split(",") if s],
        severities=[s for s in args.severity.upper().split(",") if s],
        format=args.format,
        output=args.output,
        exit_code=args.exit_code,
        cache_dir=args.cache_dir,
        cache_backend=args.cache_backend,
        cache_ttl=args.cache_ttl,
        skip_files=args.skip_files,
        skip_dirs=args.skip_dirs,
        file_patterns=list(args.file_patterns),
        secret_config=args.secret_config,
        secret_backend=args.secret_backend,
        ruleset_select=args.ruleset,
        rules_cache_dir=args.rules_cache_dir,
        pipeline_depth=args.pipeline_depth,
        resident_chunks=args.resident_chunks,
        ignore_file=args.ignorefile if os.path.exists(args.ignorefile) else "",
        server_addr=args.server,
        server_wire=args.server_wire,
        token=args.token,
        db_dir=args.db_dir,
        list_all_packages=args.list_all_pkgs,
        skip_db_update=args.skip_db_update,
        vex_path=args.vex,
        include_non_failures=args.include_non_failures,
        timeout=_parse_duration(args.timeout),
        profile_dir=args.profile_dir,
        trace_out=args.trace_out,
        explain=args.explain,
        device=args.device,
        template=args.template,
        sbom_sources=list(args.sbom_sources),
        insecure_registry=args.insecure,
        username=args.username,
        password=args.password,
        db_repository=args.db_repository,
        java_db_repository=args.java_db_repository,
        branch=getattr(args, "branch", ""),
        tag=getattr(args, "tag", ""),
        commit=getattr(args, "commit", ""),
    )


def _server_parser(sub) -> None:
    """`server`: the reference's flags (trivy_tpu/cli.py), each bound to
    TRIVY_TPU_<FLAG>, plus `--device`."""
    p = sub.add_parser("server", help="run the scan server")
    p.add_argument("--listen", default="localhost:4954")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the server's engines run: cuda (default) or cpu")
    p.add_argument("--cache-dir", default="")
    p.add_argument("--cache-backend", default=_env_default("cache-backend", ""),
                   help="server artifact/result cache: memory | fs ('' = fs when "
                   "--cache-dir is set, else memory); an explicit backend also "
                   "turns on the result cache")
    p.add_argument("--cache-ttl", type=int, default=_env_num("cache-ttl", 0, int))
    p.add_argument("--token", default="")
    p.add_argument("--db-dir", default="")
    for flag, kind, default, text in (
        ("batch-window-ms", float, 4.0, "fill-or-timeout coalescing window for the "
         "secret batcher"),
        ("max-batch-bytes", int, 8 << 20, "dispatch a batch early once its payload "
         "reaches this size"),
        ("max-queue-depth", int, 256, "admission queue bound; beyond it requests get "
         "429 + Retry-After"),
        ("max-inflight-per-client", int, 8, "per-client in-flight ticket cap"),
        ("max-resident-rulesets", int, 4, "compiled-ruleset LRU slots kept resident "
         "for per-request ruleset selection"),
        ("max-resident-mb", int, 0, "estimated device MB cap across resident "
         "rulesets (0 = count-bounded only)"),
        ("tenant-rps", float, 0.0, "default per-tenant requests/s quota (0 = "
         "unlimited)"),
        ("tenant-burst", float, 0.0, "per-tenant request token-bucket depth"),
        ("tenant-bytes-per-sec", float, 0.0, "default per-tenant payload bytes/s "
         "quota (0 = unlimited)"),
        ("tenant-bytes-burst", float, 0.0, "per-tenant byte token-bucket depth"),
        ("max-tenant-series", int, 16, "tenants with their own metric series"),
        ("flight-out-max-mb", float, 64.0, "size cap on the --flight-out file"),
        ("hbm-soft-pct", float, 85.0, "device-memory soft watermark, %% of the "
         "card's memory: above it admission evicts resident rulesets"),
        ("hbm-hard-pct", float, 95.0, "device-memory hard watermark: above it new "
         "submissions get 429 + Retry-After"),
        ("breaker-threshold", int, 3, "device-dispatch failures inside the window "
         "before the breaker opens"),
        ("breaker-window-s", float, 30.0, "sliding window the breaker counts "
         "failures over"),
        ("breaker-cooldown-s", float, 5.0, "open -> half-open probe timer"),
    ):
        p.add_argument(f"--{flag}", type=kind, default=_env_num(flag, default, kind),
                       help=text)
    pipeline_depth = _env_default("pipeline-depth", "")
    p.add_argument("--pipeline-depth", type=int,
                   default=int(pipeline_depth) if pipeline_depth else None,
                   help="chunks staged ahead in the server engine's pipeline")
    for flag, text in (
        ("slo-config", "YAML per-method latency/error objectives"),
        ("flight-out", "append flight-recorder breach records to this JSONL file"),
        ("secret-config", "secret-config the server engine loads; SIGHUP or POST "
         "/admin/ruleset/reload re-reads it and hot-swaps at a batch boundary"),
        ("rules-cache-dir", "compiled-ruleset registry directory (default "
         "~/.cache/trivy-tpu/rulesets; 'off' disables warm starts)"),
        ("mesh", "device mesh for the server's engines: N or NxM devices, 'auto', "
         "'none' (TRIVY_TPU_MESH)"),
        ("profile-dir", "default output directory for POST /admin/profile/start "
         "windows (torch.profiler trace + host spans)"),
        ("fleet-config", f"fleet member YAML (not ported: ROADMAP "
         f"{NOT_PORTED['--fleet-config']})"),
        ("watch-config", f"continuous-scanning plane YAML (not ported: ROADMAP "
         f"{NOT_PORTED['--watch-config']})"),
    ):
        p.add_argument(f"--{flag}", default=_env_default(flag, ""), help=text)


def _run_server(args) -> int:
    from trivy_tpu_torch.registry.store import resolve_rules_cache_dir
    from trivy_tpu_torch.rpc.server import serve
    from trivy_tpu_torch.serve import ServeConfig

    try:
        serve(
            args.listen,
            cache_dir=args.cache_dir,
            cache_backend=args.cache_backend,
            cache_ttl=args.cache_ttl,
            token=args.token,
            db_dir=args.db_dir,
            serve_config=ServeConfig(
                batch_window_ms=args.batch_window_ms,
                max_batch_bytes=args.max_batch_bytes,
                max_queue_depth=args.max_queue_depth,
                max_inflight_per_client=args.max_inflight_per_client,
                max_resident_rulesets=args.max_resident_rulesets,
                max_resident_bytes=args.max_resident_mb << 20,
                tenant_rps=args.tenant_rps,
                tenant_burst=args.tenant_burst,
                tenant_bytes_per_s=args.tenant_bytes_per_sec,
                tenant_bytes_burst=args.tenant_bytes_burst,
                max_tenant_series=args.max_tenant_series,
                hbm_soft_pct=args.hbm_soft_pct,
                hbm_hard_pct=args.hbm_hard_pct,
                breaker_threshold=args.breaker_threshold,
                breaker_window_s=args.breaker_window_s,
                breaker_cooldown_s=args.breaker_cooldown_s,
            ),
            secret_config=args.secret_config,
            rules_cache_dir=resolve_rules_cache_dir(args.rules_cache_dir),
            pipeline_depth=args.pipeline_depth,
            profile_dir=args.profile_dir,
            slo_config=args.slo_config,
            flight_out=args.flight_out,
            flight_out_max_mb=args.flight_out_max_mb,
            fleet_config=args.fleet_config,
            watch_config=args.watch_config,
            device=args.device,
        )
    except ValueError as e:  # a flag the port lacks, or a bad cache spec
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2
    return 0


def build_parser() -> argparse.ArgumentParser:
    from trivy_tpu_torch.commands.run import (
        TARGET_FILESYSTEM,
        TARGET_IMAGE,
        TARGET_REPOSITORY,
        TARGET_ROOTFS,
        TARGET_SBOM,
        TARGET_VM,
    )

    parser = argparse.ArgumentParser(prog="trivy_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    # --scanners defaults to the reference's (trivy_tpu/cli.py build_parser)
    for name, aliases, kind, scanners, text in (
        ("fs", [], TARGET_FILESYSTEM, "vuln,secret", "scan a local filesystem"),
        ("rootfs", [], TARGET_ROOTFS, "vuln", "scan an unpacked root filesystem"),
        ("repository", ["repo"], TARGET_REPOSITORY, "vuln,secret",
         "scan a git repository"),
        ("image", [], TARGET_IMAGE, "vuln,secret",
         "scan a container image: an archive, an OCI layout or a reference"),
        ("sbom", [], TARGET_SBOM, "vuln", "scan an SBOM (CycloneDX/SPDX JSON)"),
        ("vm", [], TARGET_VM, "vuln,secret", "scan a VM disk image (ROADMAP A13d)"),
    ):
        p = sub.add_parser(name, aliases=aliases, help=text)
        # `image --input PATH` needs no positional target
        _add_scan_flags(p, scanners, "?" if kind == TARGET_IMAGE else None)
        if kind == TARGET_IMAGE:
            p.add_argument("--input", default="",
                           help="tar archive path (docker save / OCI layout)")
        if kind == TARGET_REPOSITORY:
            for flag in ("branch", "tag", "commit"):
                p.add_argument(f"--{flag}", default="")
        p.set_defaults(kind=kind)
    _server_parser(sub)
    rules = sub.add_parser("rules", help="manage the compiled-ruleset registry")
    rules_sub = rules.add_subparsers(dest="rules_command")
    for name, text in (("compile", "compile a secret-config into the cache"),
                       ("ls", "list cached compiled artifacts"),
                       ("verify", "prove a cached artifact round-trips to "
                                  "byte-identical findings on the builtin corpus"),
                       ("push", "compile a secret-config and install it into a "
                                "running server's registry by digest")):
        cmd = rules_sub.add_parser(name, help=text)
        cmd.add_argument("--rules-cache-dir", default=_env_default("rules-cache-dir", ""))
        if name != "ls":
            cmd.add_argument("--secret-config", default=_env_default("secret-config", ""))
        if name in ("compile", "verify"):
            cmd.add_argument("--device", default=DEFAULT_DEVICE)
        if name == "push":
            cmd.add_argument("--server", default=_env_default("server", ""),
                             help="server address (host:port or URL); required")
            cmd.add_argument("--token", default=_env_default("token", ""))
            cmd.add_argument("--compile-on-server", action="store_true",
                             help="ship only the YAML and let the server compile")
            cmd.add_argument("--no-admit", action="store_true",
                             help="register the ruleset without making it resident")
        if name == "compile":
            cmd.add_argument("--warmup", action="store_true",
                             help="also build or load every kernel library a device "
                             "engine launches and, on a card, launch its sieve once a bucket")
    return parser


def main(argv: list[str] | None = None) -> int:
    raw = list(argv) if argv is not None else sys.argv[1:]
    try:
        _load_config_file(raw)  # must precede build_parser (flag defaults)
        parser = build_parser()
    except ConfigFileError as e:
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2
    args = parser.parse_args(raw)
    if getattr(args, "mesh", ""):
        # validated here, so a typo'd spec is a usage error, not a mid-scan
        # ValueError; seated where every engine's get_mesh() reads it
        from trivy_tpu_torch.mesh import topology as mesh_topology

        try:
            mesh_topology.parse_spec(args.mesh)
        except ValueError as e:
            print(f"trivy-tpu: {e}", file=sys.stderr)
            return 2
        os.environ["TRIVY_TPU_MESH"] = args.mesh
    if args.command == "rules":
        from trivy_tpu_torch.commands.rules import run_rules

        return run_rules(args)
    if args.command == "server":
        return _run_server(args)
    return _run_scan(parser, args)


def _run_scan(parser, args) -> int:
    from trivy_tpu_torch.commands.run import (
        CacheConfigError,
        NotPortedError,
        OptionsError,
        run,
    )
    from trivy_tpu_torch.db.client import DBError
    from trivy_tpu_torch.deadline import ScanTimeoutError
    from trivy_tpu_torch.image.registry import RegistryError
    from trivy_tpu_torch.log import setup as setup_logging

    setup_logging(debug=args.debug, quiet=args.quiet, no_color=args.no_color,
                  log_format=args.log_format)
    if args.secret_backend == "server" and not args.server:
        parser.error("--secret-backend server requires --server")
    if not (args.target or getattr(args, "input", "")):
        parser.error("the following arguments are required: target (or --input)")
    try:
        options = _options_from_args(args)
    except ValueError as e:  # e.g. a malformed --timeout duration
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2
    try:
        for flag, item in NOT_PORTED_FLAGS.items():
            if getattr(args, flag.replace("-", "_")):
                raise NotPortedError(f"--{flag} is not ported yet (ROADMAP {item})")
        return run(options, args.kind)
    except (CacheConfigError, OptionsError, NotPortedError, ScanTimeoutError,
            DBError, RegistryError) as e:
        # a cache spec, a malformed --file-patterns, a target, flag or
        # source that waits for a ROADMAP item, a timeout, a DB that
        # --skip-db-update refuses, an image or DB no source could serve
        # (cli.py:1224-1240);
        # anything else (an engine that fails) propagates
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
