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
document.  `config <dir>` is `fs` with `--scanners misconfig`: the IaC
analyzers (Dockerfile, Kubernetes, Terraform, CloudFormation, Helm, JSON
and TOML) run the rego checks of `iac/checks/` and those of
`--config-check` and `--checks-bundle-repository`; `--ignore-policy`
filters findings through a rego `ignore` rule, and `--trace` attaches the
checks' evaluation traces.  `--db-repository` and `--java-db-repository`
pull the DBs over OCI before the scan.  The secret analyzer's engine is the one
`engine/hybrid.py` `make_secret_engine` builds for `--secret-backend`
(default `auto`: the hybrid engine), started from the compiled-rules
registry (`--rules-cache-dir`, default `TRIVY_TPU_RULES_CACHE_DIR`, else
`~/.cache/trivy-tpu/rulesets`; "off" compiles every start); with
`--secret-backend server` the files go to a running server's batcher, and
`--server` alone is client mode (the blob goes to the server's cache, the
server applies it).  `--mesh` (default `TRIVY_TPU_MESH`) is validated and
seated in `TRIVY_TPU_MESH`, where every engine's `topology.get_mesh()`
reads it, as the reference's is; a bad spec exits 2.  `vm <disk>` scans
every ext and XFS filesystem of a raw disk image (MBR or GPT, LVM2 linear
volumes), a VMDK, or an EBS snapshot (`ebs:snap-…`, `ami:ami-…`).
`--compliance SPEC` (a builtin spec or `@path`) writes the spec's report
instead of the plain one, `--report summary|all`.  `--module-dir D` loads
extension modules (`module.py`: per-file analyzers and post-scan hooks),
and `--sbom-sources rekor [--rekor-url U]` resolves executables' packages
from their SBOM attestations in a Rekor log (`attestation.py`).

`python -m trivy_tpu_torch k8s [cluster|NAMESPACE] --kubeconfig F` scans a
cluster's workloads (misconfigurations over each manifest, RBAC with
`--scanners rbac`, and `vuln,secret` over every distinct workload image,
whose engines run on `--device`), or writes its KBOM with `-f cyclonedx`;
`python -m trivy_tpu_torch aws --service S` evaluates the checks over an
AWS account's resources.  Both start from the builtin checks alone
(`configure_shared_scanner([])`), whatever an earlier scan of the process
configured.

`python -m trivy_tpu_torch convert REPORT -f FMT` re-renders a saved JSON
report (`commands/convert.py`); `perf report|diff|gate` reads the bench
ledger (`commands/perf.py`, `obs/perfledger.py`); `version` and
`--version` print the version; `plugin install|uninstall|list|info|run`
manages subprocess plugins (`plugin.py`), and an unknown command runs the
installed plugin of that name, as in the reference, even when the config
file does not load.

`python -m trivy_tpu_torch rules compile|ls|verify|push` maintains the
registry (`commands/rules.py`; `push` installs a ruleset into a running
server).  `python -m trivy_tpu_torch server [--device cuda|cpu] ...` runs
the scan server (`rpc/server.py`: the cross-request batcher, its
failure-domain ladder, tenancy, hot reload, the debug routes, the fleet
plane under `--fleet-config`/`--fleet-member`, the watch plane under
`--watch-config`) with the reference's flags (`trivy_tpu/cli.py`
`server`), on the card by default.  `python -m trivy_tpu_torch watch
--watch-config F [--once]` runs the watch plane on a local engine
(`commands/watch.py`).  Scans take `--fleet-config` (the secret batches
route across a fleet), `--server-wire protobuf` and the remote cache
tiers (`--cache-backend redis://…|s3://…`).
"""

from __future__ import annotations

import argparse
import os
import sys

from trivy_tpu_torch import __version__
from trivy_tpu_torch.device import DEFAULT_DEVICE

# The reference CLI's backends (trivy_tpu/cli.py).
SECRET_BACKENDS = ("auto", "hybrid", "tpu", "cpu", "native", "server")
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
    plus `--device`."""
    p.add_argument("target", nargs=target_nargs)
    p.add_argument(
        "--scanners", default=_env_default("scanners", default_scanners),
        help="comma-separated: vuln,secret,misconfig,license",
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
        "items to the scan server's batcher (requires --server or "
        "--fleet-config)",
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
    p.add_argument("--trace", action="store_true", default=_bool_default("trace"),
                   help="attach rego evaluation traces to misconfiguration findings")
    p.add_argument("--trace-out", default=_env_default("trace-out", ""),
                   help="write host span timeline (Chrome-trace JSON) to this path")
    p.add_argument("--explain", action="store_true", default=_bool_default("explain"),
                   help="with --secret-backend server: print each batch's "
                   "per-phase timing breakdown after the scan")
    p.add_argument("--log-format", choices=("console", "json"),
                   default=_env_default("log-format", "console"))
    p.add_argument("--cache-dir", default=_env_default("cache-dir", ""))
    p.add_argument("--cache-backend", default=_env_default("cache-backend", "memory"),
                   help="memory | fs | redis://… | s3://…")
    p.add_argument("--cache-ttl", type=int, default=_env_num("cache-ttl", 0, int))
    p.add_argument("--server", default=_env_default("server", ""),
                   help="server address (client mode)")
    p.add_argument("--fleet-config", default=_env_default("fleet-config", ""),
                   help="fleet member YAML (client mode): route scans across the "
                   "fleet by ruleset digest with health-aware failover instead of "
                   "pinning to one --server address")
    p.add_argument("--token", default=_env_default("token", ""), help="server auth token")
    p.add_argument("--server-wire", default=_env_default("server-wire", "json"),
                   choices=["json", "protobuf"],
                   help="Twirp wire format for client mode")
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
    p.add_argument("--config-check", action="append", default=_list_default("config-check"),
                   help="directory with custom .rego checks (repeatable)")
    p.add_argument("--ignore-policy", default=_env_default("ignore-policy", ""),
                   help="rego file whose 'ignore' rule filters findings")
    p.add_argument("--checks-bundle-repository",
                   default=_env_default("checks-bundle-repository", ""),
                   help="OCI reference to pull extra .rego checks from")
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
    p.add_argument("--module-dir", default=_env_default("module-dir", ""),
                   help="directory of extension modules (custom analyzers/hooks)")
    p.add_argument("--sbom-sources", action="append", default=_list_default("sbom-sources"),
                   help="external SBOM sources: oci, rekor (rekor enables "
                   "executable digesting)")
    p.add_argument("--rekor-url", default=_env_default("rekor-url", ""),
                   help="Rekor transparency-log URL for attestation lookups")
    p.add_argument("--insecure", action="store_true", default=_bool_default("insecure"),
                   help="allow plain-http registry access (images and DB pulls)")
    p.add_argument("--username", default=_env_default("username", ""),
                   help="private registry username (TRIVY_TPU_USERNAME)")
    p.add_argument("--password", default=_env_default("password", ""),
                   help="private registry password (prefer the env var)")
    p.add_argument("--compliance", default=_env_default("compliance", ""),
                   help="compliance spec: builtin name or @/path/to/spec.yaml")
    p.add_argument("--report", choices=["summary", "all"],
                   default=_env_default("report", "summary"),
                   help="compliance report granularity")


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
        fleet_config=args.fleet_config,
        server_wire=args.server_wire,
        token=args.token,
        db_dir=args.db_dir,
        list_all_packages=args.list_all_pkgs,
        skip_db_update=args.skip_db_update,
        vex_path=args.vex,
        include_non_failures=args.include_non_failures,
        timeout=_parse_duration(args.timeout),
        ignore_policy=args.ignore_policy,
        checks_bundle_repository=args.checks_bundle_repository,
        profile_dir=args.profile_dir,
        trace=args.trace,
        trace_out=args.trace_out,
        explain=args.explain,
        config_check=list(args.config_check),
        compliance=args.compliance,
        compliance_report=args.report,
        device=args.device,
        template=args.template,
        module_dir=args.module_dir,
        sbom_sources=list(args.sbom_sources),
        rekor_url=args.rekor_url,
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
    p.add_argument("--resident-chunks", type=int,
                   default=_opt_int_default("resident-chunks"),
                   help="device-resident chunk LRU capacity for the server "
                   "engine (default 32; TRIVY_TPU_RESIDENT_CHUNKS)")
    p.add_argument("--log-format", choices=("console", "json"),
                   default=_env_default("log-format", "console"),
                   help="log line format: console (default) or one JSON object "
                   "per line with trace_id correlation")
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
        ("fleet-config", "fleet member YAML shared by every host in the fleet; "
         "turns on GET /debug/fleet, X-Trivy-Fleet-* response headers and "
         "affinity accounting"),
        ("fleet-member", "which member of --fleet-config THIS process answers as "
         "(overrides the YAML's `self:`)"),
        ("watch-config", "continuous-scanning plane YAML (event sources + "
         "verdict-delta stream); requires --cache-backend (GET /debug/watch)"),
    ):
        p.add_argument(f"--{flag}", default=_env_default(flag, ""), help=text)


def _watch_parser(sub) -> None:
    """`watch`: the reference's flags (trivy_tpu/cli.py), plus `--device`
    for the local engine."""
    p = sub.add_parser(
        "watch", help="continuously scan registry/feed changes with a local engine"
    )
    p.add_argument("--watch-config", default=_env_default("watch-config", ""),
                   help="watch-plane YAML: event sources, poll interval, "
                   "verdict-delta stream sinks (required)")
    p.add_argument("--once", action="store_true", default=_bool_default("once"),
                   help="run one poll cycle, print the JSON summary, and exit")
    p.add_argument("--cache-dir", default=_env_default("cache-dir", ""))
    p.add_argument("--cache-backend", default=_env_default("cache-backend", ""),
                   help="result-cache backend: memory | fs | redis://… | s3://… "
                   "('' = fs when --cache-dir is set, else memory)")
    p.add_argument("--cache-ttl", type=int, default=_env_num("cache-ttl", 0, int),
                   help="remote cache tier entry TTL seconds (redis/s3 backends)")
    p.add_argument("--secret-config", default=_env_default("secret-config", ""),
                   help="secret-config YAML the local engine scans with")
    p.add_argument("--rules-cache-dir", default=_env_default("rules-cache-dir", ""),
                   help="compiled-ruleset registry directory (default "
                   "~/.cache/trivy-tpu/rulesets; 'off' disables warm starts)")
    p.add_argument("--device", default=_env_default("device", DEFAULT_DEVICE),
                   help="where the local engine runs: cuda (default) or cpu")
    p.add_argument("--log-format", choices=("console", "json"),
                   default=_env_default("log-format", "console"))
    p.add_argument("--debug", action="store_true", default=_bool_default("debug"))


def _aws_parser(sub) -> None:
    """`aws`: the reference's flags (trivy_tpu/cli.py); host only."""
    p = sub.add_parser("aws", help="scan an AWS account")
    p.add_argument("--service", action="append", default=[],
                   help="services to scan (s3, ec2; repeatable; default s3)")
    p.add_argument("--region", default=_env_default("region", ""))
    p.add_argument("--endpoint", default=_env_default("endpoint", ""),
                   help="custom AWS endpoint (localstack etc.)")
    p.add_argument("-f", "--format", default=_env_default("format", "table"))
    p.add_argument("-o", "--output", default="")
    p.add_argument("--exit-code", type=int, default=_env_num("exit-code", 0, int))


def _k8s_parser(sub) -> None:
    """`k8s`: the reference's flags (trivy_tpu/cli.py), plus `--device` for
    the image scans' engines."""
    p = sub.add_parser("k8s", help="scan a kubernetes cluster")
    p.add_argument("k8s_target", nargs="?", default="cluster",
                   help="'cluster' or a namespace name")
    p.add_argument("--kubeconfig", default=_env_default("kubeconfig", ""))
    p.add_argument("--context", default="")
    p.add_argument("--scanners", default=_env_default("scanners", "misconfig"),
                   help="comma-separated: misconfig,vuln,secret,rbac")
    p.add_argument("--include-kinds", default=_env_default("include-kinds", ""),
                   help="comma-separated kind names to enumerate (Pod, Deployment, "
                   "Role, ClusterRoleBinding, ...); default: workloads, plus "
                   "RBAC kinds when the rbac scanner is enabled")
    p.add_argument("-f", "--format", default=_env_default("format", "table"))
    p.add_argument("-o", "--output", default="")
    p.add_argument("--report", choices=["summary", "all"], default="summary")
    p.add_argument("--insecure", action="store_true", default=_bool_default("insecure"))
    p.add_argument("--db-dir", default=_env_default("db-dir", ""))
    p.add_argument("--exit-code", type=int, default=_env_num("exit-code", 0, int))
    p.add_argument("--device", default=_env_default("device", DEFAULT_DEVICE),
                   help="where the image scans' engines run: cuda (default) or cpu")


def _aws_command(args) -> int:
    import json

    from trivy_tpu_torch.cloud import AwsError, AwsScanner
    from trivy_tpu_torch.iac.engine import configure_shared_scanner

    # the builtin checks alone, whatever an earlier scan in this process set
    configure_shared_scanner([], trace=False)
    try:
        scanner = AwsScanner(
            services=args.service or ["s3"],
            endpoint=args.endpoint,
            region=args.region,
        )
        misconfigs = scanner.scan()
    except AwsError as e:
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2
    failures = [f for mc in misconfigs for f in mc.failures]
    for err in scanner.errors:
        print(f"trivy-tpu: aws: {err}", file=sys.stderr)
    out = sys.stdout
    close = False
    if args.output:
        try:
            out = open(args.output, "w", encoding="utf-8")
        except OSError as e:
            print(f"trivy-tpu: cannot write {args.output}: {e}", file=sys.stderr)
            return 2
        close = True
    try:
        if args.format == "json":
            json.dump(
                {
                    "ArtifactType": "aws_account",
                    "Results": [mc.to_json() for mc in misconfigs],
                },
                out, indent=2,
            )
            out.write("\n")
        else:
            out.write("\nAWS account scan\n")
            for f in failures:
                out.write(f"{f.check_id:14} {f.severity:9} {f.message}\n")
            if not failures:
                out.write("no failed checks\n")
    finally:
        if close:
            out.close()
    if scanner.errors:
        # Degraded enumeration must not read as a clean account.
        return args.exit_code or 2
    if args.exit_code and failures:
        return args.exit_code
    return 0


def _k8s_command(args) -> int:
    import json

    from trivy_tpu_torch.iac.engine import configure_shared_scanner
    from trivy_tpu_torch.k8s import (
        K8sScanner,
        KubeClient,
        KubeConfigError,
        load_kubeconfig,
        write_k8s_report,
    )
    from trivy_tpu_torch.obs import trace as obs_trace

    # the builtin checks alone, whatever an earlier scan in this process set
    configure_shared_scanner([], trace=False)
    try:
        auth = load_kubeconfig(args.kubeconfig, args.context)
        client = KubeClient(auth)
        if args.format == "cyclonedx":
            # KBOM mode (scanner.go:63-70): emit the cluster bill of
            # materials instead of scan findings.
            from trivy_tpu_torch.k8s.kbom import build_kbom

            ns = "" if args.k8s_target == "cluster" else args.k8s_target
            doc = build_kbom(client, cluster_name=auth.server, namespace=ns)
            if args.output:
                with open(args.output, "w", encoding="utf-8") as f:
                    json.dump(doc, f, indent=2)
                    f.write("\n")
            else:
                json.dump(doc, sys.stdout, indent=2)
                print()
            return 0
        from trivy_tpu_torch.k8s.client import select_kinds

        scanners = [s for s in args.scanners.split(",") if s]
        unknown = set(scanners) - {"misconfig", "vuln", "secret", "rbac"}
        if unknown:
            # A typo'd scanner must not read as a clean cluster.
            print(
                f"trivy-tpu: unknown k8s scanners {sorted(unknown)} "
                "(expected misconfig,vuln,secret,rbac)",
                file=sys.stderr,
            )
            return 2
        kinds = select_kinds(
            [k for k in args.include_kinds.split(",") if k],
            rbac="rbac" in scanners,
            workloads=bool({"misconfig", "vuln", "secret"} & set(scanners)),
        )
        namespace = "" if args.k8s_target == "cluster" else args.k8s_target
        with obs_trace.span("k8s.list"):
            resources = client.list_workloads(namespace=namespace, kinds=kinds)
    except KubeConfigError as e:
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2
    scanner = K8sScanner(
        scanners=scanners,
        insecure_registry=args.insecure,
        db_dir=args.db_dir,
        device=args.device,
    )
    report = scanner.scan(resources, cluster_name=auth.server)
    full = args.report == "all"
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            write_k8s_report(report, args.format, full, out=f)
    else:
        write_k8s_report(report, args.format, full)
    if args.exit_code and any(r.counts() or r.error for r in report.resources):
        # Findings AND per-resource scan errors both fail the run: an
        # unreachable registry must not turn CI green.
        return args.exit_code
    return 0


def _plugin_command(args) -> int:
    from trivy_tpu_torch import plugin as plugin_mod

    try:
        if args.plugin_command == "install":
            p = plugin_mod.install(args.src)
            print(f"installed plugin {p.name} {p.version}")
        elif args.plugin_command == "uninstall":
            plugin_mod.uninstall(args.name)
            print(f"uninstalled plugin {args.name}")
        elif args.plugin_command == "list":
            for p in plugin_mod.list_plugins():
                print(f"{p.name}\t{p.version}\t{p.usage or p.description}")
        elif args.plugin_command == "info":
            p = plugin_mod.find(args.name)
            if p is None:
                print(f"trivy-tpu: plugin {args.name!r} not installed", file=sys.stderr)
                return 2
            print(f"name: {p.name}\nversion: {p.version}\n"
                  f"usage: {p.usage}\ndescription: {p.description}")
        elif args.plugin_command == "run":
            p = plugin_mod.find(args.name)
            if p is None:
                print(f"trivy-tpu: plugin {args.name!r} not installed", file=sys.stderr)
                return 2
            return p.run(list(args.plugin_args))
        else:
            print("trivy-tpu: plugin {install|uninstall|list|info|run}", file=sys.stderr)
            return 2
        return 0
    except plugin_mod.PluginError as e:
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2


def _utility_parsers(sub) -> None:
    """`convert`, `perf`, `version` and `plugin`: the reference's parsers
    (trivy_tpu/cli.py); host only."""
    p = sub.add_parser("convert", help="convert a saved JSON report")
    p.add_argument("report")
    p.add_argument("-f", "--format", default="table")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--severity", default=",".join(SEVERITIES))
    p.add_argument("--template", default="")

    p = sub.add_parser("perf", help="bench-ledger reports and regression gating")
    perf_sub = p.add_subparsers(dest="perf_command")
    ledger_help = "bench ledger JSONL (default BENCH_LEDGER_FILE or BENCH_LEDGER.jsonl)"
    cmd = perf_sub.add_parser("report", help="render the recent bench-ledger trajectory")
    cmd.add_argument("--ledger", default=_env_default("ledger", ""), help=ledger_help)
    cmd.add_argument("--limit", type=int, default=_env_num("limit", 10, int),
                     help="most-recent runs to include")
    cmd = perf_sub.add_parser("diff", help="per-metric deltas between two ledger runs")
    cmd.add_argument("--ledger", default=_env_default("ledger", ""))
    cmd.add_argument("--base", type=int, default=_env_num("base", -2, int),
                     help="base run index (negative = from the end; default -2)")
    cmd.add_argument("--head", type=int, default=_env_num("head", -1, int),
                     help="head run index (negative = from the end; default -1, "
                     "the latest run)")
    cmd = perf_sub.add_parser(
        "gate", help="exit non-zero when the latest run regresses past the "
        "baseline's per-metric tolerance")
    cmd.add_argument("--ledger", default=_env_default("ledger", ""))
    cmd.add_argument("--baseline", default=_env_default("baseline", ""),
                     help="baseline JSON with per-metric tolerances")

    sub.add_parser("version", help="print version")

    p = sub.add_parser("plugin", help="manage plugins")
    plugin_sub = p.add_subparsers(dest="plugin_command")
    plugin_sub.add_parser("install", help="install a plugin").add_argument(
        "src", help="directory, .tar.gz, or URL")
    plugin_sub.add_parser("uninstall", help="remove a plugin").add_argument("name")
    plugin_sub.add_parser("list", help="list installed plugins")
    plugin_sub.add_parser("info", help="show plugin information").add_argument("name")
    cmd = plugin_sub.add_parser("run", help="run a plugin")
    cmd.add_argument("name")
    cmd.add_argument("plugin_args", nargs=argparse.REMAINDER)


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
            resident_chunks=args.resident_chunks,
            profile_dir=args.profile_dir,
            slo_config=args.slo_config,
            flight_out=args.flight_out,
            flight_out_max_mb=args.flight_out_max_mb,
            fleet_config=args.fleet_config,
            fleet_member=args.fleet_member,
            watch_config=args.watch_config,
            device=args.device,
        )
    except ValueError as e:  # a bad cache spec, or a watch without a cache
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
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command")
    # --scanners defaults to the reference's (trivy_tpu/cli.py build_parser)
    for name, aliases, kind, scanners, text in (
        ("fs", [], TARGET_FILESYSTEM, "vuln,secret", "scan a local filesystem"),
        ("rootfs", [], TARGET_ROOTFS, "vuln", "scan an unpacked root filesystem"),
        ("repository", ["repo"], TARGET_REPOSITORY, "vuln,secret",
         "scan a git repository"),
        ("image", [], TARGET_IMAGE, "vuln,secret",
         "scan a container image: an archive, an OCI layout or a reference"),
        ("sbom", [], TARGET_SBOM, "vuln", "scan an SBOM (CycloneDX/SPDX JSON)"),
        ("vm", [], TARGET_VM, "vuln,secret", "scan a VM disk image"),
        ("config", [], TARGET_FILESYSTEM, "misconfig",
         "scan config files for misconfigurations"),
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
    _watch_parser(sub)
    _aws_parser(sub)
    _k8s_parser(sub)
    _utility_parsers(sub)
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
    # for the plugin fall-through (aliases included), so the known-command
    # set cannot drift from the subparser registry
    parser.subcommands = frozenset(sub.choices)
    return parser


def main(argv: list[str] | None = None) -> int:
    raw = list(argv) if argv is not None else sys.argv[1:]
    config_err: ConfigFileError | None = None
    parser = None
    try:
        _load_config_file(raw)  # must precede build_parser (flag defaults)
        parser = build_parser()
    except ConfigFileError as e:
        # deferred: a broken config file must not block plugin dispatch
        # (plugins do not read trivy.yaml); builtin commands still fail
        config_err = e
    if raw and not raw[0].startswith("-"):
        # an unknown top-level command falls through to an installed plugin
        # (app.go loadPluginCommands): `trivy-tpu <plugin> args...`
        known = parser.subcommands if parser is not None else frozenset()
        if raw[0] not in known:
            from trivy_tpu_torch.plugin import PluginError, find

            try:
                plugin = find(raw[0])
            except PluginError:
                plugin = None
            if plugin is not None:
                return plugin.run(raw[1:])
    if config_err is not None:
        print(f"trivy-tpu: {config_err}", file=sys.stderr)
        return 2
    args = parser.parse_args(raw)
    from trivy_tpu_torch.log import setup as setup_logging

    setup_logging(debug=getattr(args, "debug", False), quiet=getattr(args, "quiet", False),
                  no_color=getattr(args, "no_color", False),
                  log_format=getattr(args, "log_format", "console"))
    if args.command in (None, "version"):
        print(f"trivy-tpu version {__version__}")
        return 0
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
    if args.command == "watch":
        from trivy_tpu_torch.commands.watch import run_watch

        return run_watch(args)
    if args.command == "k8s":
        return _k8s_command(args)
    if args.command == "aws":
        return _aws_command(args)
    if args.command == "plugin":
        return _plugin_command(args)
    if args.command == "convert":
        from trivy_tpu_torch.commands.convert import run_convert

        return run_convert(args.report, args.format, args.output, args.severity,
                           args.template)
    if args.command == "perf":
        from trivy_tpu_torch.commands.perf import run_perf

        return run_perf(args)
    return _run_scan(parser, args)


def _run_scan(parser, args) -> int:
    from trivy_tpu_torch.commands.run import (
        CacheConfigError,
        OptionsError,
        run,
    )
    from trivy_tpu_torch.cache.redis import RedisError
    from trivy_tpu_torch.cache.s3 import S3Error
    from trivy_tpu_torch.compliance.spec import ComplianceError
    from trivy_tpu_torch.db.client import DBError
    from trivy_tpu_torch.deadline import ScanTimeoutError
    from trivy_tpu_torch.iac.rego import RegoError
    from trivy_tpu_torch.image.registry import RegistryError

    if args.secret_backend == "server" and not (args.server or args.fleet_config):
        parser.error("--secret-backend server requires --server or --fleet-config")
    if not (args.target or getattr(args, "input", "")):
        parser.error("the following arguments are required: target (or --input)")
    try:
        options = _options_from_args(args)
        if options.compliance_report not in ("summary", "all"):
            # argparse checks choices only for values given on the command
            # line, not for those from the environment or the config file
            raise ValueError(
                f"--report must be summary or all, got {options.compliance_report!r}"
            )
    except ValueError as e:  # e.g. a malformed --timeout duration
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2
    if args.command == "config":
        options.scanners = ["misconfig"]  # as the reference's, whatever --scanners says
    try:
        return run(options, args.kind)
    except (CacheConfigError, OptionsError, ScanTimeoutError,
            DBError, RegistryError, RedisError, S3Error, RegoError,
            ComplianceError) as e:
        # a cache spec, a malformed --file-patterns or --format, a timeout,
        # a DB that --skip-db-update refuses, an image or DB no source could
        # serve, a remote cache tier that fails, an ignore policy that does
        # not parse or has no `ignore` rule, a compliance spec that does not
        # load (cli.py:1224-1240); anything else (an engine that fails)
        # propagates
        print(f"trivy-tpu: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
