"""`python -m trivy_tpu_torch fs --scanners secret [--secret-config F]
[--format json] [--secret-backend auto|hybrid|tpu|cpu|native]
[--device cuda|cpu] [--rules-cache-dir D] [--mesh N|NxM|auto|none]
[--server ADDR [--token T]] <dir>`:
a filesystem secret scan
through the engine that `engine/hybrid.py` `make_secret_engine` builds for
the backend (default `auto`: the hybrid engine, as `trivy_tpu`'s CLI),
printed as Trivy's JSON report (SchemaVersion 2, one `Results[]` entry of
Class "secret" per file with findings).  Like the reference, the backend's
default comes from `TRIVY_TPU_SECRET_BACKEND`, and the engine starts from
the compiled-rules registry (`--rules-cache-dir`, default
`TRIVY_TPU_RULES_CACHE_DIR`, else `~/.cache/trivy-tpu/rulesets`; "off"
compiles every start).  `--mesh` (default `TRIVY_TPU_MESH`) is validated
and seated in `TRIVY_TPU_MESH`, where every engine's `topology.get_mesh()`
reads it, as the reference's is; a bad spec exits 2.  With
`--secret-backend server` the files go to a running server's batcher
(`rpc/client.py` `RemoteSecretEngine`) and no engine is built here.
`python -m trivy_tpu_torch rules compile|ls|verify|push`
maintains the registry (`commands/rules.py`; `push` installs a ruleset into
a running server).  `python -m trivy_tpu_torch server [--device cuda|cpu]
...` runs the scan server (`rpc/server.py`: the cross-request batcher, its
failure-domain ladder, tenancy, hot reload, the debug routes) with the
reference's flags (`trivy_tpu/cli.py` `server`), on the card by default.
What waits for a ROADMAP item is in `NOT_PORTED`.

The walk keeps the reference secret analyzer's gates
(`trivy_tpu/analyzer/secret.py`, pkg/fanal/analyzer/secret/secret.go:28-153):
skip lists, the allow-path rules, the binary sniff, and `\\r` stripping.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.rules.model import load_config

SCHEMA_VERSION = 2

# The reference CLI's backends (trivy_tpu/cli.py).
SECRET_BACKENDS = ("auto", "hybrid", "tpu", "cpu", "native", "server")
# What the port lacks of the reference CLI's secret scan and server, and
# the ROADMAP item it waits for.
NOT_PORTED = {"--fleet-config": "A13c", "--watch-config": "A13c"}

# secret.go:28-42
SKIP_FILES = {
    "go.mod",
    "go.sum",
    "package-lock.json",
    "yarn.lock",
    "pnpm-lock.yaml",
    "Pipfile.lock",
    "Gemfile.lock",
}
SKIP_DIRS = {".git", "node_modules"}
SKIP_EXTS = {
    ".jpg", ".png", ".gif", ".doc", ".pdf", ".bin", ".svg", ".socket",
    ".deb", ".rpm", ".zip", ".gz", ".gzip", ".tar", ".pyc",
}

# Bytes the reference's control-byte heuristic accepts as text.
_TEXT_BYTES = bytes(
    b
    for b in range(256)
    if not (
        b < 7 or b == 11 or (13 < b < 27) or (27 < b < 0x20) or b == 0x7F
    )
)


def is_binary(head: bytes) -> bool:
    """utils.IsBinary control-byte heuristic over the first 300 bytes
    (pkg/fanal/utils/utils.go:76-93)."""
    return bool(head[:300].translate(None, _TEXT_BYTES))


def _config_skip_paths(config_path: str) -> frozenset[str]:
    """The secret config's basename and normalized relative path: the scan
    skips the config file itself (secret.go:138)."""
    if not config_path:
        return frozenset()
    norm = os.path.normpath(config_path).replace(os.sep, "/")
    if norm.startswith("./"):
        norm = norm[2:]
    return frozenset({os.path.basename(config_path), norm})


def collect(root: str, ruleset, config_path: str = "") -> list[tuple[str, bytes]]:
    """(relative path, content) of every file the secret analyzer scans,
    in walk order."""
    cfg_skips = _config_skip_paths(config_path)
    items = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS)
        for fname in sorted(filenames):
            full = os.path.join(dirpath, fname)
            if not os.path.isfile(full) or os.path.islink(full):
                continue
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            if os.path.getsize(full) < 10 or fname in SKIP_FILES:
                continue
            if rel in cfg_skips or os.path.splitext(fname)[1] in SKIP_EXTS:
                continue
            if ruleset.allow_path(rel):
                continue
            with open(full, "rb") as f:
                content = f.read()
            if is_binary(content):
                continue
            items.append((rel, content.replace(b"\r", b"")))
    return items


def _report(target: str, secrets) -> dict:
    results = [
        {
            "Target": s.file_path,
            "Class": "secret",
            "Secrets": [f.to_json() for f in s.findings],
        }
        for s in sorted(secrets, key=lambda s: s.file_path)
        if s.findings
    ]
    out: dict = {
        "SchemaVersion": SCHEMA_VERSION,
        "ArtifactName": target,
        "ArtifactType": "filesystem",
        "Metadata": {},
    }
    if results:
        out["Results"] = results
    return out


def _env_default(name: str, default):
    """TRIVY_TPU_<NAME> when set, else `default` (the reference's
    `_env_default` without its config file)."""
    return os.environ.get(f"TRIVY_TPU_{name.upper().replace('-', '_')}", default)


def _env_num(name: str, default, kind=float):
    """`_env_default` parsed as `kind` (the reference's `_float_default`
    and `_int_default`)."""
    return kind(_env_default(name, default))


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


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="trivy_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    fs = sub.add_parser("fs", help="scan a local directory for secrets")
    fs.add_argument("--scanners", default="secret")
    fs.add_argument("--secret-config", default="")
    fs.add_argument("-f", "--format", default="json", choices=["json"])
    fs.add_argument("--secret-backend", choices=SECRET_BACKENDS,
                    default=_env_default("secret-backend", "auto"))
    fs.add_argument("--device", default=DEFAULT_DEVICE)
    fs.add_argument("--rules-cache-dir", default=_env_default("rules-cache-dir", ""),
                    help="compiled-ruleset registry directory (default "
                    "~/.cache/trivy-tpu/rulesets; 'off' disables warm starts)")
    fs.add_argument("--mesh", default=_env_default("mesh", ""),
                    help="device mesh for data-parallel scans: N or NxM devices, "
                    "'auto' (mesh only on a host with several cards), 'none' to "
                    "force single-device (default auto; TRIVY_TPU_MESH)")
    fs.add_argument("--server", default=_env_default("server", ""),
                    help="server address for --secret-backend server")
    fs.add_argument("--token", default=_env_default("token", ""),
                    help="server auth token")
    fs.add_argument("target")
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
    args = parser.parse_args(argv)
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
    scanners = {s.strip() for s in args.scanners.split(",") if s.strip()}
    if scanners != {"secret"}:
        parser.error("only --scanners secret is supported")
    from trivy_tpu_torch.rules.model import build_ruleset

    ruleset = build_ruleset(load_config(args.secret_config))
    if args.secret_backend == "server":
        if not args.server:
            parser.error("--secret-backend server requires --server")
        from trivy_tpu_torch.rpc.client import RemoteSecretEngine

        engine = RemoteSecretEngine(args.server, args.token)
    else:
        from trivy_tpu_torch.engine.hybrid import make_secret_engine
        from trivy_tpu_torch.registry.store import resolve_rules_cache_dir

        engine = make_secret_engine(ruleset=ruleset, backend=args.secret_backend,
                                    device=args.device,
                                    rules_cache_dir=resolve_rules_cache_dir(
                                        args.rules_cache_dir))
    items = collect(args.target, ruleset, args.secret_config)
    secrets = engine.scan_batch(items)
    json.dump(_report(args.target, secrets), sys.stdout, indent=2)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
