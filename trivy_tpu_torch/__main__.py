"""`python -m trivy_tpu_torch fs --scanners secret [--secret-config F]
[--format json] [--secret-backend auto|hybrid|tpu|cpu|native]
[--device cuda|cpu] [--rules-cache-dir D] [--mesh N|NxM|auto|none] <dir>`:
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
reads it, as the reference's is; a bad spec exits 2.
`python -m trivy_tpu_torch rules compile|ls|verify`
maintains the registry (`commands/rules.py`).  What waits for a ROADMAP
item is in `NOT_PORTED`.

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
# What the port lacks of the reference CLI, and the ROADMAP item it waits
# for: the server backend, and `rules push`, which installs a ruleset into
# a running server's registry (with `install_ruleset` and `RulesetManager`).
NOT_PORTED = {"server": "A13", "rules push": "A13"}

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
    fs.add_argument("target")
    rules = sub.add_parser("rules", help="manage the compiled-ruleset registry")
    rules_sub = rules.add_subparsers(dest="rules_command")
    for name, text in (("compile", "compile a secret-config into the cache"),
                       ("ls", "list cached compiled artifacts"),
                       ("verify", "prove a cached artifact round-trips to "
                                  "byte-identical findings on the builtin corpus"),
                       ("push", "install a ruleset into a running server (not ported)")):
        cmd = rules_sub.add_parser(name, help=text)
        cmd.add_argument("--rules-cache-dir", default=_env_default("rules-cache-dir", ""))
        if name != "ls":
            cmd.add_argument("--secret-config", default=_env_default("secret-config", ""))
        if name in ("compile", "verify"):
            cmd.add_argument("--device", default=DEFAULT_DEVICE)
        if name == "compile":
            cmd.add_argument("--warmup", action="store_true",
                             help="also build or load every kernel library a device "
                             "engine launches and, on a card, launch its sieve once a bucket")
    args = parser.parse_args(argv)
    if args.command == "rules":
        if args.rules_command == "push":
            parser.error(f"rules push is not ported yet (ROADMAP {NOT_PORTED['rules push']})")
        from trivy_tpu_torch.commands.rules import run_rules

        return run_rules(args)
    scanners = {s.strip() for s in args.scanners.split(",") if s.strip()}
    if scanners != {"secret"}:
        parser.error("only --scanners secret is supported")
    if args.secret_backend in NOT_PORTED:
        parser.error(f"--secret-backend {args.secret_backend} is not ported yet "
                     f"(ROADMAP {NOT_PORTED[args.secret_backend]})")
    if args.mesh:
        # validated here, so a typo'd spec is a usage error, not a mid-scan
        # ValueError; seated where every engine's get_mesh() reads it
        from trivy_tpu_torch.mesh import topology as mesh_topology

        try:
            mesh_topology.parse_spec(args.mesh)
        except ValueError as e:
            print(f"trivy-tpu: {e}", file=sys.stderr)
            return 2
        os.environ["TRIVY_TPU_MESH"] = args.mesh

    from trivy_tpu_torch.engine.hybrid import make_secret_engine
    from trivy_tpu_torch.registry.store import resolve_rules_cache_dir
    from trivy_tpu_torch.rules.model import build_ruleset

    ruleset = build_ruleset(load_config(args.secret_config))
    engine = make_secret_engine(ruleset=ruleset, backend=args.secret_backend,
                                device=args.device,
                                rules_cache_dir=resolve_rules_cache_dir(args.rules_cache_dir))
    items = collect(args.target, ruleset, args.secret_config)
    secrets = engine.scan_batch(items)
    json.dump(_report(args.target, secrets), sys.stdout, indent=2)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
