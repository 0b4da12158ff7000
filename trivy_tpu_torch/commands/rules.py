"""`python -m trivy_tpu_torch rules`: compiled-ruleset registry maintenance,
the twin of `trivy_tpu/commands/rules.py`.

compile  precompile a secret-config into the content-addressed cache so
         every later scan process starts warm (`--warmup` also builds or
         loads every kernel library a device engine launches through the
         executable cache and, on a card, launches its sieve once per row
         bucket: `registry.store.aot_warmup`)
ls       list cached artifacts: digest, rules, size, created, versions
verify   prove a cached artifact is faithful: every tensor must equal a
         fresh compile exactly, and a warm-constructed engine must give
         byte-identical findings to a cold one on the builtin corpus
push     install a ruleset into a running server's registry by digest:
         compile locally and upload the artifact (the server validates it
         exactly as it would a local one), or `--compile-on-server`
"""

from __future__ import annotations

import sys
import time

import numpy as np

from trivy_tpu_torch.registry import store as rstore
from trivy_tpu_torch.registry.digest import ruleset_digest
from trivy_tpu_torch.rules.model import build_ruleset, load_config


def _ruleset(args):
    cfg_path = getattr(args, "secret_config", "") or ""
    return build_ruleset(load_config(cfg_path) if cfg_path else None)


def _cache_dir(args) -> str:
    d = rstore.resolve_rules_cache_dir(getattr(args, "rules_cache_dir", ""))
    return d if d is not None else rstore.default_cache_dir()


def _compile(args) -> int:
    ruleset = _ruleset(args)
    cache_dir = _cache_dir(args)
    t0 = time.perf_counter()
    art, source = rstore.get_or_compile(ruleset, cache_dir=cache_dir)
    elapsed = time.perf_counter() - t0
    print(f"{art.digest}  {source}  {len(ruleset.rules)} rules  "
          f"{elapsed:.3f}s  -> {cache_dir}/{art.digest}")
    if getattr(args, "warmup", False):
        from trivy_tpu_torch.engine.hybrid import make_secret_engine

        engine = make_secret_engine(ruleset=ruleset, backend="device", compiled=art,
                                    device=args.device)
        info = rstore.aot_warmup(engine)
        print(f"aot: libraries {info['libraries']} buckets {info['buckets']} "
              f"launches {info['launched']}")
    return 0


def _ls(args) -> int:
    cache_dir = _cache_dir(args)
    entries = rstore.list_artifacts(cache_dir)
    if not entries:
        print(f"no cached rulesets under {cache_dir}")
        return 0
    print(f"{'DIGEST':16}  {'RULES':>5}  {'SIZE':>9}  {'CREATED':19}  VERSIONS")
    for e in entries:
        if not e["valid"]:
            print(f"{e['digest'][:16]:16}  (unreadable: {e.get('error', '?')})")
            continue
        created = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(e["created_at"]))
        vers = f"trivy-tpu {e['trivy_tpu_version']}"
        for framework in ("torch", "jax"):
            if e[f"{framework}_version"]:
                vers += f", {framework} {e[f'{framework}_version']}"
        print(f"{e['digest'][:16]:16}  {e['num_rules']:>5}  {e['size_bytes']:>9}  "
              f"{created:19}  {vers}")
    return 0


def _verify(args) -> int:
    from trivy_tpu_torch.engine.hybrid import make_secret_engine
    from trivy_tpu_torch.ftypes import findings_fingerprint

    ruleset = _ruleset(args)
    cache_dir = _cache_dir(args)
    digest = ruleset_digest(ruleset)
    art = rstore.load_artifact(cache_dir, digest)
    if art is None:
        print(f"verify FAILED: no loadable artifact for {digest[:16]} under {cache_dir} "
              "(run `rules compile` first)", file=sys.stderr)
        return 1
    fresh = rstore.compile_ruleset(ruleset, digest=digest)
    got, want = rstore._pack_arrays(art), rstore._pack_arrays(fresh)
    checks = [(name, got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]))
              for name in sorted(want)]
    checks.append(("nfa.rule_ids", art.nfa.rule_ids == fresh.nfa.rule_ids))
    checks.append(("pset.plans", [p.rule_id for p in art.pset.plans]
                   == [p.rule_id for p in fresh.pset.plans]))
    warm = make_secret_engine(ruleset=ruleset, backend="auto", compiled=art, device=args.device)
    cold = make_secret_engine(ruleset=ruleset, backend="auto", device=args.device)
    checks.append(("findings (builtin corpus, byte-identical)",
                   findings_fingerprint(warm) == findings_fingerprint(cold)))
    bad = [name for name, ok in checks if not ok]
    for name, ok in checks:
        print(f"  {'ok ' if ok else 'FAIL'} {name}")
    if bad:
        print(f"verify FAILED for {digest[:16]}: {', '.join(bad)}", file=sys.stderr)
        return 1
    print(f"verify OK: {digest} round-trips exactly")
    return 0


def _push(args) -> int:
    import json
    import os

    from trivy_tpu_torch.rpc.client import RpcClient, RpcError

    server = getattr(args, "server", "") or ""
    if not server:
        print("rules push: --server is required", file=sys.stderr)
        return 2
    cfg_path = getattr(args, "secret_config", "") or ""
    rules_yaml = ""
    if cfg_path:
        try:
            with open(cfg_path, encoding="utf-8") as f:
                rules_yaml = f.read()
        except OSError as e:
            print(f"rules push: cannot read {cfg_path}: {e}", file=sys.stderr)
            return 2
    client = RpcClient(server, getattr(args, "token", "") or "")
    manifest = None
    npz = None
    if not getattr(args, "compile_on_server", False):
        # Client-side compile (default): build into the local cache, then
        # ship the artifact files so the server validates and installs
        # without compiling.
        ruleset = _ruleset(args)
        cache_dir = _cache_dir(args)
        art, source = rstore.get_or_compile(ruleset, cache_dir=cache_dir)
        art_dir = os.path.join(cache_dir, art.digest)
        try:
            with open(os.path.join(art_dir, rstore.MANIFEST_JSON), encoding="utf-8") as f:
                manifest = json.load(f)
            with open(os.path.join(art_dir, rstore.ARTIFACT_NPZ), "rb") as f:
                npz = f.read()
        except OSError as e:
            print(f"rules push: compiled {art.digest[:16]} ({source}) but cannot read "
                  f"its files: {e}", file=sys.stderr)
            return 1
        print(f"compiled {art.digest[:16]} locally ({source}); uploading")
    try:
        resp = client.push_ruleset(rules_yaml=rules_yaml, manifest_json=manifest, npz=npz,
                                   admit=not getattr(args, "no_admit", False))
    except RpcError as e:
        print(f"rules push FAILED: {e}", file=sys.stderr)
        return 1
    print(f"pushed {resp.get('RulesetDigest', '?')}  source={resp.get('Source', '?')}  "
          f"resident={bool(resp.get('Resident'))}")
    return 0


def run_rules(args) -> int:
    cmd = getattr(args, "rules_command", None)
    if cmd == "compile":
        return _compile(args)
    if cmd == "ls":
        return _ls(args)
    if cmd == "verify":
        return _verify(args)
    if cmd == "push":
        return _push(args)
    print("usage: trivy_tpu_torch rules {compile,ls,verify,push} "
          "[--secret-config ...] [--rules-cache-dir ...] [--device ...] [--server ...]",
          file=sys.stderr)
    return 2
