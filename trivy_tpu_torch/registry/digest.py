"""Canonical RuleSet serialization -> sha256 ruleset_digest.

A copy of `trivy_tpu/registry/digest.py` (the port imports nothing from the
JAX package): the same canonical form, so both packages give one ruleset
the same digest.

Content addressing for compiled artifacts: two processes (or two releases)
that assemble the same effective rules — same ids, same Go-syntax patterns,
same keywords/paths/allow rules — produce the same digest and share one
cache entry; any semantic change to the rule material changes the digest and
forces a fresh compile.  The canonical form covers exactly the inputs of the
compile pipeline (compile_rules / build_probe_set / build_gram_set plus the
confirm-side allow rules and exclude blocks) and nothing else: compiled
`re.Pattern` objects, lazy gating caches, and field ordering are all
excluded, so the digest is stable across Python versions and process runs.
"""

from __future__ import annotations

import hashlib
import json

from trivy_tpu_torch.rules.model import AllowRule, ExcludeBlock, Rule, RuleSet

# Bump when the canonical form itself changes (fields added/removed): old
# digests stop matching, which is exactly the safe failure mode.
CANON_SCHEMA = 1


def _pattern_src(src: str, compiled) -> str:
    """Go-syntax source when recorded; the compiled pattern's source as a
    fallback so precompiled-regex rules (built in code, not YAML) still
    digest by content rather than hashing to an empty string."""
    if src:
        return src
    if compiled is None:
        return ""
    pat = compiled.pattern
    return pat.decode("latin-1") if isinstance(pat, bytes) else str(pat)


def _allow_rule(a: AllowRule) -> dict:
    return {
        "id": a.id,
        "description": a.description,
        "regex": _pattern_src(a.regex_src, a.regex),
        "path": _pattern_src(a.path_src, a.path),
    }


def _exclude_block(e: ExcludeBlock) -> dict:
    srcs = list(e.regex_srcs)
    if not srcs and e.regexes:
        srcs = [_pattern_src("", rx) for rx in e.regexes]
    return {"description": e.description, "regexes": srcs}


def _rule(r: Rule) -> dict:
    return {
        "id": r.id,
        "category": r.category,
        "title": r.title,
        "severity": r.severity,
        "regex": _pattern_src(r.regex_src, r.regex),
        "keywords": list(r.keywords),
        "path": _pattern_src(r.path_src, r.path),
        "allow_rules": [_allow_rule(a) for a in r.allow_rules],
        "exclude_block": _exclude_block(r.exclude_block),
        "secret_group_name": r.secret_group_name,
    }


def canonical_ruleset_bytes(ruleset: RuleSet) -> bytes:
    doc = {
        "canon_schema": CANON_SCHEMA,
        "rules": [_rule(r) for r in ruleset.rules],
        "allow_rules": [_allow_rule(a) for a in ruleset.allow_rules],
        "exclude_block": _exclude_block(ruleset.exclude_block),
    }
    return json.dumps(
        doc, sort_keys=True, separators=(",", ":"), ensure_ascii=True
    ).encode("utf-8")


def ruleset_digest(ruleset: RuleSet) -> str:
    """sha256 hex digest of the canonical rule material."""
    return hashlib.sha256(canonical_ruleset_bytes(ruleset)).hexdigest()


_DEFAULT_DIGEST: str | None = None


def default_ruleset_digest() -> str:
    """Digest of the builtin ruleset (no secret config), cached per process
    — the version every scan surface reports before a custom config or a
    reload installs anything else."""
    global _DEFAULT_DIGEST
    if _DEFAULT_DIGEST is None:
        from trivy_tpu_torch.rules.model import build_ruleset

        _DEFAULT_DIGEST = ruleset_digest(build_ruleset(None))
    return _DEFAULT_DIGEST


def engine_digest(engine) -> str:
    """Active digest of any engine shape: explicit attribute first (device
    engines cache it, fakes in tests set it), else the engine's ruleset."""
    d = getattr(engine, "ruleset_digest", None)
    if isinstance(d, str) and d:
        return d
    rs = getattr(engine, "ruleset", None)
    return ruleset_digest(rs) if rs is not None else ""
