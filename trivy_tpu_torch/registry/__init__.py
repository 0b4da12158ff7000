"""trivy_tpu_torch.registry: the content-addressed ruleset registry, the
twin of `trivy_tpu/registry/`.

A RuleSet canonicalizes to a sha256 ruleset digest (digest.py); the full
compiled sieve state serializes to one .npz + manifest JSON under
~/.cache/trivy-tpu/rulesets/<digest>/ (store.py), the same artifact the
JAX package reads and writes; the libraries the port builds (nvcc, g++)
live in a never-trust executable cache (aotcache.py).  Artifacts are
detected, never trusted: any schema/version/checksum mismatch falls back
to a fresh compile.  `RulesetManager` (manager.py) is the serve layer's
epoch-versioned engine swap, and `install_ruleset` the `rules push` seat.
"""

from trivy_tpu_torch.registry.digest import (
    canonical_ruleset_bytes,
    default_ruleset_digest,
    engine_digest,
    ruleset_digest,
)
from trivy_tpu_torch.registry.manager import RulesetManager
from trivy_tpu_torch.registry.store import (
    CompiledArtifact,
    aot_warmup,
    compile_ruleset,
    default_cache_dir,
    get_or_compile,
    install_ruleset,
    list_artifacts,
    load_artifact,
    resolve_rules_cache_dir,
    save_artifact,
)

__all__ = [
    "CompiledArtifact",
    "RulesetManager",
    "aot_warmup",
    "canonical_ruleset_bytes",
    "compile_ruleset",
    "default_cache_dir",
    "default_ruleset_digest",
    "engine_digest",
    "get_or_compile",
    "install_ruleset",
    "list_artifacts",
    "load_artifact",
    "resolve_rules_cache_dir",
    "ruleset_digest",
    "save_artifact",
]
