"""Compiled-artifact store: UnionNFA + probe/gram tensors as .npz + manifest.

The twin of `trivy_tpu/registry/store.py`, built from the port's own
compilers.  `compile_ruleset` runs the full compile once (union NFA
transition tensors, probe set, masked-gram constants, link alphabet, the
device verifier's rule stack) and `save_artifact` persists it
content-addressed under `<cache>/<ruleset_digest>/{artifact.npz,
manifest.json}`.  A later process (`get_or_compile`) loads the tensors and
constructs an engine without touching the regex compilers at all.

One artifact serves both packages: the same array names, dtypes, CSR layout
and manifest keys, the same default directory (`TRIVY_TPU_RULES_CACHE_DIR`,
else `~/.cache/trivy-tpu/rulesets`), and the same pins.  The manifest pins
the producing framework where the reference pins jax: `torch_version` here,
`jax_version` there, each checked only when the manifest carries it, so an
artifact either package writes loads through the other in strict mode
(`trivy_tpu_version` is the distribution's version, the same for both;
`trivy_tpu_torch.__version__`).

Artifacts are detected, never trusted: the manifest pins the store schema,
the producing version, the ruleset digest, the program id, each array's
shape and dtype, and a sha256 over the .npz bytes; the link class map is
derived again from the gram tensors and compared, and the rule stack must
hold 0/1 values with byte 0x00 accepting nowhere.  Any mismatch, truncation
or parse failure logs a warning and falls back to a fresh compile.  Writes
are atomic (same-directory tmp + os.replace, manifest last).

Compiling is host work and runs without a card: the verifier that
`build_rule_stack` reads is built on the CPU.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from trivy_tpu_torch import __version__, faults
from trivy_tpu_torch.registry.digest import ruleset_digest
from trivy_tpu_torch.rules.model import RuleSet

logger = logging.getLogger("trivy_tpu_torch.registry")

SCHEMA_VERSION = 3
ARTIFACT_NPZ = "artifact.npz"
MANIFEST_JSON = "manifest.json"
# The ruleset SOURCE (secret-config YAML; empty file = builtin rules only):
# the confirm-side regexes and allow rules live in the RuleSet, not the
# tensors, so a server that selects rulesets by digest rebuilds the RuleSet
# from the source stored beside the artifact.
RULESET_SRC = "ruleset.yaml"
VSTACK_KEYS = ("vstack_has", "vstack_follow", "vstack_accept_b", "vstack_first", "vstack_last")

# Sentinel values of --rules-cache-dir that disable the store entirely.
_DISABLED = ("off", "none", "0", "-")


def default_cache_dir() -> str:
    env = os.environ.get("TRIVY_TPU_RULES_CACHE_DIR", "")
    if env:
        return os.path.expanduser(env)
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "trivy-tpu", "rulesets")


def resolve_rules_cache_dir(value: str | None) -> str | None:
    """CLI/env flag -> store directory: empty means the default location,
    an "off"/"none"/"0"/"-" sentinel disables the store (None)."""
    v = (value or "").strip()
    if v.lower() in _DISABLED:
        return None
    if not v:
        return default_cache_dir()
    return os.path.expanduser(v)


@dataclass
class CompiledArtifact:
    """One ruleset's full compiled sieve state."""

    digest: str
    nfa: object  # engine.nfa.UnionNFA
    pset: object  # engine.probes.ProbeSet
    gset: object  # engine.grams.GramSet
    manifest: dict
    alphabet: object = None  # engine.link.LinkAlphabet
    # Stacked per-rule verify tensors (engine.nfa_device.build_rule_stack):
    # a warm start seeds GpuNfaVerifier(rule_stack=...) from these.
    vstack: dict | None = None
    # Which scan program (programs/base.py) this artifact compiles: "secret"
    # keeps the bare-<digest> layout, any other id stores (and validates)
    # under <cache>/programs/<id>/<digest>.
    program_id: str = "secret"


def compile_ruleset(
    ruleset: RuleSet,
    digest: str | None = None,
    program_id: str = "secret",
) -> CompiledArtifact:
    """The cold path: Glushkov union NFA + probe set + gram constants + link
    alphabet + rule stack, all on the host."""
    from trivy_tpu_torch.engine.grams import build_gram_set
    from trivy_tpu_torch.engine.link import derive_alphabet
    from trivy_tpu_torch.engine.nfa import compile_rules
    from trivy_tpu_torch.engine.nfa_device import GpuNfaVerifier, build_rule_stack
    from trivy_tpu_torch.engine.probes import build_probe_set

    if digest is None:
        digest = ruleset_digest(ruleset)
    nfa = compile_rules(ruleset.rules)
    pset = build_probe_set(ruleset.rules)
    gset = build_gram_set(pset)
    return CompiledArtifact(
        digest=digest,
        nfa=nfa,
        pset=pset,
        gset=gset,
        manifest={},
        alphabet=derive_alphabet(gset),
        vstack=build_rule_stack(GpuNfaVerifier(ruleset.rules, device="cpu")),
        program_id=program_id,
    )


# ---------------------------------------------------------------------------
# Tensor (de)serialization
# ---------------------------------------------------------------------------


def _pack_arrays(art: CompiledArtifact) -> dict[str, np.ndarray]:
    """Flatten the compiled structures into named npz arrays (the
    reference's names and layout): probe classes are 256-bit ints, one
    little-endian 32-byte row each; ragged probe lengths and the per-rule
    plan lists serialize as CSR (ptr, ids) pairs."""
    from trivy_tpu_torch.engine.link import derive_alphabet

    nfa, pset, gset = art.nfa, art.pset, art.gset
    alpha = art.alphabet if art.alphabet is not None else derive_alphabet(gset)
    vstack = art.vstack
    if vstack is None:
        # An all-zero `has` column: a loaded verifier builds its per-rule
        # tensors itself, so a stack-less save stays correct.
        nr = len(nfa.rule_ids)
        vstack = {
            "vstack_has": np.zeros(nr, np.uint8),
            "vstack_follow": np.zeros((nr, 64, 64), np.uint8),
            "vstack_accept_b": np.zeros((nr, 256, 64), np.uint8),
            "vstack_first": np.zeros((nr, 64), np.uint8),
            "vstack_last": np.zeros((nr, 64), np.uint8),
        }
    probe_lens = np.array([len(p.classes) for p in pset.probes], dtype=np.int32)
    classes = np.zeros((int(probe_lens.sum()), 32), dtype=np.uint8)
    row = 0
    for p in pset.probes:
        for bs in p.classes:
            classes[row] = np.frombuffer(int(bs).to_bytes(32, "little"), dtype=np.uint8)
            row += 1
    gate_ptr = [0]
    gate_ids: list[int] = []
    rule_conj_ptr = [0]
    conj_ptr = [0]
    conj_ids: list[int] = []
    for plan in pset.plans:
        gate_ids.extend(plan.gate_probe_ids)
        gate_ptr.append(len(gate_ids))
        for conjunct in plan.anchor_conjuncts:
            conj_ids.extend(conjunct)
            conj_ptr.append(len(conj_ids))
        rule_conj_ptr.append(len(conj_ptr) - 1)
    out = {
        "nfa_byte_class": nfa.byte_class,
        "nfa_accept": nfa.accept,
        "nfa_follow": nfa.follow,
        "nfa_first": nfa.first,
        "nfa_rule_last": nfa.rule_last,
        "nfa_pos_rule": nfa.pos_rule,
        "pset_probe_lens": probe_lens,
        "pset_probe_classes": classes,
        "pset_gate_ptr": np.array(gate_ptr, dtype=np.int32),
        "pset_gate_ids": np.array(gate_ids, dtype=np.int32),
        "pset_rule_conj_ptr": np.array(rule_conj_ptr, dtype=np.int32),
        "pset_conj_ptr": np.array(conj_ptr, dtype=np.int32),
        "pset_conj_ids": np.array(conj_ids, dtype=np.int32),
        "gset_masks": gset.masks,
        "gset_vals": gset.vals,
        "gset_gram_probe": gset.gram_probe,
        "gset_gram_window": gset.gram_window,
        "gset_window_probe": gset.window_probe,
        "gset_window_start": gset.window_start,
        "gset_probe_has_gram": gset.probe_has_gram,
        "link_values": np.asarray(alpha.values, dtype=np.uint8),
        "link_class_map": np.asarray(alpha.class_map, dtype=np.uint8),
    }
    out.update({k: np.asarray(vstack[k], dtype=np.uint8) for k in VSTACK_KEYS})
    return out


def _build_manifest(art: CompiledArtifact, arrays: dict) -> dict:
    from trivy_tpu_torch.engine.device import TILE_BUCKETS

    nfa, pset, gset = art.nfa, art.pset, art.gset
    return {
        "schema_version": SCHEMA_VERSION,
        "ruleset_digest": art.digest,
        "program_id": art.program_id or "secret",
        "created_at": time.time(),
        "trivy_tpu_version": __version__,
        "torch_version": torch.__version__,
        "numpy_version": np.__version__,
        "num_rules": len(nfa.rule_ids),
        "rule_ids": list(nfa.rule_ids),
        "plan_rule_ids": [p.rule_id for p in pset.plans],
        "nfa": {
            "num_positions": nfa.num_positions,
            "num_words": nfa.num_words,
            "num_classes": nfa.num_classes,
        },
        "pset": {"jmax": pset.jmax, "num_probes": len(pset.probes)},
        "gset": {
            "num_grams": int(gset.num_grams),
            "num_windows": int(gset.num_windows),
            "num_probes": int(gset.num_probes),
        },
        "link": {"alphabet_size": int(len(arrays["link_values"]))},
        "vstack": {"stream_rules": int(arrays["vstack_has"].sum())},
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "tile_buckets": list(TILE_BUCKETS),
    }


def _unpack_artifact(manifest: dict, z) -> CompiledArtifact:
    from trivy_tpu_torch.engine.grams import GramSet
    from trivy_tpu_torch.engine.link import LinkAlphabet, derive_alphabet
    from trivy_tpu_torch.engine.nfa import UnionNFA
    from trivy_tpu_torch.engine.probes import Probe, ProbeSet, RuleProbePlan

    for key, dtype in manifest["dtypes"].items():
        arr = z[key]
        if str(arr.dtype) != dtype or list(arr.shape) != manifest["shapes"][key]:
            raise ValueError(
                f"array {key!r} is {arr.dtype}{arr.shape}, manifest says "
                f"{dtype}{tuple(manifest['shapes'][key])}"
            )
    nm = manifest["nfa"]
    nfa = UnionNFA(
        num_positions=int(nm["num_positions"]),
        num_words=int(nm["num_words"]),
        num_classes=int(nm["num_classes"]),
        byte_class=z["nfa_byte_class"],
        accept=z["nfa_accept"],
        follow=z["nfa_follow"],
        first=z["nfa_first"],
        rule_last=z["nfa_rule_last"],
        pos_rule=z["nfa_pos_rule"],
        rule_ids=list(manifest["rule_ids"]),
    )
    probes = []
    row = 0
    classes = z["pset_probe_classes"]
    for ln in z["pset_probe_lens"]:
        cls = tuple(int.from_bytes(classes[row + j].tobytes(), "little") for j in range(int(ln)))
        row += int(ln)
        probes.append(Probe(classes=cls))
    gate_ptr, gate_ids = z["pset_gate_ptr"], z["pset_gate_ids"]
    rule_conj_ptr, conj_ptr, conj_ids = z["pset_rule_conj_ptr"], z["pset_conj_ptr"], z["pset_conj_ids"]
    plans = []
    for i, rid in enumerate(manifest["plan_rule_ids"]):
        gates = [int(g) for g in gate_ids[gate_ptr[i] : gate_ptr[i + 1]]]
        conjuncts = [
            [int(c) for c in conj_ids[conj_ptr[k] : conj_ptr[k + 1]]]
            for k in range(int(rule_conj_ptr[i]), int(rule_conj_ptr[i + 1]))
        ]
        plans.append(RuleProbePlan(rule_id=rid, gate_probe_ids=gates, anchor_conjuncts=conjuncts))
    pset = ProbeSet(probes=probes, plans=plans, jmax=int(manifest["pset"]["jmax"]))
    gset = GramSet(
        masks=z["gset_masks"],
        vals=z["gset_vals"],
        gram_probe=z["gset_gram_probe"],
        gram_window=z["gset_gram_window"],
        window_probe=z["gset_window_probe"],
        window_start=z["gset_window_start"],
        probe_has_gram=z["gset_probe_has_gram"],
        num_probes=int(manifest["gset"]["num_probes"]),
    )
    # Never-trust the stored link alphabet: derive it again from the (shape-
    # and dtype-checked) gram tensors and require byte equality, so a class
    # map rewritten together with its npz_sha256 still fails here.
    fresh = derive_alphabet(gset)
    stored_vals = np.asarray(z["link_values"], dtype=np.uint8)
    stored_map = np.asarray(z["link_class_map"], dtype=np.uint8)
    if not (np.array_equal(stored_vals, fresh.values) and np.array_equal(stored_map, fresh.class_map)):
        raise ValueError("stored link class map does not match the gram tensors (corrupt or tampered)")
    # The rule stack feeds the device verifier directly: every entry is a
    # 0/1 indicator and byte 0x00 (the stream's dead separator) accepts
    # nowhere in any valid build_rule_stack output.
    vstack = {k: np.asarray(z[k]) for k in VSTACK_KEYS}
    for k, arr in vstack.items():
        if arr.size and int(arr.max(initial=0)) > 1:
            raise ValueError(f"rule-stack tensor {k!r} has non-indicator values (corrupt or tampered)")
    if vstack["vstack_accept_b"].size and vstack["vstack_accept_b"][:, 0, :].any():
        raise ValueError("rule-stack accept tensor marks byte 0x00 live (corrupt or tampered)")
    return CompiledArtifact(
        digest=manifest["ruleset_digest"],
        nfa=nfa,
        pset=pset,
        gset=gset,
        manifest=manifest,
        alphabet=LinkAlphabet(values=stored_vals, class_map=stored_map),
        vstack=vstack,
    )


# ---------------------------------------------------------------------------
# Atomic store
# ---------------------------------------------------------------------------


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_artifact(art: CompiledArtifact, cache_dir: str) -> str:
    """Persist under <cache_dir>/<digest>/; returns the artifact directory.
    The npz first, the manifest last: the manifest's npz checksum makes it
    the commit record, so a reader never sees a torn artifact as valid."""
    dirp = os.path.join(cache_dir, art.digest)
    os.makedirs(dirp, exist_ok=True)
    arrays = _pack_arrays(art)
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    blob = buf.getvalue()
    manifest = _build_manifest(art, arrays)
    manifest["npz_sha256"] = hashlib.sha256(blob).hexdigest()
    manifest["npz_bytes"] = len(blob)
    _atomic_write(os.path.join(dirp, ARTIFACT_NPZ), blob)
    _atomic_write(
        os.path.join(dirp, MANIFEST_JSON),
        json.dumps(manifest, indent=1, sort_keys=True).encode("utf-8"),
    )
    art.manifest = manifest
    return dirp


def _check_manifest(manifest: dict, digest: str, program_id: str, strict_versions: bool) -> None:
    if manifest.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"artifact schema {manifest.get('schema_version')!r} != store schema {SCHEMA_VERSION}")
    if manifest.get("ruleset_digest") != digest:
        raise ValueError(
            f"manifest digest {manifest.get('ruleset_digest')!r} does not match directory {digest!r}")
    if manifest.get("program_id", "secret") != program_id:
        raise ValueError(
            f"artifact compiles program {manifest.get('program_id', 'secret')!r}, "
            f"caller wants {program_id!r}")
    if not strict_versions:
        return
    if manifest.get("trivy_tpu_version") != __version__:
        raise ValueError(
            f"artifact built by trivy-tpu {manifest.get('trivy_tpu_version')!r}, "
            f"this is {__version__!r}")
    tv = manifest.get("torch_version")
    if tv and tv != torch.__version__:
        raise ValueError(f"artifact built against torch {tv!r}, this is {torch.__version__!r}")


def load_artifact(
    cache_dir: str,
    digest: str,
    strict_versions: bool = True,
    program_id: str = "secret",
) -> CompiledArtifact | None:
    """Load and validate; ANY failure (missing, truncated, checksum or
    version mismatch, foreign digest, foreign program) logs a warning and
    returns None: the caller recompiles.  `strict_versions=False` skips
    the producing-version pins."""
    dirp = os.path.join(cache_dir, digest)
    mpath = os.path.join(dirp, MANIFEST_JSON)
    npath = os.path.join(dirp, ARTIFACT_NPZ)
    if not os.path.exists(mpath) or not os.path.exists(npath):
        return None
    try:
        # Chaos seam: an injected `registry.load:corrupt` fault takes the
        # same warn-and-recompile path a real tampered artifact takes.
        faults.fire("registry.load")
        with open(mpath, "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
        _check_manifest(manifest, digest, program_id, strict_versions)
        with open(npath, "rb") as f:
            blob = f.read()
        if len(blob) != manifest.get("npz_bytes"):
            raise ValueError(f"npz is {len(blob)} bytes, manifest says {manifest.get('npz_bytes')}")
        if hashlib.sha256(blob).hexdigest() != manifest.get("npz_sha256"):
            raise ValueError("npz sha256 mismatch (corrupt or tampered)")
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            art = _unpack_artifact(manifest, z)
        art.program_id = manifest.get("program_id", "secret")
        return art
    except Exception as e:  # every failure is a cache miss, never a scan failure
        logger.warning("ruleset artifact %s unusable (%s); falling back to a fresh compile", dirp, e)
        return None


def program_cache_dir(cache_dir: str, program_id: str) -> str:
    """The secret program keeps the bare-<digest> directories; any other
    program nests under programs/<id>/, so digests never collide across
    programs with different resolve semantics."""
    if program_id == "secret":
        return cache_dir
    return os.path.join(cache_dir, "programs", program_id)


def get_or_compile(
    ruleset: RuleSet,
    cache_dir: str | None = None,
    save: bool = True,
    program_id: str = "secret",
) -> tuple[CompiledArtifact, str]:
    """The engine-construction entry point: (artifact, source) with source
    "warm" (loaded from the store) or "cold" (freshly compiled, and saved
    back unless the store is unwritable: a read-only cache never fails a
    scan).  `program_id` keys the store layout and the manifest pin."""
    if cache_dir is None:
        cache_dir = default_cache_dir()
    cache_dir = program_cache_dir(cache_dir, program_id)
    digest = ruleset_digest(ruleset)
    art = load_artifact(cache_dir, digest, program_id=program_id)
    if art is not None:
        return art, "warm"
    art = compile_ruleset(ruleset, digest=digest, program_id=program_id)
    if save:
        try:
            save_artifact(art, cache_dir)
        except OSError as e:
            logger.warning("could not persist ruleset artifact: %s", e)
    return art, "cold"


def artifact_device_bytes(art: CompiledArtifact) -> int:
    """Estimated device residency of one compiled ruleset: the tensor bytes
    the engines stage.  The manifest's shape/dtype pins are the fast path; a
    just-compiled artifact (empty manifest) sums the arrays directly."""
    m = art.manifest or {}
    shapes, dtypes = m.get("shapes"), m.get("dtypes")
    if shapes and dtypes:
        return sum(int(np.prod(shape, dtype=np.int64)) * np.dtype(dtypes[key]).itemsize
                   for key, shape in shapes.items())
    total = 0
    for obj, names in (
        (art.nfa, ("byte_class", "accept", "follow", "first", "rule_last", "pos_rule")),
        (art.gset, ("masks", "vals", "gram_probe", "gram_window", "window_probe",
                    "window_start", "probe_has_gram")),
    ):
        for name in names:
            total += int(np.asarray(getattr(obj, name)).nbytes)
    return total


# ---------------------------------------------------------------------------
# Ruleset sources
# ---------------------------------------------------------------------------


def save_ruleset_source(cache_dir: str, digest: str, yaml_text: str) -> str:
    """Persist the secret-config YAML under <cache>/<digest>/ruleset.yaml
    (atomic; empty text = builtin rules).  Returns the file path."""
    dirp = os.path.join(cache_dir, digest)
    os.makedirs(dirp, exist_ok=True)
    path = os.path.join(dirp, RULESET_SRC)
    _atomic_write(path, yaml_text.encode("utf-8"))
    return path


def load_ruleset_source(cache_dir: str, digest: str) -> RuleSet | None:
    """Rebuild the RuleSet for a stored digest, or None when no source is
    registered or it fails validation.  Never trusted: the rebuilt
    ruleset's digest must equal the directory digest."""
    path = os.path.join(cache_dir, digest, RULESET_SRC)
    if not os.path.exists(path):
        return None
    try:
        from trivy_tpu_torch.rules.model import build_ruleset, load_config

        with open(path, encoding="utf-8") as f:
            text = f.read()
        ruleset = build_ruleset(load_config(path) if text.strip() else None)
        got = ruleset_digest(ruleset)
        if got != digest:
            raise ValueError(
                f"source rebuilds to digest {got[:16]}, directory says {digest[:16]} "
                "(corrupt or tampered)")
        return ruleset
    except Exception as e:  # an unusable source is absent, never a failure
        logger.warning("ruleset source %s unusable (%s)", path, e)
        return None


def install_ruleset(
    cache_dir: str,
    rules_yaml: str = "",
    manifest: dict | None = None,
    npz: bytes | None = None,
) -> tuple[str, str]:
    """The `rules push` server seat (the twin of the reference's):
    register a ruleset by source, adopt a client-compiled artifact when it
    validates exactly like a local one would (`load_artifact`'s checks, so
    an artifact either package compiled installs here), else compile
    server-side (or warm-load a prior compile).  Returns (digest, source)
    with source "pushed" | "warm" | "cold"."""
    import tempfile

    from trivy_tpu_torch.rules.model import build_ruleset, load_config

    cfg = None
    if rules_yaml.strip():
        fd, tmp = tempfile.mkstemp(suffix=".yaml", prefix="trivy-push-")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(rules_yaml)
            cfg = load_config(tmp)
        finally:
            os.unlink(tmp)
    ruleset = build_ruleset(cfg)
    digest = ruleset_digest(ruleset)
    save_ruleset_source(cache_dir, digest, rules_yaml)
    if manifest is not None and npz is not None:
        # Never-trust adoption: write the pushed files, then run them
        # through the exact load_artifact gauntlet (digest pin, sha256,
        # schema/version pins, link class map re-derivation).  A rejected
        # push falls through to a server-side compile — a bad client can
        # cost the server a compile, never a wrong artifact.
        try:
            if manifest.get("ruleset_digest") != digest:
                raise ValueError(
                    f"pushed manifest digest "
                    f"{str(manifest.get('ruleset_digest'))[:16]!r} does not "
                    f"match the YAML's digest {digest[:16]!r}"
                )
            dirp = os.path.join(cache_dir, digest)
            os.makedirs(dirp, exist_ok=True)
            _atomic_write(os.path.join(dirp, ARTIFACT_NPZ), npz)
            _atomic_write(
                os.path.join(dirp, MANIFEST_JSON),
                json.dumps(manifest, indent=1, sort_keys=True).encode("utf-8"),
            )
            if load_artifact(cache_dir, digest) is None:
                raise ValueError("pushed artifact failed validation")
            return digest, "pushed"
        except Exception as e:
            logger.warning(
                "pushed artifact for %s rejected (%s); compiling server-side",
                digest[:16], e,
            )
    _, source = get_or_compile(ruleset, cache_dir=cache_dir)
    return digest, source


def list_artifacts(cache_dir: str | None = None) -> list[dict]:
    """Manifest summaries of every cache entry, newest first (the `rules ls`
    listing).  Unreadable entries are reported, not hidden."""
    if cache_dir is None:
        cache_dir = default_cache_dir()
    out = []
    if not os.path.isdir(cache_dir):
        return out
    for name in sorted(os.listdir(cache_dir)):
        dirp = os.path.join(cache_dir, name)
        if not os.path.isdir(dirp):
            continue
        entry = {"digest": name, "path": dirp, "valid": False}
        try:
            with open(os.path.join(dirp, MANIFEST_JSON), "rb") as f:
                m = json.loads(f.read().decode("utf-8"))
            entry.update(
                valid=True,
                size_bytes=int(m.get("npz_bytes") or 0),
                created_at=float(m.get("created_at") or 0.0),
                trivy_tpu_version=m.get("trivy_tpu_version", ""),
                torch_version=m.get("torch_version", ""),
                jax_version=m.get("jax_version", ""),
                num_rules=int(m.get("num_rules") or 0),
            )
        except (OSError, ValueError, TypeError) as e:
            entry["error"] = str(e)
        out.append(entry)
    out.sort(key=lambda e: e.get("created_at", 0.0), reverse=True)
    return out


# ---------------------------------------------------------------------------
# Warmup
# ---------------------------------------------------------------------------


def engine_libraries(engine) -> list[str]:
    """The `csrc/` libraries an engine launches: on a card, its sieve's
    (K1/K2 `gram_sieve`, B5 `gram_rows`, B6 `lut_sieve`), the megakernel's
    (K3/K4) and the device verifier's (K5/K6 `nfa_verify`); the native
    sieve, the host verifiers and an engine on the CPU launch none."""
    names = []
    if getattr(engine, "device", torch.device("cpu")).type != "cuda":
        return names
    if getattr(engine, "sieve", "native") != "native" and getattr(engine, "_sieve_fn", None):
        names.append("lut_sieve" if engine.sieve == "lut" else
                     "gram_sieve" if engine._pallas_obj is not None else "gram_rows")
    if getattr(engine, "_mega", None) is not None:
        names.append("megakernel")
    if getattr(engine, "_nfa_verifier", None) is not None:
        names.append("nfa_verify")
    return names


def aot_warmup(engine, cache_dir: str | None = None) -> dict:
    """Make the engine's first batch pay no build, load or upload: build or
    load through the executable cache (`registry/aotcache.py`; `cache_dir`,
    else the engine's `aot_cache_dir`, else the default one) every library
    the engine launches and the native host library, then, on a card, launch
    the sieve once per row bucket on zero rows (CUDA's lazy module load and
    the table uploads happen here) and warm the device verifier.

    Deliberate difference: the reference logs a failure and goes on; here a
    build or launch failure raises."""
    from trivy_tpu_torch.native.loader import load_native
    from trivy_tpu_torch.ops import _build

    cache_dir = cache_dir or getattr(engine, "aot_cache_dir", None)
    device = getattr(engine, "device", torch.device("cpu"))
    out = {"libraries": [], "buckets": [], "launched": 0, "verify": ""}
    load_native(cache_dir)
    out["libraries"].append("native")
    names = engine_libraries(engine)
    _build.load_all(names, cache_dir)
    out["libraries"] += names
    if device.type == "cuda":
        if getattr(engine, "_sieve_fn", None) is not None:
            for rows in engine._buckets():
                engine._exec(torch.zeros((rows, engine._staged_cols), dtype=torch.uint8,
                                         device=device))
                out["buckets"].append(rows)
                out["launched"] += 1
            if engine._mega is not None:
                engine._mega(*engine._mega_zero_args())
                out["launched"] += 1
            torch.cuda.synchronize(device)
    nfa = getattr(engine, "_nfa_verifier", None)
    if nfa is not None:
        nfa.warmup(cache_dir)
        out["verify"] = "fused" if nfa.fused else "stream"
    return out
