"""The compiled ruleset tensors: what the engine carries instead of weights.

`CompiledRules` holds the arrays the staged fused path reads: the gram
compare constants and the 0/1 membership matrices that turn gram hits into
candidate (file, rule) lanes.  It comes from either side:

* `CompiledRules.build(ruleset)` computes them with the port's own copies of
  the probe and gram compilers;
* `CompiledRules.from_numpy(arrays)` takes them as `trivy_tpu` built them,
  under the JAX package's own attribute names (`ARRAY_NAMES`), so a test can
  hand the reference's state across and hold the two engines equal;
* `CompiledRules.from_artifact(art)` derives them from a registry
  `CompiledArtifact` (`registry/store.py`) without compiling anything.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from trivy_tpu_torch.engine.grams import GramSet, build_gram_set, probe_hits_bool
from trivy_tpu_torch.engine.probes import MAX_CONJUNCTS, ProbeSet, build_probe_set
from trivy_tpu_torch.rules.model import RuleSet

# Reference attribute name (TpuSecretEngine / its GramSet) -> field.
ARRAY_NAMES = {
    "gset.masks": "masks",
    "gset.vals": "vals",
    "gset._wmember": "wmember",
    "gset._pmember": "pmember",
    "gset._pwindows": "pwindows",
    "gset.probe_has_gram": "probe_has_gram",
    "_gate_member": "gate_member",
    "_gate_any": "gate_any",
    "_conj_member": "conj_member",
    "_conj_any": "conj_any",
    "_num_conjuncts": "num_conjuncts",
}


@dataclass
class CompiledRules:
    masks: np.ndarray  # [G] uint32 gram masks
    vals: np.ndarray  # [G] uint32 gram values
    wmember: np.ndarray  # [G, W] 0/1 gram -> window
    pmember: np.ndarray  # [W, P] 0/1 window -> probe
    pwindows: np.ndarray  # [P] windows per probe
    probe_has_gram: np.ndarray  # [P] bool
    gate_member: np.ndarray  # [P, R] 0/1 probe -> rule gate
    gate_any: np.ndarray  # [R] bool: rule has a gate
    conj_member: np.ndarray  # [P, R*K] 0/1 probe -> rule anchor conjunct
    conj_any: np.ndarray  # [R, K] bool: conjunct k of rule r exists
    num_conjuncts: int  # K

    @property
    def num_rules(self) -> int:
        return len(self.gate_any)

    def probe_hits_bool(self, gram_hits: np.ndarray) -> np.ndarray:
        """[F, G] bool gram hits -> [F, P] bool probe hits
        (`GramSet.probe_hits_bool`)."""
        return probe_hits_bool(self.wmember, self.pmember, self.pwindows,
                               self.probe_has_gram, gram_hits)

    def candidate_matrix_bool(self, probe_bool: np.ndarray) -> np.ndarray:
        """[F, P] bool probe hits -> [F, R] bool candidates, the matmul form
        of the reference engine's `candidate_matrix_bool`."""
        f = len(probe_bool)
        ph = probe_bool.astype(np.float32)
        gate_ok = ~self.gate_any[None, :] | (ph @ self.gate_member > 0)
        conj_hit = (ph @ self.conj_member).reshape(f, self.num_rules, self.num_conjuncts) > 0
        conj_ok = (~self.conj_any[None] | conj_hit).all(-1)
        return gate_ok & conj_ok

    @classmethod
    def from_numpy(cls, arrays: dict) -> "CompiledRules":
        """From the reference's arrays, keyed by `ARRAY_NAMES`."""
        missing = sorted(set(ARRAY_NAMES) - set(arrays))
        if missing:
            raise KeyError(f"compiled arrays missing {missing}")
        kw = {field: np.asarray(arrays[name]) for name, field in ARRAY_NAMES.items()}
        kw["masks"] = kw["masks"].astype(np.uint32)
        kw["vals"] = kw["vals"].astype(np.uint32)
        kw["probe_has_gram"] = kw["probe_has_gram"].astype(bool)
        kw["gate_any"] = kw["gate_any"].astype(bool)
        kw["conj_any"] = kw["conj_any"].astype(bool)
        kw["num_conjuncts"] = int(kw["num_conjuncts"])
        return cls(**kw)

    @classmethod
    def build(cls, ruleset: RuleSet) -> "CompiledRules":
        """Compile `ruleset` with the port's own probe and gram compilers
        (the counterpart of `TpuSecretEngine.__init__` and its
        `_build_member_matrices`)."""
        pset = build_probe_set(ruleset.rules)
        return cls.from_sets(pset, build_gram_set(pset))

    @classmethod
    def from_artifact(cls, art) -> "CompiledRules":
        """From a registry `CompiledArtifact`'s probe and gram sets: the
        membership matrices only, no compiler runs."""
        return cls.from_sets(art.pset, art.gset)

    @classmethod
    def of(cls, compiled, pset: ProbeSet, gset: GramSet) -> "CompiledRules":
        """`compiled` (None, a `CompiledRules` or the reference's arrays) as
        the `CompiledRules` of the ruleset `pset` and `gset` were compiled
        from; arrays whose grams are not `gset`'s belong to another ruleset
        and are refused."""
        if compiled is None:
            return cls.from_sets(pset, gset)
        if isinstance(compiled, dict):
            compiled = cls.from_numpy(compiled)
        if not (np.array_equal(compiled.masks, gset.masks)
                and np.array_equal(compiled.vals, gset.vals)):
            raise ValueError("compiled rules do not belong to this ruleset")
        return compiled

    @classmethod
    def from_sets(cls, pset: ProbeSet, gset: GramSet) -> "CompiledRules":
        """From a compiled probe set and its gram set (the hybrid engine
        keeps both for its host pre-sieve tables)."""
        _gate, gate_any, _conj, conj_any = pset.gate_masks()
        p, r = len(pset.probes), len(pset.plans)
        gate_member = np.zeros((p, r), dtype=np.float32)
        conj_member = np.zeros((p, r * MAX_CONJUNCTS), dtype=np.float32)
        for i, plan in enumerate(pset.plans):
            for pid in plan.gate_probe_ids:
                gate_member[pid, i] = 1.0
            for k, conjunct in enumerate(plan.anchor_conjuncts):
                for pid in conjunct:
                    conj_member[pid, i * MAX_CONJUNCTS + k] = 1.0
        return cls(
            masks=gset.masks,
            vals=gset.vals,
            wmember=gset._wmember,
            pmember=gset._pmember,
            pwindows=gset._pwindows,
            probe_has_gram=gset.probe_has_gram,
            gate_member=gate_member,
            gate_any=gate_any,
            conj_member=conj_member,
            conj_any=conj_any,
            num_conjuncts=MAX_CONJUNCTS,
        )
