"""Device scan programs: one sieve pass, many analyzers.

A copy of `trivy_tpu/programs/base.py`.  Trivy's per-file analyzers share
one shape: a keyword/regex sieve over raw bytes gating an exact, expensive
confirm.  A **ScanProgram** reifies that shape: a compiled ruleset
(keywords + regex factors feed the gram sieve exactly like secret rules
do), a `verify` opt-in for the host DFA claim-killer, and a `resolve` hook
that turns the program's slice of the candidate matrix into per-file
verdicts (the secret program's oracle confirm, the license program's
full-text classifier, ...).

A **ProgramTable** stacks programs into ONE merged ruleset whose rule
axis is the concatenation of the programs' rules, in table order.  The
engine sieves the merged ruleset in a single pass (every program's
candidates come from the same `[F, R_total]` matrix) and demuxes
per-program verdicts on fetch by slicing the rule axis
(`GpuSecretEngine.scan_programs`).  The secret program, when present,
must sit first: its rules keep indices 0..N-1, identical to a
secret-only engine, so the confirm loop and its verdicts are
byte-identical to the single-program path by construction.

The reference compiles programs through its registry seam
(`get_or_compile(..., program_id=...)`); the port's registry is not
ported yet (ROADMAP A10), so programs compile in the engine.
"""

from __future__ import annotations

import hashlib

import numpy as np

from trivy_tpu_torch.registry.digest import ruleset_digest
from trivy_tpu_torch.rules.model import RuleSet


class ProgramCompileError(ValueError):
    """A program's ruleset failed its compile-time self-checks (e.g. the
    license corpus contains a text none of the anchor tokens cover)."""


class ScanProgram:
    """One analyzer's seat in the shared device pass.

    Subclasses pin `program_id` (stable, key-safe: it participates in
    registry paths and result-cache keys) and implement `build_ruleset`
    and `resolve`.  `verify=True` opts the program's candidate columns
    into the host-DFA claim-killer (exact regex refutation — only sound
    when the program's rules carry real regexes, like secret rules do).
    """

    program_id: str = ""
    verify: bool = False

    def __init__(self) -> None:
        self._ruleset: RuleSet | None = None

    # -- compilation ------------------------------------------------------

    def build_ruleset(self) -> RuleSet:
        raise NotImplementedError

    def ruleset(self) -> RuleSet:
        """The program's compiled-once ruleset (sieve side)."""
        if self._ruleset is None:
            self._ruleset = self.build_ruleset()
        return self._ruleset

    def verdict_digest(self) -> str:
        """Digest of everything that can change this program's verdicts
        (ruleset digest for secrets; ruleset + corpus for licenses).
        Feeds the table digest and program-qualified cache keys."""
        return ruleset_digest(self.ruleset())

    # -- verdicts ---------------------------------------------------------

    def resolve(self, engine, items, cand, offset: int) -> list:
        """Per-file verdicts from this program's candidate slice.

        `cand` is the `[F, R_prog]` bool slice of the batch candidate
        matrix; `offset` is where the slice starts on the merged rule
        axis (global index = local + offset).  Must return one verdict
        per item, in item order — the demux contract.
        """
        raise NotImplementedError

    def verdict_count(self, verdicts: list) -> int:
        """How many of `verdicts` are non-empty (attribution only)."""
        return sum(1 for v in verdicts if v)

    def snapshot(self) -> dict:
        return {
            "id": self.program_id,
            "rules": len(self.ruleset().rules),
            "verify": self.verify,
        }


class ProgramTable:
    """An ordered set of programs sharing one device pass."""

    def __init__(self, programs: list[ScanProgram]):
        if not programs:
            raise ValueError("a program table needs at least one program")
        ids = [p.program_id for p in programs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate program ids: {ids}")
        if "secret" in ids and ids[0] != "secret":
            # Stable-prefix invariant: secret rules keep the indices a
            # secret-only engine would give them, so the oracle-confirm
            # path is byte-identical by construction.
            raise ValueError("the secret program must be first in the table")
        self.programs = programs
        self._slices: list[tuple[ScanProgram, slice]] = []
        off = 0
        for p in programs:
            n = len(p.ruleset().rules)
            self._slices.append((p, slice(off, off + n)))
            off += n
        self.num_rules = off

    @property
    def table_id(self) -> str:
        """Registry/path-safe identity of the program combination."""
        return "+".join(p.program_id for p in self.programs)

    def slices(self) -> list[tuple[ScanProgram, slice]]:
        return list(self._slices)

    def merged_ruleset(self) -> RuleSet:
        """One ruleset over the concatenated rule axis.  Path gating
        (allow rules, exclude blocks) is the FIRST program's — per-file
        allow semantics belong to the secret path; other programs gate
        inside their own resolve hooks."""
        first = self.programs[0].ruleset()
        rules = []
        for p in self.programs:
            rules.extend(p.ruleset().rules)
        return RuleSet(
            rules=rules,
            allow_rules=first.allow_rules,
            exclude_block=first.exclude_block,
        )

    def verify_column_mask(self, num_rules: int):
        """[R_total] bool: which merged-rule columns opted into the host
        DFA claim-killer."""
        if num_rules != self.num_rules:
            raise ValueError(
                f"candidate matrix has {num_rules} rule columns, "
                f"table compiled {self.num_rules}"
            )
        mask = np.zeros(num_rules, dtype=bool)
        for p, sl in self._slices:
            if p.verify:
                mask[sl] = True
        return mask

    def digest(self) -> str:
        """Content digest over (program_id, verdict_digest) pairs — the
        identity program-qualified pool slots and caches key on."""
        h = hashlib.sha256()
        for p in self.programs:
            h.update(p.program_id.encode("utf-8"))
            h.update(b"\x00")
            h.update(p.verdict_digest().encode("utf-8"))
            h.update(b"\x00")
        return "sha256:" + h.hexdigest()

    def snapshot(self) -> dict:
        return {
            "table": self.table_id,
            "digest": self.digest(),
            "programs": [p.snapshot() for p in self.programs],
        }


def build_program_table(programs: list[ScanProgram]) -> ProgramTable:
    """The one construction seam for tables (GL014's loop-hoisting
    target: build once per process/config change, never per call)."""
    return ProgramTable(programs)
