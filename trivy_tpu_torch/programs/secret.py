"""The secret path as a ScanProgram — the refactor that proves the shape.

The twin of `trivy_tpu/programs/secret.py`.  Resolve is the exact confirm
loop `GpuSecretEngine.scan_batch` runs (`GpuSecretEngine.confirm`, one
copy for both): the oracle restricted to candidate rule indices, with the
reference's allow-path result shape preserved for candidate-free files.
Rule indices translate local -> merged by `offset`; the table pins the
secret program first (offset 0), so the oracle sees the same indices a
secret-only engine would — findings are byte-identical by construction.
"""

from __future__ import annotations

from trivy_tpu_torch.ftypes import Secret
from trivy_tpu_torch.programs.base import ScanProgram
from trivy_tpu_torch.rules.model import RuleSet, SecretConfig, build_ruleset


class SecretScanProgram(ScanProgram):
    program_id = "secret"
    verify = True  # secret rules carry real regexes: DFA refutation is sound

    def __init__(
        self,
        ruleset: RuleSet | None = None,
        config: SecretConfig | None = None,
    ):
        super().__init__()
        self._ruleset = (
            ruleset if ruleset is not None else build_ruleset(config)
        )

    def build_ruleset(self) -> RuleSet:
        return self._ruleset

    def resolve(self, engine, items, cand, offset: int) -> list[Secret]:
        return engine.confirm(items, cand, offset)

    def verdict_count(self, verdicts: list) -> int:
        return sum(1 for s in verdicts if s.findings)
