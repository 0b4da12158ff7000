"""Scan programs: one sieve pass, many verdicts (the twin of
`trivy_tpu/programs/`).

- ScanProgram / ProgramTable / build_program_table — the abstraction
- SecretScanProgram — the secret path as a program
- LicenseScanProgram — SPDX license classification on the gram sieve
- default_programs / make_program_engine — construction
"""

from trivy_tpu_torch.programs.base import (
    ProgramCompileError,
    ProgramTable,
    ScanProgram,
    build_program_table,
)
from trivy_tpu_torch.programs.factory import default_programs, make_program_engine
from trivy_tpu_torch.programs.license import LicenseScanProgram
from trivy_tpu_torch.programs.secret import SecretScanProgram

__all__ = [
    "LicenseScanProgram",
    "ProgramCompileError",
    "ProgramTable",
    "ScanProgram",
    "SecretScanProgram",
    "build_program_table",
    "default_programs",
    "make_program_engine",
]
