"""Program-engine construction, the twin of `trivy_tpu/programs/factory.py`.

`make_program_engine` is to multi-program scanning what
`make_secret_engine` is to secrets: the one place a program table turns
into an engine, and (`rules_cache_dir`) the place its compile goes through
the program-id-keyed artifact registry (`registry/store.py`).
"""

from __future__ import annotations

import torch

from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.engine.hybrid import make_secret_engine
from trivy_tpu_torch.programs.base import ProgramTable, build_program_table
from trivy_tpu_torch.programs.license import LicenseScanProgram
from trivy_tpu_torch.programs.secret import SecretScanProgram
from trivy_tpu_torch.registry.store import get_or_compile


def default_programs(config=None) -> list:
    """The stock table: the builtin secret ruleset plus the SPDX license
    program, one sieve pass for both."""
    return [SecretScanProgram(config=config), LicenseScanProgram()]


def make_program_engine(
    programs: list | ProgramTable | None = None,
    *,
    config=None,
    backend: str = "auto",
    device: str | torch.device = DEFAULT_DEVICE,
    mesh=None,
    rules_cache_dir: str | None = None,
    **kw,
):
    """Build a multi-program engine over one merged sieve pass.

    `programs` is a list of ScanPrograms (or a prebuilt ProgramTable);
    None = `default_programs(config)`.  `backend` accepts the
    make_secret_engine engine backends (auto/device/native/hybrid; alias
    tpu = device): device builds `GpuSecretEngine` over the device sieve,
    the others `GpuSecretEngine(sieve="native")`, the reference hybrid's
    program path; the oracle backend has no sieve and therefore no program
    demux.  `compiled` (in `kw`) takes the merged table's
    `CompiledArtifact`, `CompiledRules` or the reference's arrays.
    `rules_cache_dir` routes every compile through the registry's
    program-id-keyed warm path: the merged table under
    `programs/<table_id>/<digest>`, and each member program's own artifact
    warmed too, so a standalone engine for any member starts warm from the
    same store.  `mesh` (a `mesh.topology.Mesh`, a list of devices, or
    None for `topology.engine_mesh`'s) passes through to `make_secret_engine`:
    the device engine's sieve splits over its lanes."""
    if programs is None:
        programs = default_programs(config)
    table = (
        programs
        if isinstance(programs, ProgramTable)
        else build_program_table(programs)
    )
    backend = {"tpu": "device"}.get(backend, backend)
    if backend in ("oracle", "cpu"):
        raise ValueError(
            "the oracle backend has no device pass to demux programs from"
        )
    merged = table.merged_ruleset()
    if rules_cache_dir is not None and "compiled" not in kw:
        kw["compiled"], _ = get_or_compile(merged, cache_dir=rules_cache_dir,
                                           program_id=table.table_id)
        for prog in table.programs:
            get_or_compile(prog.ruleset(), cache_dir=rules_cache_dir,
                           program_id=prog.program_id)
    return make_secret_engine(
        ruleset=merged,
        backend=backend,
        device=device,
        mesh=mesh,
        program_table=table,
        **kw,
    )
