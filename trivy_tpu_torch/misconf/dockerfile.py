"""Dockerfile parsing + the misconf facade's dockerfile entry point.

The instruction parser feeds both the rego input builder
(trivy_tpu_torch/iac/inputs.py, mirroring the reference's buildkit-parsed
Stages/Commands shape) and the image-history analyzer; the DS-series
checks themselves are .rego policies under trivy_tpu_torch/iac/checks/.

Copied from `trivy_tpu/misconf/dockerfile.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from trivy_tpu_torch.misconf.types import Misconfiguration


@dataclass
class Instruction:
    cmd: str
    value: str
    start_line: int
    end_line: int


def parse_dockerfile(content: bytes) -> list[Instruction]:
    out: list[Instruction] = []
    lines = content.decode("utf-8", errors="replace").splitlines()
    i = 0
    while i < len(lines):
        raw = lines[i].strip()
        start = i + 1
        if not raw or raw.startswith("#"):
            i += 1
            continue
        # continuation lines
        while raw.endswith("\\") and i + 1 < len(lines):
            i += 1
            raw = raw[:-1].rstrip() + " " + lines[i].strip()
        m = re.match(r"(\S+)\s*(.*)", raw)
        if m:
            out.append(
                Instruction(
                    cmd=m.group(1).upper(),
                    value=m.group(2),
                    start_line=start,
                    end_line=i + 1,
                )
            )
        i += 1
    return out


def scan_dockerfile(file_path: str, content: bytes) -> Misconfiguration:
    """Rego-driven dockerfile scan (DS-series checks in trivy_tpu_torch/iac/checks).

    Kept as the misconf facade entry point; the hand-coded Python checks
    this module originally carried are now .rego policies evaluated by
    trivy_tpu_torch/iac (the same engine user checks load into).
    """
    from trivy_tpu_torch.iac.engine import shared_scanner

    mc = shared_scanner().scan(file_path, content)
    if mc is None:
        return Misconfiguration(file_type="dockerfile", file_path=file_path)
    return mc
