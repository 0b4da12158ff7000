"""Wire conversion: result/blob model <-> JSON payloads.

The pkg/rpc/convert.go analogue.  The JSON field names are the same ones the
report writer emits (ftypes/atypes to_json), so the client/server split is
proved lossless by the same serialization the reference proves with its
Go<->proto converters.

Copied from `trivy_tpu/rpc/convert.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from typing import Any

from trivy_tpu_torch.atypes import BlobInfo, OS, Package, _secret_from_json
from trivy_tpu_torch.ftypes import DetectedVulnerability, Result, ResultClass
from trivy_tpu_torch.ltypes import LicenseFinding
from trivy_tpu_torch.misconf.types import MisconfFinding


def result_to_json(r: Result) -> dict[str, Any]:
    return r.to_json()


def result_from_json(d: dict[str, Any]) -> Result:
    secrets = []
    for s in d.get("Secrets") or []:
        secrets.extend(
            _secret_from_json({"FilePath": d.get("Target", ""), "Findings": [s]}).findings
        )
    return Result(
        target=d.get("Target", ""),
        result_class=ResultClass(d.get("Class", "custom")),
        result_type=d.get("Type", ""),
        secrets=secrets,
        vulnerabilities=[
            DetectedVulnerability.from_json(v)
            for v in (d.get("Vulnerabilities") or [])
        ],
        misconfigurations=[
            MisconfFinding.from_json(m)
            for m in (d.get("Misconfigurations") or [])
        ],
        licenses=[
            LicenseFinding.from_json(l) for l in (d.get("Licenses") or [])
        ],
        packages=[Package.from_json(p) for p in (d.get("Packages") or [])],
    )


def os_to_json(os_obj) -> dict[str, Any] | None:
    if os_obj is None:
        return None
    return os_obj.to_json() if hasattr(os_obj, "to_json") else None


def os_from_json(d: dict[str, Any] | None):
    return OS.from_json(d) if d else None


def blob_to_json(b: BlobInfo) -> dict[str, Any]:
    return b.to_json()


def blob_from_json(d: dict[str, Any]) -> BlobInfo:
    return BlobInfo.from_json(d)
