"""Misconfiguration types (pkg/fanal/types/misconf.go).

Copied from `trivy_tpu/misconf/types.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class MisconfFinding:
    """One check outcome (types.MisconfResult / DetectedMisconfiguration)."""

    check_id: str
    title: str
    description: str = ""
    message: str = ""
    resolution: str = ""
    severity: str = "MEDIUM"
    status: str = "FAIL"  # FAIL | PASS
    start_line: int = 0
    end_line: int = 0
    references: list[str] = field(default_factory=list)
    traces: list[str] = field(default_factory=list)  # --trace rego traces

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "Type": "",
            "ID": self.check_id,
            "Title": self.title,
            "Description": self.description,
            "Message": self.message,
            "Resolution": self.resolution,
            "Severity": self.severity,
            "Status": self.status,
        }
        if self.references:
            out["References"] = self.references
        if self.traces:
            out["Traces"] = self.traces
        if self.start_line:
            out["CauseMetadata"] = {
                "StartLine": self.start_line,
                "EndLine": self.end_line or self.start_line,
            }
        return out

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "MisconfFinding":
        cause = d.get("CauseMetadata") or {}
        return cls(
            check_id=d.get("ID", ""),
            title=d.get("Title", ""),
            description=d.get("Description", ""),
            message=d.get("Message", ""),
            resolution=d.get("Resolution", ""),
            severity=d.get("Severity", "MEDIUM"),
            status=d.get("Status", "FAIL"),
            start_line=cause.get("StartLine", 0),
            end_line=cause.get("EndLine", 0),
            references=list(d.get("References") or []),
            traces=list(d.get("Traces") or []),
        )


@dataclass
class Misconfiguration:
    """types.Misconfiguration — per (file, checker) outcome bundle."""

    file_type: str
    file_path: str
    failures: list[MisconfFinding] = field(default_factory=list)
    successes: list[MisconfFinding] = field(default_factory=list)
    layer: Any = None

    def to_json(self) -> dict[str, Any]:
        return {
            "FileType": self.file_type,
            "FilePath": self.file_path,
            "Failures": [f.to_json() for f in self.failures],
            "Successes": [s.to_json() for s in self.successes],
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Misconfiguration":
        return cls(
            file_type=d.get("FileType", ""),
            file_path=d.get("FilePath", ""),
            failures=[
                MisconfFinding.from_json(f) for f in (d.get("Failures") or [])
            ],
            successes=[
                MisconfFinding.from_json(s) for s in (d.get("Successes") or [])
            ],
        )
