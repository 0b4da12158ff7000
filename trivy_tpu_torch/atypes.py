"""Artifact/blob cache schema types.

Mirrors pkg/fanal/types/artifact.go: ArtifactInfo, BlobInfo (the cache value
schema, versioned), ArtifactDetail (the post-applier merged view), OS, Package
containers.  JSON field names match the reference so cached blobs and RPC
payloads are wire-compatible.

Copied from `trivy_tpu/atypes.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from trivy_tpu_torch.ftypes import Secret, SecretFinding, Code, Line, Layer

ARTIFACT_JSON_SCHEMA_VERSION = 1  # artifact.go ArtifactJSONSchemaVersion
BLOB_JSON_SCHEMA_VERSION = 2  # artifact.go BlobJSONSchemaVersion


@dataclass
class OS:
    """types.OS (pkg/fanal/types/artifact.go:17)."""

    family: str = ""
    name: str = ""
    extended_support: bool = False  # eosl

    def is_empty(self) -> bool:
        return not (self.family or self.name)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"Family": self.family, "Name": self.name}
        if self.extended_support:
            out["Extended"] = True
        return out

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "OS":
        return cls(
            family=d.get("Family", ""),
            name=d.get("Name", ""),
            extended_support=d.get("Extended", False),
        )


@dataclass
class Package:
    """types.Package (artifact.go:79) — subset used by detectors."""

    name: str = ""
    version: str = ""
    release: str = ""
    epoch: int = 0
    arch: str = ""
    src_name: str = ""
    src_version: str = ""
    src_release: str = ""
    src_epoch: int = 0
    licenses: list[str] = field(default_factory=list)
    layer: Layer = field(default_factory=Layer)
    file_path: str = ""
    dev: bool = False
    indirect: bool = False
    depends_on: list[str] = field(default_factory=list)
    id: str = ""

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"Name": self.name, "Version": self.version}
        if self.id:
            out["ID"] = self.id
        if self.release:
            out["Release"] = self.release
        if self.epoch:
            out["Epoch"] = self.epoch
        if self.arch:
            out["Arch"] = self.arch
        if self.src_name:
            out["SrcName"] = self.src_name
        if self.src_version:
            out["SrcVersion"] = self.src_version
        if self.src_release:
            out["SrcRelease"] = self.src_release
        if self.src_epoch:
            out["SrcEpoch"] = self.src_epoch
        if self.licenses:
            out["Licenses"] = self.licenses
        if self.dev:
            out["Dev"] = True
        if self.indirect:
            out["Indirect"] = True
        if self.depends_on:
            out["DependsOn"] = self.depends_on
        if self.file_path:
            out["FilePath"] = self.file_path
        if not self.layer.empty():
            out["Layer"] = self.layer.to_json()
        return out

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Package":
        layer = d.get("Layer") or {}
        return cls(
            name=d.get("Name", ""),
            version=d.get("Version", ""),
            id=d.get("ID", ""),
            release=d.get("Release", ""),
            epoch=d.get("Epoch", 0),
            arch=d.get("Arch", ""),
            src_name=d.get("SrcName", ""),
            src_version=d.get("SrcVersion", ""),
            src_release=d.get("SrcRelease", ""),
            src_epoch=d.get("SrcEpoch", 0),
            licenses=list(d.get("Licenses") or []),
            dev=d.get("Dev", False),
            indirect=d.get("Indirect", False),
            depends_on=list(d.get("DependsOn") or []),
            file_path=d.get("FilePath", ""),
            layer=Layer(
                digest=layer.get("Digest", ""), diff_id=layer.get("DiffID", "")
            ),
        )


@dataclass
class PackageInfo:
    """types.PackageInfo (artifact.go)."""

    file_path: str = ""
    packages: list[Package] = field(default_factory=list)

    def to_json(self) -> dict[str, Any]:
        return {
            "FilePath": self.file_path,
            "Packages": [p.to_json() for p in self.packages],
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "PackageInfo":
        return cls(
            file_path=d.get("FilePath", ""),
            packages=[Package.from_json(p) for p in (d.get("Packages") or [])],
        )


@dataclass
class Application:
    """types.Application (artifact.go:256) — one lockfile/app manifest."""

    app_type: str = ""
    file_path: str = ""
    packages: list[Package] = field(default_factory=list)

    def to_json(self) -> dict[str, Any]:
        return {
            "Type": self.app_type,
            "FilePath": self.file_path,
            "Packages": [p.to_json() for p in self.packages],
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Application":
        return cls(
            app_type=d.get("Type", ""),
            file_path=d.get("FilePath", ""),
            packages=[Package.from_json(p) for p in (d.get("Packages") or [])],
        )


def _secret_to_json(s: Secret) -> dict[str, Any]:
    return {
        "FilePath": s.file_path,
        "Findings": [f.to_json() for f in s.findings],
    }


def _secret_from_json(d: dict[str, Any]) -> Secret:
    findings = []
    for f in d.get("Findings") or []:
        code = Code(
            lines=[
                Line(
                    number=l.get("Number", 0),
                    content=l.get("Content", ""),
                    is_cause=l.get("IsCause", False),
                    annotation=l.get("Annotation", ""),
                    truncated=l.get("Truncated", False),
                    highlighted=l.get("Highlighted", ""),
                    first_cause=l.get("FirstCause", False),
                    last_cause=l.get("LastCause", False),
                )
                for l in (f.get("Code", {}).get("Lines") or [])
            ]
        )
        layer = f.get("Layer") or {}
        findings.append(
            SecretFinding(
                rule_id=f.get("RuleID", ""),
                category=f.get("Category", ""),
                severity=f.get("Severity", ""),
                title=f.get("Title", ""),
                start_line=f.get("StartLine", 0),
                end_line=f.get("EndLine", 0),
                code=code,
                match=f.get("Match", ""),
                layer=Layer(
                    digest=layer.get("Digest", ""),
                    diff_id=layer.get("DiffID", ""),
                    created_by=layer.get("CreatedBy", ""),
                ),
            )
        )
    return Secret(file_path=d.get("FilePath", ""), findings=findings)


@dataclass
class ArtifactInfo:
    """types.ArtifactInfo (artifact.go:325) — image-level cache value."""

    schema_version: int = ARTIFACT_JSON_SCHEMA_VERSION
    architecture: str = ""
    created: str = ""
    docker_version: str = ""
    os_name: str = ""

    def to_json(self) -> dict[str, Any]:
        return {
            "SchemaVersion": self.schema_version,
            "Architecture": self.architecture,
            "Created": self.created,
            "DockerVersion": self.docker_version,
            "OS": self.os_name,
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ArtifactInfo":
        return cls(
            schema_version=d.get("SchemaVersion", ARTIFACT_JSON_SCHEMA_VERSION),
            architecture=d.get("Architecture", ""),
            created=d.get("Created", ""),
            docker_version=d.get("DockerVersion", ""),
            os_name=d.get("OS", ""),
        )


@dataclass
class BlobInfo:
    """types.BlobInfo (artifact.go) — per-layer/per-blob cache value."""

    schema_version: int = BLOB_JSON_SCHEMA_VERSION
    digest: str = ""
    diff_id: str = ""
    created_by: str = ""
    opaque_dirs: list[str] = field(default_factory=list)
    whiteout_files: list[str] = field(default_factory=list)
    os: OS | None = None
    package_infos: list[PackageInfo] = field(default_factory=list)
    applications: list[Application] = field(default_factory=list)
    secrets: list[Secret] = field(default_factory=list)
    licenses: list = field(default_factory=list)
    misconfigurations: list = field(default_factory=list)
    # Extension-module outputs (module.go CustomResources): opaque JSON
    # values threaded through the cache/applier to post-scan hooks.
    custom_resources: list = field(default_factory=list)
    build_info: dict | None = None  # Red Hat buildinfo (types.BuildInfo)

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"SchemaVersion": self.schema_version}
        if self.digest:
            out["Digest"] = self.digest
        if self.diff_id:
            out["DiffID"] = self.diff_id
        if self.created_by:
            out["CreatedBy"] = self.created_by
        if self.opaque_dirs:
            out["OpaqueDirs"] = self.opaque_dirs
        if self.whiteout_files:
            out["WhiteoutFiles"] = self.whiteout_files
        if self.os is not None and not self.os.is_empty():
            out["OS"] = self.os.to_json()
        if self.package_infos:
            out["PackageInfos"] = [p.to_json() for p in self.package_infos]
        if self.applications:
            out["Applications"] = [a.to_json() for a in self.applications]
        if self.secrets:
            out["Secrets"] = [_secret_to_json(s) for s in self.secrets]
        if self.licenses:
            out["Licenses"] = [
                l.to_json() if hasattr(l, "to_json") else l for l in self.licenses
            ]
        if self.misconfigurations:
            out["Misconfigurations"] = [
                m.to_json() if hasattr(m, "to_json") else m
                for m in self.misconfigurations
            ]
        if self.custom_resources:
            out["CustomResources"] = list(self.custom_resources)
        if self.build_info:
            out["BuildInfo"] = dict(self.build_info)
        return out

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "BlobInfo":
        return cls(
            schema_version=d.get("SchemaVersion", BLOB_JSON_SCHEMA_VERSION),
            digest=d.get("Digest", ""),
            diff_id=d.get("DiffID", ""),
            created_by=d.get("CreatedBy", ""),
            opaque_dirs=list(d.get("OpaqueDirs") or []),
            whiteout_files=list(d.get("WhiteoutFiles") or []),
            os=OS.from_json(d["OS"]) if d.get("OS") else None,
            package_infos=[
                PackageInfo.from_json(p) for p in (d.get("PackageInfos") or [])
            ],
            applications=[
                Application.from_json(a) for a in (d.get("Applications") or [])
            ],
            secrets=[_secret_from_json(s) for s in (d.get("Secrets") or [])],
            licenses=[_license_from_json(l) for l in (d.get("Licenses") or [])],
            misconfigurations=[
                _misconf_from_json(m) for m in (d.get("Misconfigurations") or [])
            ],
            custom_resources=list(d.get("CustomResources") or []),
            build_info=d.get("BuildInfo") or None,
        )


def _license_from_json(d: dict[str, Any]):
    from trivy_tpu_torch.ltypes import LicenseFile

    return LicenseFile.from_json(d) if isinstance(d, dict) else d


def _misconf_from_json(d: dict[str, Any]):
    from trivy_tpu_torch.misconf.types import Misconfiguration

    return Misconfiguration.from_json(d) if isinstance(d, dict) else d


@dataclass
class ArtifactDetail:
    """types.ArtifactDetail (artifact.go:355) — applier output."""

    os: OS | None = None
    repository: object | None = None
    packages: list[Package] = field(default_factory=list)
    package_infos: list[PackageInfo] = field(default_factory=list)
    applications: list[Application] = field(default_factory=list)
    secrets: list[Secret] = field(default_factory=list)
    licenses: list = field(default_factory=list)
    misconfigurations: list = field(default_factory=list)
    custom_resources: list = field(default_factory=list)
    build_info: dict | None = None  # Red Hat buildinfo (merged over layers)


@dataclass
class ArtifactReference:
    """artifact.Reference (pkg/fanal/artifact/artifact.go)."""

    name: str
    artifact_type: str
    id: str
    blob_ids: list[str] = field(default_factory=list)
    image_metadata: dict[str, Any] = field(default_factory=dict)
