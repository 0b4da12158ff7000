"""CycloneDX 1.5 JSON encode/decode (pkg/sbom/cyclonedx/).

Copied from `trivy_tpu/sbom/cyclonedx.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
One repair: the encoder writes an OS package's purl with the OS family as
its type (`pkg:debian/...`, as the reference's does), which the
reference's decoder read as an application of that type, so `sbom` over
its own output lost the OS packages; the port's decoder reads a purl
whose type is the document's operating-system component as an OS package.
"""

from __future__ import annotations

from typing import Any

from trivy_tpu_torch import __version__
from trivy_tpu_torch.atypes import Application, ArtifactDetail, OS, Package
from trivy_tpu_torch.ftypes import Report
from trivy_tpu_torch.purl import OS_PURL_TYPES, PURL_TO_APP, package_url, parse_purl

SPEC_VERSION = "1.5"


def encode_report(report: Report) -> dict[str, Any]:
    """report -> CycloneDX BOM (the --format cyclonedx writer)."""
    components: list[dict[str, Any]] = []
    for result in report.results:
        pkg_type = result.result_type
        for pkg in result.packages:
            purl = package_url(pkg_type, pkg.name, pkg.version)
            comp = {
                "bom-ref": purl,
                "type": "library",
                "name": pkg.name,
                "version": pkg.version,
                "purl": purl,
            }
            if pkg.licenses:
                comp["licenses"] = [
                    {"license": {"name": l}} for l in pkg.licenses
                ]
            components.append(comp)

    if report.metadata.os_family:
        components.insert(
            0,
            {
                "bom-ref": f"os:{report.metadata.os_family}",
                "type": "operating-system",
                "name": report.metadata.os_family,
                "version": report.metadata.os_name,
            },
        )

    return {
        "bomFormat": "CycloneDX",
        "specVersion": SPEC_VERSION,
        "version": 1,
        "metadata": {
            "tools": {
                "components": [
                    {
                        "type": "application",
                        "name": "trivy-tpu",
                        "version": __version__,
                    }
                ]
            },
            "component": {
                "type": _artifact_component_type(report.artifact_type.value),
                "name": report.artifact_name,
            },
        },
        "components": components,
    }


def _artifact_component_type(artifact_type: str) -> str:
    return "container" if artifact_type == "container_image" else "application"


def decode(bom: dict[str, Any]) -> ArtifactDetail:
    """CycloneDX BOM -> ArtifactDetail (the sbom artifact input)."""
    apps: dict[str, Application] = {}
    detail = ArtifactDetail()
    os_types = OS_PURL_TYPES | {c.get("name", "") for c in bom.get("components") or []
                                if c.get("type") == "operating-system"}
    for comp in bom.get("components") or []:
        if comp.get("type") == "operating-system":
            continue  # handled below as detail.os, not a package
        purl = comp.get("purl", "")
        ptype, name, version = parse_purl(purl)
        if not name:
            name, version = comp.get("name", ""), comp.get("version", "")
        if not name or not version:
            continue
        if ptype in os_types:
            detail.packages.append(
                Package(id=f"{name}@{version}", name=name, version=version)
            )
            continue
        app_type = PURL_TO_APP.get(ptype, ptype or "unknown")
        app = apps.setdefault(
            app_type, Application(app_type=app_type, file_path="")
        )
        app.packages.append(
            Package(id=f"{name}@{version}", name=name, version=version)
        )

    # OS metadata components (trivy emits an operating-system component)
    meta_comp = (bom.get("metadata") or {}).get("component") or {}
    for prop in meta_comp.get("properties") or []:
        if prop.get("name") == "aquasecurity:trivy:OSFamily":
            detail.os = OS(family=prop.get("value", ""))
    for comp in bom.get("components") or []:
        if comp.get("type") == "operating-system":
            detail.os = OS(
                family=comp.get("name", ""), name=comp.get("version", "")
            )

    detail.applications = list(apps.values())
    return detail
