"""SPDX 2.3 JSON encode/decode (pkg/sbom/spdx/).

Copied from `trivy_tpu/sbom/spdx.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
`decode` reads a purl whose type is the document's operating-system
element as an OS package (the repair `sbom/cyclonedx.py` describes).
"""

from __future__ import annotations

import re
import uuid
from typing import Any

from trivy_tpu_torch import __version__
from trivy_tpu_torch.atypes import Application, ArtifactDetail, OS, Package
from trivy_tpu_torch.ftypes import Report, ResultClass
from trivy_tpu_torch.purl import OS_PURL_TYPES, PURL_TO_APP, package_url, parse_purl

# Deterministic namespace derivation (instead of the reference's random
# uuid): same artifact + creation time -> same DocumentNamespace, so
# SBOM output is reproducible and golden-testable.
_NAMESPACE_BASE = "https://trivy-tpu.dev/spdxdocs"


def _document_namespace(report: Report) -> str:
    name = report.artifact_name or "unknown"
    seed = f"{name}-{report.created_at or ''}"
    # path-like artifact names must still yield a valid URI segment
    safe = re.sub(r"[^A-Za-z0-9.+-]", "-", name).strip("-") or "unknown"
    return f"{_NAMESPACE_BASE}/{safe}-{uuid.uuid5(uuid.NAMESPACE_URL, seed)}"


def encode_report(report: Report) -> dict[str, Any]:
    packages = []
    relationships: list[dict[str, str]] = []
    idx = 0
    os_id = None
    if report.metadata.os_family:
        os_id = "SPDXRef-OperatingSystem"
        packages.append(
            {
                "SPDXID": os_id,
                "name": report.metadata.os_family,
                "versionInfo": report.metadata.os_name,
                "downloadLocation": "NONE",
                "primaryPackagePurpose": "OPERATING-SYSTEM",
            }
        )
        relationships.append(
            {
                "spdxElementId": "SPDXRef-DOCUMENT",
                "relatedSpdxElement": os_id,
                "relationshipType": "DESCRIBES",
            }
        )
    for result in report.results:
        os_pkgs = result.result_class == ResultClass.OS_PKGS
        for pkg in result.packages:
            idx += 1
            spdx_id = f"SPDXRef-Package-{idx}"
            purl = package_url(result.result_type, pkg.name, pkg.version)
            packages.append(
                {
                    "SPDXID": spdx_id,
                    "name": pkg.name,
                    "versionInfo": pkg.version,
                    "downloadLocation": "NONE",
                    "licenseConcluded": " AND ".join(pkg.licenses) or "NOASSERTION",
                    "externalRefs": [
                        {
                            "referenceCategory": "PACKAGE-MANAGER",
                            "referenceType": "purl",
                            "referenceLocator": purl,
                        }
                    ],
                }
            )
            if os_pkgs and os_id:
                # OS packages hang off the operating system element
                relationships.append(
                    {
                        "spdxElementId": os_id,
                        "relatedSpdxElement": spdx_id,
                        "relationshipType": "CONTAINS",
                    }
                )
            else:
                relationships.append(
                    {
                        "spdxElementId": "SPDXRef-DOCUMENT",
                        "relatedSpdxElement": spdx_id,
                        "relationshipType": "DESCRIBES",
                    }
                )
    return {
        "spdxVersion": "SPDX-2.3",
        "dataLicense": "CC0-1.0",
        "SPDXID": "SPDXRef-DOCUMENT",
        "name": report.artifact_name,
        "documentNamespace": _document_namespace(report),
        "creationInfo": {
            "creators": [f"Tool: trivy-tpu-{__version__}"],
            "created": report.created_at or "1970-01-01T00:00:00Z",
        },
        "packages": packages,
        "relationships": relationships,
    }


def encode_tag_value(report: Report) -> str:
    """The SPDX tag-value rendering (the reference's `--format spdx`,
    pkg/report FormatSPDX): the same document the JSON encoder builds,
    serialized as `Tag: value` stanzas separated by blank lines."""
    doc = encode_report(report)
    lines = [
        f"SPDXVersion: {doc['spdxVersion']}",
        f"DataLicense: {doc['dataLicense']}",
        f"SPDXID: {doc['SPDXID']}",
        f"DocumentName: {doc['name']}",
        f"DocumentNamespace: {doc['documentNamespace']}",
        f"Creator: {doc['creationInfo']['creators'][0]}",
        f"Created: {doc['creationInfo']['created']}",
    ]
    for pkg in doc["packages"]:
        lines.append("")
        lines.append(f"PackageName: {pkg['name']}")
        lines.append(f"SPDXID: {pkg['SPDXID']}")
        if pkg.get("versionInfo"):
            lines.append(f"PackageVersion: {pkg['versionInfo']}")
        lines.append(f"PackageDownloadLocation: {pkg['downloadLocation']}")
        if pkg.get("licenseConcluded"):
            lines.append(f"PackageLicenseConcluded: {pkg['licenseConcluded']}")
        if pkg.get("primaryPackagePurpose"):
            lines.append(
                f"PrimaryPackagePurpose: {pkg['primaryPackagePurpose']}"
            )
        for ref in pkg.get("externalRefs") or []:
            lines.append(
                "ExternalRef: "
                f"{ref['referenceCategory']} {ref['referenceType']} "
                f"{ref['referenceLocator']}"
            )
    if doc.get("relationships"):
        lines.append("")
        for rel in doc["relationships"]:
            lines.append(
                "Relationship: "
                f"{rel['spdxElementId']} {rel['relationshipType']} "
                f"{rel['relatedSpdxElement']}"
            )
    return "\n".join(lines) + "\n"


def is_tag_value(text: str) -> bool:
    """True when the first non-comment, non-blank line is the tag-value
    version stanza (sbom.go's text sniff, tolerant of comment headers the
    parser itself accepts)."""
    for raw in text[:2048].splitlines():  # the stanza leads the document
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        return line.startswith("SPDXVersion:")
    return False


def decode_tag_value(text: str) -> ArtifactDetail:
    """SPDX tag-value input -> the same document dict the JSON decoder
    consumes (packages with purl externalRefs / OS purpose), then the
    shared decode."""
    packages: list[dict[str, Any]] = []
    doc: dict[str, Any] = {"packages": packages}
    cur: dict[str, Any] | None = None
    in_text = False
    for raw in text.splitlines():
        line = raw.strip()
        if in_text:
            # multi-line <text>...</text> value: free text, never tags
            if "</text>" in line:
                in_text = False
            continue
        if not line or line.startswith("#"):
            continue
        tag, _, value = line.partition(":")
        if "<text>" in value and "</text>" not in value:
            in_text = True
            continue
        value = value.strip()
        if tag == "DocumentName":
            doc["name"] = value
        elif tag == "PackageName":
            cur = {"name": value}
            packages.append(cur)
        elif cur is not None and tag == "PackageVersion":
            cur["versionInfo"] = value
        elif cur is not None and tag == "PrimaryPackagePurpose":
            cur["primaryPackagePurpose"] = value
        elif cur is not None and tag == "ExternalRef":
            parts = value.split()
            if len(parts) == 3:
                cur.setdefault("externalRefs", []).append(
                    {
                        "referenceCategory": parts[0],
                        "referenceType": parts[1],
                        "referenceLocator": parts[2],
                    }
                )
    return decode(doc)


def decode(doc: dict[str, Any]) -> ArtifactDetail:
    detail = ArtifactDetail()
    apps: dict[str, Application] = {}
    os_types = OS_PURL_TYPES | {p.get("name", "") for p in doc.get("packages") or []
                                if p.get("primaryPackagePurpose") == "OPERATING-SYSTEM"}
    for pkg in doc.get("packages") or []:
        if pkg.get("primaryPackagePurpose") == "OPERATING-SYSTEM":
            detail.os = OS(
                family=pkg.get("name", ""), name=pkg.get("versionInfo", "")
            )
            continue
        purl = ""
        for ref in pkg.get("externalRefs") or []:
            if ref.get("referenceType") == "purl":
                purl = ref.get("referenceLocator", "")
        ptype, name, version = parse_purl(purl)
        if not name:
            name, version = pkg.get("name", ""), pkg.get("versionInfo", "")
        if not name or not version or name == doc.get("name"):
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
    detail.applications = list(apps.values())
    return detail
