"""Protobuf wire <-> internal JSON-dict conversion for the Twirp services.

The pkg/rpc/convert.go analogue for the binary wire: every function maps
between this framework's canonical JSON field names (what rpc/convert.py
and the report writers speak) and the proto messages generated from
rpc/proto/*.proto.  The JSON dicts stay the single internal currency — the
server and client call these at the edge only, so protobuf and JSON
clients see identical semantics.

Unpopulated reference fields (timestamps, custom advisory data, CWE ids)
round-trip as proto defaults; adding them later is additive.
"""

from __future__ import annotations

from typing import Any

from trivy_tpu_torch.result.filter import SEVERITIES as _SEVERITIES
from trivy_tpu_torch.rpc.protogen import load

_LICENSE_CATEGORIES = [
    "", "forbidden", "restricted", "reciprocal", "notice", "permissive",
    "unencumbered", "unknown",
]


def _sev_enum(s: str) -> int:
    try:
        return _SEVERITIES.index((s or "UNKNOWN").upper())
    except ValueError:
        return 0


def _sev_str(v: int) -> str:
    return _SEVERITIES[v] if 0 <= v < len(_SEVERITIES) else "UNKNOWN"


def _cat_enum(s: str) -> int:
    try:
        return _LICENSE_CATEGORIES.index((s or "").lower())
    except ValueError:
        return 7  # UNKNOWN


def _cat_str(v: int) -> str:
    return (
        _LICENSE_CATEGORIES[v]
        if 0 < v < len(_LICENSE_CATEGORIES)
        else ("unknown" if v else "")
    )


# -- code / layers ---------------------------------------------------------


def _code_to_pb(d: dict | None, msg) -> None:
    for line in (d or {}).get("Lines") or []:
        pb = msg.lines.add()
        pb.number = line.get("Number", 0)
        pb.content = line.get("Content", "")
        pb.is_cause = line.get("IsCause", False)
        pb.annotation = line.get("Annotation", "")
        pb.truncated = line.get("Truncated", False)
        pb.highlighted = line.get("Highlighted", "")
        pb.first_cause = line.get("FirstCause", False)
        pb.last_cause = line.get("LastCause", False)


def _code_from_pb(msg) -> dict | None:
    if not msg.lines:
        return None
    return {
        "Lines": [
            {
                "Number": ln.number,
                "Content": ln.content,
                "IsCause": ln.is_cause,
                "Annotation": ln.annotation,
                "Truncated": ln.truncated,
                "Highlighted": ln.highlighted,
                "FirstCause": ln.first_cause,
                "LastCause": ln.last_cause,
            }
            for ln in msg.lines
        ]
    }


def _layer_to_pb(d: dict | None, msg) -> None:
    if not d:
        return
    msg.digest = d.get("Digest", "")
    msg.diff_id = d.get("DiffID", "")
    msg.created_by = d.get("CreatedBy", "")


def _layer_from_pb(msg) -> dict | None:
    if not (msg.digest or msg.diff_id or msg.created_by):
        return None
    out: dict = {}
    if msg.digest:
        out["Digest"] = msg.digest
    if msg.diff_id:
        out["DiffID"] = msg.diff_id
    if msg.created_by:
        out["CreatedBy"] = msg.created_by
    return out


# -- findings --------------------------------------------------------------


def secret_finding_to_pb(d: dict, msg) -> None:
    msg.rule_id = d.get("RuleID", "")
    msg.category = d.get("Category", "")
    msg.severity = d.get("Severity", "")
    msg.title = d.get("Title", "")
    msg.start_line = d.get("StartLine", 0)
    msg.end_line = d.get("EndLine", 0)
    msg.match = d.get("Match", "")
    _code_to_pb(d.get("Code"), msg.code)
    _layer_to_pb(d.get("Layer"), msg.layer)


def secret_finding_from_pb(msg) -> dict:
    out = {
        "RuleID": msg.rule_id,
        "Category": msg.category,
        "Severity": msg.severity,
        "Title": msg.title,
        "StartLine": msg.start_line,
        "EndLine": msg.end_line,
        "Match": msg.match,
    }
    code = _code_from_pb(msg.code)
    if code:
        out["Code"] = code
    layer = _layer_from_pb(msg.layer)
    if layer:
        out["Layer"] = layer
    return out


def vuln_to_pb(d: dict, msg) -> None:
    msg.vulnerability_id = d.get("VulnerabilityID", "")
    msg.pkg_id = d.get("PkgID", "")
    msg.pkg_name = d.get("PkgName", "")
    msg.installed_version = d.get("InstalledVersion", "")
    msg.fixed_version = d.get("FixedVersion", "")
    msg.title = d.get("Title", "")
    msg.description = d.get("Description", "")
    msg.severity = _sev_enum(d.get("Severity", ""))
    msg.severity_source = d.get("SeveritySource", "")
    msg.primary_url = d.get("PrimaryURL", "")
    msg.pkg_path = d.get("PkgPath", "")
    for r in d.get("References") or []:
        msg.references.append(r)
    for src, sev in (d.get("VendorSeverity") or {}).items():
        msg.vendor_severity[src] = _sev_enum(sev)
    for src, cv in (d.get("CVSS") or {}).items():
        pb = msg.cvss[src]
        pb.v2_vector = cv.get("V2Vector", "")
        pb.v3_vector = cv.get("V3Vector", "")
        pb.v2_score = cv.get("V2Score", 0.0)
        pb.v3_score = cv.get("V3Score", 0.0)
    _layer_to_pb(d.get("Layer"), msg.layer)


def vuln_from_pb(msg) -> dict:
    out: dict = {
        "VulnerabilityID": msg.vulnerability_id,
        "PkgName": msg.pkg_name,
        "InstalledVersion": msg.installed_version,
        "FixedVersion": msg.fixed_version,
        "Severity": _sev_str(msg.severity),
    }
    if msg.pkg_id:
        out["PkgID"] = msg.pkg_id
    if msg.title:
        out["Title"] = msg.title
    if msg.description:
        out["Description"] = msg.description
    if msg.severity_source:
        out["SeveritySource"] = msg.severity_source
    if msg.primary_url:
        out["PrimaryURL"] = msg.primary_url
    if msg.pkg_path:
        out["PkgPath"] = msg.pkg_path
    if msg.references:
        out["References"] = list(msg.references)
    if msg.vendor_severity:
        out["VendorSeverity"] = {
            k: _sev_str(v) for k, v in msg.vendor_severity.items()
        }
    if msg.cvss:
        out["CVSS"] = {
            k: {
                "V2Vector": v.v2_vector,
                "V3Vector": v.v3_vector,
                "V2Score": v.v2_score,
                "V3Score": v.v3_score,
            }
            for k, v in msg.cvss.items()
        }
    layer = _layer_from_pb(msg.layer)
    if layer:
        out["Layer"] = layer
    return out


def misconf_to_pb(d: dict, msg) -> None:
    """DetectedMisconfiguration (result-level finding)."""
    msg.type = d.get("Type", "")
    msg.id = d.get("ID", "")
    msg.avd_id = d.get("AVDID", d.get("ID", ""))
    msg.title = d.get("Title", "")
    msg.description = d.get("Description", "")
    msg.message = d.get("Message", "")
    msg.namespace = d.get("Namespace", "")
    msg.resolution = d.get("Resolution", "")
    msg.severity = _sev_enum(d.get("Severity", ""))
    msg.primary_url = d.get("PrimaryURL", "")
    msg.status = d.get("Status", "")
    for r in d.get("References") or []:
        msg.references.append(r)
    cm = d.get("CauseMetadata") or {}
    msg.cause_metadata.start_line = cm.get("StartLine", 0)
    msg.cause_metadata.end_line = cm.get("EndLine", 0)
    msg.cause_metadata.resource = cm.get("Resource", "")


def misconf_from_pb(msg) -> dict:
    out: dict = {
        "Type": msg.type,
        "ID": msg.id,
        "Title": msg.title,
        "Description": msg.description,
        "Message": msg.message,
        "Resolution": msg.resolution,
        "Severity": _sev_str(msg.severity),
        "Status": msg.status,
    }
    if msg.namespace:
        out["Namespace"] = msg.namespace
    if msg.primary_url:
        out["PrimaryURL"] = msg.primary_url
    if msg.references:
        out["References"] = list(msg.references)
    if msg.cause_metadata.start_line or msg.cause_metadata.end_line:
        out["CauseMetadata"] = {
            "StartLine": msg.cause_metadata.start_line,
            "EndLine": msg.cause_metadata.end_line,
        }
    return out


def package_to_pb(d: dict, msg) -> None:
    msg.id = d.get("ID", "")
    msg.name = d.get("Name", "")
    msg.version = d.get("Version", "")
    msg.release = d.get("Release", "")
    msg.epoch = d.get("Epoch", 0)
    msg.arch = d.get("Arch", "")
    msg.src_name = d.get("SrcName", "")
    msg.src_version = d.get("SrcVersion", "")
    msg.src_release = d.get("SrcRelease", "")
    msg.src_epoch = d.get("SrcEpoch", 0)
    msg.file_path = d.get("FilePath", "")
    msg.digest = d.get("Digest", "")
    msg.dev = d.get("Dev", False)
    msg.indirect = d.get("Indirect", False)
    for lic in d.get("Licenses") or []:
        msg.licenses.append(lic)
    for dep in d.get("DependsOn") or []:
        msg.depends_on.append(dep)
    ident = d.get("Identifier") or {}
    if ident.get("PURL"):
        msg.identifier.purl = ident["PURL"]


def package_from_pb(msg) -> dict:
    out: dict = {"Name": msg.name, "Version": msg.version}
    for attr, key in (
        ("id", "ID"), ("release", "Release"), ("arch", "Arch"),
        ("src_name", "SrcName"), ("src_version", "SrcVersion"),
        ("src_release", "SrcRelease"), ("file_path", "FilePath"),
        ("digest", "Digest"),
    ):
        val = getattr(msg, attr)
        if val:
            out[key] = val
    if msg.epoch:
        out["Epoch"] = msg.epoch
    if msg.src_epoch:
        out["SrcEpoch"] = msg.src_epoch
    if msg.dev:
        out["Dev"] = True
    if msg.indirect:
        out["Indirect"] = True
    if msg.licenses:
        out["Licenses"] = list(msg.licenses)
    if msg.depends_on:
        out["DependsOn"] = list(msg.depends_on)
    if msg.identifier.purl:
        out["Identifier"] = {"PURL": msg.identifier.purl}
    return out


def license_to_pb(d: dict, msg) -> None:
    msg.severity = _sev_enum(d.get("Severity", ""))
    msg.category = _cat_enum(d.get("Category", ""))
    msg.pkg_name = d.get("PkgName", "")
    msg.file_path = d.get("FilePath", "")
    msg.name = d.get("Name", "")
    msg.confidence = d.get("Confidence", 0.0)
    msg.link = d.get("Link", "")


def license_from_pb(msg) -> dict:
    return {
        "Severity": _sev_str(msg.severity),
        "Category": _cat_str(msg.category),
        "PkgName": msg.pkg_name,
        "FilePath": msg.file_path,
        "Name": msg.name,
        "Confidence": round(msg.confidence, 6),
        "Link": msg.link,
    }


# -- scanner service -------------------------------------------------------


def result_to_pb(d: dict, msg) -> None:
    msg.target = d.get("Target", "")
    setattr(msg, "class", d.get("Class", ""))
    msg.type = d.get("Type", "")
    for v in d.get("Vulnerabilities") or []:
        vuln_to_pb(v, msg.vulnerabilities.add())
    for m in d.get("Misconfigurations") or []:
        misconf_to_pb(m, msg.misconfigurations.add())
    for p in d.get("Packages") or []:
        package_to_pb(p, msg.packages.add())
    for s in d.get("Secrets") or []:
        secret_finding_to_pb(s, msg.secrets.add())
    for lic in d.get("Licenses") or []:
        license_to_pb(lic, msg.licenses.add())


def result_from_pb(msg) -> dict:
    out: dict = {"Target": msg.target, "Class": getattr(msg, "class")}
    if msg.type:
        out["Type"] = msg.type
    if msg.vulnerabilities:
        out["Vulnerabilities"] = [vuln_from_pb(v) for v in msg.vulnerabilities]
    if msg.misconfigurations:
        out["Misconfigurations"] = [
            misconf_from_pb(m) for m in msg.misconfigurations
        ]
    if msg.packages:
        out["Packages"] = [package_from_pb(p) for p in msg.packages]
    if msg.secrets:
        out["Secrets"] = [secret_finding_from_pb(s) for s in msg.secrets]
    if msg.licenses:
        out["Licenses"] = [license_from_pb(lic) for lic in msg.licenses]
    return out


def scan_request_to_pb(d: dict):
    pb = load()["scanner"].ScanRequest()
    pb.target = d.get("Target", "")
    pb.artifact_id = d.get("ArtifactID", "")
    for b in d.get("BlobIDs") or []:
        pb.blob_ids.append(b)
    opts = d.get("Options") or {}
    for s in opts.get("Scanners") or []:
        pb.options.scanners.append(s)
    pb.options.list_all_packages = opts.get("ListAllPackages", False)
    return pb


def scan_request_from_pb(msg) -> dict:
    return {
        "Target": msg.target,
        "ArtifactID": msg.artifact_id,
        "BlobIDs": list(msg.blob_ids),
        "Options": {
            "Scanners": list(msg.options.scanners),
            "ListAllPackages": msg.options.list_all_packages,
        },
    }


def scan_response_to_pb(d: dict):
    pb = load()["scanner"].ScanResponse()
    os_d = d.get("OS") or {}
    if os_d:  # touching pb.os marks presence -> an empty message on wire
        pb.os.family = os_d.get("Family", "")
        pb.os.name = os_d.get("Name", "")
        pb.os.eosl = os_d.get("Eosl", False)
    for r in d.get("Results") or []:
        result_to_pb(r, pb.results.add())
    return pb


def scan_response_from_pb(msg) -> dict:
    out: dict = {"Results": [result_from_pb(r) for r in msg.results]}
    if msg.os.family or msg.os.name:
        os_d: dict = {"Family": msg.os.family, "Name": msg.os.name}
        if msg.os.eosl:
            os_d["Eosl"] = True
        out["OS"] = os_d
    return out


# -- cache service ---------------------------------------------------------


def _misconfiguration_to_pb(d: dict, msg) -> None:
    """Blob-level Misconfiguration (per-file successes/failures)."""
    msg.file_type = d.get("FileType", "")
    msg.file_path = d.get("FilePath", "")
    for kind, field in (("Successes", msg.successes), ("Failures", msg.failures)):
        for f in d.get(kind) or []:
            pb = field.add()
            pb.message = f.get("Message", "")
            pm = pb.policy_metadata
            pm.id = f.get("ID", "")
            pm.adv_id = f.get("AVDID", f.get("ID", ""))
            pm.type = f.get("Type", "")
            pm.title = f.get("Title", "")
            pm.description = f.get("Description", "")
            pm.severity = f.get("Severity", "")
            pm.recommended_actions = f.get("Resolution", "")
            cm = f.get("CauseMetadata") or {}
            pb.cause_metadata.start_line = cm.get("StartLine", 0)
            pb.cause_metadata.end_line = cm.get("EndLine", 0)


def _misconfiguration_from_pb(msg) -> dict:
    def conv(field, status: str) -> list[dict]:
        out = []
        for f in field:
            d = {
                "Type": f.policy_metadata.type,
                "ID": f.policy_metadata.id,
                "Title": f.policy_metadata.title,
                "Description": f.policy_metadata.description,
                "Message": f.message,
                "Resolution": f.policy_metadata.recommended_actions,
                "Severity": f.policy_metadata.severity,
                "Status": status,
            }
            if f.cause_metadata.start_line or f.cause_metadata.end_line:
                d["CauseMetadata"] = {
                    "StartLine": f.cause_metadata.start_line,
                    "EndLine": f.cause_metadata.end_line,
                }
            out.append(d)
        return out

    out: dict = {"FileType": msg.file_type, "FilePath": msg.file_path}
    succ = conv(msg.successes, "PASS")
    fails = conv(msg.failures, "FAIL")
    if succ:
        out["Successes"] = succ
    if fails:
        out["Failures"] = fails
    return out


def blob_info_to_pb(d: dict):
    pb = load()["cache"].BlobInfo()
    pb.schema_version = d.get("SchemaVersion", 0)
    pb.digest = d.get("Digest", "")
    pb.diff_id = d.get("DiffID", "")
    os_d = d.get("OS") or {}
    if os_d:
        pb.os.family = os_d.get("Family", "")
        pb.os.name = os_d.get("Name", "")
        pb.os.eosl = os_d.get("Eosl", False)
    for x in d.get("OpaqueDirs") or []:
        pb.opaque_dirs.append(x)
    for x in d.get("WhiteoutFiles") or []:
        pb.whiteout_files.append(x)
    for pi in d.get("PackageInfos") or []:
        msg = pb.package_infos.add()
        msg.file_path = pi.get("FilePath", "")
        for p in pi.get("Packages") or []:
            package_to_pb(p, msg.packages.add())
    for app in d.get("Applications") or []:
        msg = pb.applications.add()
        msg.type = app.get("Type", "")
        msg.file_path = app.get("FilePath", "")
        for p in app.get("Packages") or []:
            package_to_pb(p, msg.libraries.add())
    for mc in d.get("Misconfigurations") or []:
        _misconfiguration_to_pb(mc, pb.misconfigurations.add())
    for sec in d.get("Secrets") or []:
        msg = pb.secrets.add()
        msg.filepath = sec.get("FilePath", "")
        for f in sec.get("Findings") or []:
            secret_finding_to_pb(f, msg.findings.add())
    return pb


def blob_info_from_pb(msg) -> dict:
    out: dict = {"SchemaVersion": msg.schema_version}
    if msg.digest:
        out["Digest"] = msg.digest
    if msg.diff_id:
        out["DiffID"] = msg.diff_id
    if msg.os.family or msg.os.name:
        os_d: dict = {"Family": msg.os.family, "Name": msg.os.name}
        if msg.os.eosl:
            os_d["Eosl"] = True
        out["OS"] = os_d
    if msg.opaque_dirs:
        out["OpaqueDirs"] = list(msg.opaque_dirs)
    if msg.whiteout_files:
        out["WhiteoutFiles"] = list(msg.whiteout_files)
    if msg.package_infos:
        out["PackageInfos"] = [
            {
                "FilePath": pi.file_path,
                "Packages": [package_from_pb(p) for p in pi.packages],
            }
            for pi in msg.package_infos
        ]
    if msg.applications:
        out["Applications"] = [
            {
                "Type": app.type,
                "FilePath": app.file_path,
                "Packages": [package_from_pb(p) for p in app.libraries],
            }
            for app in msg.applications
        ]
    if msg.misconfigurations:
        out["Misconfigurations"] = [
            _misconfiguration_from_pb(mc) for mc in msg.misconfigurations
        ]
    if msg.secrets:
        out["Secrets"] = [
            {
                "FilePath": sec.filepath,
                "Findings": [
                    secret_finding_from_pb(f) for f in sec.findings
                ],
            }
            for sec in msg.secrets
        ]
    return out


def artifact_info_to_pb(d: dict):
    pb = load()["cache"].ArtifactInfo()
    pb.schema_version = d.get("SchemaVersion", 0)
    pb.architecture = d.get("Architecture", "")
    pb.docker_version = d.get("DockerVersion", "")
    pb.os = d.get("OS", "")
    created = d.get("Created", "")
    if created:
        try:
            pb.created.FromJsonString(created)
        except ValueError:
            pass
    return pb


def artifact_info_from_pb(msg) -> dict:
    out = {
        "SchemaVersion": msg.schema_version,
        "Architecture": msg.architecture,
        "DockerVersion": msg.docker_version,
        "OS": msg.os,
    }
    if msg.created.seconds or msg.created.nanos:
        out["Created"] = msg.created.ToJsonString()
    return out


# -- per-method wire codecs (server decodes requests / encodes responses;
# the client uses the mirror pair) ----------------------------------------


def _empty_bytes(_out: dict) -> bytes:
    from google.protobuf import empty_pb2

    return empty_pb2.Empty().SerializeToString()


def decode_request(method: str, raw: bytes) -> dict:
    mods = load()
    if method == "scan":
        pb = mods["scanner"].ScanRequest()
        pb.ParseFromString(raw)
        return scan_request_from_pb(pb)
    if method == "put_artifact":
        pb = mods["cache"].PutArtifactRequest()
        pb.ParseFromString(raw)
        return {
            "ArtifactID": pb.artifact_id,
            "ArtifactInfo": artifact_info_from_pb(pb.artifact_info),
        }
    if method == "put_blob":
        pb = mods["cache"].PutBlobRequest()
        pb.ParseFromString(raw)
        return {
            "BlobID": pb.diff_id,
            "BlobInfo": blob_info_from_pb(pb.blob_info),
        }
    if method == "missing_blobs":
        pb = mods["cache"].MissingBlobsRequest()
        pb.ParseFromString(raw)
        return {"ArtifactID": pb.artifact_id, "BlobIDs": list(pb.blob_ids)}
    if method == "delete_blobs":
        pb = mods["cache"].DeleteBlobsRequest()
        pb.ParseFromString(raw)
        return {"BlobIDs": list(pb.blob_ids)}
    raise KeyError(f"no protobuf codec for method {method!r}")


def encode_response(method: str, out: dict) -> bytes:
    mods = load()
    if method == "scan":
        return scan_response_to_pb(out).SerializeToString()
    if method == "missing_blobs":
        pb = mods["cache"].MissingBlobsResponse()
        pb.missing_artifact = bool(out.get("MissingArtifact"))
        for b in out.get("MissingBlobIDs") or []:
            pb.missing_blob_ids.append(b)
        return pb.SerializeToString()
    if method in ("put_artifact", "put_blob", "delete_blobs"):
        return _empty_bytes(out)
    raise KeyError(f"no protobuf codec for method {method!r}")


# Twirp URL path -> (encode request, decode response) for the client side.
def encode_request(path: str, payload: dict) -> bytes:
    mods = load()
    if path.endswith("Scanner/Scan"):
        return scan_request_to_pb(payload).SerializeToString()
    if path.endswith("Cache/PutArtifact"):
        pb = mods["cache"].PutArtifactRequest()
        pb.artifact_id = payload.get("ArtifactID", "")
        pb.artifact_info.CopyFrom(
            artifact_info_to_pb(payload.get("ArtifactInfo") or {})
        )
        return pb.SerializeToString()
    if path.endswith("Cache/PutBlob"):
        pb = mods["cache"].PutBlobRequest()
        pb.diff_id = payload.get("BlobID", "")
        pb.blob_info.CopyFrom(blob_info_to_pb(payload.get("BlobInfo") or {}))
        return pb.SerializeToString()
    if path.endswith("Cache/MissingBlobs"):
        pb = mods["cache"].MissingBlobsRequest()
        pb.artifact_id = payload.get("ArtifactID", "")
        for b in payload.get("BlobIDs") or []:
            pb.blob_ids.append(b)
        return pb.SerializeToString()
    if path.endswith("Cache/DeleteBlobs"):
        pb = mods["cache"].DeleteBlobsRequest()
        for b in payload.get("BlobIDs") or []:
            pb.blob_ids.append(b)
        return pb.SerializeToString()
    raise KeyError(f"no protobuf codec for path {path!r}")


def decode_response(path: str, raw: bytes) -> dict:
    mods = load()
    if path.endswith("Scanner/Scan"):
        pb = mods["scanner"].ScanResponse()
        pb.ParseFromString(raw)
        return scan_response_from_pb(pb)
    if path.endswith("Cache/MissingBlobs"):
        pb = mods["cache"].MissingBlobsResponse()
        pb.ParseFromString(raw)
        return {
            "MissingArtifact": pb.missing_artifact,
            "MissingBlobIDs": list(pb.missing_blob_ids),
        }
    return {}  # Empty responses


def available() -> bool:
    return load() is not None
