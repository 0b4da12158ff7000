"""In-toto attestation parsing + Rekor transparency-log client
(pkg/attestation, pkg/rekor).

Attestations arrive as DSSE envelopes: a base64 payload holding an
in-toto statement whose predicate can be an SBOM (CycloneDX/SPDX).  The
Rekor client looks up entries by artifact digest (the executable
analyzer's sha256 keys) and decodes any SBOM attestation found — the
reference's `unpackaged` post-handler flow: binaries with no package
owner resolve their package lists from signed build attestations.

Copied from `trivy_tpu/attestation.py`; the port imports nothing from the
JAX package.  The SBOM predicates decode through the port's `sbom/`
decoders, and the handler runs in the port's post-handler chain
(`handler.py`), on the host.
"""

from __future__ import annotations

import base64
import copy
import http.client
import json
import logging
import urllib.request
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

DEFAULT_REKOR_URL = "https://rekor.sigstore.dev"


class AttestationError(ValueError):
    pass


@dataclass
class Statement:
    """in-toto statement (attestation/attestation.go)."""

    type: str
    predicate_type: str
    subjects: list[dict] = field(default_factory=list)  # {name, digest{}}
    predicate: object = None


def parse_envelope(doc: dict) -> Statement:
    """DSSE envelope -> in-toto statement.  The payload is base64; the
    payloadType must be in-toto JSON."""
    if doc.get("payloadType") not in (
        "application/vnd.in-toto+json",
        "application/vnd.dsse.envelope.v1+json",
    ):
        raise AttestationError(
            f"unsupported payloadType {doc.get('payloadType')!r}"
        )
    try:
        payload = json.loads(base64.b64decode(doc.get("payload", "")))
    except (ValueError, TypeError) as e:
        raise AttestationError(f"bad attestation payload: {e}") from e
    return Statement(
        type=payload.get("_type", ""),
        predicate_type=payload.get("predicateType", ""),
        subjects=list(payload.get("subject") or []),
        predicate=payload.get("predicate"),
    )


def sbom_from_statement(stmt: Statement):
    """Decode an SBOM predicate into an ArtifactDetail, or None for
    non-SBOM attestations."""
    pred = stmt.predicate
    if isinstance(pred, dict) and "Data" in pred:  # cosign predicate wrapper
        pred = pred["Data"]
    if isinstance(pred, str):
        try:
            pred = json.loads(pred)
        except ValueError:
            return None
    if not isinstance(pred, dict):
        return None
    if pred.get("bomFormat") == "CycloneDX":
        from trivy_tpu_torch.sbom.cyclonedx import decode
    elif pred.get("spdxVersion"):
        from trivy_tpu_torch.sbom.spdx import decode
    else:
        return None
    try:
        return decode(pred)
    except Exception:
        logger.warning("undecodable SBOM attestation", exc_info=True)
        return None


@dataclass
class RekorClient:
    """pkg/rekor client: digest -> entry UUIDs -> decoded entry bodies."""

    url: str = DEFAULT_REKOR_URL

    def _post(self, path: str, body: dict) -> object:
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            self.url.rstrip("/") + path,
            data=data,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def _get(self, path: str) -> object:
        with urllib.request.urlopen(
            self.url.rstrip("/") + path, timeout=60
        ) as resp:
            return json.loads(resp.read())

    def search_by_digest(self, sha256_hex: str) -> list[str]:
        """POST /api/v1/index/retrieve {hash: sha256:<hex>} -> entry UUIDs."""
        out = self._post(
            "/api/v1/index/retrieve", {"hash": f"sha256:{sha256_hex}"}
        )
        return list(out) if isinstance(out, list) else []

    def get_attestation(self, uuid: str) -> Statement | None:
        """GET /api/v1/log/entries/<uuid>: the entry's attestation.data is
        base64 DSSE."""
        entry = self._get(f"/api/v1/log/entries/{uuid}")
        if not isinstance(entry, dict):
            return None
        for body in entry.values():
            if not isinstance(body, dict):
                continue
            att = body.get("attestation") or {}
            data = att.get("data")
            if not data:
                continue
            try:
                env = json.loads(base64.b64decode(data))
                return parse_envelope(env)
            except (ValueError, AttestationError):
                continue
        return None

    def sbom_for_digest(self, sha256_hex: str):
        """The unpackaged flow: first SBOM attestation for an artifact
        digest, decoded, or None."""
        # OSError covers URLError plus the read-phase failures urlopen's
        # timeout doesn't convert (TimeoutError, ConnectionResetError);
        # HTTPException covers truncated/garbled responses (IncompleteRead,
        # BadStatusLine) — one flaky response must degrade per digest, not
        # abort the handler.
        try:
            uuids = self.search_by_digest(sha256_hex)
        except (OSError, ValueError, http.client.HTTPException) as e:
            logger.warning("rekor lookup failed for %s: %s", sha256_hex, e)
            return None
        for uuid in uuids[:5]:
            try:
                stmt = self.get_attestation(uuid)
            except (OSError, ValueError, http.client.HTTPException):
                continue
            if stmt is None:
                continue
            detail = sbom_from_statement(stmt)
            if detail is not None:
                return detail
        return None


def rekor_unpackaged_handler(rekor_url: str):
    """Build the `unpackaged` post-handler (handler/unpackaged): executable
    digests with no owning package resolve package lists from Rekor SBOM
    attestations.  Register via trivy_tpu_torch.handler.register_post_handler
    when --sbom-sources rekor is active."""
    client = RekorClient(rekor_url)
    # digest -> ArtifactDetail | None: the same binary recurring across
    # layers (or as copies in one tree) costs one network round trip, and a
    # no-attestation answer is remembered too.
    resolved: dict[str, object] = {}

    def handler(result) -> None:
        for rec in list(result.configs):
            if not isinstance(rec, dict) or rec.get("Type") != "executable":
                continue
            digest = rec.get("Digest", "").removeprefix("sha256:")
            if not digest:
                continue
            if digest not in resolved:
                resolved[digest] = client.sbom_for_digest(digest)
            if resolved[digest] is None:
                continue
            # Fresh copies per occurrence: the loop below sets file_path and
            # the result owns what it appends — the cached detail must stay
            # pristine for the next occurrence/layer.
            detail = copy.deepcopy(resolved[digest])
            for app in detail.applications:
                if not app.file_path:
                    app.file_path = rec.get("FilePath", "")
            result.applications.extend(detail.applications)
            result.package_infos.extend(detail.package_infos)
            if detail.packages:
                # OS packages (apk/deb/rpm purls) decode into the flat
                # packages list; blobs carry them as PackageInfo groups.
                from trivy_tpu_torch.atypes import PackageInfo

                result.package_infos.append(
                    PackageInfo(
                        file_path=rec.get("FilePath", ""),
                        packages=list(detail.packages),
                    )
                )

    return handler
