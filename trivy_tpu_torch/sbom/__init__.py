"""SBOM encode/decode (pkg/sbom): CycloneDX + SPDX (JSON and tag-value).

`decode_sbom` is the single format dispatch both consumers share — the
sbom artifact and the embedded-SBOM analyzer must never diverge on what
counts as an SBOM or how it parses.

Copied from `trivy_tpu/sbom/__init__.py` with `cyclonedx.py` and
`spdx.py`, whole; the port imports nothing from the JAX package.  The
decoders serve the embedded-SBOM analyzer (`analyzer/misc.py`), the `sbom`
target (`artifact/sbom.py`) and the image path's referrer SBOM; the
encoders serve `-f cyclonedx|spdx|spdx-json` (`report/writer.py`).
"""

from __future__ import annotations

import json


def decode_sbom(text: str):
    """(ArtifactDetail, format) for SBOM text in any supported format:
    SPDX tag-value (version-stanza sniff, comment-tolerant), CycloneDX
    JSON, or SPDX JSON.  Raises ValueError when the text is none of
    them."""
    from trivy_tpu_torch.sbom.spdx import decode_tag_value, is_tag_value

    if is_tag_value(text):
        return decode_tag_value(text), "spdx"
    doc = json.loads(text)
    if doc.get("bomFormat") == "CycloneDX":
        from trivy_tpu_torch.sbom.cyclonedx import decode

        return decode(doc), "cyclonedx"
    if str(doc.get("spdxVersion", "")).startswith("SPDX-"):
        from trivy_tpu_torch.sbom.spdx import decode

        return decode(doc), "spdx"
    raise ValueError(
        "unrecognized SBOM format (expected CycloneDX or SPDX)"
    )
