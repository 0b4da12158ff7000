"""Image-config analyzer: scan the serialized container config.

Mirrors pkg/fanal/analyzer/imgconf/secret/secret.go: a secret scan over
the config JSON, which catches credentials in ENV and history.

Copied from `trivy_tpu/analyzer/imgconf.py`; the port imports nothing from
the JAX package.  It keeps the secret half.  The misconfig half
(`history_to_dockerfile`, `scan_config_misconfig`: the image history
rebuilt into a Dockerfile and run through the dockerfile checks) waits for
the misconfig scanner (ROADMAP A13d); the port's analyzer options disable
the `dockerfile` type, so the image artifact never asks for it.
"""

from __future__ import annotations

import json

from trivy_tpu_torch.ftypes import Secret


def scan_config_secrets(config: dict, engine) -> Secret | None:
    """imgconf/secret/secret.go:39-60 — serialize config, reuse the engine
    (one single-file batch, on the engine's device)."""
    if not config:
        return None
    content = json.dumps(config, indent=0, sort_keys=True).encode()
    result = engine.scan("config.json", content.replace(b"\r", b""))
    return result if result.findings else None
