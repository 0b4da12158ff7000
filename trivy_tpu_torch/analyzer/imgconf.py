"""Image-config analyzers: scan the serialized container config.

Mirrors pkg/fanal/analyzer/imgconf/secret/secret.go (secret scan over the
config JSON — catches credentials in ENV/history) and the history-dockerfile
misconfig analyzer (imgconf/dockerfile): the image history is reconstructed
into a Dockerfile and run through the dockerfile checks.

Copied from `trivy_tpu/analyzer/imgconf.py`; the port imports nothing from
the JAX package.  The secret scan runs through the secret analyzer's
engine, on its device; the dockerfile checks run on the host.
"""

from __future__ import annotations

import json

from trivy_tpu_torch.ftypes import Secret
from trivy_tpu_torch.misconf.dockerfile import scan_dockerfile
from trivy_tpu_torch.misconf.types import Misconfiguration


def scan_config_secrets(config: dict, engine) -> Secret | None:
    """imgconf/secret/secret.go:39-60 — serialize config, reuse the engine
    (one single-file batch, on the engine's device)."""
    if not config:
        return None
    content = json.dumps(config, indent=0, sort_keys=True).encode()
    result = engine.scan("config.json", content.replace(b"\r", b""))
    return result if result.findings else None


def history_to_dockerfile(config: dict) -> bytes:
    """imgconf/dockerfile: rebuild Dockerfile lines from history entries."""
    lines = []
    for h in config.get("history") or []:
        created_by = h.get("created_by", "")
        if not created_by:
            continue
        # docker stores "/bin/sh -c #(nop)  CMD ..." or "/bin/sh -c cmd"
        if "#(nop)" in created_by:
            instruction = created_by.split("#(nop)", 1)[1].strip()
        elif created_by.startswith("/bin/sh -c"):
            instruction = "RUN " + created_by[len("/bin/sh -c") :].strip()
        else:
            instruction = created_by
        lines.append(instruction)
    return ("\n".join(lines) + "\n").encode()


def scan_config_misconfig(config: dict) -> Misconfiguration | None:
    if not config or not config.get("history"):
        return None
    dockerfile = history_to_dockerfile(config)
    mc = scan_dockerfile("Dockerfile", dockerfile)
    mc.file_type = "dockerfile"
    if not mc.failures:
        return None
    mc.successes = []  # history reconstruction is lossy; report failures only
    return mc
