"""Checks-bundle client (pkg/policy/policy.go).

The reference distributes its misconfiguration checks as an OCI artifact
(the trivy-checks bundle, media type below) and refreshes it like the
databases.  Here the bundle is a tar.gz of .rego sources; ensure_checks_
bundle pulls it into the cache and returns the directory, which the IaC
engine loads alongside the builtin checks and --config-check dirs — the
same evaluator runs all three.

Copied from `trivy_tpu/policy.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import datetime
import json
import os
import tarfile

BUNDLE_MEDIA_TYPE = "application/vnd.cncf.openpolicyagent.layer.v1.tar+gzip"
_MAX_AGE_HOURS = 24.0  # policy.go: bundle refreshes daily


def ensure_checks_bundle(
    repository: str, cache_dir: str = "", insecure: bool = False
) -> str:
    """Pull the bundle when stale; returns the local check directory."""
    from trivy_tpu_torch.db.client import _parse_time
    from trivy_tpu_torch.oci import OciArtifact

    base = cache_dir or os.path.expanduser("~/.cache/trivy-tpu")
    bundle_dir = os.path.join(base, "policy", "content")
    meta_path = os.path.join(bundle_dir, "metadata.json")
    try:
        with open(meta_path, encoding="utf-8") as f:
            stamp = json.load(f).get("DownloadedAt", "")
        age = datetime.datetime.now(datetime.timezone.utc) - _parse_time(stamp)
        if stamp and age < datetime.timedelta(hours=_MAX_AGE_HOURS):
            return bundle_dir
    except (OSError, ValueError):
        pass

    os.makedirs(bundle_dir, exist_ok=True)
    art = OciArtifact(repository, insecure=insecure)
    with art.download_layer(BUNDLE_MEDIA_TYPE) as blob:
        with tarfile.open(fileobj=blob, mode="r:*") as tf:
            for member in tf.getmembers():
                if not member.isfile() or ".." in member.name:
                    continue
                if not member.name.endswith(".rego"):
                    continue
                name = os.path.basename(member.name)
                with open(os.path.join(bundle_dir, name), "wb") as out:
                    out.write(tf.extractfile(member).read())
    with open(meta_path, "w", encoding="utf-8") as f:
        json.dump(
            {
                "DownloadedAt": datetime.datetime.now(
                    datetime.timezone.utc
                ).isoformat()
            },
            f,
        )
    return bundle_dir
