"""Layer squash: N cached BlobInfos -> one ArtifactDetail.

Mirrors pkg/fanal/applier/{applier.go,docker.go}: overlayfs semantics (opaque
dirs and whiteout files delete earlier-layer entries), path-keyed overwrite for
packages/applications/misconfigs, OS merge, and the secrets-survive-deletion
rule (docker.go:308-331: secrets from lower layers are kept even when the file
was removed above; same-RuleID findings are overwritten by the upper layer).

Copied from `trivy_tpu/applier/apply.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

from trivy_tpu_torch.atypes import ArtifactDetail, BlobInfo, OS
from trivy_tpu_torch.cache.store import ArtifactCache, BlobNotFoundError
from trivy_tpu_torch.ftypes import Layer, Secret


def _merge_os(base: OS | None, new: OS | None) -> OS | None:
    if new is None:
        return base
    if base is None:
        return copy.copy(new)
    if new.family:
        base.family = new.family
    if new.name:
        base.name = new.name
    if new.extended_support:
        base.extended_support = True
    return base


def _merge_secrets(
    secrets_map: dict[str, Secret], new_secret: Secret, layer: Layer
) -> None:
    """applier/docker.go:308-331 mergeSecrets."""
    new_secret = Secret(
        file_path=new_secret.file_path,
        findings=[copy.copy(f) for f in new_secret.findings],
    )
    for f in new_secret.findings:
        f.layer = layer

    prev = secrets_map.get(new_secret.file_path)
    if prev is not None:
        new_ids = {f.rule_id for f in new_secret.findings}
        for pf in prev.findings:
            if pf.rule_id not in new_ids:
                new_secret.findings.append(pf)
    secrets_map[new_secret.file_path] = new_secret


def apply_layers(layers: list[BlobInfo]) -> ArtifactDetail:
    """applier/docker.go:94 ApplyLayers."""
    # path-keyed map with overlayfs delete semantics; keys are
    # (file_path, kind-discriminator) like the reference's nested map keys.
    nested: dict[tuple[str, str], object] = {}
    secrets_map: dict[str, Secret] = {}
    merged = ArtifactDetail()

    def _delete_prefix(prefix: str) -> None:
        prefix = prefix.rstrip("/") + "/"
        for key in [k for k in nested if k[0] == prefix[:-1] or k[0].startswith(prefix)]:
            del nested[key]

    for layer in layers:
        for opq in layer.opaque_dirs:
            _delete_prefix(opq)
        for wh in layer.whiteout_files:
            _delete_prefix(wh)
            nested.pop((wh, "ospkg"), None)

        merged.os = _merge_os(merged.os, layer.os)

        for pkg_info in layer.package_infos:
            nested[(pkg_info.file_path, "ospkg")] = pkg_info
        for app in layer.applications:
            nested[(app.file_path, f"app:{app.app_type}")] = app
        for config in layer.misconfigurations:
            c = copy.copy(config)
            if hasattr(c, "layer"):
                c.layer = Layer(digest=layer.digest, diff_id=layer.diff_id)
            nested[(getattr(c, "file_path", ""), "config")] = c
        for secret in layer.secrets:
            _merge_secrets(
                secrets_map,
                secret,
                Layer(
                    digest=layer.digest,
                    diff_id=layer.diff_id,
                    created_by=layer.created_by,
                ),
            )
        merged.custom_resources.extend(layer.custom_resources)
        if layer.build_info:
            # Red Hat buildinfo: later layers override earlier fields
            # (applier/docker.go BuildInfo handling).
            bi = dict(merged.build_info or {})
            bi.update(layer.build_info)
            merged.build_info = bi
        for license_file in layer.licenses:
            lf = copy.copy(license_file)
            if hasattr(lf, "layer"):
                lf.layer = Layer(digest=layer.digest, diff_id=layer.diff_id)
            key = f"license,{getattr(lf, 'license_type', '')}"
            nested[(getattr(lf, "file_path", ""), key)] = lf

    for (path, kind), value in sorted(nested.items(), key=lambda kv: kv[0]):
        if kind == "ospkg":
            merged.package_infos.append(value)  # type: ignore[arg-type]
            merged.packages.extend(value.packages)  # type: ignore[union-attr]
        elif kind.startswith("app:"):
            merged.applications.append(value)  # type: ignore[arg-type]
        elif kind == "config":
            merged.misconfigurations.append(value)
        elif kind.startswith("license"):
            merged.licenses.append(value)

    merged.secrets = sorted(secrets_map.values(), key=lambda s: s.file_path)
    return merged


@dataclass
class Applier:
    """applier/applier.go Applier: Get-side cache reads + ApplyLayers."""

    cache: ArtifactCache

    def apply_layers(self, artifact_id: str, blob_ids: list[str]) -> ArtifactDetail:
        blobs: list[BlobInfo] = []
        missing: list[str] = []
        for bid in blob_ids:
            blob = self.cache.get_blob(bid)
            if blob is None:
                missing.append(bid)
            else:
                blobs.append(blob)
        if missing or not blob_ids:
            # Any absent layer blob means the squashed view would be silently
            # incomplete; the reference errors likewise (applier.go:28-29).
            # An empty blob list is equally a client error, not a clean scan.
            raise BlobNotFoundError(f"layer cache missing blobs: {missing}")
        return apply_layers(blobs)
