"""Image source resolution: archives, runtime daemons, remote registries.

The reference probes docker daemon -> containerd -> podman -> remote
registry in order, accumulating errors (pkg/fanal/image/image.go:26); the
same chain lives in resolve_image below.  Archive paths (docker save tars,
OCI layouts) bypass the chain via the artifact loader.

Copied from `trivy_tpu/image/__init__.py` with `registry.py`, `daemon.py`
and `containerd.py`; the port imports nothing from the JAX package, so it
keeps its own copy of these jax-free modules.
"""

from __future__ import annotations

import os

from trivy_tpu_torch.image.daemon import (
    SourceUnavailable,
    containerd_image,
    docker_image,
    podman_image,
)
from trivy_tpu_torch.image.registry import RegistryClient, RegistryError, parse_reference

__all__ = [
    "resolve_image",
    "RegistryClient",
    "RegistryError",
    "SourceUnavailable",
    "parse_reference",
]


def resolve_image(
    ref: str,
    insecure_registry: bool = False,
    username: str = "",
    password: str = "",
):
    """Resolution chain (image.go:26): local archive path, then daemon ->
    containerd -> podman -> registry; raises with every source's error when
    all fail, like the reference's errs join."""
    from trivy_tpu_torch.artifact.image import load_image

    if os.path.exists(ref):
        return load_image(ref)
    errors: list[str] = []
    for name, source in (
        ("docker", docker_image),
        ("containerd", containerd_image),
        ("podman", podman_image),
    ):
        try:
            src = source(ref)
            # Referrer SBOMs live in the registry regardless of which hop
            # supplied the bytes (remote_sbom.go looks up by name): attach
            # a lazy fetcher so --sbom-sources oci works for daemon images.
            if getattr(src, "sbom_fetcher", None) is None:
                src.sbom_fetcher = RegistryClient(
                    insecure=insecure_registry,
                    username=username, password=password,
                ).sbom_fetcher_for(ref)
            return src
        except SourceUnavailable as e:
            errors.append(f"{name}: {e}")
    try:
        return RegistryClient(
            insecure=insecure_registry, username=username, password=password
        ).fetch_image(ref)
    except RegistryError as e:
        errors.append(f"registry: {e}")
    raise RegistryError(
        "unable to resolve image %r:\n  %s" % (ref, "\n  ".join(errors))
    )
