"""containerd image source: direct content-store + boltdb metadata read.

The reference reaches containerd through its gRPC API
(pkg/fanal/image/daemon.go:24 via the containerd client); this build
speaks no gRPC, but the common case needs none: containerd's on-disk
state is a content-addressed blob store plus a boltdb metadata database,
both world-readable for root scanners:

    <root>/io.containerd.metadata.v1.bolt/meta.db
        v1/<namespace>/images/<name>/target/{digest,mediatype,size}
    <root>/io.containerd.content.v1.content/blobs/sha256/<hex>

The existing pure-Python bbolt reader (trivy_tpu_torch/db/bolt.py, built for
trivy.db) reads meta.db as-is; manifests/configs/layers resolve straight
out of the blob store with zero copies.  This is the same shortcut
`nerdctl`-less debugging takes, and it works against a STOPPED
containerd too — something the gRPC path cannot do.

Image names in the metadata db are fully-qualified references
("docker.io/library/alpine:latest"); lookup tries the caller's reference
plus its canonical expansions across every namespace (k8s clusters use
"k8s.io", plain nerdctl uses "default").

Copied from `trivy_tpu/image/containerd.py`; the port imports nothing from
the JAX package, so it keeps its own copy of this jax-free module; meta.db
is read through the port's `db/bolt.py`."""

from __future__ import annotations

import json
import os

from trivy_tpu_torch.image.daemon import SourceUnavailable

DEFAULT_ROOT = "/var/lib/containerd"

_INDEX_TYPES = {
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.index.v1+json",
}


def _name_variants(image_ref: str) -> list[str]:
    """Candidate metadata keys for a user reference, most specific first."""
    from trivy_tpu_torch.image.registry import parse_reference

    ref = parse_reference(image_ref)
    # containerd canonicalizes Docker Hub to "docker.io", not the
    # "index.docker.io" endpoint name the registry client dials.
    registry = "docker.io" if ref.registry == "index.docker.io" else ref.registry
    out = [image_ref]
    if ref.digest:
        out.append(f"{registry}/{ref.repository}@{ref.digest}")
    else:
        out.append(f"{registry}/{ref.repository}:{ref.tag}")
    # nerdctl also stores short forms verbatim
    if ":" not in image_ref and "@" not in image_ref:
        out.append(f"{image_ref}:latest")
    seen: set[str] = set()
    return [v for v in out if not (v in seen or seen.add(v))]


def _blob_path(root: str, digest: str) -> str:
    algo, _, hexd = digest.partition(":")
    return os.path.join(
        root, "io.containerd.content.v1.content", "blobs", algo, hexd
    )


def _read_blob(root: str, digest: str) -> bytes:
    path = _blob_path(root, digest)
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise SourceUnavailable(
            f"containerd content store missing blob {digest}: {e}"
        ) from e


def _open_blob(root: str, digest: str):
    """Open a content-store blob for streaming, translating a vanished
    blob (containerd GC can collect between resolution and the walker
    reading the layer) into the chain's degradable error."""
    try:
        return open(_blob_path(root, digest), "rb")
    except OSError as e:
        raise SourceUnavailable(
            f"containerd content store missing blob {digest}: {e}"
        ) from e


def _find_target(meta_path: str, variants: list[str]) -> tuple[str, str]:
    """(digest, resolved name) of the image target descriptor."""
    from trivy_tpu_torch.db.bolt import Bolt, BoltError

    try:
        bolt = Bolt.open(meta_path)
    except (OSError, BoltError) as e:
        raise SourceUnavailable(f"containerd meta.db unreadable: {e}") from e
    v1 = bolt.bucket(b"v1")
    if v1 is None:
        raise SourceUnavailable("containerd meta.db: no v1 bucket")
    for _ns, nsb in v1.buckets():
        images = nsb.bucket(b"images")
        if images is None:
            continue
        for name in variants:
            img = images.bucket(name.encode())
            if img is None:
                continue
            target = img.bucket(b"target")
            digest = target.get(b"digest") if target is not None else None
            if digest:
                return digest.decode(), name
    raise SourceUnavailable(
        f"containerd: image not found in metadata (tried {variants})"
    )


def containerd_image(
    image_ref: str,
    root: str | None = None,
    platform_os: str = "linux",
    platform_arch: str = "amd64",
):
    """Resolve an image from a local containerd installation."""
    from trivy_tpu_torch.artifact.image import ImageSource, _sha256_hex

    from trivy_tpu_torch.image.registry import pick_platform

    root = root or os.environ.get("CONTAINERD_ROOT") or DEFAULT_ROOT
    meta_path = os.path.join(root, "io.containerd.metadata.v1.bolt", "meta.db")
    if not os.path.exists(meta_path):
        raise SourceUnavailable(f"no containerd metadata at {meta_path}")

    digest, resolved = _find_target(meta_path, _name_variants(image_ref))
    # Malformed store contents (corrupt blob JSON, schema1 manifests,
    # attestation-only descriptors) must degrade to the next chain hop,
    # not abort the scan: resolve_image catches only SourceUnavailable.
    try:
        manifest = json.loads(_read_blob(root, digest))
        if manifest.get("mediaType") in _INDEX_TYPES or (
            "manifests" in manifest and "layers" not in manifest
        ):
            desc = pick_platform(
                manifest, platform_os, platform_arch, SourceUnavailable
            )
            manifest = json.loads(_read_blob(root, desc["digest"]))
        raw_config = _read_blob(root, manifest["config"]["digest"])
        layers = []
        for layer in manifest.get("layers", []):
            ldigest = layer["digest"]
            if not os.path.exists(_blob_path(root, ldigest)):
                raise SourceUnavailable(
                    f"containerd content store missing layer {ldigest}"
                )
            layers.append(lambda d=ldigest: _open_blob(root, d))
    except (KeyError, ValueError, TypeError, AttributeError) as e:
        # TypeError/AttributeError cover blobs whose JSON parses to a
        # non-dict (store corruption, digest reassigned to a non-manifest
        # artifact) — still "this source can't serve it", not a crash.
        raise SourceUnavailable(
            f"containerd: unusable image metadata for {resolved!r}: "
            f"{type(e).__name__}: {e}"
        ) from e
    return ImageSource(
        config=json.loads(raw_config),
        config_digest=_sha256_hex(raw_config),
        layers=layers,
        repo_tags=[resolved] if "@" not in resolved else [],
        repo_digests=[resolved] if "@" in resolved else [],
    )
