"""Container image artifact: docker-save archives and OCI layouts.

Mirrors pkg/fanal/artifact/image/image.go over the archive-input sources
(pkg/fanal/image/{archive.go,oci.go}); daemon/registry sources are a
deployment concern behind the same interface.  Pipeline per image:

  image ID + per-layer diff IDs -> cache keys (sha256 + analyzer versions)
  cache.missing_blobs diff -> only uncached layers are analyzed (image.go:113)
  per missing layer: layer tar walk -> batched analyzer group -> BlobInfo
    with whiteout/opaque dirs (applier resolves overlayfs semantics later)
  image config analysis (history secret scan - imgconf analyzer)

The reference parallelizes layer inspection with a worker pipeline
(image.go:205-227); here each layer's files join the same device batch — the
batch axis absorbs the layer axis.

Copied from `trivy_tpu/artifact/image.py`; the port imports nothing from
the JAX package.  The analyzer group is built from the analyzer options,
whose `device` (default "cuda") is where the secret and license engines
run; the image config's secret scan is one single-file batch through the
secret analyzer's engine, on that device.  The keys (`_layer_key`,
`_artifact_key`, the imgconf key in `inspect`) are the reference's, byte
for byte: the reference also hashes `cache_key_extra`, which only its
rekor SBOM source sets (ROADMAP A13d) and is "" otherwise.  The image config's misconfig half (the history rebuilt into a
Dockerfile, ROADMAP A13d) keeps the reference's `"dockerfile" in enabled`
gate, which the port's analyzer options never open.  The port adds host
spans: `image.layer` (one layer's analysis), `layer.open` (its blob
opened: a registry source downloads it there), `layer.walk` (its tar
index) and `image.config`.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tarfile
import tempfile
from dataclasses import dataclass

logger = logging.getLogger(__name__)

from trivy_tpu_torch.analyzer.core import AnalyzerGroup, AnalyzerOptions
from trivy_tpu_torch.atypes import ArtifactInfo, ArtifactReference, BlobInfo
from trivy_tpu_torch.cache import stats as cache_stats
from trivy_tpu_torch.cache.store import ArtifactCache
from trivy_tpu_torch.ftypes import ArtifactType
from trivy_tpu_torch.walker.layer_tar import walk_layer_tar


@dataclass
class ImageSource:
    """Parsed archive: config JSON + ordered layer blob readers."""

    config: dict
    config_digest: str  # sha256:... of the raw config bytes
    layers: list  # list of callables -> file object
    repo_tags: list[str]
    repo_digests: list[str]
    # Registry sources attach a callable returning the image's OCI-referrer
    # CycloneDX SBOM (or None) — the remote-SBOM short-circuit input
    # (remote_sbom.go).
    sbom_fetcher: object | None = None
    # Holds a tempfile.TemporaryDirectory for OCI-in-tar extraction; its
    # finalizer removes the extracted blobs when the source is collected.
    _tmpdir: object | None = None

    @property
    def diff_ids(self) -> list[str]:
        return list((self.config.get("rootfs") or {}).get("diff_ids") or [])


def _sha256_hex(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def load_docker_archive(path: str) -> ImageSource:
    """`docker save` tar: manifest.json lists config + layer paths."""
    tf = tarfile.open(path)
    names = tf.getnames()
    if "manifest.json" in names:
        manifest = json.loads(tf.extractfile("manifest.json").read())[0]
        config_name = manifest["Config"]
        raw_config = tf.extractfile(config_name).read()
        layer_names = manifest.get("Layers") or []
        return ImageSource(
            config=json.loads(raw_config),
            config_digest=_sha256_hex(raw_config),
            layers=[(lambda n=n: tf.extractfile(n)) for n in layer_names],
            repo_tags=list(manifest.get("RepoTags") or []),
            repo_digests=[],
        )
    if "index.json" in names:  # OCI layout packed as tar
        tmp = tempfile.TemporaryDirectory(prefix="trivy-tpu-oci-")
        with tf:
            tf.extractall(tmp.name, filter="data")
        src = load_oci_layout(tmp.name)
        src._tmpdir = tmp
        return src
    raise ValueError(f"unrecognized image archive: {path}")


def load_oci_layout(path: str) -> ImageSource:
    """OCI image layout directory (oci.go)."""

    def blob(digest: str) -> str:
        algo, _, hexd = digest.partition(":")
        return os.path.join(path, "blobs", algo, hexd)

    with open(os.path.join(path, "index.json"), encoding="utf-8") as f:
        index = json.load(f)
    manifest_desc = index["manifests"][0]
    with open(blob(manifest_desc["digest"]), encoding="utf-8") as f:
        manifest = json.load(f)
    with open(blob(manifest["config"]["digest"]), "rb") as f:
        raw_config = f.read()

    layers = [
        (lambda p=blob(l["digest"]): open(p, "rb")) for l in manifest["layers"]
    ]
    return ImageSource(
        config=json.loads(raw_config),
        config_digest=_sha256_hex(raw_config),
        layers=layers,
        repo_tags=[],
        repo_digests=[],
    )


def load_image(target: str) -> ImageSource:
    """Source resolution chain for archive inputs (image.go:26 analogue)."""
    if os.path.isdir(target):
        return load_oci_layout(target)
    return load_docker_archive(target)


def guess_base_image_index(history: list[dict]) -> int:
    """pkg/fanal/image/image.go:111 GuessBaseImageIndex: walk history from
    the bottom, skip the trailing empty layers (ENTRYPOINT/CMD of the built
    image), and treat the next CMD as the end of the base image."""
    base_index = -1
    found_non_empty = False
    for i in range(len(history) - 1, -1, -1):
        h = history[i]
        empty = bool(h.get("empty_layer"))
        if not found_non_empty:
            if empty:
                continue
            found_non_empty = True
        if not empty:
            continue
        created_by = h.get("created_by", "")
        if created_by.startswith("/bin/sh -c #(nop)  CMD") or created_by.startswith("CMD"):
            base_index = i
            break
    return base_index


def guess_base_layers(diff_ids: list[str], config: dict) -> list[str]:
    """image.go:399 guessBaseLayers: diff IDs of the guessed base image
    (empty layers carry no diff ID)."""
    history = list(config.get("history") or [])
    base_index = guess_base_image_index(history)
    out: list[str] = []
    di = 0
    for i, h in enumerate(history):
        if i > base_index:
            break
        if h.get("empty_layer"):
            continue
        if di >= len(diff_ids):
            return []
        out.append(diff_ids[di])
        di += 1
    return out


class ImageArtifact:
    """artifact/image/image.go Artifact."""

    # Class-level default: _layer_key must work on partially-constructed
    # instances too (tests build them via __new__ to probe key math).
    _secret_digest: str | None = None

    def __init__(
        self,
        target: str,
        cache: ArtifactCache,
        analyzer_options: AnalyzerOptions | None = None,
        source: ImageSource | None = None,
    ):
        self.target = target
        self.cache = cache
        self.group = AnalyzerGroup(analyzer_options)
        # `source` lets the daemon/registry chain (trivy_tpu_torch/image) hand in
        # an already-resolved image; plain paths load as archives/layouts.
        self.source = source if source is not None else load_image(target)
        self._secret_digest: str | None = None
        # Hit/miss accounting of the last inspect() (Explain.cache, bench).
        self.last_cache_stats: dict = {}

    def _secret_ruleset_digest(self) -> str:
        """Digest of the ruleset the secret analyzer would scan with —
        derived from config alone (registry/digest.py), never by building
        the engine: on a fully-warm inspect the engine must not be
        constructed at all.  Part of every secret-enabled layer key, so a
        `rules push` invalidates exactly the entries whose verdicts the
        new rules could change."""
        if self._secret_digest is not None:
            return self._secret_digest
        digest = ""
        if any(a.type() == "secret" for a in self.group.analyzers):
            from trivy_tpu_torch.registry.digest import (
                default_ruleset_digest,
                ruleset_digest,
            )

            opt = self.group.options.secret_scanner_option
            config_path = getattr(opt, "config_path", "")
            if config_path:
                from trivy_tpu_torch.rules.model import build_ruleset, load_config

                digest = ruleset_digest(build_ruleset(load_config(config_path)))
            else:
                digest = default_ruleset_digest()
        self._secret_digest = digest
        return digest

    def _layer_key(self, diff_id: str, disabled: tuple[str, ...] = ()) -> str:
        h = hashlib.sha256()
        h.update(diff_id.encode())
        h.update(json.dumps(self.group.analyzer_versions(), sort_keys=True).encode())
        # Per-layer disabled analyzers change the blob's contents, so they
        # are part of the key (image.go calcCacheKey includes them).
        h.update(json.dumps(sorted(disabled)).encode())
        if "secret" not in disabled:
            h.update(self._secret_ruleset_digest().encode())
        return "sha256:" + h.hexdigest()

    def _artifact_key(self) -> str:
        h = hashlib.sha256()
        h.update(self.source.config_digest.encode())
        h.update(json.dumps(self.group.analyzer_versions(), sort_keys=True).encode())
        return "sha256:" + h.hexdigest()

    def _try_remote_sbom(self) -> ArtifactReference | None:
        """Remote-SBOM short-circuit (image.go:92-98 + remote_sbom.go): a
        CycloneDX SBOM attached via OCI referrers replaces the layer walk
        entirely — packages come from the attestation, not re-analysis."""
        fetcher = getattr(self.source, "sbom_fetcher", None)
        if fetcher is None:
            return None
        doc = fetcher()
        if not doc:
            return None
        from trivy_tpu_torch.sbom.cyclonedx import decode

        try:
            detail = decode(doc)
        except Exception as e:
            logger.warning("OCI-referrer SBOM undecodable: %s", e)
            return None
        logger.info("Found SBOM in the OCI referrers; skipping layer scan")
        from trivy_tpu_torch.artifact.sbom import build_sbom_reference

        return build_sbom_reference(
            detail,
            json.dumps(doc, sort_keys=True).encode(),
            self.cache,
            self.target,
            ArtifactType.CYCLONEDX,
        )

    def inspect(self) -> ArtifactReference:
        if "oci" in (self.group.options.sbom_sources or []):
            ref = self._try_remote_sbom()
            if ref is not None:
                return ref
        src = self.source
        diff_ids = src.diff_ids
        # Base layers skip secret scanning (image.go:100-102, 209-213): the
        # base image's secrets are the base image publisher's problem, and
        # scanning them again in every derived image is pure waste.
        base_diff_ids = set(guess_base_layers(diff_ids, src.config))
        layer_disabled = [
            ("secret",) if d in base_diff_ids else () for d in diff_ids
        ]
        layer_keys = [
            self._layer_key(d, dis)
            for d, dis in zip(diff_ids, layer_disabled)
        ]
        artifact_key = self._artifact_key()

        # The imgconf blob holds a secret scan of the config JSON, so its
        # key carries the ruleset digest too (rules push invalidates it).
        config_key = "sha256:" + hashlib.sha256(
            (artifact_key + ":imgconf:" + self._secret_ruleset_digest()).encode()
        ).hexdigest()
        missing_artifact, missing = self.cache.missing_blobs(
            artifact_key, layer_keys + [config_key]
        )
        total_blobs = len(layer_keys) + 1
        cache_stats.record_request("artifact", "miss", len(missing))
        cache_stats.record_request(
            "artifact", "hit", total_blobs - len(missing)
        )
        self.last_cache_stats = {
            "blobs": total_blobs,
            "hits": total_blobs - len(missing),
            "misses": len(missing),
            "artifact_hit": not missing_artifact,
            "ruleset_digest": self._secret_ruleset_digest(),
        }

        history = [
            h for h in (src.config.get("history") or []) if not h.get("empty_layer")
        ]
        for i, (diff_id, key) in enumerate(zip(diff_ids, layer_keys)):
            if key not in missing:
                continue
            created_by = history[i].get("created_by", "") if i < len(history) else ""
            self._inspect_layer(
                i, diff_id, key, created_by, set(layer_disabled[i])
            )

        if missing_artifact:
            cfg = src.config
            self.cache.put_artifact(
                artifact_key,
                ArtifactInfo(
                    architecture=cfg.get("architecture", ""),
                    created=cfg.get("created", ""),
                    docker_version=cfg.get("docker_version", ""),
                    os_name=cfg.get("os", ""),
                ),
            )

        if config_key in missing:
            self._config_analysis_blob(config_key)
        blob_ids = layer_keys + [config_key]

        return ArtifactReference(
            name=self.target,
            artifact_type=ArtifactType.CONTAINER_IMAGE.value,
            id=artifact_key,
            blob_ids=blob_ids,
            image_metadata={
                "ImageID": src.config_digest,
                "DiffIDs": diff_ids,
                "RepoTags": src.repo_tags,
                "RepoDigests": src.repo_digests,
                "ImageConfig": src.config,
            },
        )

    def _inspect_layer(
        self,
        index: int,
        diff_id: str,
        key: str,
        created_by: str,
        disabled: set[str] | None = None,
    ) -> None:
        """image.go:242 inspectLayer."""
        from trivy_tpu_torch.handler import run_post_handlers
        from trivy_tpu_torch.obs import trace as obs_trace

        cache_stats.event("layer_analysis")
        with obs_trace.span("image.layer", index=index):
            with obs_trace.span("layer.open"):
                f = self.source.layers[index]()
            with f:
                # Entries read lazily through the open tar; analysis happens
                # inside the `with` so only claimed files materialize.
                with obs_trace.span("layer.walk"):
                    layer = walk_layer_tar(f)
                result = self.group.analyze_entries("", layer.entries, disabled)
                with obs_trace.span("artifact.post"):
                    result.merge(self.group.post_analyze())
                    run_post_handlers(result)
                    result.sort()
        blob = BlobInfo(
            diff_id=diff_id,
            created_by=created_by,
            opaque_dirs=layer.opaque_dirs,
            whiteout_files=layer.whiteout_files,
            os=result.os,
            package_infos=list(result.package_infos),
            applications=list(result.applications),
            secrets=list(result.secrets),
            licenses=list(result.licenses),
            misconfigurations=list(result.misconfigs),
            custom_resources=list(result.configs),
            build_info=result.build_info,
        )
        with obs_trace.span("cache.put"):
            self.cache.put_blob(key, blob)

    def _config_analysis_blob(self, key: str) -> None:
        """Image-config analysis (imgconf analyzers): secrets in the config
        JSON, stored as one extra blob so it merges through the applier and
        survives the client/server split.  It only runs when the secret
        analyzer is enabled; the blob is cache-gated like layer blobs
        (always put, possibly empty, so missing_blobs stays accurate).  The
        misconfig over the history-reconstructed Dockerfile waits for
        ROADMAP A13d."""
        from trivy_tpu_torch.analyzer.imgconf import scan_config_secrets
        from trivy_tpu_torch.obs import trace as obs_trace

        cache_stats.event("config_analysis")
        enabled = {a.type() for a in self.group.analyzers}
        secrets = []
        with obs_trace.span("image.config"):
            if "secret" in enabled:
                secret_analyzer = next(
                    a for a in self.group.analyzers if a.type() == "secret"
                )
                res = scan_config_secrets(self.source.config, secret_analyzer.engine)
                if res is not None:
                    secrets.append(res)
        if "dockerfile" in enabled:
            raise ValueError(
                "the image config's misconfig analysis is not ported yet (ROADMAP A13d)"
            )
        self.cache.put_blob(key, BlobInfo(secrets=secrets))

    def clean(self, ref: ArtifactReference) -> None:
        pass  # layer blobs stay cached (content-addressed)
