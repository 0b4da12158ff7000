"""OCI Distribution (registry) image source.

The remote end of the reference's source chain
(pkg/fanal/image/remote.go:15, backed by go-containerregistry): pull
manifest + config + layer blobs over the Distribution API v2 so
``image <name>`` works without a pre-exported archive.

Implemented against the spec with stdlib HTTP only:
  * ``GET /v2/<name>/manifests/<ref>`` with the manifest-list, OCI-index,
    Docker-v2 and OCI-manifest media types accepted; indexes resolve to the
    requested (default linux/amd64) platform.
  * Bearer token auth: a 401 with ``WWW-Authenticate: Bearer realm=...``
    triggers the token round-trip (anonymous or basic credentials), like
    go-containerregistry's default keychain flow.
  * Blobs download to spooled temp files; gzip/zstd layer compression is
    transparent to the tar walker (tarfile mode "r:*").

Copied from `trivy_tpu/image/registry.py`; the port imports nothing from
the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import base64
import json
import shutil
import re
import tempfile
import urllib.error
import logging
import urllib.parse
import urllib.request
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)

MANIFEST_ACCEPT = ", ".join(
    [
        "application/vnd.docker.distribution.manifest.v2+json",
        "application/vnd.docker.distribution.manifest.list.v2+json",
        "application/vnd.oci.image.manifest.v1+json",
        "application/vnd.oci.image.index.v1+json",
    ]
)

_INDEX_TYPES = {
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.index.v1+json",
}


class RegistryError(RuntimeError):
    pass


def pick_platform(
    index: dict, os_name: str, arch: str, error_cls=RuntimeError
) -> dict:
    """Select the index entry for (os, arch), falling back to the first
    entry when none matches exactly — shared by the registry and
    containerd sources so platform-selection quirks stay in one place."""
    best = None
    for desc in index.get("manifests", []):
        plat = desc.get("platform") or {}
        if (
            plat.get("os", os_name) == os_name
            and plat.get("architecture", arch) == arch
        ):
            return desc
        best = best or desc
    if best is None:
        raise error_cls("empty manifest index")
    return best


@dataclass
class Reference:
    """A parsed image reference (registry/repository:tag@digest)."""

    registry: str
    repository: str
    tag: str = "latest"
    digest: str = ""

    @property
    def name(self) -> str:
        out = f"{self.registry}/{self.repository}"
        if self.digest:
            return f"{out}@{self.digest}"
        return f"{out}:{self.tag}"


def parse_reference(ref: str) -> Reference:
    """Docker-style reference normalization: bare names go to
    index.docker.io with the library/ prefix (image.go's behavior through
    go-containerregistry's name.ParseReference)."""
    digest = ""
    if "@" in ref:
        ref, _, digest = ref.partition("@")
    head, _, rest = ref.partition("/")
    if rest and ("." in head or ":" in head or head == "localhost"):
        registry, repo = head, rest
    else:
        registry, repo = "index.docker.io", ref
    if registry in ("docker.io", "registry-1.docker.io"):
        registry = "index.docker.io"
    if registry == "index.docker.io" and "/" not in repo:
        repo = "library/" + repo  # official images live under library/
    tag = "latest"
    if ":" in repo.rsplit("/", 1)[-1]:
        repo, _, tag = repo.rpartition(":")
    return Reference(registry=registry, repository=repo, tag=tag, digest=digest)


@dataclass
class RegistryClient:
    """Minimal Distribution API client (one registry host per instance)."""

    insecure: bool = False  # plain http (local/test registries)
    username: str = ""
    password: str = ""
    platform_os: str = "linux"
    platform_arch: str = "amd64"
    _tokens: dict[str, str] = field(default_factory=dict)

    def _scheme(self, registry: str) -> str:
        if self.insecure or registry.startswith(("localhost", "127.0.0.1")):
            return "http"
        return "https"

    def _basic_credential(self) -> str:
        return base64.b64encode(
            f"{self.username}:{self.password}".encode()
        ).decode()

    def _auth_headers(self, token_scope: str) -> dict[str, str]:
        """Authorization header for a scope: a cached Bearer token wins;
        otherwise Basic credentials are attached preemptively."""
        tok = self._tokens.get(token_scope)
        if tok:
            return {"Authorization": f"Bearer {tok}"}
        if self.username:
            return {"Authorization": f"Basic {self._basic_credential()}"}
        return {}

    def _request(
        self,
        url: str,
        headers: dict[str, str],
        token_scope: str,
        _retried: bool = False,
    ) -> tuple[bytes, dict[str, str]]:
        hdrs = dict(headers) | self._auth_headers(token_scope)
        req = urllib.request.Request(url, headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            # A Bearer challenge triggers the token round-trip even when
            # Basic credentials were preemptively attached — token-issuing
            # registries (Docker Hub, GHCR) 401 the Basic attempt and
            # expect the client to trade those credentials for a token at
            # the realm, which is go-containerregistry's keychain flow
            # (pkg/fanal/image/remote.go:15).  One retry only.
            if e.code == 401 and not _retried:
                challenge = e.headers.get("WWW-Authenticate", "")
                token = self._fetch_token(challenge)
                if token:
                    self._tokens[token_scope] = token
                    return self._request(
                        url, headers, token_scope, _retried=True
                    )
            raise RegistryError(f"registry: GET {url}: HTTP {e.code}") from e
        except urllib.error.URLError as e:
            raise RegistryError(f"registry: GET {url}: {e.reason}") from e

    def _fetch_token(self, challenge: str) -> str:
        """Bearer token round-trip from a WWW-Authenticate challenge."""
        if not challenge.lower().startswith("bearer"):
            return ""
        params = dict(re.findall(r'(\w+)="([^"]*)"', challenge))
        realm = params.get("realm")
        if not realm:
            return ""
        query = []
        if params.get("service"):
            query.append("service=" + urllib.parse.quote(params["service"]))
        if params.get("scope"):
            query.append("scope=" + urllib.parse.quote(params["scope"]))
        url = realm + ("?" + "&".join(query) if query else "")
        headers = {}
        if self.username:
            headers["Authorization"] = f"Basic {self._basic_credential()}"
        req = urllib.request.Request(url, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                doc = json.loads(resp.read())
        except (urllib.error.URLError, ValueError):
            return ""
        return doc.get("token") or doc.get("access_token") or ""

    # ------------------------------------------------------------------

    def get_manifest(self, ref: Reference) -> tuple[dict, bytes]:
        base = f"{self._scheme(ref.registry)}://{ref.registry}/v2/{ref.repository}"
        target = ref.digest or ref.tag
        raw, _ = self._request(
            f"{base}/manifests/{target}",
            {"Accept": MANIFEST_ACCEPT},
            ref.repository,
        )
        manifest = json.loads(raw)
        if manifest.get("mediaType") in _INDEX_TYPES or "manifests" in manifest:
            desc = self._pick_platform(manifest)
            raw, _ = self._request(
                f"{base}/manifests/{desc['digest']}",
                {"Accept": MANIFEST_ACCEPT},
                ref.repository,
            )
            manifest = json.loads(raw)
        return manifest, raw

    def _pick_platform(self, index: dict) -> dict:
        return pick_platform(
            index, self.platform_os, self.platform_arch, RegistryError
        )

    def get_blob(self, ref: Reference, digest: str, _retried: bool = False):
        """Stream a blob into a spooled temp file; returns the open file
        positioned at 0 (caller owns/closes it).  Streaming keeps multi-GB
        layers out of resident memory."""
        base = f"{self._scheme(ref.registry)}://{ref.registry}/v2/{ref.repository}"
        url = f"{base}/blobs/{digest}"
        req = urllib.request.Request(
            url, headers=self._auth_headers(ref.repository)
        )
        try:
            resp = urllib.request.urlopen(req, timeout=300)
        except urllib.error.HTTPError as e:
            if e.code == 401 and not _retried:
                token = self._fetch_token(e.headers.get("WWW-Authenticate", ""))
                if token:
                    self._tokens[ref.repository] = token
                    return self.get_blob(ref, digest, _retried=True)
            raise RegistryError(f"registry: GET {url}: HTTP {e.code}") from e
        except urllib.error.URLError as e:
            raise RegistryError(f"registry: GET {url}: {e.reason}") from e
        f = tempfile.SpooledTemporaryFile(max_size=32 << 20)
        with resp:
            shutil.copyfileobj(resp, f, length=1 << 20)
        f.seek(0)
        return f

    # CycloneDX artifact types the reference accepts for OCI-referrer
    # SBOMs (remote_sbom.go).
    _SBOM_ARTIFACT_TYPES = (
        "application/vnd.cyclonedx+json",
        "application/vnd.cyclonedx",
    )

    def get_referrers(self, ref: Reference, digest: str) -> dict:
        """OCI 1.1 referrers index for `digest`, falling back to the
        referrers TAG schema (`sha256-<hex>`) on registries without the
        API — the same chain go-containerregistry's remote.Referrers walks
        for the reference.  {} when neither exists."""
        base = f"{self._scheme(ref.registry)}://{ref.registry}/v2/{ref.repository}"
        accept = "application/vnd.oci.image.index.v1+json"
        for path in (
            f"{base}/referrers/{digest}",
            f"{base}/manifests/{digest.replace(':', '-')}",
        ):
            try:
                raw, _ = self._request(
                    path, {"Accept": accept}, ref.repository
                )
                doc = json.loads(raw)
            except (RegistryError, ValueError):
                continue
            if isinstance(doc, dict) and doc.get("manifests") is not None:
                return doc
        return {}

    def fetch_sbom_referrer(self, ref: Reference, digest: str) -> dict | None:
        """A CycloneDX SBOM attached to `digest` via OCI referrers, decoded
        (remote_sbom.go:61-114), or None when absent/undecodable."""
        for desc in self.get_referrers(ref, digest).get("manifests") or []:
            if desc.get("artifactType") not in self._SBOM_ARTIFACT_TYPES:
                continue
            try:
                raw, _ = self._request(
                    f"{self._scheme(ref.registry)}://{ref.registry}/v2/"
                    f"{ref.repository}/manifests/{desc['digest']}",
                    {"Accept": MANIFEST_ACCEPT},
                    ref.repository,
                )
                manifest = json.loads(raw)
                layers = manifest.get("layers") or []
                if not layers:
                    continue
                with self.get_blob(ref, layers[0]["digest"]) as f:
                    return json.loads(f.read())
            except (RegistryError, ValueError, KeyError) as e:
                logger.warning("OCI-referrer SBOM unusable: %s", e)
        return None

    def list_tags(self, ref: Reference) -> list[str]:
        """All tags in the reference's repository (GET /v2/<name>/tags/list),
        sorted.  The watch plane's registry poller diffs successive calls
        against its last-seen digests to synthesize change events; sorted
        output keeps that diff deterministic across registries that page
        or reorder."""
        base = f"{self._scheme(ref.registry)}://{ref.registry}/v2/{ref.repository}"
        raw, _ = self._request(f"{base}/tags/list", {}, ref.repository)
        try:
            doc = json.loads(raw)
        except ValueError as e:
            raise RegistryError(
                f"registry: bad tags/list body for {ref.repository}"
            ) from e
        return sorted(str(t) for t in (doc.get("tags") or []))

    def subject_digest(self, ref: Reference) -> str:
        """The digest SBOM referrers attach to: the user-supplied digest,
        or the digest of whatever the tag resolves to FIRST (the index for
        multi-arch images — cosign et al. attach to that, not to the
        platform child; remote_sbom.go uses the repo digest the same
        way)."""
        from trivy_tpu_torch.artifact.image import _sha256_hex

        if ref.digest:
            return ref.digest
        base = f"{self._scheme(ref.registry)}://{ref.registry}/v2/{ref.repository}"
        raw, headers = self._request(
            f"{base}/manifests/{ref.tag}",
            {"Accept": MANIFEST_ACCEPT},
            ref.repository,
        )
        return headers.get("Docker-Content-Digest") or _sha256_hex(raw)

    def fetch_image(self, ref_str: str):
        """Resolve a reference into an ImageSource (artifact/image.py)."""
        from trivy_tpu_torch.artifact.image import ImageSource, _sha256_hex

        ref = parse_reference(ref_str)
        manifest, _raw_manifest = self.get_manifest(ref)
        with self.get_blob(ref, manifest["config"]["digest"]) as f:
            raw_config = f.read()
        layers = [
            (lambda d=layer["digest"]: self.get_blob(ref, d))
            for layer in manifest.get("layers", [])
        ]
        return ImageSource(
            config=json.loads(raw_config),
            config_digest=_sha256_hex(raw_config),
            layers=layers,
            repo_tags=[f"{ref.repository}:{ref.tag}"] if not ref.digest else [],
            repo_digests=[ref.name] if ref.digest else [],
            sbom_fetcher=self.sbom_fetcher_for(ref_str),
        )

    def sbom_fetcher_for(self, ref_str: str):
        """A zero-argument callable resolving the reference's OCI-referrer
        SBOM on demand (None on any failure) — attached to ImageSources
        from ANY resolution hop (daemon/podman included: the referrers
        live in the registry regardless of where the bytes came from)."""

        def fetch():
            try:
                ref = parse_reference(ref_str)
                return self.fetch_sbom_referrer(ref, self.subject_digest(ref))
            except (RegistryError, ValueError) as e:
                logger.debug("no OCI-referrer SBOM for %s: %s", ref_str, e)
                return None

        return fetch
