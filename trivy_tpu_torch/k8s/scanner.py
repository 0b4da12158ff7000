"""k8s scan fan-out (pkg/k8s/scanner + commands/cluster.go).

Per enumerated workload: the manifest runs through the rego kubernetes
checks; every container image it references scans through the image
pipeline (daemon/registry chain).  Per-resource failures are recorded on
the resource (resource.Error) instead of sinking the cluster scan —
unreachable registries and RBAC holes are normal in a live cluster.
Owned resources (pods of a deployment's replicaset etc.) are skipped when
their controller is also enumerated, matching the reference's dedup.

Copied from `trivy_tpu/k8s/scanner.py`;
the port imports nothing from the JAX package.  `K8sScanner.device` is where
the image scans' engines run (default "cuda").  Unlike the reference, which
records any exception of a resource's scans on the resource, the port
tolerates only an image that no source could serve (`ImagePullError`, a
`RegistryError` while its layers are fetched): an engine's or the card's
error, or a kernel that fails to build, fails the cluster scan instead of
reading as one bad resource.  The port adds the host spans `k8s.manifest`
(a resource's checks), `k8s.image` (an image's first scan) and `image.pull`.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field

from trivy_tpu_torch.device import DEFAULT_DEVICE
from trivy_tpu_torch.k8s.report import RBAC_RESOURCE_KINDS, K8sReport, K8sResource

logger = logging.getLogger(__name__)


class ImagePullError(RuntimeError):
    """A workload image that no source could serve (an unreachable or
    refusing registry, a malformed reference)."""


def _images_of(resource: dict) -> list[str]:
    spec = resource.get("spec") or {}
    pod = (
        spec.get("template", {}).get("spec")
        or spec.get("jobTemplate", {})
        .get("spec", {})
        .get("template", {})
        .get("spec")
        or (spec if "containers" in spec else {})
    )
    out = []
    for section in ("initContainers", "containers"):
        for c in pod.get(section) or []:
            img = c.get("image")
            if img:
                out.append(img)
    return out


_ENUMERATED_KINDS = {
    "Pod", "Deployment", "StatefulSet", "DaemonSet", "ReplicaSet", "Job",
    "CronJob",
}


def _owned(resource: dict) -> bool:
    """Skip only resources whose controller kind is itself enumerated —
    a pod owned by a CRD controller (Rollout, static-pod Node ref) has no
    covering row and must be scanned directly."""
    refs = (resource.get("metadata") or {}).get("ownerReferences") or []
    return any(
        r.get("controller") and r.get("kind") in _ENUMERATED_KINDS
        for r in refs
    )


@dataclass
class K8sScanner:
    scanners: list[str] = field(default_factory=lambda: ["misconfig"])
    insecure_registry: bool = False
    db_dir: str = ""
    device: str = DEFAULT_DEVICE
    _vuln_detector: object = field(default=None, repr=False)
    _vuln_ready: bool = field(default=False, repr=False)

    def scan(
        self, resources: list[dict], cluster_name: str = ""
    ) -> K8sReport:
        from trivy_tpu_torch.image.registry import RegistryError

        report = K8sReport(cluster_name=cluster_name)
        scanned_images: dict[str, list] = {}
        for resource in resources:
            if _owned(resource):
                continue  # controller-owned: the controller row covers it
            meta = resource.get("metadata") or {}
            res = K8sResource(
                namespace=meta.get("namespace", ""),
                kind=resource.get("kind", ""),
                name=meta.get("name", ""),
            )
            try:
                is_rbac = res.kind in RBAC_RESOURCE_KINDS
                if ("misconfig" in self.scanners) or (
                    is_rbac and "rbac" in self.scanners
                ):
                    res.results.extend(self._scan_manifest(resource))
                if not is_rbac and {"vuln", "secret"} & set(self.scanners):
                    for image in _images_of(resource):
                        res.results.extend(
                            self._scan_image(image, scanned_images)
                        )
            except (ImagePullError, RegistryError) as e:  # per-resource tolerance
                logger.warning(
                    "k8s scan failed for %s/%s", res.kind, res.name,
                    exc_info=True,
                )
                res.error = str(e)
            report.resources.append(res)
        return report

    def _scan_manifest(self, resource: dict) -> list:
        from trivy_tpu_torch.ftypes import Result, ResultClass
        from trivy_tpu_torch.iac.engine import shared_scanner
        from trivy_tpu_torch.obs import trace as obs_trace

        meta = resource.get("metadata") or {}
        name = f"{resource.get('kind')}/{meta.get('name', '')}"
        with obs_trace.span("k8s.manifest"):
            mc = shared_scanner().scan(
                f"{name}.json", json.dumps(resource).encode()
            )
        if mc is None or not (mc.failures or mc.successes):
            return []
        return [
            Result(
                target=name,
                result_class=ResultClass.CONFIG,
                result_type="kubernetes",
                misconfigurations=mc.failures,
            )
        ]

    def _scan_image(self, image: str, cache: dict[str, object]) -> list:
        if image in cache:
            hit = cache[image]
            if isinstance(hit, Exception):
                raise hit  # one timeout per unreachable image, not per resource
            return hit
        from trivy_tpu_torch.obs import trace as obs_trace

        with obs_trace.span("k8s.image"):
            return self._scan_new_image(image, cache)

    def _scan_new_image(self, image: str, cache: dict[str, object]) -> list:
        from trivy_tpu_torch.artifact.image import ImageArtifact
        from trivy_tpu_torch.cache.store import MemoryCache
        from trivy_tpu_torch.commands.run import (
            Options,
            _analyzer_options,
            _init_vuln_scanner,
        )
        from trivy_tpu_torch.image import resolve_image
        from trivy_tpu_torch.image.daemon import SourceUnavailable
        from trivy_tpu_torch.image.registry import RegistryError
        from trivy_tpu_torch.obs import trace as obs_trace
        from trivy_tpu_torch.scanner.service import LocalDriver, ScanOptions, Scanner

        try:
            with obs_trace.span("image.pull"):
                source = resolve_image(
                    image, insecure_registry=self.insecure_registry
                )
        except (RegistryError, SourceUnavailable, OSError, ValueError) as e:
            err = ImagePullError(str(e))
            cache[image] = err
            raise err from e
        mem = MemoryCache()
        options = Options(
            target=image,
            scanners=[s for s in self.scanners if s != "misconfig"],
            db_dir=self.db_dir,
            secret_backend="auto",  # the CLI-wide default: the hybrid engine
            device=self.device,
        )
        if not self._vuln_ready:
            # One DB open per cluster scan, not per image.
            self._vuln_detector = _init_vuln_scanner(options)
            self._vuln_ready = True
        artifact = ImageArtifact(
            image, mem,
            analyzer_options=_analyzer_options(options),
            source=source,
        )
        driver = LocalDriver(mem, vuln_detector=self._vuln_detector)
        scanner = Scanner(artifact=artifact, driver=driver)
        report = scanner.scan_artifact(
            ScanOptions(scanners=list(options.scanners))
        )
        results = list(report.results)
        cache[image] = results
        return results
