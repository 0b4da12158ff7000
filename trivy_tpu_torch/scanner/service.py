"""Scanner service: joins artifact inspection with a detection driver.

Mirrors pkg/scanner/scan.go (Scanner :125, Driver seam :131-134) and the local
driver pkg/scanner/local/scan.go (ScanTarget :107, secretsToResults :263).
The Driver seam is where the client/server split (and the TPU sidecar RPC
backend) plugs in: LocalDriver applies layers from the cache in-process, the
RPC client driver (trivy_tpu/rpc/client.py) forwards the same call over HTTP.

Copied from `trivy_tpu/scanner/service.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
The local driver's apply runs under the host span `cache.apply`, its
vulnerability detection (or the DB-less package inventory) under
`scan.vuln`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from trivy_tpu_torch.applier.apply import Applier
from trivy_tpu_torch.atypes import ArtifactReference
from trivy_tpu_torch.cache.store import ArtifactCache
from trivy_tpu_torch.ftypes import (
    ArtifactType,
    Metadata,
    Report,
    Result,
    ResultClass,
)

SCANNER_VULN = "vuln"
SCANNER_MISCONFIG = "misconfig"
SCANNER_SECRET = "secret"
SCANNER_LICENSE = "license"
DEFAULT_SCANNERS = [SCANNER_VULN, SCANNER_SECRET]


@dataclass
class ScanOptions:
    """types.ScanOptions (pkg/types/scan.go)."""

    scanners: list[str] = field(default_factory=lambda: list(DEFAULT_SCANNERS))
    pkg_types: list[str] = field(default_factory=lambda: ["os", "library"])
    list_all_packages: bool = False


def secrets_to_results(secrets) -> list[Result]:
    """local/scan.go:263-281 secretsToResults — one Result per file.

    Module-level so the serve path (rpc/server.py ScanSecrets, fed by the
    cross-request batcher) shapes its response through the SAME function the
    local driver uses: parity between batched-across-requests and sequential
    output is then a property of the engine, not of two converters."""
    return [
        Result(
            target=secret.file_path,
            result_class=ResultClass.SECRET,
            secrets=list(secret.findings),
        )
        for secret in secrets
    ]


class Driver:
    """scanner.Driver (scan.go:131-134) — the local-vs-remote seam."""

    def scan(
        self,
        target: str,
        artifact_id: str,
        blob_ids: list[str],
        options: ScanOptions,
    ) -> tuple[list[Result], object | None]:
        raise NotImplementedError


@dataclass
class LocalDriver(Driver):
    """pkg/scanner/local/scan.go Scanner."""

    cache: ArtifactCache
    vuln_detector: object | None = None  # scanner/vuln.py VulnerabilityScanner

    def scan(self, target, artifact_id, blob_ids, options):
        from trivy_tpu_torch import deadline
        from trivy_tpu_torch.obs import trace as obs_trace

        deadline.check()
        with obs_trace.span("cache.apply"):
            detail = Applier(self.cache).apply_layers(artifact_id, blob_ids)
        results: list[Result] = []

        deadline.check()
        if SCANNER_VULN in options.scanners and self.vuln_detector is not None:
            with obs_trace.span("scan.vuln"):
                results.extend(
                    self.vuln_detector.detect(target, detail, options)  # type: ignore[attr-defined]
                )
        elif getattr(options, "list_all_packages", False):
            # No vulnerability DB, but the caller wants the package
            # inventory (SBOM formats, --list-all-pkgs): emit the package
            # results without detection — SBOM generation must not require
            # a DB download (run.go format handling).
            with obs_trace.span("scan.vuln"):
                results.extend(self._packages_to_results(target, detail, options))

        if SCANNER_SECRET in options.scanners:
            results.extend(self._secrets_to_results(detail))

        if SCANNER_LICENSE in options.scanners:
            results.extend(self._licenses_to_results(detail))

        if SCANNER_MISCONFIG in options.scanners and detail.misconfigurations:
            results.extend(self._misconfigs_to_results(detail))

        # Post-scan hooks mutate assembled results (post_scan.go:19-41);
        # the WASM/extension seat.
        from trivy_tpu_torch.scanner.post import run_post_scan_hooks

        results = run_post_scan_hooks(
            results, custom_resources=detail.custom_resources
        )

        return results, detail.os

    @staticmethod
    def _packages_to_results(target, detail, options) -> list[Result]:
        """Package inventory rows with no vulnerabilities (DB-less SBOM);
        same shapes and pkg_types gating as VulnerabilityScanner.detect."""
        from trivy_tpu_torch.scanner.vuln import (
            has_os_pkgs,
            lang_pkgs_result,
            os_pkgs_result,
        )

        pkg_types = getattr(options, "pkg_types", ["os", "library"])
        out: list[Result] = []
        if "os" in pkg_types and has_os_pkgs(detail):
            out.append(os_pkgs_result(target, detail, [], detail.packages))
        if "library" in pkg_types:
            for app in detail.applications:
                out.append(lang_pkgs_result(app, [], app.packages))
        return out

    @staticmethod
    def _secrets_to_results(detail) -> list[Result]:
        """local/scan.go:263-281 secretsToResults — one Result per file."""
        return secrets_to_results(detail.secrets)

    @staticmethod
    def _licenses_to_results(detail) -> list[Result]:
        """local/scan.go:283 scanLicenses: package-declared licenses become
        one ClassLicense result per source; license files become
        ClassLicenseFile results."""
        from trivy_tpu_torch.ltypes import LicenseFinding

        out = []
        os_findings = [
            LicenseFinding.of(name)
            for pkg in detail.packages
            for name in pkg.licenses
        ]
        if os_findings:
            out.append(
                Result(
                    target="OS Packages",
                    result_class=ResultClass.LICENSE,
                    licenses=os_findings,
                )
            )
        for app in detail.applications:
            findings = [
                LicenseFinding.of(name)
                for pkg in app.packages
                for name in pkg.licenses
            ]
            if findings:
                out.append(
                    Result(
                        target=app.file_path or app.app_type,
                        result_class=ResultClass.LICENSE,
                        licenses=findings,
                    )
                )
        for lf in detail.licenses:
            out.append(
                Result(
                    target=getattr(lf, "file_path", ""),
                    result_class=ResultClass.LICENSE_FILE,
                    licenses=list(getattr(lf, "findings", [])),
                )
            )
        return out

    @staticmethod
    def _misconfigs_to_results(detail) -> list[Result]:
        out = []
        for mc in detail.misconfigurations:
            out.append(
                Result(
                    target=getattr(mc, "file_path", ""),
                    result_class=ResultClass.CONFIG,
                    result_type=getattr(mc, "file_type", ""),
                    misconfigurations=list(getattr(mc, "failures", []))
                    + list(getattr(mc, "successes", [])),
                )
            )
        return out


@dataclass
class Scanner:
    """scanner.Scanner (scan.go:125)."""

    artifact: object  # anything with .inspect() -> ArtifactReference
    driver: Driver

    def scan_artifact(self, options: ScanOptions) -> Report:
        """scan.go:145 ScanArtifact."""
        ref: ArtifactReference = self.artifact.inspect()
        results, detected_os = self.driver.scan(
            ref.name, ref.id, ref.blob_ids, options
        )

        metadata = Metadata()
        if detected_os is not None and getattr(detected_os, "family", ""):
            metadata.os_family = detected_os.family
            metadata.os_name = detected_os.name
        if ref.image_metadata:
            metadata.image_id = ref.image_metadata.get("ImageID", "")
            metadata.diff_ids = ref.image_metadata.get("DiffIDs", [])
            metadata.repo_tags = ref.image_metadata.get("RepoTags", [])
            metadata.repo_digests = ref.image_metadata.get("RepoDigests", [])

        return Report(
            artifact_name=ref.name,
            artifact_type=ArtifactType(ref.artifact_type),
            results=results,
            metadata=metadata,
        )
