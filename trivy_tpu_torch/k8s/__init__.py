"""Kubernetes super-command (pkg/k8s).

Enumerates cluster resources through the Kubernetes API (kubeconfig auth),
fans out inner scans — misconfiguration checks over each workload manifest
and vulnerability/secret scans over every referenced container image — and
aggregates per-resource results into the k8s report (summary or all).

Copied from `trivy_tpu/k8s/__init__.py`;
the port imports nothing from the JAX package.
"""

from trivy_tpu_torch.k8s.client import KubeClient, KubeConfigError, load_kubeconfig
from trivy_tpu_torch.k8s.scanner import K8sScanner
from trivy_tpu_torch.k8s.report import K8sReport, K8sResource, write_k8s_report

__all__ = [
    "KubeClient",
    "KubeConfigError",
    "load_kubeconfig",
    "K8sScanner",
    "K8sReport",
    "K8sResource",
    "write_k8s_report",
]
