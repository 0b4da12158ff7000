"""Kubernetes manifest misconfiguration checks.

The pkg/iac k8s scanner's role (checks modeled on trivy-checks' KSV-series
policies) over parsed YAML documents.

Copied from `trivy_tpu/misconf/kubernetes.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations


def scan_kubernetes(file_path: str, content: bytes):
    """Rego-driven kubernetes scan (KSV-series checks in
    trivy_tpu_torch/iac/checks); returns None for YAML that is not a k8s
    manifest."""
    from trivy_tpu_torch.iac.engine import shared_scanner

    return shared_scanner().scan(file_path, content)
