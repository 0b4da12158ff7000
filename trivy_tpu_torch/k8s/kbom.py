"""KBOM: the Kubernetes bill of materials.

pkg/k8s/scanner/scanner.go clusterInfoToReportResources analogue —
`k8s --format cyclonedx` emits a CycloneDX 1.5 BOM of the CLUSTER itself
rather than scan findings: the cluster root component, every node with its
OS / kubelet / container-runtime components, and the container images the
workloads run, wired together with dependency relationships.

Cluster facts come from the live API (/version, /api/v1/nodes) — the
reference's node-collector gathers the same fields from node status.

Copied from `trivy_tpu/k8s/kbom.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import uuid
from typing import Any

from trivy_tpu_torch.k8s.client import KubeClient
from trivy_tpu_torch.k8s.scanner import _images_of, _owned


def _component(
    ctype: str, name: str, version: str = "", purl: str = "",
    properties: dict[str, str] | None = None,
) -> dict:
    ref = purl or f"{ctype}:{name}@{version or 'unknown'}"
    out: dict[str, Any] = {"bom-ref": ref, "type": ctype, "name": name}
    if version:
        out["version"] = version
    if purl:
        out["purl"] = purl
    if properties:
        out["properties"] = [
            {"name": f"trivy-tpu:resource:{k}", "value": v}
            for k, v in sorted(properties.items())
        ]
    return out


def _image_purl(image: str) -> tuple[str, str, str]:
    """(name, version, purl) for a container image reference."""
    base, _, digest = image.partition("@")
    name, _, tag = base.rpartition(":")
    if not name or "/" in tag:  # no tag present
        name, tag = base, ""
    repo = name.rsplit("/", 1)[-1]
    version = digest or tag
    purl = f"pkg:oci/{repo}"
    if version:
        purl += f"@{version.replace(':', '%3A')}"
    if "/" in name:
        purl += f"?repository_url={name}"
    return name, version, purl


def _split_os_image(os_image: str) -> tuple[str, str]:
    """('red hat enterprise linux', '8.6') from 'Red Hat Enterprise Linux
    8.6': the version starts at the first digit-led token, so multi-word
    distro names survive intact."""
    tokens = os_image.split()
    for i, tok in enumerate(tokens):
        if tok[:1].isdigit():
            return " ".join(tokens[:i]).lower(), " ".join(tokens[i:])
    return os_image.lower(), ""


def build_kbom(
    client: KubeClient, cluster_name: str = "", namespace: str = ""
) -> dict:
    """CycloneDX 1.5 JSON document describing the cluster (or one
    namespace's workloads).  API failures PROPAGATE as KubeConfigError —
    an expired token must not read as a healthy empty cluster (the same
    contract as KubeClient.list_workloads)."""
    ver = client.get("/version")
    k8s_version = ver.get("gitVersion", "")

    root = _component(
        "platform",
        cluster_name or "kubernetes-cluster",
        k8s_version,
        purl=f"pkg:k8s/kubernetes@{k8s_version}" if k8s_version else "",
    )
    # Components dedup by bom-ref: shared node software (same kubelet,
    # same OS image across the fleet) must appear ONCE — CycloneDX
    # requires unique bom-refs.
    by_ref: dict[str, dict] = {}

    def add(comp: dict) -> str:
        return by_ref.setdefault(comp["bom-ref"], comp)["bom-ref"]

    dependencies: list[dict] = [{"ref": root["bom-ref"], "dependsOn": []}]
    root_deps = dependencies[0]["dependsOn"]

    nodes = client.get("/api/v1/nodes").get("items") or []
    for node in nodes:
        meta = node.get("metadata") or {}
        info = (node.get("status") or {}).get("nodeInfo") or {}
        nname = meta.get("name", "node")
        node_comp = _component(
            "platform", nname,
            properties={
                "architecture": info.get("architecture", ""),
                "kernelVersion": info.get("kernelVersion", ""),
                "nodeRole": (
                    "master"
                    if {
                        "node-role.kubernetes.io/control-plane",
                        "node-role.kubernetes.io/master",  # legacy kubeadm
                    } & set(meta.get("labels") or {})
                    else "worker"
                ),
                "operatingSystem": info.get("operatingSystem", ""),
            },
        )
        root_deps.append(add(node_comp))
        node_deps: list[str] = []

        os_image = info.get("osImage", "")
        if os_image:
            os_name, os_ver = _split_os_image(os_image)
            node_deps.append(add(_component(
                "operating-system", os_name, os_ver
            )))
        kubelet = info.get("kubeletVersion", "")
        if kubelet:
            node_deps.append(add(_component(
                "application", "k8s.io/kubelet", kubelet,
                purl=f"pkg:k8s/kubelet@{kubelet}",
            )))
        runtime = info.get("containerRuntimeVersion", "")
        if runtime:
            rname, _, rver = runtime.partition("://")
            node_deps.append(add(_component(
                "application", rname, rver,
                purl=f"pkg:golang/{rname}@{rver}" if rver else "",
            )))
        dependencies.append(
            {"ref": node_comp["bom-ref"], "dependsOn": node_deps}
        )

    # Workload images (deduplicated; controller-owned pods are covered by
    # their controllers, mirroring the scan path's ownership rule).
    seen: set[str] = set()
    for resource in client.list_workloads(namespace=namespace):
        if _owned(resource):
            continue
        for image in _images_of(resource):
            if image in seen:
                continue
            seen.add(image)
            name, version, purl = _image_purl(image)
            root_deps.append(add(_component(
                "container", name, version, purl=purl
            )))

    return {
        "bomFormat": "CycloneDX",
        "specVersion": "1.5",
        "serialNumber": f"urn:uuid:{uuid.uuid4()}",
        "version": 1,
        "metadata": {"component": root},
        "components": list(by_ref.values()),
        "dependencies": dependencies,
    }
