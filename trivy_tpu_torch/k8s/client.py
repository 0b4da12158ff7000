"""Kubernetes API client: kubeconfig parsing + resource enumeration.

The reference rides the trivy-kubernetes library; this client speaks the
API directly with stdlib HTTP: kubeconfig contexts resolve to (server,
auth) where auth is a bearer token, basic credentials, or client
certificates (an mTLS ssl context).  Enumerated kinds mirror the
reference's artifact list: workloads always, RBAC resources
(Role/RoleBinding/ClusterRole/ClusterRoleBinding) when the rbac scanner
is on or ``--include-kinds`` names them (pkg/k8s/commands/cluster.go).

Divergence: the reference's node-collector job (a privileged pod it
schedules to collect kubelet/node file facts) is NOT implemented — this
build never mutates the cluster; node inventory comes read-only from the
KBOM path (k8s/kbom.py nodeInfo).

Copied from `trivy_tpu/k8s/client.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import base64
import json
import os
import ssl
import tempfile
import urllib.error
import urllib.request
from dataclasses import dataclass, field

import yaml

WORKLOAD_KINDS = (
    # (kind, api path, namespaced collection name)
    ("Pod", "/api/v1", "pods"),
    ("Deployment", "/apis/apps/v1", "deployments"),
    ("StatefulSet", "/apis/apps/v1", "statefulsets"),
    ("DaemonSet", "/apis/apps/v1", "daemonsets"),
    ("ReplicaSet", "/apis/apps/v1", "replicasets"),
    ("Job", "/apis/batch/v1", "jobs"),
    ("CronJob", "/apis/batch/v1", "cronjobs"),
)

_RBAC_API = "/apis/rbac.authorization.k8s.io/v1"
RBAC_KINDS = (
    # (kind, api path, collection); ClusterRole(Binding) are cluster-scoped
    ("Role", _RBAC_API, "roles"),
    ("RoleBinding", _RBAC_API, "rolebindings"),
    ("ClusterRole", _RBAC_API, "clusterroles"),
    ("ClusterRoleBinding", _RBAC_API, "clusterrolebindings"),
)
_CLUSTER_SCOPED = {"ClusterRole", "ClusterRoleBinding"}


def select_kinds(
    include_kinds: list[str] | None, rbac: bool, workloads: bool = True
):
    """Resolve the enumerated kind tuples from ``--include-kinds`` (kind
    names, case-insensitive).  Empty: workload kinds when any workload
    scanner is active, RBAC kinds when the rbac scanner is on — an
    rbac-only scan must not list every pod in a large cluster just to
    print guaranteed-empty rows."""
    universe = WORKLOAD_KINDS + RBAC_KINDS
    if include_kinds:
        wanted = {k.strip().lower() for k in include_kinds if k.strip()}
        unknown = wanted - {k.lower() for k, _a, _c in universe}
        if unknown:
            raise KubeConfigError(
                f"--include-kinds: unknown kinds {sorted(unknown)}"
            )
        return tuple(t for t in universe if t[0].lower() in wanted)
    out: tuple = ()
    if workloads:
        out += WORKLOAD_KINDS
    if rbac:
        out += RBAC_KINDS
    return out


class KubeConfigError(RuntimeError):
    def __init__(self, msg: str, status: int = 0):
        super().__init__(msg)
        self.status = status


@dataclass
class KubeAuth:
    server: str
    token: str = ""
    username: str = ""
    password: str = ""
    client_cert_data: bytes = b""
    client_key_data: bytes = b""
    ca_data: bytes = b""
    insecure: bool = False


def _b64field(d: dict, key: str) -> bytes:
    v = d.get(key, "")
    return base64.b64decode(v) if v else b""


def load_kubeconfig(path: str = "", context: str = "") -> KubeAuth:
    """Resolve (server, auth) from a kubeconfig (KUBECONFIG or
    ~/.kube/config by default), honoring the selected/current context."""
    path = (
        path
        or os.environ.get("KUBECONFIG", "")
        or os.path.expanduser("~/.kube/config")
    )
    try:
        with open(path, encoding="utf-8") as f:
            doc = yaml.safe_load(f) or {}
    except (OSError, yaml.YAMLError) as e:
        raise KubeConfigError(f"cannot load kubeconfig {path}: {e}") from e

    ctx_name = context or doc.get("current-context", "")
    try:
        contexts = {
            c["name"]: c.get("context") or {}
            for c in doc.get("contexts") or []
        }
        clusters = {
            c["name"]: c.get("cluster") or {}
            for c in doc.get("clusters") or []
        }
        users = {u["name"]: u.get("user") or {} for u in doc.get("users") or []}
    except (KeyError, TypeError) as e:
        raise KubeConfigError(f"malformed kubeconfig {path}: {e}") from e
    if ctx_name not in contexts:
        raise KubeConfigError(f"kubeconfig context {ctx_name!r} not found")
    ctx = contexts[ctx_name]
    cluster = clusters.get(ctx.get("cluster", ""))
    if cluster is None:
        raise KubeConfigError(f"cluster {ctx.get('cluster')!r} not found")
    user = users.get(ctx.get("user", ""), {})

    token = user.get("token", "")
    token_file = user.get("tokenFile", "")
    if not token and token_file:
        try:
            with open(token_file, encoding="utf-8") as f:
                token = f.read().strip()
        except OSError:
            pass
    return KubeAuth(
        server=cluster.get("server", "").rstrip("/"),
        token=token,
        username=user.get("username", ""),
        password=user.get("password", ""),
        client_cert_data=_b64field(user, "client-certificate-data"),
        client_key_data=_b64field(user, "client-key-data"),
        ca_data=_b64field(cluster, "certificate-authority-data"),
        insecure=bool(cluster.get("insecure-skip-tls-verify")),
    )


@dataclass
class KubeClient:
    auth: KubeAuth
    _ctx: ssl.SSLContext | None = field(default=None, repr=False)

    def _ssl_context(self) -> ssl.SSLContext | None:
        if not self.auth.server.startswith("https"):
            return None
        if self._ctx is None:
            ctx = ssl.create_default_context()
            if self.auth.insecure:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            elif self.auth.ca_data:
                ctx.load_verify_locations(
                    cadata=self.auth.ca_data.decode("utf-8", "replace")
                )
            if self.auth.client_cert_data and self.auth.client_key_data:
                # ssl wants files; write key material to a private tempdir
                d = tempfile.mkdtemp(prefix="trivy-tpu-kube-")
                cert = os.path.join(d, "cert.pem")
                key = os.path.join(d, "key.pem")
                try:
                    with open(cert, "wb") as f:
                        f.write(self.auth.client_cert_data)
                    with open(key, "wb") as f:
                        f.write(self.auth.client_key_data)
                    os.chmod(key, 0o600)
                    ctx.load_cert_chain(cert, key)
                finally:
                    # The context holds the loaded chain; the private key
                    # must not linger on disk.
                    import shutil

                    shutil.rmtree(d, ignore_errors=True)
            self._ctx = ctx
        return self._ctx

    def get(self, path: str) -> dict:
        url = self.auth.server + path
        headers = {"Accept": "application/json"}
        if self.auth.token:
            headers["Authorization"] = f"Bearer {self.auth.token}"
        elif self.auth.username:
            cred = base64.b64encode(
                f"{self.auth.username}:{self.auth.password}".encode()
            ).decode()
            headers["Authorization"] = f"Basic {cred}"
        req = urllib.request.Request(url, headers=headers)
        try:
            with urllib.request.urlopen(
                req, timeout=60, context=self._ssl_context()
            ) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise KubeConfigError(f"GET {path}: HTTP {e.code}", e.code) from e
        except (urllib.error.URLError, ValueError) as e:
            raise KubeConfigError(f"GET {path}: {e}") from e

    def list_workloads(
        self, namespace: str = "", kinds: tuple = WORKLOAD_KINDS
    ) -> list[dict]:
        """All resources of `kinds` (cluster-wide or one namespace), each
        a full resource dict with kind/metadata/spec.  Cluster-scoped
        kinds (ClusterRole/ClusterRoleBinding) always enumerate at the
        cluster level — a namespace filter cannot apply to them."""
        out: list[dict] = []
        for kind, api, collection in kinds:
            if namespace and kind not in _CLUSTER_SCOPED:
                path = f"{api}/namespaces/{namespace}/{collection}"
            else:
                path = f"{api}/{collection}"
            try:
                doc = self.get(path)
            except KubeConfigError as e:
                if e.status == 404:
                    continue  # API group absent (minimal clusters)
                # Auth/network failures must not read as an empty cluster.
                raise
            for item in doc.get("items") or []:
                item.setdefault("kind", kind)
                item.setdefault(
                    "apiVersion", api.removeprefix("/apis/").removeprefix("/api/")
                )
                out.append(item)
        return out
