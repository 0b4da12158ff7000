"""Kubernetes cluster fixture: a seeded cluster behind an in-process API
server, and a kubeconfig for it.

For the port's tests and `chip_smoke.py`; the scanner never imports this
module.  `seeded_cluster(images, ...)` draws namespaces of workloads
(Deployments with the ReplicaSets and Pods they own, StatefulSets and
DaemonSets with their Pods, CronJobs with a Job and its Pod, Jobs and
standalone Pods), RBAC objects (Roles, ClusterRoles and their bindings,
some granting wildcards, secrets or cluster-admin) and nodes; container
images are drawn from `images`, security contexts from hardened to
privileged.  `serve_cluster(cluster, token)` answers the Kubernetes API
paths a client lists them by (`/api/v1/...`, `/apis/<group>/<version>/...`,
cluster-wide and per namespace), `/version` and `/api/v1/nodes`, with bearer
token auth (401 otherwise); `write_kubeconfig` points a context at it.
"""

from __future__ import annotations

import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

TOKEN = "fixture-cluster-token"
VERSION = "v1.29.2"
# kind -> (API prefix, collection, namespaced), as the Kubernetes API serves them
API = {
    "Pod": ("/api/v1", "pods", True),
    "Deployment": ("/apis/apps/v1", "deployments", True),
    "ReplicaSet": ("/apis/apps/v1", "replicasets", True),
    "StatefulSet": ("/apis/apps/v1", "statefulsets", True),
    "DaemonSet": ("/apis/apps/v1", "daemonsets", True),
    "Job": ("/apis/batch/v1", "jobs", True),
    "CronJob": ("/apis/batch/v1", "cronjobs", True),
    "Role": ("/apis/rbac.authorization.k8s.io/v1", "roles", True),
    "RoleBinding": ("/apis/rbac.authorization.k8s.io/v1", "rolebindings", True),
    "ClusterRole": ("/apis/rbac.authorization.k8s.io/v1", "clusterroles", False),
    "ClusterRoleBinding": ("/apis/rbac.authorization.k8s.io/v1", "clusterrolebindings", False),
}
TOP_KINDS = ("Deployment", "StatefulSet", "DaemonSet", "CronJob", "Job", "Pod")
_SECURITY = (
    {"privileged": True},
    {"allowPrivilegeEscalation": True, "capabilities": {"add": ["SYS_ADMIN"]}},
    {"runAsUser": 0},
    {},
    {"runAsNonRoot": True, "runAsUser": 10001, "runAsGroup": 10001,
     "readOnlyRootFilesystem": True, "allowPrivilegeEscalation": False,
     "capabilities": {"drop": ["ALL"]}, "seccompProfile": {"type": "RuntimeDefault"}},
)


def _container(rng: random.Random, name: str, image: str) -> dict:
    c = {"name": name, "image": image, "securityContext": dict(rng.choice(_SECURITY))}
    if rng.random() < 0.5:
        c["resources"] = {"limits": {"cpu": "500m", "memory": "256Mi"},
                          "requests": {"cpu": "100m", "memory": "128Mi"}}
    return c


def _pod_spec(rng: random.Random, images: list[str], first: str) -> dict:
    spec = {"containers": [_container(rng, f"c{j}", first if j == 0 else rng.choice(images))
                           for j in range(rng.choice((1, 1, 2)))]}
    if rng.random() < 0.2:
        spec["initContainers"] = [_container(rng, "init", rng.choice(images))]
    if rng.random() < 0.1:
        spec["hostNetwork"] = True
    if rng.random() < 0.1:
        spec["hostPID"] = True
    return spec


def _meta(name: str, ns: str, owner: dict | None = None) -> dict:
    meta = {"name": name, "namespace": ns, "uid": f"uid-{ns}-{name}",
            "labels": {"app": name}}
    if owner is not None:
        meta["ownerReferences"] = [{"apiVersion": owner["apiVersion"], "kind": owner["kind"],
                                    "name": owner["metadata"]["name"],
                                    "uid": owner["metadata"]["uid"], "controller": True}]
    return meta


def _api_version(kind: str) -> str:
    return API[kind][0].removeprefix("/apis/").removeprefix("/api/")


def _obj(kind: str, meta: dict, **body) -> dict:
    return {"apiVersion": _api_version(kind), "kind": kind, "metadata": meta, **body}


def seeded_cluster(images: list[str], workloads: int = 150, namespaces: int = 6,
                   rbac: int = 40, nodes: int = 3, seed: int = 0) -> dict:
    """{"items": {kind: [objects]}, "nodes": [...]}: `workloads` top-level workloads in
    turns of TOP_KINDS over `namespaces` namespaces, with the objects their
    controllers own (the first container of the i-th workload runs
    `images[i % len(images)]`, so each image has a workload); `rbac` RBAC
    objects; `nodes` nodes, the first the control plane."""
    rng = random.Random(seed)
    items: dict[str, list] = {k: [] for k in API}
    nss = [f"team-{i}" for i in range(namespaces)]
    for i in range(workloads):
        kind = TOP_KINDS[i % len(TOP_KINDS)]
        ns = nss[rng.randrange(namespaces)]
        name = f"{kind.lower()}-{i:03d}"
        pod = _pod_spec(rng, images, images[i % len(images)])
        template = {"metadata": {"labels": {"app": name}}, "spec": pod}
        if kind == "Pod":
            items["Pod"].append(_obj("Pod", _meta(name, ns), spec=pod))
            continue
        if kind == "CronJob":
            top = _obj(kind, _meta(name, ns), spec={
                "schedule": "*/30 * * * *",
                "jobTemplate": {"spec": {"template": template}}})
            job = _obj("Job", _meta(f"{name}-2900", ns, top), spec={"template": template})
            items["Job"].append(job)
            items["Pod"].append(_obj("Pod", _meta(f"{name}-2900-x1", ns, job), spec=pod))
        else:
            spec = {"selector": {"matchLabels": {"app": name}}, "template": template}
            if kind in ("Deployment", "StatefulSet"):
                spec["replicas"] = 2
            top = _obj(kind, _meta(name, ns), spec=spec)
            parent = top
            if kind == "Deployment":
                parent = _obj("ReplicaSet", _meta(f"{name}-5d8f", ns, top), spec=dict(spec))
                items["ReplicaSet"].append(parent)
            for j in range(2 if kind != "Job" else 1):
                items["Pod"].append(_obj("Pod", _meta(f"{parent['metadata']['name']}-p{j}", ns,
                                                      parent), spec=pod))
        items[kind].append(top)
    for i in range(rbac):
        which = i % 4
        if which in (0, 1):
            cluster_scoped = which == 1
            kind = "ClusterRole" if cluster_scoped else "Role"
            rules = rng.choice((
                [{"apiGroups": ["*"], "resources": ["*"], "verbs": ["*"]}],
                [{"apiGroups": [""], "resources": ["secrets"], "verbs": ["get", "list"]}],
                [{"apiGroups": [""], "resources": ["pods/exec"], "verbs": ["create"]}],
                [{"apiGroups": [""], "resources": ["configmaps"], "verbs": ["get"]}],
                [{"apiGroups": ["apps"], "resources": ["deployments"], "verbs": ["get", "list"]}],
            ))
            meta = {"name": f"{kind.lower()}-{i:02d}"}
            if not cluster_scoped:
                meta["namespace"] = nss[rng.randrange(namespaces)]
            items[kind].append(_obj(kind, meta, rules=rules))
        else:
            cluster_scoped = which == 3
            kind = "ClusterRoleBinding" if cluster_scoped else "RoleBinding"
            role = rng.choice(("cluster-admin", "view", "edit", f"role-{i:02d}"))
            subject = rng.choice(({"kind": "Group", "name": "system:authenticated"},
                                  {"kind": "ServiceAccount", "name": "default",
                                   "namespace": nss[0]},
                                  {"kind": "User", "name": f"dev-{i}"}))
            meta = {"name": f"{kind.lower()}-{i:02d}"}
            if not cluster_scoped:
                meta["namespace"] = nss[rng.randrange(namespaces)]
            items[kind].append(_obj(kind, meta, roleRef={
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole" if role in ("cluster-admin", "view", "edit") else "Role",
                "name": role}, subjects=[subject]))
    node_list = []
    for i in range(nodes):
        labels = {"kubernetes.io/hostname": f"node-{i}"}
        if i == 0:
            labels["node-role.kubernetes.io/control-plane"] = ""
        node_list.append({"apiVersion": "v1", "kind": "Node",
                          "metadata": {"name": f"node-{i}", "labels": labels},
                          "status": {"nodeInfo": {
                              "architecture": "amd64", "kernelVersion": "6.1.0-18-cloud-amd64",
                              "osImage": "Debian GNU/Linux 12 (bookworm)",
                              "operatingSystem": "linux", "kubeletVersion": VERSION,
                              "containerRuntimeVersion": "containerd://1.7.13"}}})
    return {"items": items, "nodes": node_list}


def serve_cluster(cluster: dict, token: str = TOKEN) -> ThreadingHTTPServer:
    """A localhost API server over `cluster` (`seeded_cluster`); call
    `shutdown()` and `server_close()` when done."""
    routes: dict[str, list] = {"/api/v1/nodes": cluster["nodes"]}
    for kind, (prefix, coll, namespaced) in API.items():
        objs = cluster["items"].get(kind, [])
        routes[f"{prefix}/{coll}"] = objs
        if namespaced:
            for o in objs:
                ns = o["metadata"].get("namespace", "")
                routes.setdefault(f"{prefix}/namespaces/{ns}/{coll}", []).append(o)
    namespaced_colls = {(prefix, coll) for prefix, coll, namespaced in API.values() if namespaced}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, status: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.headers.get("Authorization") != f"Bearer {token}":
                return self._send(401, {"kind": "Status", "code": 401,
                                        "reason": "Unauthorized"})
            path = self.path.partition("?")[0]
            if path == "/version":
                return self._send(200, {"major": "1", "minor": VERSION.split(".")[1],
                                        "gitVersion": VERSION, "platform": "linux/amd64"})
            objs = routes.get(path)
            if objs is None:
                # an empty namespace lists nothing, an unknown path is a 404
                head, _, coll = path.rpartition("/")
                prefix = head.rpartition("/namespaces/")[0]
                if (prefix, coll) not in namespaced_colls or "/namespaces/" not in head:
                    return self._send(404, {"kind": "Status", "code": 404})
                objs = []
            return self._send(200, {"kind": "List", "apiVersion": "v1",
                                    "metadata": {"resourceVersion": "1"}, "items": objs})

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def write_kubeconfig(path: str, server: str, token: str = TOKEN) -> str:
    """A kubeconfig whose current context is `server` with bearer `token`."""
    import yaml

    doc = {"apiVersion": "v1", "kind": "Config", "current-context": "fixture",
           "contexts": [{"name": "fixture", "context": {"cluster": "c", "user": "u"}}],
           "clusters": [{"name": "c", "cluster": {"server": server}}],
           "users": [{"name": "u", "user": {"token": token}}]}
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(doc, f)
    return path
