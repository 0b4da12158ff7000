"""Container-runtime daemon image sources (docker / podman / containerd).

The local end of the reference's resolution chain
(pkg/fanal/image/daemon.go:12,24,35): docker and podman export the image
as a docker-save archive over their HTTP-over-unix-socket APIs, parsed by
the existing archive loader; containerd resolves through its on-disk
content store + boltdb metadata directly (image/containerd.py) — no gRPC
needed for the read-only case.

Copied from `trivy_tpu/image/daemon.py`; the port imports nothing from
the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import http.client
import os
import socket
import tempfile
import urllib.parse
import weakref

DOCKER_SOCKETS = ("/var/run/docker.sock", "/run/docker.sock")
PODMAN_SOCKETS = (
    "/run/podman/podman.sock",
    os.path.expanduser("~/.local/share/containers/podman/machine/podman.sock"),
)


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class SourceUnavailable(RuntimeError):
    """This source cannot provide the image (daemon absent, image unknown)."""


class _UnixHTTPConnection(http.client.HTTPConnection):
    def __init__(self, socket_path: str, timeout: float = 60.0):
        super().__init__("localhost", timeout=timeout)
        self._socket_path = socket_path

    def connect(self) -> None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self._socket_path)
        self.sock = sock


def _export_from_socket(socket_path: str, image_ref: str):
    """GET /images/<ref>/get -> docker-save tar -> ImageSource."""
    from trivy_tpu_torch.artifact.image import load_docker_archive

    if not os.path.exists(socket_path):
        raise SourceUnavailable(f"no socket at {socket_path}")
    conn = _UnixHTTPConnection(socket_path)
    try:
        quoted = urllib.parse.quote(image_ref, safe="")
        conn.request("GET", f"/images/{quoted}/get")
        resp = conn.getresponse()
        if resp.status == 404:
            raise SourceUnavailable(f"image {image_ref!r} not found in daemon")
        if resp.status != 200:
            raise SourceUnavailable(
                f"daemon export failed: HTTP {resp.status}"
            )
        tmp = tempfile.NamedTemporaryFile(
            prefix="trivy-tpu-daemon-", suffix=".tar", delete=False
        )
        try:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                tmp.write(chunk)
            tmp.close()
            src = load_docker_archive(tmp.name)
            # The export tar lives as long as the source (layer readers
            # stream from it); unlink when the source is collected.
            src._tmpfile = tmp.name
            weakref.finalize(src, _unlink_quiet, tmp.name)
            return src
        except Exception:
            tmp.close()
            os.unlink(tmp.name)
            raise
    except (OSError, http.client.HTTPException) as e:
        raise SourceUnavailable(f"daemon at {socket_path}: {e}") from e
    finally:
        conn.close()


def docker_image(image_ref: str):
    for sock_path in DOCKER_SOCKETS:
        if os.path.exists(sock_path):
            return _export_from_socket(sock_path, image_ref)
    raise SourceUnavailable("docker daemon socket not found")


def podman_image(image_ref: str):
    for sock_path in PODMAN_SOCKETS:
        if os.path.exists(sock_path):
            return _export_from_socket(sock_path, image_ref)
    raise SourceUnavailable("podman socket not found")


def containerd_image(image_ref: str):
    from trivy_tpu_torch.image.containerd import containerd_image as _impl

    return _impl(image_ref)
