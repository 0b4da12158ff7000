"""Image fixtures: layer tars, OCI layouts, `docker save` archives, OCI
artifact manifests, an in-process registry and the bounded-memory probe.

Builders for the port's tests and `chip_smoke.py`, laid out as `docker
save`, an OCI image layout and the Distribution API lay them out; the
scanner never imports this module.  A layer is given as its bytes or as
the path of its tar on disk (a large layer stays on disk: the OCI layout
moves the file into its blob store, the archive streams it).

The memory probe scans the C2 image (`tests/test_big_file_memory.py`: a
99 MiB C source and a planted github-pat in one layer) through
`ImageArtifact` in a fresh interpreter:

    python -m trivy_tpu_torch.image.fixtures [--layer TAR] [--device cpu]
        [--rules-cache-dir DIR]

Without `--layer` the layer is built in memory, as the reference test
holds it.  It prints one JSON line: the resident MiB at the start, after
the secret engine's construction and warm-up, the peak during `inspect`
(sampled every 5 ms from a thread), at its end, the interpreter's own
peak (`VmHWM`, null where /proc does not give it), the secrets found, the
blob count, the engine's class and its device.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import tarfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

MANIFEST_TYPE = "application/vnd.oci.image.manifest.v1+json"
BIG_SIZE = 99 << 20  # the C2 fixture's file: just under the walker's 100 MiB skip
BIG_PAT = b'key = "ghp_' + b"A" * 36 + b'"\n'


def sha256_digest(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return "sha256:" + h.hexdigest()


def _descriptor(layer: bytes | str) -> tuple[str, int]:
    """(digest, size) of a layer given as bytes or as a file's path."""
    if isinstance(layer, bytes):
        return sha256_digest(layer), len(layer)
    return file_digest(layer), os.path.getsize(layer)


def _write_layer(fileobj, files, whiteouts=(), opaque=()) -> None:
    with tarfile.open(fileobj=fileobj, mode="w") as tf:
        names = list(files.items() if isinstance(files, dict) else files)
        names += [(os.path.join(os.path.dirname(w), ".wh." + os.path.basename(w)), b"")
                  for w in whiteouts]
        names += [(os.path.join(d, ".wh..wh..opq"), b"") for d in opaque]
        for name, content in names:
            info = tarfile.TarInfo(name)
            info.size = len(content)
            info.mode = 0o644
            tf.addfile(info, io.BytesIO(content))


def layer_tar(files, whiteouts=(), opaque=()) -> bytes:
    """An uncompressed layer tar of `files` ({path: bytes} or (path, bytes)
    pairs), `.wh.<name>` whiteouts of `whiteouts` and `.wh..wh..opq`
    markers in the `opaque` directories."""
    buf = io.BytesIO()
    _write_layer(buf, files, whiteouts, opaque)
    return buf.getvalue()


def write_layer(path: str, files, whiteouts=(), opaque=()) -> str:
    """`layer_tar` written to `path`; returns its diff ID."""
    with open(path, "wb") as f:
        _write_layer(f, files, whiteouts, opaque)
    return file_digest(path)


def image_manifest(config: bytes, layers: list[tuple[str, int]]) -> bytes:
    """An OCI image manifest of a config blob and (digest, size) layers."""
    return json.dumps({
        "schemaVersion": 2, "mediaType": MANIFEST_TYPE,
        "config": {"mediaType": "application/vnd.oci.image.config.v1+json",
                   "digest": sha256_digest(config), "size": len(config)},
        "layers": [{"mediaType": "application/vnd.oci.image.layer.v1.tar", "digest": d,
                    "size": n} for d, n in layers],
    }).encode()


def oci_blobs(layers: list[bytes], config: dict) -> tuple[bytes, dict, str]:
    """(manifest, {digest: blob} of the config and layers, the manifest's
    digest) of an image held in memory."""
    raw = json.dumps(config).encode()
    blobs = {sha256_digest(raw): raw}
    blobs.update({sha256_digest(layer): layer for layer in layers})
    manifest = image_manifest(raw, [_descriptor(layer) for layer in layers])
    return manifest, blobs, sha256_digest(manifest)


def write_oci_layout(root: str, layers: list, config: dict) -> dict:
    """An OCI image layout at `root` of `layers` (bytes, or tar files that
    are moved into its blob store) and `config`.  Returns {"manifest":
    bytes, "digest": its digest, "blobs": the blob directory}."""
    blobs = os.path.join(root, "blobs", "sha256")
    os.makedirs(blobs, exist_ok=True)

    def put(data: bytes) -> str:
        digest = sha256_digest(data)
        with open(os.path.join(blobs, digest.split(":")[1]), "wb") as f:
            f.write(data)
        return digest

    described = []
    for layer in layers:
        digest, size = _descriptor(layer)
        if isinstance(layer, bytes):
            put(layer)
        else:
            os.replace(layer, os.path.join(blobs, digest.split(":")[1]))
        described.append((digest, size))
    raw = json.dumps(config).encode()
    put(raw)
    manifest = image_manifest(raw, described)
    digest = put(manifest)
    with open(os.path.join(root, "index.json"), "w") as f:
        json.dump({"schemaVersion": 2, "manifests": [
            {"mediaType": MANIFEST_TYPE, "digest": digest, "size": len(manifest)}]}, f)
    with open(os.path.join(root, "oci-layout"), "w") as f:
        json.dump({"imageLayoutVersion": "1.0.0"}, f)
    return {"manifest": manifest, "digest": digest, "blobs": blobs}


def write_docker_archive(path: str, layers: list, config: dict,
                         tags=("smoke/app:1",)) -> None:
    """`docker save`'s layout of `config` and `layers` (bytes, or tar files
    streamed into the archive) at `path`."""
    raw = json.dumps(config).encode()
    cfg_name = hashlib.sha256(raw).hexdigest() + ".json"
    names = [f"layer{i}/layer.tar" for i in range(len(layers))]
    manifest = [{"Config": cfg_name, "RepoTags": list(tags), "Layers": names}]
    with tarfile.open(path, "w") as tf:
        for name, data in ((cfg_name, raw), ("manifest.json", json.dumps(manifest).encode())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        for name, layer in zip(names, layers):
            if isinstance(layer, bytes):
                info = tarfile.TarInfo(name)
                info.size = len(layer)
                tf.addfile(info, io.BytesIO(layer))
            else:
                tf.add(layer, arcname=name)


def artifact_manifest(media_type: str, layer: bytes | str) -> bytes:
    """The manifest of a one-layer OCI artifact (a DB or Java index
    tar.gz, as bytes or a file's path)."""
    digest, size = _descriptor(layer)
    return json.dumps({
        "schemaVersion": 2, "mediaType": MANIFEST_TYPE,
        "config": {"mediaType": "application/vnd.oci.empty.v1+json",
                   "digest": sha256_digest(b"{}"), "size": 2},
        "layers": [{"mediaType": media_type, "digest": digest, "size": size}],
    }).encode()


def serve_registry(repos: dict, referrers: dict | None = None) -> ThreadingHTTPServer:
    """An in-process registry (the Distribution API's GETs, no auth) on
    127.0.0.1: `repos` maps a repository to {"manifests": {tag or digest:
    bytes}, "blobs": {digest: bytes}, "blob_dir": a directory whose files
    are named by their hex digests, streamed}; `referrers` maps a subject
    digest to its OCI index.  Both may change while it serves.  Returns
    the server; `shutdown()` and `server_close()` stop it."""
    referrers = {} if referrers is None else referrers

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _head(self, code: int, size: int, ctype: str = "application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(size))
            self.end_headers()

        def do_GET(self):  # noqa: N802
            parts = self.path.split("/")
            repo, kind, ref = "/".join(parts[2:-2]), parts[-2], parts[-1]
            spec = repos.get(repo) or {}
            body = None
            if kind == "manifests":
                body = spec.get("manifests", {}).get(ref)
            elif kind == "referrers" and ref in referrers:
                body = json.dumps(referrers[ref]).encode()
            elif kind == "blobs":
                body = spec.get("blobs", {}).get(ref)
            if body is not None:
                self._head(200, len(body), "application/json")
                self.wfile.write(body)
                return
            path = os.path.join(spec.get("blob_dir") or "", ref.split(":")[-1])
            if kind == "blobs" and spec.get("blob_dir") and os.path.isfile(path):
                self._head(200, os.path.getsize(path))
                with open(path, "rb") as f:
                    shutil.copyfileobj(f, self.wfile, 1 << 20)
                return
            self._head(404, 0)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def big_file(size: int = BIG_SIZE) -> bytes:
    """The C2 fixture's C source (`tests/test_big_file_memory.py`)."""
    line = b"int filler_symbol_%08d = 1; /* kernel-ish text */\n"
    body = bytearray()
    i = 0
    while len(body) < size:
        body += line % i
        i += 1
    return bytes(body[:size])


def big_layer() -> bytes:
    """The C2 image's one layer: `opt/big/huge.c` and `etc/leak.conf`."""
    return layer_tar([("opt/big/huge.c", big_file()), ("etc/leak.conf", BIG_PAT)])


def _resident_mib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / (1 << 20)


def _hwm_mib() -> float | None:
    try:
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) for line in f
                        if line.startswith("VmHWM:")) / 1024
    except (OSError, StopIteration):
        return None


def main(argv: list[str] | None = None) -> int:
    import argparse

    from trivy_tpu_torch.analyzer.core import AnalyzerOptions, SecretScannerOption
    from trivy_tpu_torch.artifact.image import ImageArtifact, ImageSource
    from trivy_tpu_torch.cache.store import MemoryCache

    ap = argparse.ArgumentParser(prog="python -m trivy_tpu_torch.image.fixtures")
    ap.add_argument("--layer", default="", help="the C2 layer's tar on disk")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rules-cache-dir", default="")
    args = ap.parse_args(argv)
    start = _resident_mib()
    if args.layer:
        diff = file_digest(args.layer)
        opener = lambda: open(args.layer, "rb")  # noqa: E731
    else:
        raw = big_layer()
        diff = sha256_digest(raw)
        opener = lambda: io.BytesIO(raw)  # noqa: E731
    config = {"architecture": "amd64", "os": "linux",
              "rootfs": {"type": "layers", "diff_ids": [diff]}}
    src = ImageSource(config=config, config_digest=sha256_digest(json.dumps(config).encode()),
                      layers=[opener], repo_tags=["bigfixture:1"], repo_digests=[])
    art = ImageArtifact("bigfixture:1", MemoryCache(), source=src,
                        analyzer_options=AnalyzerOptions(
                            device=args.device, secret_scanner_option=SecretScannerOption(
                                device=args.device, rules_cache_dir=args.rules_cache_dir)))
    engine = next(a for a in art.group.analyzers if a.type() == "secret").engine
    engine.warmup()
    base = _resident_mib()
    peak, done = [base], threading.Event()

    def sample() -> None:
        while not done.wait(0.005):
            peak[0] = max(peak[0], _resident_mib())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    ref = art.inspect()
    done.set()
    sampler.join()
    after = _resident_mib()
    secrets = sorted(s.file_path for b in ref.blob_ids for s in art.cache.get_blob(b).secrets)
    print(json.dumps({"start_mib": start, "base_mib": base, "peak_mib": max(peak[0], after),
                      "after_mib": after, "hwm_mib": _hwm_mib(), "secrets": secrets,
                      "blob_ids": len(ref.blob_ids), "engine": type(engine).__name__,
                      "device": str(engine.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
