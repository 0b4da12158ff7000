"""A fake Rekor transparency log and the executables it attests, for the
port's tests and `chip_smoke.py` (phase `extend`), which has no network and
cannot import `tests/`.

`serve_rekor(attestations)` answers the two routes `attestation.RekorClient`
calls, on 127.0.0.1: `POST /api/v1/index/retrieve {"hash": "sha256:<hex>"}`
with the entry UUIDs of that digest, and `GET /api/v1/log/entries/<uuid>`
with the entry, whose `attestation.data` is a base64 DSSE envelope of an
in-toto statement whose predicate is a CycloneDX SBOM (the shapes of the
reference's `tests/test_attestation.py`).  The server's `lookups` counts
the index lookups of each digest.

`elf_binary(tag)` makes a distinct ELF-headed file; `attested_set(n)`
pairs n of them with one Maven purl and one Debian purl each and makes the
DB advisories that plant one vulnerability on each package, recording the
planted truth as it writes them; `executable_layer` writes a layer tar
whose ELF files are executable (mode 0755), as the `executable` analyzer
claims only those.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import tarfile
import threading
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

ELF_MAGIC = b"\x7fELF"


def elf_binary(tag: str, size: int = 4096) -> bytes:
    """An ELF-headed file whose body is derived from `tag` (distinct tags,
    distinct digests)."""
    seed = hashlib.sha256(tag.encode()).digest()
    body = (seed * (size // len(seed) + 1))[: size - 16]
    return ELF_MAGIC + b"\x02\x01\x01" + b"\x00" * 9 + body


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sbom_predicate(purls: list[str]) -> dict:
    """A CycloneDX SBOM listing one library component a purl."""
    components = []
    for purl in purls:
        body = purl[4:].split("@")[0]
        name = body.rsplit("/", 1)[-1]
        version = purl.rsplit("@", 1)[-1]
        components.append({"type": "library", "name": name, "version": version,
                           "purl": purl})
    return {"bomFormat": "CycloneDX", "specVersion": "1.5", "components": components}


def envelope(predicate, digest_hex: str, name: str = "app") -> dict:
    """A DSSE envelope of an in-toto statement about `digest_hex`."""
    statement = {
        "_type": "https://in-toto.io/Statement/v0.1",
        "predicateType": "https://cyclonedx.org/bom",
        "subject": [{"name": name, "digest": {"sha256": digest_hex}}],
        "predicate": predicate,
    }
    return {
        "payloadType": "application/vnd.in-toto+json",
        "payload": base64.b64encode(json.dumps(statement).encode()).decode(),
        "signatures": [{"sig": "unverified"}],
    }


class _Handler(BaseHTTPRequestHandler):
    server: "RekorServer"

    def log_message(self, *a):
        pass

    def _send(self, code: int, doc) -> None:
        data = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n) or b"{}")
        if self.path.rstrip("/") != "/api/v1/index/retrieve":
            self._send(404, {"message": "not found"})
            return
        digest = str(body.get("hash", "")).removeprefix("sha256:")
        with self.server.lock:
            self.server.lookups[digest] += 1
        self._send(200, [u for u, d in self.server.uuids if d == digest])

    def do_GET(self):  # noqa: N802
        uuid = self.path.rsplit("/", 1)[-1]
        entry = self.server.entries.get(uuid)
        if not self.path.startswith("/api/v1/log/entries/") or entry is None:
            self._send(404, {"message": "not found"})
            return
        self._send(200, {uuid: entry})


class RekorServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, attestations: dict[str, dict]):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.lock = threading.Lock()
        self.lookups: Counter = Counter()
        self.uuids: list[tuple[str, str]] = []
        self.entries: dict[str, dict] = {}
        for i, (digest, predicate) in enumerate(sorted(attestations.items())):
            uuid = f"{i:04d}{digest[:60]}"
            data = base64.b64encode(json.dumps(envelope(predicate, digest)).encode()).decode()
            self.uuids.append((uuid, digest))
            self.entries[uuid] = {"body": "", "attestation": {"data": data}}

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server_address[1]}"


def serve_rekor(attestations: dict[str, dict]) -> RekorServer:
    """A fake Rekor log serving `attestations` ({sha256 hex: SBOM
    predicate}) on a background thread; call `shutdown()` and
    `server_close()` when done."""
    srv = RekorServer(attestations)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def attested_set(n: int, prefix: str = "usr/local/bin/tool") -> dict:
    """n attested executables: {"files": {path: bytes}, "attestations":
    {sha256 hex: predicate}, "db": {source: {pkg: [advisory]}}, "lang":
    {(path, name, version, vuln id)}, "os": {(name, version, vuln id)}}.
    Executable i's SBOM lists `pkg:maven/smoke.attested/lib<i>@1.<i>.0`
    and `pkg:deb/libattest<i>@2.<i>-1`, each with one advisory fixed in a
    later version (the Debian ones in the "debian 12" bucket)."""
    files, attestations, lang, os_pkgs = {}, {}, set(), set()
    maven, debian = {}, {}
    for i in range(n):
        path = f"{prefix}{i:02d}"
        content = elf_binary(path)
        files[path] = content
        jar, jar_ver = f"smoke.attested:lib{i}", f"1.{i}.0"
        deb, deb_ver = f"libattest{i}", f"2.{i}-1"
        attestations[sha256_hex(content)] = sbom_predicate([
            f"pkg:maven/smoke.attested/lib{i}@{jar_ver}", f"pkg:deb/{deb}@{deb_ver}"])
        maven[jar] = [{"VulnerabilityID": f"SMOKE-ATT-{2 * i:04d}", "Severity": "HIGH",
                       "FixedVersion": f"1.{i}.9"}]
        debian[deb] = [{"VulnerabilityID": f"SMOKE-ATT-{2 * i + 1:04d}", "Severity": "MEDIUM",
                        "FixedVersion": f"2.{i}-9"}]
        lang.add((path, jar, jar_ver, f"SMOKE-ATT-{2 * i:04d}"))
        os_pkgs.add((deb, deb_ver, f"SMOKE-ATT-{2 * i + 1:04d}"))
    return {"files": files, "attestations": attestations,
            "db": {"maven": maven, "debian 12": debian}, "lang": lang, "os": os_pkgs}


DEBIAN_ROOT = {
    "etc/os-release": b'PRETTY_NAME="Debian GNU/Linux 12 (bookworm)"\nID=debian\n'
                      b'VERSION_ID="12"\n',
    "etc/debian_version": b"12.5\n",
}


def executable_layer(files) -> bytes:
    """An uncompressed layer tar of `files` ({path: bytes} or pairs); the
    ELF-headed ones get mode 0755, the rest 0644."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, content in (files.items() if isinstance(files, dict) else files):
            info = tarfile.TarInfo(name)
            info.size = len(content)
            info.mode = 0o755 if content.startswith(ELF_MAGIC) else 0o644
            tf.addfile(info, io.BytesIO(content))
    return buf.getvalue()
