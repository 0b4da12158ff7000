"""Binary dependency analyzers: Go buildinfo and Rust cargo-auditable.

Go toolchains stamp module lists into every binary (the public buildinfo
format read by ``debug/buildinfo``); cargo-auditable embeds a
zlib-compressed JSON crate list in a ``.dep-v0`` ELF section.  Reference
behavior: analyzer/language/golang/binary/binary.go and
analyzer/language/rust/binary/binary.go with their parsers
(dependency/parser/golang/binary/parse.go:49-120,
dependency/parser/rust/binary/parse.go:40-70 — runtime-kind crates only).

Both are from-scratch readers over the documented formats — no toolchain
or cgo involvement, so they run anywhere the scanner does.

Copied from `trivy_tpu/analyzer/binary.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import json
import logging
import zlib

from trivy_tpu_torch.analyzer.core import (
    Analyzer,
    AnalysisInput,
    AnalysisResult,
    register_analyzer,
)
from trivy_tpu_torch.analyzer.elf import ELF_MAGIC, ElfError, ElfFile
from trivy_tpu_torch.atypes import Application, Package

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Go buildinfo

_BUILDINFO_MAGIC = b"\xff Go buildinf:"
# The modinfo string is fenced by these 16-byte sentinels (the toolchain's
# runtime/debug modinfo markers).
_INFO_START = bytes.fromhex("3077af0c9274080241e1c107e6d618e6")
_INFO_END = bytes.fromhex("f9324331861820720082521041164164")


def _read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while pos < len(data):
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            break
    raise ValueError("bad uvarint")


def _read_varlen_string(data: bytes, pos: int) -> tuple[bytes, int]:
    n, pos = _read_uvarint(data, pos)
    if pos + n > len(data):
        raise ValueError("truncated string")
    return data[pos : pos + n], pos + n


def _read_go_string_ptr(elf: ElfFile, addr: int, ptr_size: int, big: bool) -> bytes:
    """Pointer-format (pre-go1.18) string: addr -> (data ptr, len) header."""
    off = elf.vaddr_to_offset(addr)
    if off is None or off + 2 * ptr_size > len(elf.data):
        raise ValueError("bad string pointer")
    order = "big" if big else "little"
    data_ptr = int.from_bytes(elf.data[off : off + ptr_size], order)
    length = int.from_bytes(elf.data[off + ptr_size : off + 2 * ptr_size], order)
    doff = elf.vaddr_to_offset(data_ptr)
    if doff is None or length > 1 << 24 or doff + length > len(elf.data):
        raise ValueError("bad string data pointer")
    return elf.data[doff : doff + length]


def read_go_buildinfo(content: bytes) -> tuple[str, str] | None:
    """Locate the buildinfo header; returns (go_version, modinfo) or None.

    Header layout (32 bytes): magic[14], ptrSize, flags.  Flag bit 0x2
    selects the inline format (go1.18+): two varint-prefixed strings at
    offset 32.  Otherwise two ptrSize pointers at offset 16 reference Go
    string headers, reachable only through ELF PT_LOAD translation.
    """
    pos = content.find(_BUILDINFO_MAGIC)
    if pos < 0 or pos + 32 > len(content):
        return None
    ptr_size = content[pos + 14]
    flags = content[pos + 15]
    try:
        if flags & 0x2:  # inline strings
            go_version, p = _read_varlen_string(content, pos + 32)
            modinfo, _ = _read_varlen_string(content, p)
        else:
            if not content.startswith(ELF_MAGIC) or ptr_size not in (4, 8):
                return None  # pointer format only implemented for ELF
            big = bool(flags & 0x1)
            order = "big" if big else "little"
            elf = ElfFile(content)
            a1 = int.from_bytes(content[pos + 16 : pos + 16 + ptr_size], order)
            a2 = int.from_bytes(
                content[pos + 16 + ptr_size : pos + 16 + 2 * ptr_size], order
            )
            go_version = _read_go_string_ptr(elf, a1, ptr_size, big)
            modinfo = _read_go_string_ptr(elf, a2, ptr_size, big)
    except (ValueError, ElfError):
        return None
    # Sentinel stripping happens on bytes: the markers are not valid UTF-8.
    if len(modinfo) >= 32 and modinfo[:16] == _INFO_START:
        modinfo = modinfo[16:-16]
    return (
        go_version.decode("utf-8", "replace"),
        modinfo.decode("utf-8", "replace"),
    )


def parse_go_modinfo(go_version: str, modinfo: str) -> list[Package]:
    """Module lines -> packages (parse.go:49-120 semantics): the main
    module (skipping the unstamped ``(devel)`` pseudo-version), a ``stdlib``
    package carrying the toolchain version, deps, and ``=>`` replacements
    overriding the preceding dep."""
    pkgs: list[Package] = []
    if go_version:
        v = go_version.removeprefix("go")
        pkgs.append(Package(id=f"stdlib@{v}", name="stdlib", version=v))
    last_dep: Package | None = None
    for line in modinfo.split("\n"):
        parts = line.split("\t")
        if len(parts) >= 3 and parts[0] == "mod":
            version = parts[2]
            if version == "(devel)":
                # Stamped -ldflags versions are not recoverable without
                # symbol analysis; report the module without a version the
                # way the reference falls back (parse.go:63-68).
                version = ""
            pkgs.append(
                Package(
                    id=f"{parts[1]}@{version}" if version else parts[1],
                    name=parts[1],
                    version=version,
                )
            )
        elif len(parts) >= 3 and parts[0] == "dep":
            if not parts[1] or parts[2] == "Devel":
                continue  # old-toolchain artifacts (parse.go:79-84)
            last_dep = Package(
                id=f"{parts[1]}@{parts[2]}", name=parts[1], version=parts[2]
            )
            pkgs.append(last_dep)
        elif len(parts) >= 3 and parts[0] == "=>" and last_dep is not None:
            last_dep.name = parts[1]
            last_dep.version = parts[2]
            last_dep.id = f"{parts[1]}@{parts[2]}"
    return [p for p in pkgs if p.name]


class GoBinaryAnalyzer(Analyzer):
    """analyzer/language/golang/binary/binary.go: executables only."""

    def version(self) -> int:
        return 1

    def type(self) -> str:
        return "gobinary"

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return bool(mode & 0o111) and size > 0

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        info = read_go_buildinfo(inp.content)
        if info is None:
            return None
        pkgs = parse_go_modinfo(*info)
        if not pkgs:
            return None
        result = AnalysisResult()
        result.applications.append(
            Application(
                app_type="gobinary", file_path=inp.file_path, packages=pkgs
            )
        )
        return result


# ---------------------------------------------------------------------------
# Rust cargo-auditable

_DEP_SECTION = ".dep-v0"


def read_rust_audit(content: bytes) -> list[Package] | None:
    """cargo-auditable payload: zlib JSON in the ``.dep-v0`` ELF section.

    Only runtime-kind crates are reported (parse.go:52-54); build/dev
    dependencies never ship in the binary's attack surface.
    """
    if not content.startswith(ELF_MAGIC):
        return None
    try:
        raw = ElfFile(content).section_data(_DEP_SECTION)
    except ElfError:
        return None
    if not raw:
        return None
    try:
        doc = json.loads(zlib.decompress(raw))
    except (zlib.error, ValueError):
        logger.debug("undecodable .dep-v0 payload")
        return None
    pkgs = []
    for p in doc.get("packages") or []:
        if p.get("kind", "runtime") != "runtime":
            continue
        name, version = p.get("name", ""), p.get("version", "")
        if not name or not version:
            continue
        pkgs.append(Package(id=f"{name}@{version}", name=name, version=version))
    return pkgs or None


class RustBinaryAnalyzer(Analyzer):
    """analyzer/language/rust/binary/binary.go."""

    def version(self) -> int:
        return 1

    def type(self) -> str:
        return "rustbinary"

    def required(self, file_path: str, size: int, mode: int) -> bool:
        return bool(mode & 0o111) and size > 0

    def analyze(self, inp: AnalysisInput) -> AnalysisResult | None:
        pkgs = read_rust_audit(inp.content)
        if pkgs is None:
            return None
        result = AnalysisResult()
        result.applications.append(
            Application(
                app_type="rustbinary", file_path=inp.file_path, packages=pkgs
            )
        )
        return result


register_analyzer(GoBinaryAnalyzer)
register_analyzer(RustBinaryAnalyzer)
