"""Minimal ELF reader for binary dependency analyzers.

Just enough structure for two consumers: section lookup by name (the Rust
cargo-auditable ``.dep-v0`` payload) and virtual-address translation via
PT_LOAD program headers (the Go buildinfo pointer format).  Both 32- and
64-bit, both endiannesses.

Copied from `trivy_tpu/analyzer/elf.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

ELF_MAGIC = b"\x7fELF"


class ElfError(ValueError):
    pass


@dataclass
class Section:
    name: str
    offset: int
    size: int
    addr: int


@dataclass
class Segment:  # PT_LOAD
    vaddr: int
    offset: int
    filesz: int


class ElfFile:
    def __init__(self, data: bytes):
        if len(data) < 64 or not data.startswith(ELF_MAGIC):
            raise ElfError("not an ELF file")
        self.data = data
        ei_class, ei_data = data[4], data[5]
        if ei_class not in (1, 2) or ei_data not in (1, 2):
            raise ElfError("bad ELF ident")
        self.is64 = ei_class == 2
        self.end = "<" if ei_data == 1 else ">"
        if self.is64:
            (
                self.e_phoff,
                self.e_shoff,
            ) = struct.unpack_from(f"{self.end}QQ", data, 0x20)
            self.e_phentsize, self.e_phnum = struct.unpack_from(
                f"{self.end}HH", data, 0x36
            )
            self.e_shentsize, self.e_shnum, self.e_shstrndx = struct.unpack_from(
                f"{self.end}HHH", data, 0x3A
            )
        else:
            (
                self.e_phoff,
                self.e_shoff,
            ) = struct.unpack_from(f"{self.end}II", data, 0x1C)
            self.e_phentsize, self.e_phnum = struct.unpack_from(
                f"{self.end}HH", data, 0x2A
            )
            self.e_shentsize, self.e_shnum, self.e_shstrndx = struct.unpack_from(
                f"{self.end}HHH", data, 0x2E
            )

    def segments(self) -> list[Segment]:
        out = []
        for i in range(self.e_phnum):
            off = self.e_phoff + i * self.e_phentsize
            if off + self.e_phentsize > len(self.data):
                break
            p_type = struct.unpack_from(f"{self.end}I", self.data, off)[0]
            if p_type != 1:  # PT_LOAD
                continue
            if self.is64:
                p_offset, p_vaddr = struct.unpack_from(
                    f"{self.end}QQ", self.data, off + 8
                )
                p_filesz = struct.unpack_from(f"{self.end}Q", self.data, off + 32)[0]
            else:
                p_offset, p_vaddr = struct.unpack_from(
                    f"{self.end}II", self.data, off + 4
                )
                p_filesz = struct.unpack_from(f"{self.end}I", self.data, off + 16)[0]
            out.append(Segment(vaddr=p_vaddr, offset=p_offset, filesz=p_filesz))
        return out

    def sections(self) -> list[Section]:
        secs = []
        raw = []
        for i in range(self.e_shnum):
            off = self.e_shoff + i * self.e_shentsize
            if off + self.e_shentsize > len(self.data):
                break
            sh_name = struct.unpack_from(f"{self.end}I", self.data, off)[0]
            if self.is64:
                sh_addr, sh_offset, sh_size = struct.unpack_from(
                    f"{self.end}QQQ", self.data, off + 0x10
                )
            else:
                sh_addr, sh_offset, sh_size = struct.unpack_from(
                    f"{self.end}III", self.data, off + 0x0C
                )
            raw.append((sh_name, sh_addr, sh_offset, sh_size))
        if not raw or self.e_shstrndx >= len(raw):
            return []
        _, _, str_off, str_size = raw[self.e_shstrndx]
        strtab = self.data[str_off : str_off + str_size]
        for sh_name, sh_addr, sh_offset, sh_size in raw:
            end = strtab.find(b"\x00", sh_name)
            if end < 0:
                continue
            secs.append(
                Section(
                    name=strtab[sh_name:end].decode("latin-1"),
                    offset=sh_offset,
                    size=sh_size,
                    addr=sh_addr,
                )
            )
        return secs

    def section_data(self, name: str) -> bytes | None:
        for s in self.sections():
            if s.name == name:
                return self.data[s.offset : s.offset + s.size]
        return None

    def vaddr_to_offset(self, vaddr: int) -> int | None:
        for seg in self.segments():
            if seg.vaddr <= vaddr < seg.vaddr + seg.filesz:
                return seg.offset + (vaddr - seg.vaddr)
        return None
