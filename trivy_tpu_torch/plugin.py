"""Subprocess plugins (pkg/plugin/plugin.go).

A plugin is a directory holding plugin.yaml (name/version/usage/platforms)
plus executables; `trivy-tpu plugin install <src>` copies it under
~/.trivy-tpu/plugins/<name>, and `trivy-tpu <name> [args...]` (or
`plugin run`) executes the platform-matching binary as a subprocess —
unknown top-level commands fall through to installed plugins exactly like
the reference's cobra tree (app.go loadPluginCommands).

Install sources: a local directory, a local .tar.gz, or an http(s) URL to
a tarball (the reference uses go-getter; git sources are out of scope
here).  Platform selection follows plugin.go:136: first platform whose
selector (os/arch, empty = wildcard) matches the host.

Copied from `trivy_tpu/plugin.py`; the port imports nothing from the JAX
package.  Plugins live in `TRIVY_TPU_PLUGIN_DIR`, else
`~/.trivy-tpu/plugins`, the reference's directory, so either CLI runs the
plugins the other installed.
"""

from __future__ import annotations

import os
import platform as _platform
import shutil
import stat
import subprocess
import sys
import tarfile
import tempfile
from dataclasses import dataclass, field

import yaml

CONFIG_FILE = "plugin.yaml"

# Plugin names become path components under the plugins dir; anything else
# (separators, dot-dot, hidden names) is a path-traversal attempt from an
# attacker-controlled plugin.yaml.
_NAME_RE = __import__("re").compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


class PluginError(RuntimeError):
    pass


def _validate_name(name: str) -> str:
    if not _NAME_RE.fullmatch(name) or ".." in name:
        raise PluginError(f"invalid plugin name {name!r}")
    return name


def plugins_dir() -> str:
    return os.environ.get(
        "TRIVY_TPU_PLUGIN_DIR",
        os.path.join(os.path.expanduser("~"), ".trivy-tpu", "plugins"),
    )


@dataclass
class Platform:
    os: str = ""
    arch: str = ""
    uri: str = ""
    bin: str = ""


@dataclass
class Plugin:
    name: str
    version: str = ""
    usage: str = ""
    description: str = ""
    repository: str = ""
    platforms: list[Platform] = field(default_factory=list)
    dir: str = ""

    @classmethod
    def load(cls, plugin_dir: str) -> "Plugin":
        path = os.path.join(plugin_dir, CONFIG_FILE)
        try:
            with open(path, encoding="utf-8") as f:
                doc = yaml.safe_load(f) or {}
        except (OSError, yaml.YAMLError) as e:
            raise PluginError(f"cannot load {path}: {e}") from e
        platforms = []
        for p in doc.get("platforms") or []:
            sel = p.get("selector") or {}
            platforms.append(
                Platform(
                    os=sel.get("os", ""),
                    arch=sel.get("arch", ""),
                    uri=p.get("uri", ""),
                    bin=p.get("bin", ""),
                )
            )
        name = doc.get("name", "")
        if not name:
            raise PluginError(f"{path}: plugin has no name")
        _validate_name(name)
        return cls(
            name=name,
            version=str(doc.get("version", "")),
            usage=doc.get("usage", ""),
            description=doc.get("description", ""),
            repository=doc.get("repository", ""),
            platforms=platforms,
            dir=plugin_dir,
        )

    def select_platform(self) -> Platform:
        """plugin.go:136 — first matching selector; empty fields wildcard."""
        host_os = {"linux": "linux", "darwin": "darwin", "win32": "windows"}.get(
            sys.platform, sys.platform
        )
        machine = _platform.machine().lower()
        host_arch = {
            "x86_64": "amd64", "aarch64": "arm64", "arm64": "arm64",
        }.get(machine, machine)
        for p in self.platforms:
            if (not p.os or p.os == host_os) and (
                not p.arch or p.arch == host_arch
            ):
                return p
        raise PluginError(
            f"plugin {self.name!r} supports no platform matching "
            f"{host_os}/{host_arch}"
        )

    def run(self, args: list[str]) -> int:
        p = self.select_platform()
        if not p.bin:
            raise PluginError(f"plugin {self.name!r} declares no binary")
        bin_path = os.path.join(self.dir, p.bin)
        if not os.path.exists(bin_path):
            raise PluginError(f"plugin binary not found: {bin_path}")
        mode = os.stat(bin_path).st_mode
        if not mode & stat.S_IXUSR:
            os.chmod(bin_path, mode | stat.S_IXUSR)
        proc = subprocess.run([bin_path, *args])
        return proc.returncode


def _extract_tar(src, dest: str) -> None:
    try:
        with tarfile.open(fileobj=src, mode="r:*") as tf:
            for member in tf.getmembers():
                parts = member.name.split("/")
                if ".." in parts or member.name.startswith("/"):
                    continue  # path traversal; names merely containing '..' pass
                try:
                    tf.extract(member, dest, filter="data")
                except TypeError:  # Python < 3.10.12: no extraction filters
                    if member.issym() or member.islnk() or member.isdev():
                        continue
                    tf.extract(member, dest)
    except tarfile.TarError as e:
        raise PluginError(f"invalid plugin archive: {e}") from e


def install(src: str) -> Plugin:
    """plugin install <dir|tar.gz|url>; returns the installed plugin."""
    with tempfile.TemporaryDirectory(prefix="trivy-tpu-plugin-") as tmp:
        if os.path.isdir(src):
            stage = src
        elif os.path.isfile(src):
            with open(src, "rb") as f:
                _extract_tar(f, tmp)
            stage = tmp
        elif src.startswith(("http://", "https://")):
            import io
            import urllib.error
            import urllib.request

            try:
                with urllib.request.urlopen(src, timeout=120) as resp:
                    buf = io.BytesIO(resp.read())
            except urllib.error.URLError as e:
                raise PluginError(f"cannot download plugin {src!r}: {e}") from e
            _extract_tar(buf, tmp)
            stage = tmp
        else:
            raise PluginError(
                f"unsupported plugin source {src!r} (dir, .tar.gz, or URL)"
            )
        # plugin.yaml may sit at the top level or one directory down
        cfg_dir = stage
        if not os.path.exists(os.path.join(cfg_dir, CONFIG_FILE)):
            subdirs = [
                d
                for d in os.listdir(stage)
                if os.path.isdir(os.path.join(stage, d))
            ]
            for d in subdirs:
                if os.path.exists(os.path.join(stage, d, CONFIG_FILE)):
                    cfg_dir = os.path.join(stage, d)
                    break
            else:
                raise PluginError(f"no {CONFIG_FILE} found in {src!r}")
        plugin = Plugin.load(cfg_dir)  # load() validates the name
        dest = os.path.join(plugins_dir(), plugin.name)
        if os.path.realpath(dest) == os.path.realpath(cfg_dir):
            return plugin  # reinstalling from the installed dir: no-op
        if os.path.exists(dest):
            shutil.rmtree(dest)
        shutil.copytree(cfg_dir, dest)
        return Plugin.load(dest)


def uninstall(name: str) -> None:
    _validate_name(name)
    dest = os.path.join(plugins_dir(), name)
    if not os.path.isdir(dest):
        raise PluginError(f"plugin {name!r} is not installed")
    shutil.rmtree(dest)


def list_plugins() -> list[Plugin]:
    base = plugins_dir()
    if not os.path.isdir(base):
        return []
    out = []
    for name in sorted(os.listdir(base)):
        d = os.path.join(base, name)
        if os.path.isfile(os.path.join(d, CONFIG_FILE)):
            try:
                out.append(Plugin.load(d))
            except PluginError:
                continue
    return out


def find(name: str) -> Plugin | None:
    try:
        _validate_name(name)
    except PluginError:
        return None
    d = os.path.join(plugins_dir(), name)
    if os.path.isfile(os.path.join(d, CONFIG_FILE)):
        return Plugin.load(d)
    return None
