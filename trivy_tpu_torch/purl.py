"""PackageURL conversion (pkg/purl/).

Copied from `trivy_tpu/purl.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
`OS_PURL_TYPES` is the port's: its SBOM decoders' OS package types.
"""

from __future__ import annotations

from urllib.parse import quote, unquote

# app/pkg type -> purl type
_PURL_TYPES = {
    "npm": "npm",
    "yarn": "npm",
    "pnpm": "npm",
    "pip": "pypi",
    "pipenv": "pypi",
    "poetry": "pypi",
    "gomod": "golang",
    "cargo": "cargo",
    "composer": "composer",
    "bundler": "gem",
    "nuget": "nuget",
    "dotnet-core": "nuget",
    "packages-props": "nuget",
    "julia": "julia",
    "pom": "maven",
    "gradle": "maven",
    "jar": "maven",
    "war": "maven",
    "gobinary": "golang",
    "rustbinary": "cargo",
    "python-pkg": "pypi",
    "node-pkg": "npm",
    "gemspec": "gem",
    "pub": "pub",
    "hex": "hex",
    "conan": "conan",
    "swift": "swift",
    "cocoapods": "cocoapods",
    "conda-pkg": "conda",
    "conda-environment": "conda",
    "apk": "apk",
    "dpkg": "deb",
    "rpm": "rpm",
}

# purl types of OS packages (an SBOM decoder also takes the document's OS
# family, the type the encoders write for OS packages)
OS_PURL_TYPES = frozenset({"apk", "deb", "rpm"})

# purl type -> (app type, version-compare flavor)
PURL_TO_APP = {
    "npm": "npm",
    "pypi": "pip",
    "golang": "gomod",
    "cargo": "cargo",
    "composer": "composer",
    "gem": "bundler",
    "nuget": "nuget",
    "maven": "pom",
    "pub": "pub",
    "hex": "hex",
    "conan": "conan",
    "swift": "swift",
    "cocoapods": "cocoapods",
    "conda": "conda-pkg",
}


def package_url(
    pkg_type: str, name: str, version: str, namespace: str = ""
) -> str:
    ptype = _PURL_TYPES.get(pkg_type, pkg_type)
    if ptype == "maven" and ":" in name and not namespace:
        # Maven package names are group:artifact (purl.go:198-203); the
        # group becomes the purl namespace.
        namespace, _, name = name.rpartition(":")
    if "/" in name and not namespace:
        namespace, _, name = name.rpartition("/")
    parts = ["pkg:" + ptype]
    if namespace:
        parts.append(quote(namespace, safe="/"))
    parts.append(quote(name, safe=""))
    return "/".join(parts) + "@" + quote(version, safe="")


def parse_purl(purl: str) -> tuple[str, str, str]:
    """Returns (purl_type, full_name, version)."""
    if not purl.startswith("pkg:"):
        return "", "", ""
    body = purl[4:].split("?")[0]
    ptype, _, rest = body.partition("/")
    name_part, _, version = rest.rpartition("@")
    if not name_part:
        name_part, version = rest, ""
    name = unquote(name_part)
    if ptype == "maven" and "/" in name:
        # Back to the group:artifact form trivy package names / DB keys use
        # (purl.go:129-137 Package(): maven joins namespace with ':').
        ns, _, base = name.rpartition("/")
        name = f"{ns}:{base}"
    return ptype, name, unquote(version)
