"""Additional report writers: template, github dependency snapshot,
cosign-vuln predicate (pkg/report/{template.go,github/github.go,predicate}).

Copied from `trivy_tpu/report/extra.py`; the port imports nothing from the
JAX package, so it keeps its own copy of this jax-free module (with the
`os` import that `resolve_template` needs).
"""

from __future__ import annotations

import json
import os
import re
from typing import IO, Any

from trivy_tpu_torch import __version__
from trivy_tpu_torch.ftypes import Report
from trivy_tpu_torch.purl import package_url


def write_template(report: Report, template: str, out: IO[str]) -> None:
    """`--format template --template <tpl>`.

    The reference evaluates Go text/template; here the template language is a
    minimal mustache subset over the report JSON: `{{ .Path.Like.This }}`
    dotted lookups and `{{ range .Results }}...{{ end }}` loops.  `@file`
    template references are resolved by the CLI before calling this.
    """
    data = report.to_json()
    out.write(_render(template, data))


_TOKEN = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}")


class TemplateError(ValueError):
    pass


def resolve_template(template: str) -> str:
    """Shared --template handling: `@/path` loads the file (errors early)."""
    if template.startswith("@"):
        path = template[1:]
        if not os.path.exists(path):
            raise TemplateError(f"template file not found: {path}")
        with open(path, encoding="utf-8") as f:
            return f.read()
    return template


def _lookup(data: Any, path: str) -> Any:
    if path in (".", ""):
        return data
    cur = data
    for part in path.lstrip(".").split("."):
        if isinstance(cur, dict):
            cur = cur.get(part, "")
        else:
            cur = getattr(cur, part, "")
    return cur


def _tokenize(template: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    trim_next = False
    for m in _TOKEN.finditer(template):
        if m.start() > pos:
            text = template[pos : m.start()]
            if trim_next:
                text = text.lstrip()
            if m.group(1):  # {{- left trim marker
                text = text.rstrip()
            if text:
                tokens.append(("text", text))
        tokens.append(("expr", m.group(2)))
        trim_next = bool(m.group(3))  # -}} right trim marker
        pos = m.end()
    if pos < len(template):
        text = template[pos:]
        if trim_next:
            text = text.lstrip()
        if text:
            tokens.append(("text", text))
    return tokens


_BLOCK_KEYWORDS = ("range ", "if ", "with ")


def _build(tokens: list[tuple[str, str]], i: int) -> tuple[list, int]:
    """AST nodes: ('text', s) | ('var', path) |
    ('range'|'if'|'with', path, children, else_children)."""
    nodes: list = []
    while i < len(tokens):
        kind, val = tokens[i]
        if kind == "text":
            nodes.append(("text", val))
            i += 1
        elif val in ("end", "else"):
            return nodes, i
        elif val.startswith(_BLOCK_KEYWORDS):
            keyword, _, path = val.partition(" ")
            children, i = _build(tokens, i + 1)
            else_children: list = []
            if i < len(tokens) and tokens[i] == ("expr", "else"):
                else_children, i = _build(tokens, i + 1)
            if i < len(tokens) and tokens[i] == ("expr", "end"):
                i += 1
            nodes.append((keyword, path.strip(), children, else_children))
        else:
            nodes.append(("var", val))
            i += 1
    return nodes, i


def _eval(nodes: list, data: Any) -> str:
    out: list[str] = []
    for node in nodes:
        if node[0] == "text":
            out.append(node[1])
        elif node[0] == "var":
            value = _lookup(data, node[1])
            out.append(
                json.dumps(value) if isinstance(value, (dict, list)) else str(value)
            )
        elif node[0] == "range":
            items = _lookup(data, node[1]) or []
            if items:
                out.extend(_eval(node[2], item) for item in items)
            else:
                out.append(_eval(node[3], data))
        elif node[0] == "if":
            value = _lookup(data, node[1])
            out.append(_eval(node[2], data) if value else _eval(node[3], data))
        elif node[0] == "with":
            value = _lookup(data, node[1])
            out.append(_eval(node[2], value) if value else _eval(node[3], data))
    return "".join(out)


def _render(template: str, data: Any) -> str:
    tokens = _tokenize(template)
    nodes, consumed = _build(tokens, 0)
    if consumed != len(tokens):
        kind, val = tokens[consumed]
        raise TemplateError(f"unexpected {{{{ {val} }}}} outside a block")
    return _eval(nodes, data)


def write_github(report: Report, out: IO[str]) -> None:
    """GitHub dependency snapshot (pkg/report/github/github.go)."""
    manifests: dict[str, Any] = {}
    for result in report.results:
        if not result.packages:
            continue
        resolved = {}
        for pkg in result.packages:
            purl = package_url(result.result_type, pkg.name, pkg.version)
            resolved[pkg.name] = {
                "package_url": purl,
                "relationship": "indirect" if pkg.indirect else "direct",
                "scope": "development" if pkg.dev else "runtime",
            }
        manifests[result.target] = {
            "name": result.result_type,
            "file": {"source_location": result.target},
            "resolved": resolved,
        }
    snapshot = {
        "version": 0,
        "detector": {
            "name": "trivy-tpu",
            "version": __version__,
            "url": "https://github.com/trivy-tpu",
        },
        "metadata": {
            "aquasecurity:trivy:RepoTag": ",".join(
                report.metadata.repo_tags
            ),
        },
        "scanned": report.created_at or "1970-01-01T00:00:00Z",
        "manifests": manifests,
    }
    json.dump(snapshot, out, indent=2)
    out.write("\n")


def write_cosign_vuln(report: Report, out: IO[str]) -> None:
    """Cosign vulnerability attestation predicate (pkg/report/predicate)."""
    results = [r.to_json() for r in report.results]
    predicate = {
        "invocation": {
            "parameters": None,
            "uri": "",
            "event_id": "",
            "builder.id": "",
        },
        "scanner": {
            "uri": f"pkg:github/trivy-tpu@{__version__}",
            "version": __version__,
            "result": {
                "SchemaVersion": report.schema_version,
                "ArtifactName": report.artifact_name,
                "ArtifactType": report.artifact_type.value,
                "Results": results,
            },
        },
        "metadata": {
            "scanStartedOn": report.created_at or "1970-01-01T00:00:00Z",
            "scanFinishedOn": report.created_at or "1970-01-01T00:00:00Z",
        },
    }
    json.dump(predicate, out, indent=2)
    out.write("\n")
