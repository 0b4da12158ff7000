"""Helm chart rendering for misconfiguration scanning.

The reference renders charts with the embedded helm engine
(pkg/iac/scanners/helm/parser/parser.go) and feeds the manifests to the
kubernetes checks.  This is a from-scratch Go-template-subset renderer —
a documented divergence: it covers the template constructs that appear
in common charts (actions, pipelines, if/with/range/define/include,
sprig string helpers, toYaml/nindent, variables) and skips a file it
cannot render rather than failing the chart.

Release context mirrors the reference's defaults (parser.go:190-204: the
chart directory name seeds the release name).

Copied from `trivy_tpu/iac/helm.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import json
import logging
import posixpath
import re
from dataclasses import dataclass, field
from typing import Any, Callable

import yaml

logger = logging.getLogger(__name__)


class HelmError(ValueError):
    pass


# ---------------------------------------------------------------------------
# template tokenizer / parser


@dataclass
class _Text:
    s: str


@dataclass
class _Action:
    code: str


@dataclass
class _If:
    arms: list[tuple[str | None, list]]  # (cond | None for else, body)


@dataclass
class _With:
    expr: str
    body: list
    else_body: list = field(default_factory=list)


@dataclass
class _Range:
    expr: str
    body: list
    else_body: list = field(default_factory=list)
    key_var: str = ""
    val_var: str = ""


@dataclass
class _Define:
    name: str
    body: list


_TOKEN_RE = re.compile(r"\{\{-?.*?-?\}\}", re.S)


def _tokenize(src: str) -> list:
    """Split template source into text and action tokens, applying the
    {{- / -}} whitespace-trim markers to neighboring text."""
    out: list = []
    pos = 0
    for m in _TOKEN_RE.finditer(src):
        text = src[pos : m.start()]
        action = m.group(0)
        trim_l = action.startswith("{{-")
        trim_r = action.endswith("-}}")
        code = action[3 if trim_l else 2 : -3 if trim_r else -2].strip()
        if trim_l:
            text = text.rstrip()
        if out and isinstance(out[-1], str) and out[-1] == "\0TRIM":
            out.pop()
            text = text.lstrip()
        out.append(_Text(text))
        if not code.startswith("/*"):
            out.append(_Action(code))
        if trim_r:
            out.append("\0TRIM")
        pos = m.end()
    tail = src[pos:]
    if out and isinstance(out[-1], str) and out[-1] == "\0TRIM":
        out.pop()
        tail = tail.lstrip()
    out.append(_Text(tail))
    return [t for t in out if not isinstance(t, str)]


_RANGE_VARS = re.compile(
    r"^(?:(\$[\w]*)\s*(?:,\s*(\$[\w]*)\s*)?:=\s*)?(.*)$", re.S
)


def _parse(tokens: list, i: int = 0, in_block: bool = False) -> tuple[list, int]:
    nodes: list = []
    while i < len(tokens):
        tok = tokens[i]
        if isinstance(tok, _Text):
            nodes.append(tok)
            i += 1
            continue
        code = tok.code
        word = code.split(None, 1)[0] if code else ""
        if word in ("end", "else"):
            if not in_block:
                raise HelmError(f"unexpected {{{{ {word} }}}}")
            return nodes, i
        if word == "if":
            arms: list[tuple[str | None, list]] = []
            cond = code[2:].strip()
            while True:
                body, i = _parse(tokens, i + 1, True)
                arms.append((cond, body))
                nxt = tokens[i].code
                if nxt == "end":
                    break
                if nxt.startswith("else if"):
                    cond = nxt[len("else if") :].strip()
                    continue
                if nxt == "else":
                    body, i = _parse(tokens, i + 1, True)
                    arms.append((None, body))
                    if tokens[i].code != "end":
                        raise HelmError("expected {{ end }}")
                    break
            nodes.append(_If(arms))
            i += 1
        elif word == "with":
            body, i = _parse(tokens, i + 1, True)
            node = _With(code[4:].strip(), body)
            if tokens[i].code == "else":
                node.else_body, i = _parse(tokens, i + 1, True)
            if tokens[i].code != "end":
                raise HelmError("expected {{ end }}")
            nodes.append(node)
            i += 1
        elif word == "range":
            m = _RANGE_VARS.match(code[5:].strip())
            body, i = _parse(tokens, i + 1, True)
            node = _Range(
                m.group(3).strip(),
                body,
                key_var=m.group(1) or "",
                val_var=m.group(2) or "",
            )
            if tokens[i].code == "else":
                node.else_body, i = _parse(tokens, i + 1, True)
            if tokens[i].code != "end":
                raise HelmError("expected {{ end }}")
            nodes.append(node)
            i += 1
        elif word == "define":
            name = code[6:].strip().strip('"')
            body, i = _parse(tokens, i + 1, True)
            if tokens[i].code != "end":
                raise HelmError("expected {{ end }}")
            nodes.append(_Define(name, body))
            i += 1
        else:
            nodes.append(_Action(code))
            i += 1
    if in_block:
        raise HelmError("missing {{ end }}")
    return nodes, i


# ---------------------------------------------------------------------------
# expression evaluation


_EXPR_TOKEN = re.compile(
    r"""
    "(?:[^"\\]|\\.)*"        # double-quoted string
  | `[^`]*`                  # raw string
  | -?\d+\.\d+ | -?\d+       # numbers
  | \$[\w]*(?:\.[\w-]+)*     # $var[.path]
  | \.[\w-]*(?:\.[\w-]+)*    # .dotted.path (or lone .)
  | [A-Za-z_][\w]*           # identifier
  | \| | \( | \) | :=
    """,
    re.X,
)


def _truthy(v: Any) -> bool:
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v != 0
    if isinstance(v, (str, list, dict)):
        return len(v) > 0
    return True


def _to_yaml(v: Any) -> str:
    return yaml.safe_dump(v, default_flow_style=False, sort_keys=False).rstrip(
        "\n"
    )


def _go_str(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


class _Renderer:
    def __init__(self, root_ctx: dict, defines: dict[str, list]):
        self.root = root_ctx
        self.defines = defines
        self.funcs: dict[str, Callable] = self._build_funcs()

    # -- functions ---------------------------------------------------------

    def _build_funcs(self) -> dict[str, Callable]:
        def default(d, v=None):
            # helm: `default d v` — v when set, else d.  Single-arg form
            # means the piped value was absent entirely.
            return v if _truthy(v) else d

        def indent(n, s):
            pad = " " * int(n)
            return "\n".join(pad + line for line in _go_str(s).split("\n"))

        funcs: dict[str, Callable] = {
            "default": default,
            "quote": lambda *a: '"' + _go_str(a[-1]).replace('"', '\\"') + '"',
            "squote": lambda *a: "'" + _go_str(a[-1]) + "'",
            "upper": lambda s: _go_str(s).upper(),
            "lower": lambda s: _go_str(s).lower(),
            "title": lambda s: _go_str(s).title(),
            "trim": lambda s: _go_str(s).strip(),
            "trimSuffix": lambda suf, s: _go_str(s).removesuffix(_go_str(suf)),
            "trimPrefix": lambda pre, s: _go_str(s).removeprefix(_go_str(pre)),
            "trunc": lambda n, s: _go_str(s)[: int(n)]
            if int(n) >= 0
            else _go_str(s)[int(n) :],
            "replace": lambda old, new, s: _go_str(s).replace(
                _go_str(old), _go_str(new)
            ),
            "contains": lambda sub, s: _go_str(sub) in _go_str(s),
            "hasPrefix": lambda pre, s: _go_str(s).startswith(_go_str(pre)),
            "hasSuffix": lambda suf, s: _go_str(s).endswith(_go_str(suf)),
            "indent": indent,
            "nindent": lambda n, s: "\n" + indent(n, s),
            "toYaml": _to_yaml,
            "toJson": lambda v: json.dumps(v),
            "fromYaml": lambda s: yaml.safe_load(_go_str(s)) or {},
            "printf": lambda fmt, *a: _go_printf(fmt, a),
            "print": lambda *a: "".join(_go_str(x) for x in a),
            "required": lambda msg, v: v,
            "coalesce": lambda *a: next((x for x in a if _truthy(x)), None),
            "ternary": lambda t, f, c: t if _truthy(c) else f,
            "empty": lambda v: not _truthy(v),
            "not": lambda v: not _truthy(v),
            "and": lambda *a: next((x for x in a if not _truthy(x)), a[-1]),
            "or": lambda *a: next((x for x in a if _truthy(x)), a[-1]),
            "eq": lambda a, *b: all(a == x for x in b),
            "ne": lambda a, b: a != b,
            "lt": lambda a, b: a < b,
            "le": lambda a, b: a <= b,
            "gt": lambda a, b: a > b,
            "ge": lambda a, b: a >= b,
            "len": lambda v: len(v) if hasattr(v, "__len__") else 0,
            "add": lambda *a: sum(int(x) for x in a),
            "sub": lambda a, b: int(a) - int(b),
            "int": lambda v: int(float(v)) if v not in (None, "") else 0,
            "toString": _go_str,
            "b64enc": lambda s: __import__("base64")
            .b64encode(_go_str(s).encode())
            .decode(),
            "b64dec": lambda s: __import__("base64")
            .b64decode(_go_str(s))
            .decode("utf-8", "replace"),
            "list": lambda *a: list(a),
            "dict": lambda *a: {
                _go_str(a[i]): a[i + 1] for i in range(0, len(a) - 1, 2)
            },
            "get": lambda d, k: (d or {}).get(_go_str(k), ""),
            "hasKey": lambda d, k: _go_str(k) in (d or {}),
            "keys": lambda d: sorted((d or {}).keys()),
            "kindIs": lambda kind, v: _go_kind(v) == _go_str(kind),
            "semverCompare": lambda *a: True,  # capability probes pass
            "lookup": lambda *a: {},  # no live cluster at scan time
            "include": self._include,
            "template": self._include,
            "tpl": self._tpl,
            "fail": lambda msg: (_ for _ in ()).throw(HelmError(_go_str(msg))),
        }
        return funcs

    def _include(self, name, ctx=None):
        body = self.defines.get(_go_str(name))
        if body is None:
            raise HelmError(f"include of undefined template {name!r}")
        return self.render(body, ctx if ctx is not None else self.root, {})

    def _tpl(self, src, ctx=None):
        tokens = _tokenize(_go_str(src))
        nodes, _ = _parse(tokens)
        return self.render(nodes, ctx if ctx is not None else self.root, {})

    # -- expression evaluation --------------------------------------------

    def _resolve_path(self, path: str, dot: Any, variables: dict) -> Any:
        if path.startswith("$"):
            head, _, rest = path.partition(".")
            base = self.root if head == "$" else variables.get(head)
            cur = base
        else:
            cur = dot
            rest = path[1:]
        for part in [p for p in rest.split(".") if p]:
            if isinstance(cur, dict):
                cur = cur.get(part)
            else:
                cur = getattr(cur, part, None)
        return cur

    def _eval_tokens(
        self, tokens: list[str], dot: Any, variables: dict
    ) -> Any:
        # pipeline: call (| call)*
        calls: list[list[str]] = [[]]
        depth = 0
        groups: list[Any] = []
        i = 0
        while i < len(tokens):
            t = tokens[i]
            if t == "(":
                # find matching paren, eval inner as a sub-pipeline
                depth, j = 1, i + 1
                while j < len(tokens) and depth:
                    if tokens[j] == "(":
                        depth += 1
                    elif tokens[j] == ")":
                        depth -= 1
                    j += 1
                inner = self._eval_tokens(tokens[i + 1 : j - 1], dot, variables)
                groups.append(inner)
                calls[-1].append(f"\0group{len(groups) - 1}")
                i = j
                continue
            if t == "|":
                calls.append([])
            else:
                calls[-1].append(t)
            i += 1

        def atom(tok: str) -> Any:
            if tok.startswith("\0group"):
                return groups[int(tok[6:])]
            if tok.startswith('"'):
                return json.loads(tok)
            if tok.startswith("`"):
                return tok[1:-1]
            if re.fullmatch(r"-?\d+", tok):
                return int(tok)
            if re.fullmatch(r"-?\d+\.\d+", tok):
                return float(tok)
            if tok == "true":
                return True
            if tok == "false":
                return False
            if tok in ("nil", "null"):
                return None
            if tok.startswith(("$", ".")):
                return self._resolve_path(tok, dot, variables)
            if tok in self.funcs:
                return self.funcs[tok]
            raise HelmError(f"unknown identifier {tok!r}")

        value: Any = None
        for idx, call in enumerate(calls):
            if not call:
                raise HelmError("empty pipeline stage")
            head = atom(call[0])
            args = [atom(t) for t in call[1:]]
            if idx > 0:
                args.append(value)  # piped value is the last argument
            if callable(head):
                value = head(*args)
            elif args:
                raise HelmError(f"cannot call non-function {call[0]!r}")
            else:
                value = head
        return value

    def eval_expr(self, code: str, dot: Any, variables: dict) -> Any:
        tokens = [m.group(0) for m in _EXPR_TOKEN.finditer(code)]
        if not tokens:
            return None
        return self._eval_tokens(tokens, dot, variables)

    # -- rendering ---------------------------------------------------------

    def render(self, nodes: list, dot: Any, variables: dict) -> str:
        out: list[str] = []
        for node in nodes:
            if isinstance(node, _Text):
                out.append(node.s)
            elif isinstance(node, _Define):
                self.defines[node.name] = node.body
            elif isinstance(node, _Action):
                m = re.match(r"^(\$[\w]+)\s*:?=\s*(.*)$", node.code, re.S)
                if m:
                    variables[m.group(1)] = self.eval_expr(
                        m.group(2), dot, variables
                    )
                    continue
                v = self.eval_expr(node.code, dot, variables)
                if v is not None:
                    out.append(_go_str(v))
            elif isinstance(node, _If):
                for cond, body in node.arms:
                    if cond is None or _truthy(
                        self.eval_expr(cond, dot, variables)
                    ):
                        out.append(self.render(body, dot, dict(variables)))
                        break
            elif isinstance(node, _With):
                v = self.eval_expr(node.expr, dot, variables)
                if _truthy(v):
                    out.append(self.render(node.body, v, dict(variables)))
                else:
                    out.append(
                        self.render(node.else_body, dot, dict(variables))
                    )
            elif isinstance(node, _Range):
                v = self.eval_expr(node.expr, dot, variables)
                items: list[tuple[Any, Any]]
                if isinstance(v, dict):
                    items = sorted(
                        (k, val)
                        for k, val in v.items()
                        if not str(k).startswith("__")
                    )
                elif isinstance(v, list):
                    items = list(enumerate(v))
                else:
                    items = []
                if not items:
                    out.append(
                        self.render(node.else_body, dot, dict(variables))
                    )
                for k, val in items:
                    scope = dict(variables)
                    if node.key_var and not node.val_var:
                        scope[node.key_var] = val  # single var binds values
                    elif node.key_var:
                        scope[node.key_var] = k
                    if node.val_var:
                        scope[node.val_var] = val
                    out.append(self.render(node.body, val, scope))
        return "".join(out)


def _go_kind(v: Any) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float64"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "slice"
    if isinstance(v, dict):
        return "map"
    return "invalid"


def _go_printf(fmt: str, args: tuple) -> str:
    out = []
    i = ai = 0
    while i < len(fmt):
        c = fmt[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        spec = fmt[i + 1] if i + 1 < len(fmt) else ""
        if spec == "%":
            out.append("%")
        elif ai < len(args):
            v = args[ai]
            ai += 1
            out.append(json.dumps(_go_str(v)) if spec == "q" else _go_str(v))
        i += 2
    return "".join(out)


# ---------------------------------------------------------------------------
# chart model


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def render_chart(
    files: dict[str, bytes],
    chart_root: str = "",
    values_override: dict | None = None,
) -> dict[str, str]:
    """Render a chart's templates.  `files` maps chart-relative paths
    (Chart.yaml, values.yaml, templates/...) to contents.  Returns
    {template path: rendered manifest text}; files that fail to render are
    skipped with a warning (the subset renderer's fail-soft contract)."""
    try:
        chart = yaml.safe_load(files.get("Chart.yaml", b"")) or {}
    except yaml.YAMLError as e:
        raise HelmError(f"bad Chart.yaml: {e}") from e
    try:
        values = yaml.safe_load(files.get("values.yaml", b"")) or {}
    except yaml.YAMLError:
        values = {}
    if values_override:
        values = _deep_merge(values, values_override)

    release_name = (
        posixpath.basename(chart_root.rstrip("/"))
        or chart.get("name")
        or "release-name"
    )
    # Helm exposes Chart.yaml fields capitalized (.Chart.AppVersion for
    # appVersion); keep the raw keys too for charts that use them.
    chart_ctx = {**chart}
    for k, v in chart.items():
        chart_ctx[k[:1].upper() + k[1:]] = v
    root_ctx = {
        "Values": values,
        "Chart": chart_ctx,
        "Release": {
            "Name": release_name,
            "Namespace": "default",
            "Service": "Helm",
            "IsInstall": True,
            "IsUpgrade": False,
        },
        "Capabilities": {
            "KubeVersion": {
                "Version": "v1.28.0",
                "Major": "1",
                "Minor": "28",
            },
            "APIVersions": _APIVersions(),
        },
        "Template": {"Name": "", "BasePath": "templates"},
    }

    defines: dict[str, list] = {}
    renderer = _Renderer(root_ctx, defines)

    template_files = sorted(
        p
        for p in files
        if p.startswith("templates/")
        and p.endswith((".yaml", ".yml", ".tpl", ".txt"))
    )
    # First pass: collect defines from helpers (render .tpl files first so
    # named templates exist before manifests include them).
    parsed: dict[str, list] = {}
    for path in template_files:
        try:
            nodes, _ = _parse(
                _tokenize(files[path].decode("utf-8", "replace"))
            )
            parsed[path] = nodes
        except HelmError as e:
            logger.warning("helm: cannot parse %s: %s", path, e)
    for path, nodes in parsed.items():
        if path.endswith(".tpl"):
            try:
                renderer.render(nodes, root_ctx, {})
            except HelmError as e:
                logger.warning("helm: helpers %s failed: %s", path, e)

    out: dict[str, str] = {}
    for path, nodes in parsed.items():
        if path.endswith((".tpl", ".txt")):
            continue
        root_ctx["Template"]["Name"] = f"{chart.get('name', '')}/{path}"
        try:
            text = renderer.render(nodes, root_ctx, {})
        except (HelmError, TypeError, ValueError, KeyError) as e:
            logger.warning("helm: cannot render %s: %s", path, e)
            continue
        if text.strip():
            out[path] = text
    return out


class _APIVersions:
    """.Capabilities.APIVersions — Has() is optimistic at scan time."""

    def Has(self, _v: str = "") -> bool:  # noqa: N802 (Go method name)
        return True


def find_charts(paths: list[str]) -> dict[str, list[str]]:
    """Group file paths by chart root (the directory holding Chart.yaml)."""
    roots = [
        posixpath.dirname(p)
        for p in paths
        if posixpath.basename(p) == "Chart.yaml"
    ]
    charts: dict[str, list[str]] = {}
    for root in sorted(roots):
        prefix = root + "/" if root else ""
        members = [p for p in paths if p.startswith(prefix) or p == root]
        # Exclude files belonging to nested subcharts (charts/ dir)
        sub = prefix + "charts/"
        charts[root] = [p for p in members if not p.startswith(sub)]
    return charts
