"""HCL2 (terraform) parser: blocks/attributes -> a rego input document.

The reference evaluates terraform through a full HCL interpreter plus cloud
adapters (pkg/iac/scanners/terraform, ~13.5k LoC of adapters); checks then
run against adapted cloud state.  This module takes the conftest-style
route instead: parse HCL into a JSON-like document

    {"resource": {"aws_s3_bucket": {"logs": {...attrs...}}},
     "variable": {...}, "locals": {...}, "provider": {...}, ...}

with ``__startline__``/``__endline__`` markers on every block (the same
convention trivy uses for YAML/JSON inputs), resolve ``var.x`` from
variable defaults and ``local.x`` from locals, and let rego checks walk the
resource tree directly.  This covers the attribute-level checks (the large
majority of the reference's terraform corpus); whole-infrastructure
reasoning (module evaluation, cross-resource adaptation) is out of scope
and documented as such.

Supported HCL: blocks with 0-2 labels, nested blocks, attributes with
strings (incl. ``${...}`` interpolation), heredocs, numbers, bools, null,
lists, maps, ``var.``/``local.`` references, dotted references (kept as
reference strings), function calls (kept as opaque strings), and ``a ? b :
c`` conditionals when the condition resolves to a literal.

Copied from `trivy_tpu/iac/hcl.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

__all__ = ["HclError", "parse_hcl", "terraform_input"]


class HclError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<heredoc><<-?\s*([A-Za-z_][A-Za-z0-9_]*)\n)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_.-]*)
  | (?P<punct>\{|\}|\[|\]|\(|\)|==|!=|>=|<=|=|,|\?|:|\.|\+|-|\*|/|%|>|<|!|&&|\|\|)
  | (?P<nl>\n)
  | (?P<ws>[ \t\r]+)
""",
    re.VERBOSE | re.DOTALL,
)


@dataclass
class _Tok:
    kind: str
    text: str
    line: int


def _tokenize(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    line = 1
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise HclError(f"hcl: bad token at line {line}: {src[pos:pos+20]!r}")
        kind = m.lastgroup
        text = m.group()
        if kind == "heredoc":
            tag = m.group(3)
            line += 1
            end = re.search(
                rf"^\s*{re.escape(tag)}\s*$", src[m.end():], re.MULTILINE
            )
            if end is None:
                raise HclError(f"hcl: unterminated heredoc <<{tag}")
            body = src[m.end() : m.end() + end.start()]
            toks.append(_Tok("string", body.rstrip("\n"), line))
            line += body.count("\n") + 1
            pos = m.end() + end.end()
            continue
        pos = m.end()
        if kind == "nl":
            toks.append(_Tok("nl", "\n", line))
            line += 1
            continue
        if kind in ("ws",):
            continue
        if kind == "comment":
            line += text.count("\n")
            continue
        if kind == "string":
            # strip quotes; unescape minimal
            body = text[1:-1]
            body = body.replace(r"\"", '"').replace(r"\\", "\\").replace(r"\n", "\n")
            toks.append(_Tok("string", body, line))
            continue
        toks.append(_Tok(kind, text, line))
    toks.append(_Tok("eof", "", line))
    return toks


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self, skip_nl: bool = True) -> _Tok:
        j = self.i
        while skip_nl and self.toks[j].kind == "nl":
            j += 1
        return self.toks[j]

    def next(self, skip_nl: bool = True) -> _Tok:
        while skip_nl and self.toks[self.i].kind == "nl":
            self.i += 1
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, text: str | None = None) -> _Tok:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise HclError(f"hcl: expected {text or kind} at line {t.line}, got {t.text!r}")
        return t

    def at(self, kind: str, text: str | None = None) -> bool:
        t = self.peek()
        return t.kind == kind and (text is None or t.text == text)

    def eat(self, kind: str, text: str | None = None) -> bool:
        if self.at(kind, text):
            self.next()
            return True
        return False

    # ------------------------------------------------------------------

    def parse_body(self, end_line_holder: list[int]) -> dict[str, Any]:
        """Parse block contents until '}' or EOF.  Repeated nested block
        types accumulate into lists."""
        out: dict[str, Any] = {}
        while True:
            t = self.peek()
            if t.kind == "eof" or (t.kind == "punct" and t.text == "}"):
                end_line_holder[0] = t.line
                return out
            name = self.next()
            if name.kind not in ("name", "string"):
                raise HclError(f"hcl: bad body item at line {name.line}: {name.text!r}")
            if self.at("punct", "="):
                self.next()
                out[name.text] = self.parse_value()
                continue
            # nested block: labels then {
            labels = []
            while self.peek().kind in ("name", "string") and not self.at("punct", "{"):
                labels.append(self.next().text)
            self.expect("punct", "{")
            holder = [name.line]
            body = self.parse_body(holder)
            self.expect("punct", "}")
            body["__startline__"] = name.line
            body["__endline__"] = holder[0]
            node: Any = body
            for lbl in reversed(labels):
                node = {lbl: node}
            if name.text in out and not labels:
                prev = out[name.text]
                if isinstance(prev, list):
                    prev.append(node)
                else:
                    out[name.text] = [prev, node]
            elif name.text in out and labels:
                _merge(out[name.text], node)
            else:
                out[name.text] = node
        # unreachable

    def parse_value(self) -> Any:
        """Primary value plus infix folding: arithmetic/comparison chains on
        non-literal operands collapse into opaque reference text (the same
        treatment as function calls), and ``cond ? a : b`` resolves when the
        condition is a literal bool."""
        val = self._parse_primary_value()
        while self.peek().kind == "punct" and self.peek(skip_nl=False).text in (
            "+", "-", "*", "/", "%", "==", "!=", ">", "<", ">=", "<=",
            "&&", "||",
        ):
            op = self.next().text
            rhs = self._parse_primary_value()
            if isinstance(val, (int, float)) and isinstance(rhs, (int, float))                     and not isinstance(val, bool) and not isinstance(rhs, bool)                     and op in ("+", "-", "*", "/", "%"):
                try:
                    val = {
                        "+": lambda a, b: a + b,
                        "-": lambda a, b: a - b,
                        "*": lambda a, b: a * b,
                        "/": lambda a, b: a / b,
                        "%": lambda a, b: a % b,
                    }[op](val, rhs)
                    continue
                except ZeroDivisionError:
                    pass
            val = _RefStr(f"{val} {op} {rhs}")
        if self.at("punct", "?"):  # conditional
            self.next()
            a = self.parse_value()
            self.expect("punct", ":")
            b = self.parse_value()
            if val is True:
                return a
            if val is False:
                return b
            return a  # unresolved condition: keep the true branch
        return val

    def _parse_primary_value(self) -> Any:
        t = self.peek()
        if t.kind == "string":
            self.next()
            return t.text
        if t.kind == "number":
            self.next()
            v = float(t.text)
            return int(v) if v == int(v) else v
        if t.kind == "name":
            # true/false/null, references, or function calls
            self.next()
            if t.text == "true":
                val: Any = True
            elif t.text == "false":
                val = False
            elif t.text == "null":
                val = None
            else:
                val = _RefStr(t.text)
            while self.at("punct", "["):  # index/splat: ref[0].id etc.
                depth = 0
                parts = [str(val)] if not isinstance(val, _RefStr) else [str(val)]
                self.next()
                parts.append("[")
                depth = 1
                while depth:
                    tok = self.next(skip_nl=False)
                    if tok.kind == "eof":
                        raise HclError("hcl: unterminated index")
                    if tok.kind == "punct" and tok.text == "[":
                        depth += 1
                    if tok.kind == "punct" and tok.text == "]":
                        depth -= 1
                    if tok.kind != "nl":
                        parts.append(tok.text)
                while self.at("punct", "."):  # trailing .attr after index
                    self.next()
                    parts.append(".")
                    parts.append(self.next().text)
                val = _RefStr("".join(parts))
            if self.at("punct", "("):  # function call -> opaque string
                depth = 0
                parts = [t.text]
                while True:
                    tok = self.next(skip_nl=False)
                    if tok.kind == "eof":
                        raise HclError("hcl: unterminated call")
                    if tok.kind == "punct" and tok.text == "(":
                        depth += 1
                    if tok.kind == "punct" and tok.text == ")":
                        depth -= 1
                        if depth == 0:
                            parts.append(")")
                            break
                    if tok.kind != "nl":
                        parts.append(tok.text)
                val = _RefStr("".join(parts))
            return val
        if t.kind == "punct" and t.text == "[":
            self.next()
            items = []
            while not self.at("punct", "]"):
                items.append(self.parse_value())
                if not self.eat("punct", ","):
                    break
            self.expect("punct", "]")
            return items
        if t.kind == "punct" and t.text == "{":
            self.next()
            holder = [t.line]
            body = self.parse_body(holder)
            self.expect("punct", "}")
            body.pop("__startline__", None)
            body.pop("__endline__", None)
            return body
        raise HclError(f"hcl: bad value at line {t.line}: {t.text!r}")


class _RefStr(str):
    """A bare reference or call kept as its source text."""


def _merge(dst: Any, src: Any) -> None:
    if isinstance(dst, dict) and isinstance(src, dict):
        for k, v in src.items():
            if k in dst:
                _merge(dst[k], v)
            else:
                dst[k] = v


def parse_hcl(content: str) -> dict[str, Any]:
    p = _Parser(_tokenize(content))
    holder = [0]
    return p.parse_body(holder)


_INTERP_RE = re.compile(r"\$\{([^}]*)\}")


def _resolve(value: Any, variables: dict, local_vals: dict) -> Any:
    if isinstance(value, _RefStr):
        text = str(value)
        if text.startswith("var."):
            v = variables.get(text[4:])
            if v is not None:
                return _resolve(v, variables, local_vals)
        if text.startswith("local."):
            v = local_vals.get(text[6:])
            if v is not None:
                return _resolve(v, variables, local_vals)
        return text
    if isinstance(value, str):
        def sub(m: re.Match) -> str:
            inner = m.group(1).strip()
            r = _resolve(_RefStr(inner), variables, local_vals)
            return r if isinstance(r, str) else str(r)

        return _INTERP_RE.sub(sub, value)
    if isinstance(value, list):
        return [_resolve(v, variables, local_vals) for v in value]
    if isinstance(value, dict):
        return {
            k: (v if k.startswith("__") else _resolve(v, variables, local_vals))
            for k, v in value.items()
        }
    return value


def terraform_input(content: str) -> dict[str, Any]:
    """Parse terraform source and resolve var defaults/locals into the
    conftest-style input document."""
    return terraform_docs_input([parse_hcl(content)])


def _merge_tf_docs(docs: list[dict[str, Any]]) -> dict[str, Any]:
    """Merge per-file parse_hcl docs the way terraform merges a module
    dir: block-type dicts union (resource types/names across files),
    locals lists concatenate."""
    merged: dict[str, Any] = {}
    for doc in docs:
        for key, val in doc.items():
            if key == "locals":
                cur = merged.setdefault("locals", [])
                if isinstance(cur, dict):
                    cur = merged["locals"] = [cur]
                cur.extend(val if isinstance(val, list) else [val])
            elif isinstance(val, dict) and isinstance(merged.get(key), dict):
                for sub, blk in val.items():
                    if isinstance(blk, dict) and isinstance(
                        merged[key].get(sub), dict
                    ):
                        merged[key][sub].update(blk)
                    else:
                        merged[key][sub] = blk
            else:
                merged[key] = val
    return merged


_MODULE_META_KEYS = {
    "source", "version", "providers", "count", "for_each", "depends_on",
}


def terraform_docs_input(
    docs: list[dict[str, Any]], overrides: dict[str, Any] | None = None
) -> dict[str, Any]:
    """The shared resolution core: merge per-file docs, apply variable
    defaults then caller overrides, fold locals, resolve references.
    terraform_input (single file) and terraform_module_input (module dir
    with caller arguments) both delegate here so the variable semantics
    cannot diverge."""
    doc = _merge_tf_docs(docs) if len(docs) != 1 else docs[0]
    variables: dict[str, Any] = {}
    for name, blk in (doc.get("variable") or {}).items():
        if isinstance(blk, dict) and "default" in blk:
            variables[name] = blk["default"]
    for name, val in (overrides or {}).items():
        if name not in _MODULE_META_KEYS and not name.startswith("__"):
            variables[name] = val
    local_vals: dict[str, Any] = {}
    locals_blk = doc.get("locals")
    if isinstance(locals_blk, list):
        m: dict[str, Any] = {}
        for b in locals_blk:
            if isinstance(b, dict):
                m.update(b)
        locals_blk = m
    if isinstance(locals_blk, dict):
        local_vals = {
            k: v for k, v in locals_blk.items() if not k.startswith("__")
        }
    return _resolve(doc, variables, local_vals)


def terraform_module_input(
    sources: dict[str, str], overrides: dict[str, Any] | None = None
) -> dict[str, Any]:
    """Evaluate a terraform module directory: every file's doc merged,
    variable defaults overridden by the caller's module-block arguments
    (the reference's module expansion, pkg/iac/scanners/terraform
    executor — defaults-only here, no remote modules)."""
    return terraform_docs_input(
        [parse_hcl(sources[p]) for p in sorted(sources)], overrides
    )
