"""A Rego-subset evaluator for policy-as-code misconfiguration checks.

The reference drives all IaC scanning through OPA Rego (pkg/iac/rego/
scanner.go, pkg/iac/rego/load.go); checks live in the trivy-checks bundle
and user policies load from --config-check dirs.  This module implements the
practically-used subset of the language so the same *model* works here:
checks are .rego sources (trivy_tpu_torch/iac/checks/), users can add their own,
and the engine evaluates them against structured file inputs
(iac/inputs.py).

Supported subset (sufficient for the builtin check corpus and typical
user checks; unsupported constructs raise RegoError at load time so a
failing policy is loud, not silently green):

  * package / import lines; METADATA comment blocks (YAML) and the legacy
    ``__rego_metadata__`` object
  * rules: partial sets ``deny[msg] { ... }`` and the modern
    ``deny contains msg if { ... }``; complete rules ``name := expr``,
    ``name = expr { body }``, ``name { body }``; ``default name := v``;
    functions ``f(x) { ... }`` / ``f(x) = y { ... }``; multiple bodies
    per rule name (OR semantics); ``else`` chains on complete rules,
    boolean rules, and functions (first satisfiable link wins)
  * statements: ``x := e``, ``some x in e``, ``some k, v in e``, ``not e``,
    ``every x in e { ... }`` / ``every k, v in e { ... }`` (universal
    quantification, vacuously true on empty collections), boolean
    expressions, comparisons (== != < <= > >=), unification ``=``
    treated as equality when both sides are bound
  * expressions: input/data references with fields, ``[...]`` indexing,
    ``[_]`` wildcard iteration (backtracks), array/object/set literals,
    arithmetic, ``in`` membership, string concat via ``+``
  * builtins: startswith endswith contains lower upper split trim
    trim_space trim_prefix trim_suffix replace sprintf count concat
    to_number is_string is_number is_null is_array is_object object.get
    array.concat regex.match re_match json.unmarshal result.new

Evaluation is generator-based: each statement yields extended environments;
wildcard and ``some`` iteration backtrack through them.  A rule body that
references an undefined path is simply unsatisfied (OPA semantics), not an
error.

Copied from `trivy_tpu/iac/rego.py`;
the port imports nothing from the JAX package.
"""

from __future__ import annotations

import json
import re as _re
from dataclasses import dataclass, field
from typing import Any, Iterator

__all__ = ["RegoError", "RegoModule", "RegoEngine", "parse_module"]


class RegoError(ValueError):
    pass


class _Undefined(Exception):
    """Raised when a reference path is undefined (kills the current branch)."""


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = _re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|`[^`]*`)
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>:=|==|!=|<=|>=|\{|\}|\[|\]|\(|\)|,|\.|:|;|=|<|>|\+|-|\*|/|%|\|)
  | (?P<nl>\n)
  | (?P<ws>[ \t\r]+)
""",
    _re.VERBOSE,
)

_KEYWORDS = {
    "package", "import", "default", "not", "some", "in", "if",
    "contains", "else", "true", "false", "null", "as", "every", "with",
}


@dataclass
class _Tok:
    kind: str  # name, string, number, punct, nl, kw
    text: str
    line: int


def _tokenize(src: str) -> list[_Tok]:
    toks: list[_Tok] = []
    line = 1
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise RegoError(f"rego: bad token at line {line}: {src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind == "nl":
            toks.append(_Tok("nl", "\n", line))
            line += 1
            continue
        if kind in ("ws", "comment"):
            continue
        if kind == "name" and text in _KEYWORDS:
            kind = "kw"
        toks.append(_Tok(kind, text, line))
    toks.append(_Tok("eof", "", line))
    return toks


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Lit:
    value: Any


@dataclass
class Var:
    name: str


@dataclass
class Wildcard:
    pass


@dataclass
class Ref:
    base: Any  # expr
    path: list[Any]  # str field names or expr indices / Wildcard


@dataclass
class Call:
    name: str
    args: list[Any]


@dataclass
class BinOp:
    op: str
    left: Any
    right: Any


@dataclass
class ArrayLit:
    items: list[Any]


@dataclass
class ObjectLit:
    items: list[tuple[Any, Any]]


@dataclass
class SetLit:
    items: list[Any]


@dataclass
class Comprehension:
    head: Any
    body: list[Any]


@dataclass
class St_Assign:
    var: str
    expr: Any


@dataclass
class St_Some:
    vars: list[str]
    expr: Any


@dataclass
class St_Not:
    expr: Any


@dataclass
class St_Every:
    """Universal quantification: every x in coll { body } — succeeds when
    the body is satisfiable for EVERY element (vacuously true on empty
    collections, OPA semantics); bindings do not escape."""

    vars: list[str]
    expr: Any
    body: list[Any]


@dataclass
class St_Expr:
    expr: Any


@dataclass
class St_AssignMulti:
    """Array destructuring: [a, b, c] := expr."""

    vars: list
    expr: Any


@dataclass
class St_With:
    """statement `with input[.path] as v` / `with data.path as v`:
    the wrapped statement evaluates under a modified input/data document
    (OPA test-idiom mocking); bindings escape to the outer body."""

    stmt: Any
    mods: list  # [(path tuple like ("input","foo"), value expr), ...]


@dataclass
class RuleClause:
    key: Any | None  # partial-set element expr (deny[msg])
    value: Any | None  # complete-rule value expr
    body: list[Any]
    args: list[str] | None = None  # function parameters
    # `else` chain link: evaluated only when THIS clause's body fails
    # (complete rules and functions; illegal on partial sets in rego).
    else_clause: "RuleClause | None" = None


@dataclass
class Rule:
    name: str
    clauses: list[RuleClause] = field(default_factory=list)
    default: Any = None
    has_default: bool = False
    is_set: bool = False
    is_func: bool = False


class _SetVal(list):
    """A partial-set rule's result: ``s[x]`` binds x to MEMBERS (rego set
    semantics), unlike a plain list where ``arr[i]`` binds the index."""


@dataclass
class _ModuleVal:
    """An imported module referenced as a value (``import data.lib.k8s``
    binds alias -> this); field access resolves the module's rules."""

    module: "RegoModule"


@dataclass
class RegoModule:
    package: str
    rules: dict[str, Rule]
    metadata: dict[str, Any]
    source_path: str = ""
    # alias -> imported package path ("kubernetes" -> "lib.kubernetes");
    # resolved against an evaluator's module registry at eval time.
    imports: dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


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
            raise RegoError(
                f"rego: expected {text or kind} at line {t.line}, got {t.text!r}"
            )
        return t

    def at(self, kind: str, text: str | None = None) -> bool:
        t = self.peek()
        return t.kind == kind and (text is None or t.text == text)

    def eat(self, kind: str, text: str | None = None) -> bool:
        if self.at(kind, text):
            self.next()
            return True
        return False

    # -- expressions -------------------------------------------------------

    def parse_expr(self) -> Any:
        return self.parse_in()

    def parse_in(self) -> Any:
        left = self.parse_cmp()
        if self.at("kw", "in"):
            self.next()
            right = self.parse_cmp()
            return BinOp("in", left, right)
        return left

    def parse_cmp(self) -> Any:
        left = self.parse_add()
        t = self.peek()
        if t.kind == "punct" and t.text in ("==", "!=", "<", "<=", ">", ">=", "="):
            self.next()
            right = self.parse_add()
            op = "==" if t.text == "=" else t.text
            return BinOp(op, left, right)
        return left

    def parse_add(self) -> Any:
        left = self.parse_mul()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.text in ("+", "-"):
                self.next()
                left = BinOp(t.text, left, self.parse_mul())
            else:
                return left

    def parse_mul(self) -> Any:
        left = self.parse_postfix()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.text in ("*", "/", "%"):
                self.next()
                left = BinOp(t.text, left, self.parse_postfix())
            else:
                return left

    def parse_postfix(self) -> Any:
        node = self.parse_primary()
        path: list[Any] = []
        name_parts: list[str] = []
        while True:
            if self.at("punct", "."):
                # no newline allowed before '.': field access
                self.next()
                fld = self.next()
                if fld.kind not in ("name", "kw"):
                    raise RegoError(f"rego: bad field at line {fld.line}")
                path.append(fld.text)
                name_parts.append(fld.text)
            elif (
                self.peek(skip_nl=False).kind == "punct"
                and self.peek(skip_nl=False).text == "["
            ):
                # indexing binds only on the same line: `x := f(y)` followed
                # by a `[a, b] := ...` destructuring statement on the next
                # line must not parse as f(y)[a, b]
                self.next(skip_nl=False)
                if self.at("name") and self.peek().text == "_":
                    self.next()
                    path.append(Wildcard())
                else:
                    path.append(self.parse_expr())
                self.expect("punct", "]")
                name_parts = []
            elif self.at("punct", "("):
                # function call on a dotted name: lower(...), regex.match(...)
                if not isinstance(node, Var):
                    raise RegoError("rego: cannot call non-name")
                fname = ".".join([node.name] + [p for p in path if isinstance(p, str)])
                self.next()
                args = []
                if not self.at("punct", ")"):
                    args.append(self.parse_expr())
                    while self.eat("punct", ","):
                        args.append(self.parse_expr())
                self.expect("punct", ")")
                node = Call(fname, args)
                path = []
                continue
            else:
                break
        if path:
            return Ref(node, path)
        return node

    def parse_primary(self) -> Any:
        t = self.peek()
        if t.kind == "string":
            self.next()
            if t.text.startswith("`"):
                return Lit(t.text[1:-1])
            return Lit(json.loads(t.text))
        if t.kind == "number":
            self.next()
            v = float(t.text)
            return Lit(int(v) if v == int(v) else v)
        if t.kind == "kw" and t.text in ("true", "false", "null"):
            self.next()
            return Lit({"true": True, "false": False, "null": None}[t.text])
        if t.kind == "kw" and t.text == "not":
            # inside comprehension bodies etc. handled at statement level
            raise RegoError(f"rego: unexpected 'not' in expression at line {t.line}")
        if t.kind == "name":
            self.next()
            if t.text == "_":
                return Wildcard()
            return Var(t.text)
        if t.kind == "kw" and t.text == "contains":
            # `contains` is a keyword at rule level (deny contains msg) but
            # also the string builtin in expression position.
            self.next()
            return Var("contains")
        if t.kind == "punct" and t.text == "[":
            self.next()
            items = []
            if not self.at("punct", "]"):
                items.append(self.parse_expr())
                # comprehension: [head | body]
                if self.at("punct", "|"):
                    self.next()
                    body = self.parse_body_until(("]",))
                    self.expect("punct", "]")
                    return Comprehension(items[0], body)
                while self.eat("punct", ","):
                    if self.at("punct", "]"):
                        break
                    items.append(self.parse_expr())
            self.expect("punct", "]")
            return ArrayLit(items)
        if t.kind == "punct" and t.text == "{":
            self.next()
            if self.at("punct", "}"):
                self.next()
                return ObjectLit([])
            first = self.parse_expr()
            if self.at("punct", ":"):
                self.next()
                items = [(first, self.parse_expr())]
                while self.eat("punct", ","):
                    if self.at("punct", "}"):
                        break
                    k = self.parse_expr()
                    self.expect("punct", ":")
                    items.append((k, self.parse_expr()))
                self.expect("punct", "}")
                return ObjectLit(items)
            # set literal
            elems = [first]
            while self.eat("punct", ","):
                if self.at("punct", "}"):
                    break
                elems.append(self.parse_expr())
            self.expect("punct", "}")
            return SetLit(elems)
        if t.kind == "punct" and t.text == "(":
            self.next()
            e = self.parse_expr()
            self.expect("punct", ")")
            return e
        raise RegoError(f"rego: unexpected token {t.text!r} at line {t.line}")

    # -- statements / bodies ----------------------------------------------

    def parse_statement(self) -> Any:
        if self.at("kw", "not"):
            self.next()
            return self._maybe_with(St_Not(self.parse_expr()))
        if self.at("kw", "some"):
            self.next()
            names = [self.expect("name").text]
            while self.eat("punct", ","):
                names.append(self.expect("name").text)
            self.expect("kw", "in")
            return St_Some(names, self.parse_expr())
        if self.at("kw", "every"):
            self.next()
            names = [self.expect("name").text]
            while self.eat("punct", ","):
                names.append(self.expect("name").text)
            self.expect("kw", "in")
            expr = self.parse_expr()
            body = self.parse_block_body()
            return St_Every(names, expr, body)
        # assignment or expression
        save = self.i
        t = self.peek()
        stmt = None
        if t.kind == "punct" and t.text == "[":
            # possible array destructuring [a, b] := expr
            self.next()
            names = []
            ok = True
            while True:
                tt = self.peek()
                if tt.kind == "name":
                    names.append(tt.text)
                    self.next()
                elif tt.kind == "punct" and tt.text == "_":
                    names.append("_")
                    self.next()
                else:
                    ok = False
                    break
                if self.eat("punct", "]"):
                    break
                if not self.eat("punct", ","):
                    ok = False
                    break
            if ok and names and self.at("punct", ":="):
                self.next()
                return self._maybe_with(
                    St_AssignMulti(names, self.parse_expr())
                )
            self.i = save
        if t.kind == "name":
            self.next()
            if self.at("punct", ":="):
                self.next()
                stmt = St_Assign(t.text, self.parse_expr())
            else:
                self.i = save
        if stmt is None:
            stmt = St_Expr(self.parse_expr())
        return self._maybe_with(stmt)

    def _maybe_with(self, stmt: Any) -> Any:
        """Attach trailing `with <target> as <value>` modifiers."""
        if not self.at("kw", "with"):
            return stmt
        mods = []
        while self.eat("kw", "with"):
            head = self.expect("name").text
            path = [head]
            while self.eat("punct", "."):
                path.append(self.expect("name").text)
            if path[0] not in ("input", "data"):
                raise RegoError(
                    f"rego: 'with' target must be input/data, got {head}"
                )
            self.expect("kw", "as")
            mods.append((tuple(path), self.parse_expr()))
        return St_With(stmt, mods)

    def parse_body_until(self, closers: tuple[str, ...]) -> list[Any]:
        body = []
        while True:
            t = self.peek()
            if t.kind == "punct" and t.text in closers:
                return body
            if t.kind == "eof":
                raise RegoError("rego: unterminated body")
            body.append(self.parse_statement())
            self.eat("punct", ";")

    def parse_block_body(self) -> list[Any]:
        self.expect("punct", "{")
        body = self.parse_body_until(("}",))
        self.expect("punct", "}")
        return body


def _parse_metadata_comment(block: list[str]) -> dict[str, Any]:
    """Parse a `# METADATA` YAML comment block.

    Tries YAML first; on failure (titles like `":latest" tag used` are not
    valid YAML scalars) falls back to a two-level key/value mini-parser,
    which covers the metadata shape trivy checks actually use."""
    try:
        import yaml

        out = yaml.safe_load("\n".join(block))
        if isinstance(out, dict):
            return out
    except Exception:
        pass
    out: dict[str, Any] = {}
    stack: list[dict[str, Any]] = [out]
    indents = [0]
    for raw in block:
        if not raw.strip():
            continue
        indent = len(raw) - len(raw.lstrip())
        key, _, val = raw.strip().partition(":")
        val = val.strip()
        while len(indents) > 1 and indent < indents[-1]:
            stack.pop()
            indents.pop()
        if val:
            stack[-1][key] = val
        else:
            child: dict[str, Any] = {}
            stack[-1][key] = child
            stack.append(child)
            indents.append(indent + 1)
    return out


def _parse_else_chain(p: "_Parser", clause: RuleClause) -> RuleClause:
    """Attach `else [:= value] [if] { body }` links to a clause."""
    cur = clause
    while p.at("kw", "else"):
        p.next()
        value = None
        if p.eat("punct", ":=") or p.eat("punct", "="):
            value = p.parse_expr()
        if p.eat("kw", "if"):
            body = (
                p.parse_block_body()
                if p.at("punct", "{")
                else [p.parse_statement()]
            )
        elif p.at("punct", "{"):
            body = p.parse_block_body()
        else:
            body = []
        cur.else_clause = RuleClause(
            key=None, value=value, body=body, args=clause.args
        )
        cur = cur.else_clause
    return clause


def parse_module(src: str, source_path: str = "") -> RegoModule:
    toks = _tokenize(src)
    p = _Parser(toks)

    # metadata comment blocks come from the raw source
    metadata: dict[str, Any] = {}
    lines = src.splitlines()
    for i, raw in enumerate(lines):
        if raw.strip() == "# METADATA":
            block = []
            j = i + 1
            while j < len(lines) and lines[j].lstrip().startswith("#"):
                block.append(lines[j].lstrip()[1:].lstrip("\t").removeprefix(" "))
                j += 1
            md = _parse_metadata_comment(block)
            if md:
                metadata.update(md)
            break

    p.expect("kw", "package")
    parts = [p.next().text]
    while p.eat("punct", "."):
        parts.append(p.next().text)
    package = ".".join(parts)

    rules: dict[str, Rule] = {}

    def rule_for(name: str) -> Rule:
        if name not in rules:
            rules[name] = Rule(name=name)
        return rules[name]

    imports: dict[str, str] = {}
    while not p.at("eof"):
        if p.eat("kw", "import"):
            # `import data.lib.kubernetes [as alias]` binds alias (default:
            # last segment) to the package path for cross-module rule
            # references; `rego.v1` / `future.keywords.*` are no-ops.
            parts = [p.next().text]
            while p.eat("punct", "."):
                parts.append(p.next().text)
            alias = ""
            if p.eat("kw", "as"):
                alias = p.expect("name").text
            if parts[0] == "data" and len(parts) > 1:
                imports[alias or parts[-1]] = ".".join(parts[1:])
            continue
        if p.eat("kw", "default"):
            name = p.expect("name").text
            if not (p.eat("punct", ":=") or p.eat("punct", "=")):
                raise RegoError("rego: default needs := or =")
            val = p.parse_expr()
            r = rule_for(name)
            r.default = val
            r.has_default = True
            continue
        t = p.next()
        if t.kind != "name":
            raise RegoError(f"rego: expected rule name at line {t.line}, got {t.text!r}")
        name = t.text
        r = rule_for(name)

        if p.at("punct", "("):  # function definition
            p.next()
            args = []
            if not p.at("punct", ")"):
                args.append(p.expect("name").text)
                while p.eat("punct", ","):
                    args.append(p.expect("name").text)
            p.expect("punct", ")")
            value = None
            if p.eat("punct", "=") or p.eat("punct", ":="):
                value = p.parse_expr()
            p.eat("kw", "if")  # rego.v1: f(x) [= v] if { body }
            body = p.parse_block_body() if p.at("punct", "{") else []
            r.is_func = True
            r.clauses.append(
                _parse_else_chain(
                    p,
                    RuleClause(key=None, value=value, body=body, args=args),
                )
            )
            continue

        if p.at("punct", "["):  # partial set/object: deny[msg] { ... }
            p.next()
            key = p.parse_expr()
            p.expect("punct", "]")
            body = p.parse_block_body() if p.at("punct", "{") else []
            r.is_set = True
            r.clauses.append(RuleClause(key=key, value=None, body=body))
            continue

        if p.at("kw", "contains"):  # deny contains msg if { ... }
            p.next()
            key = p.parse_expr()
            if p.eat("kw", "if"):
                if p.at("punct", "{"):
                    body = p.parse_block_body()
                else:
                    body = [p.parse_statement()]
            else:
                body = []
            r.is_set = True
            r.clauses.append(RuleClause(key=key, value=None, body=body))
            continue

        if p.eat("punct", ":=") or p.eat("punct", "="):
            value = p.parse_expr()
            if p.eat("kw", "if"):
                if p.at("punct", "{"):
                    body = p.parse_block_body()
                else:
                    body = [p.parse_statement()]
            elif p.at("punct", "{"):
                body = p.parse_block_body()
            else:
                body = []
            r.clauses.append(
                _parse_else_chain(
                    p, RuleClause(key=None, value=value, body=body)
                )
            )
            continue

        if p.eat("kw", "if"):
            if p.at("punct", "{"):
                body = p.parse_block_body()
            else:
                body = [p.parse_statement()]
            r.clauses.append(
                _parse_else_chain(
                    p, RuleClause(key=None, value=Lit(True), body=body)
                )
            )
            continue

        if p.at("punct", "{"):  # boolean rule: name { body }
            body = p.parse_block_body()
            r.clauses.append(
                _parse_else_chain(
                    p, RuleClause(key=None, value=Lit(True), body=body)
                )
            )
            continue

        raise RegoError(f"rego: cannot parse rule {name!r} at line {t.line}")

    # Legacy __rego_metadata__ := {...}
    meta_rule = rules.get("__rego_metadata__")
    if meta_rule and meta_rule.clauses:
        try:
            ev = _Evaluator({}, rules)
            metadata.update(ev.eval_expr(meta_rule.clauses[0].value, {}))
        except Exception:
            pass

    return RegoModule(
        package=package, rules=rules, metadata=metadata,
        source_path=source_path, imports=imports,
    )


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


def _truthy(v: Any) -> bool:
    return v is not False and v is not None


def _sprintf(fmt: str, args: list[Any]) -> str:
    out = []
    i = 0
    ai = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            if spec == "%":
                out.append("%")
            elif spec in "svdqf":
                a = args[ai] if ai < len(args) else ""
                ai += 1
                if spec == "q":
                    out.append(json.dumps(str(a)))
                elif spec == "d":
                    out.append(str(int(a)))
                elif spec == "f":
                    out.append(str(float(a)))
                else:
                    out.append(a if isinstance(a, str) else json.dumps(a))
            else:
                out.append(c + spec)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _with_set(root: Any, path: tuple, val: Any) -> Any:
    """Copy-on-write path replacement for `with` document overrides."""
    if not path:
        return val
    out = dict(root) if isinstance(root, dict) else {}
    key = path[0]
    out[key] = _with_set(out.get(key, {}), path[1:], val)
    return out


class _Evaluator:
    MAX_STEPS = 200_000

    def __init__(
        self,
        input_doc: Any,
        rules: dict[str, Rule],
        data: Any | None = None,
        registry: dict[str, "RegoModule"] | None = None,
        imports: dict[str, str] | None = None,
    ):
        self.input = input_doc
        self.rules = rules
        self.data = data or {}
        self.registry = registry or {}
        self.imports = imports or {}
        self._cache: dict[str, Any] = {}
        self._mod_evals: dict[str, "_Evaluator"] = {}
        self._steps = 0

    def _module_eval(self, mod: "RegoModule") -> "_Evaluator":
        """Sub-evaluator for an imported module: same input/data/registry,
        the module's own rules and imports; cached per package."""
        ev = self._mod_evals.get(mod.package)
        if ev is None:
            ev = _Evaluator(
                self.input, mod.rules, self.data,
                registry=self.registry, imports=mod.imports,
            )
            ev._mod_evals = self._mod_evals  # share the cache (cycles safe)
            self._mod_evals[mod.package] = ev
        return ev

    def _module_rule_value(self, mod: "RegoModule", name: str) -> Any:
        ev = self._module_eval(mod)
        rule = mod.rules.get(name)
        if rule is None:
            raise _Undefined()
        if rule.is_set:
            return _SetVal(ev.eval_set_rule(name))
        return ev.eval_complete_rule(name)

    # -- entry points ------------------------------------------------------

    def eval_set_rule(self, name: str) -> list[Any]:
        """All values of a partial-set rule (e.g. deny)."""
        rule = self.rules.get(name)
        if rule is None:
            return []
        out = []
        for clause in rule.clauses:
            for env in self.eval_body(clause.body, {}):
                try:
                    out.append(self.eval_expr(clause.key, env))
                except _Undefined:
                    continue
        return out

    def eval_complete_rule(self, name: str) -> Any:
        if name in self._cache:
            return self._cache[name]
        rule = self.rules.get(name)
        if rule is None:
            raise _Undefined()
        if rule.is_set:
            val = _SetVal(self.eval_set_rule(name))
            self._cache[name] = val
            return val
        for clause in rule.clauses:
            try:
                v = self._eval_clause_chain(clause, {})
            except _Undefined:
                continue
            self._cache[name] = v
            return v
        if rule.has_default:
            v = self.eval_expr(rule.default, {})
            self._cache[name] = v
            return v
        raise _Undefined()

    def _eval_clause_chain(self, clause: RuleClause, env0: dict) -> Any:
        """Value of the first link in a clause's else chain whose body is
        satisfiable (the whole chain fails -> _Undefined)."""
        link: RuleClause | None = clause
        while link is not None:
            for env in self.eval_body(link.body, dict(env0)):
                if link.value is None:
                    return True
                try:
                    return self.eval_expr(link.value, env)
                except _Undefined:
                    continue
            link = link.else_clause
        raise _Undefined()

    def call_function(self, rule: Rule, args: list[Any]) -> Any:
        for clause in rule.clauses:
            if clause.args is None or len(clause.args) != len(args):
                continue
            try:
                return self._eval_clause_chain(
                    clause, dict(zip(clause.args, args))
                )
            except _Undefined:
                continue
        raise _Undefined()

    # -- body evaluation ---------------------------------------------------

    def eval_body(self, body: list[Any], env: dict) -> Iterator[dict]:
        self._steps += 1
        if self._steps > self.MAX_STEPS:
            raise RegoError("rego: evaluation step limit exceeded")
        if not body:
            yield env
            return
        st, rest = body[0], body[1:]
        for env2 in self.eval_statement(st, env):
            yield from self.eval_body(rest, env2)

    def eval_statement(self, st: Any, env: dict) -> Iterator[dict]:
        if isinstance(st, St_Assign):
            try:
                for val, env2 in self.eval_iter(st.expr, env):
                    yield {**env2, st.var: val}
            except _Undefined:
                return
        elif isinstance(st, St_Some):
            try:
                for coll, env2 in self.eval_iter(st.expr, env):
                    yield from self._iterate_some(st.vars, coll, env2)
            except _Undefined:
                return
        elif isinstance(st, St_Every):
            try:
                for coll, env2 in self.eval_iter(st.expr, env):
                    if not isinstance(coll, (list, tuple, dict)):
                        # OPA raises a type error on non-collection
                        # domains; vacuous success would read malformed
                        # input as green.
                        raise RegoError(
                            "rego: 'every' domain is not a collection"
                        )
                    ok = True
                    for env_e in self._iterate_some(st.vars, coll, env2):
                        if not any(
                            True for _ in self.eval_body(st.body, env_e)
                        ):
                            ok = False
                            break
                    if ok:
                        yield env2  # bindings do not escape `every`
            except _Undefined:
                return
        elif isinstance(st, St_Not):
            # negation-as-failure over a wildcard-free evaluation
            try:
                found = False
                for val, _env2 in self.eval_iter(st.expr, env):
                    if _truthy(val):
                        found = True
                        break
                if not found:
                    yield env
            except _Undefined:
                yield env
        elif isinstance(st, St_Expr):
            try:
                for val, env2 in self.eval_iter(st.expr, env):
                    if _truthy(val):
                        yield env2
            except _Undefined:
                return
        elif isinstance(st, St_AssignMulti):
            try:
                for val, env2 in self.eval_iter(st.expr, env):
                    if not isinstance(val, (list, tuple)) or len(val) != len(
                        st.vars
                    ):
                        continue
                    bound = dict(env2)
                    for name, item in zip(st.vars, val):
                        if name != "_":
                            bound[name] = item
                    yield bound
            except _Undefined:
                return
        elif isinstance(st, St_With):
            try:
                new_input, new_data = self.input, self.data
                for path, vexpr in st.mods:
                    val = self.eval_expr(vexpr, env)
                    if path[0] == "input":
                        new_input = _with_set(new_input, path[1:], val)
                    else:
                        new_data = _with_set(new_data, path[1:], val)
            except _Undefined:
                return
            # fresh evaluator: rule caches depend on the documents
            ev2 = _Evaluator(
                new_input, self.rules, new_data,
                registry=self.registry, imports=self.imports,
            )
            yield from ev2.eval_statement(st.stmt, env)
        else:
            raise RegoError(f"rego: bad statement {st!r}")

    def _iterate_some(self, names: list[str], coll: Any, env: dict) -> Iterator[dict]:
        if isinstance(coll, dict):
            items = coll.items()
            if len(names) == 1:
                for k, _v in items:
                    yield {**env, names[0]: k}
            else:
                for k, v in items:
                    yield {**env, names[0]: k, names[1]: v}
        elif isinstance(coll, (list, tuple)):
            if len(names) == 1:
                for v in coll:
                    yield {**env, names[0]: v}
            else:
                for i, v in enumerate(coll):
                    yield {**env, names[0]: i, names[1]: v}

    # -- expression evaluation --------------------------------------------

    def eval_iter(self, expr: Any, env: dict) -> Iterator[tuple[Any, dict]]:
        """Evaluate an expression that may contain wildcard iteration;
        yields (value, extended_env) per branch."""
        if isinstance(expr, Ref):
            yield from self._ref_iter(expr, env)
            return
        if isinstance(expr, BinOp):
            for lv, env1 in self.eval_iter(expr.left, env):
                for rv, env2 in self.eval_iter(expr.right, env1):
                    yield self._binop(expr.op, lv, rv), env2
            return
        if isinstance(expr, Call):
            # iterate arguments (wildcards inside calls)
            def rec(args: list[Any], acc: list[Any], e: dict):
                if not args:
                    yield self._call(expr.name, acc, e), e
                    return
                for v, e2 in self.eval_iter(args[0], e):
                    yield from rec(args[1:], acc + [v], e2)

            yield from rec(expr.args, [], env)
            return
        yield self.eval_expr(expr, env), env

    def eval_expr(self, expr: Any, env: dict) -> Any:
        if isinstance(expr, Lit):
            return expr.value
        if isinstance(expr, Var):
            if expr.name in env:
                return env[expr.name]
            if expr.name == "input":
                return self.input
            if expr.name == "data":
                return self.data
            if expr.name in self.rules:
                return self.eval_complete_rule(expr.name)
            if expr.name in self.imports:
                mod = self.registry.get(self.imports[expr.name])
                if mod is None:
                    raise _Undefined()
                return _ModuleVal(mod)
            raise _Undefined()
        if isinstance(expr, Wildcard):
            raise RegoError("rego: wildcard outside reference")
        if isinstance(expr, Ref):
            vals = list(self._ref_iter(expr, env))
            if not vals:
                raise _Undefined()
            return vals[0][0]
        if isinstance(expr, Call):
            args = [self.eval_expr(a, env) for a in expr.args]
            return self._call(expr.name, args, env)
        if isinstance(expr, BinOp):
            return self._binop(
                expr.op, self.eval_expr(expr.left, env), self.eval_expr(expr.right, env)
            )
        if isinstance(expr, ArrayLit):
            return [self.eval_expr(i, env) for i in expr.items]
        if isinstance(expr, SetLit):
            # A set literal must carry set semantics: `{"a","b"}[x]` is a
            # membership test on a bound x, not an index lookup.
            return _SetVal([self.eval_expr(i, env) for i in expr.items])
        if isinstance(expr, ObjectLit):
            return {
                self.eval_expr(k, env): self.eval_expr(v, env)
                for k, v in expr.items
            }
        if isinstance(expr, Comprehension):
            out = []
            for env2 in self.eval_body(expr.body, env):
                try:
                    out.append(self.eval_expr(expr.head, env2))
                except _Undefined:
                    continue
            return out
        raise RegoError(f"rego: bad expression {expr!r}")

    def _ref_iter(self, ref: Ref, env: dict) -> Iterator[tuple[Any, dict]]:
        try:
            base = self.eval_expr(ref.base, env)
        except _Undefined:
            return

        def walk(value: Any, path: list[Any], e: dict) -> Iterator[tuple[Any, dict]]:
            if not path:
                yield value, e
                return
            seg, rest = path[0], path[1:]
            if isinstance(value, _ModuleVal):
                # imported-module field: resolve the rule in that module
                if not isinstance(seg, str):
                    return
                try:
                    rv = self._module_rule_value(value.module, seg)
                except _Undefined:
                    return
                yield from walk(rv, rest, e)
                return
            if isinstance(seg, Wildcard):
                if isinstance(value, dict):
                    for v in value.values():
                        yield from walk(v, rest, e)
                elif isinstance(value, (list, tuple)):
                    for v in value:
                        yield from walk(v, rest, e)
                return
            # `coll[x]` with x unbound BINDS x (rego semantics): set members
            # for partial-set results, keys for objects, indices for arrays.
            if (
                isinstance(seg, Var)
                and seg.name not in e
                and seg.name not in self.rules
                and seg.name not in self.imports
            ):
                if isinstance(value, _SetVal):
                    for v in value:
                        yield from walk(v, rest, {**e, seg.name: v})
                elif isinstance(value, dict):
                    for k, v in value.items():
                        yield from walk(v, rest, {**e, seg.name: k})
                elif isinstance(value, (list, tuple)):
                    for i, v in enumerate(value):
                        yield from walk(v, rest, {**e, seg.name: i})
                return
            if isinstance(seg, str):
                key: Any = seg
            else:
                try:
                    key = self.eval_expr(seg, e)
                except _Undefined:
                    return
            if isinstance(value, _SetVal):
                # bound lookup on a set: membership, yields the member
                if key in value:
                    yield from walk(key, rest, e)
                return
            if isinstance(value, dict):
                if key in value:
                    yield from walk(value[key], rest, e)
                return
            if isinstance(value, (list, tuple)):
                if isinstance(key, bool) or not isinstance(key, (int, float)):
                    return
                idx = int(key)
                if 0 <= idx < len(value):
                    yield from walk(value[idx], rest, e)
                return
            return

        yield from walk(base, ref.path, env)

    def _binop(self, op: str, lv: Any, rv: Any) -> Any:
        if op == "==":
            return lv == rv
        if op == "!=":
            return lv != rv
        if op == "in":
            if isinstance(rv, dict):
                return lv in rv
            return lv in (rv or [])
        if op in ("<", "<=", ">", ">="):
            try:
                if op == "<":
                    return lv < rv
                if op == "<=":
                    return lv <= rv
                if op == ">":
                    return lv > rv
                return lv >= rv
            except TypeError:
                raise _Undefined()
        if op == "+":
            if isinstance(lv, str) or isinstance(rv, str):
                return str(lv) + str(rv)
            if isinstance(lv, list):
                return lv + rv
            return lv + rv
        if op == "-":
            return lv - rv
        if op == "*":
            return lv * rv
        if op == "/":
            if rv == 0:
                raise _Undefined()
            return lv / rv
        if op == "%":
            return lv % rv
        raise RegoError(f"rego: bad operator {op}")

    def _call(self, name: str, args: list[Any], env: dict) -> Any:
        rule = self.rules.get(name)
        if rule is not None and rule.is_func:
            return self.call_function(rule, args)
        if "." in name:
            # imported-module function: kubernetes.isPrivileged(c)
            alias, _, fname = name.partition(".")
            if alias in self.imports:
                mod = self.registry.get(self.imports[alias])
                frule = mod.rules.get(fname) if mod else None
                if frule is None:
                    raise _Undefined()
                return self._module_eval(mod).call_function(frule, args)
        fn = _BUILTINS.get(name)
        if fn is None:
            raise RegoError(f"rego: unknown function {name!r}")
        return fn(args)


def _bi_object_get(args):
    obj, key, default = args[:3]
    # OPA accepts a path array key: object.get(o, ["a","b"], d) walks
    # nested objects/arrays (the trivy-checks lib/ helpers lean on this).
    if isinstance(key, (list, tuple)) and not isinstance(key, str):
        cur = obj
        for seg in key:
            if isinstance(cur, dict) and seg in cur:
                cur = cur[seg]
            elif (
                isinstance(cur, (list, tuple))
                and isinstance(seg, (int, float))
                and not isinstance(seg, bool)
                and 0 <= int(seg) < len(cur)
            ):
                cur = cur[int(seg)]
            else:
                return default
        return cur
    if isinstance(obj, dict):
        return obj.get(key, default)
    return default


def _bi_result_new(args):
    msg, cause = (args + [None, None])[:2]
    out = {"msg": msg, "startline": 0, "endline": 0}
    if isinstance(cause, dict):
        # Typed provider state (iac/providers): a value object carries its
        # own lowercase range keys; a struct nests them under
        # __defsec_metadata__ (pkg/iac/rego/convert naming).
        meta = cause
        if isinstance(cause.get("__defsec_metadata__"), dict):
            meta = cause["__defsec_metadata__"]
        for ok, keys in (
            ("startline", ("StartLine", "startline", "__startline__")),
            ("endline", ("EndLine", "endline", "__endline__")),
        ):
            for k in keys:
                if meta.get(k):
                    out[ok] = meta[k]
                    break
        if isinstance(meta.get("filepath"), str):
            out["filepath"] = meta["filepath"]
    return out


def _bi_time_parse_rfc3339(args):
    import datetime

    s = args[0]
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    try:
        dt = datetime.datetime.fromisoformat(s)
    except ValueError:
        raise _Undefined()
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return int(dt.timestamp() * 1e9)


def _bi_time_date(args):
    import datetime

    dt = datetime.datetime.fromtimestamp(
        args[0] / 1e9, tz=datetime.timezone.utc
    )
    return [dt.year, dt.month, dt.day]


def _bi_time_clock(args):
    import datetime

    dt = datetime.datetime.fromtimestamp(
        args[0] / 1e9, tz=datetime.timezone.utc
    )
    return [dt.hour, dt.minute, dt.second]


def _bi_time_add_date(args):
    import datetime

    ns, years, months, days = args
    dt = datetime.datetime.fromtimestamp(ns / 1e9, tz=datetime.timezone.utc)
    month0 = dt.month - 1 + int(months)
    year = dt.year + int(years) + month0 // 12
    month = month0 % 12 + 1
    day = min(
        dt.day,
        [31, 29 if year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)
         else 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31][month - 1],
    )
    dt = dt.replace(year=year, month=month, day=day)
    dt += datetime.timedelta(days=int(days))
    return int(dt.timestamp() * 1e9)


def _net(value: str):
    import ipaddress

    try:
        if "/" in value:
            return ipaddress.ip_network(value, strict=False)
        ip = ipaddress.ip_address(value)
        return ipaddress.ip_network(f"{ip}/{ip.max_prefixlen}")
    except ValueError:
        raise _Undefined()


def _bi_cidr_contains(args):
    net, other = _net(args[0]), _net(args[1])
    return other.subnet_of(net) if other.version == net.version else False


def _bi_cidr_intersects(args):
    a, b = _net(args[0]), _net(args[1])
    return a.overlaps(b) if a.version == b.version else False


def _bi_json_patch(args):
    import copy

    doc = copy.deepcopy(args[0])
    for op in args[1]:
        parts = [
            p.replace("~1", "/").replace("~0", "~")
            for p in op["path"].split("/")[1:]
        ]
        kind = op["op"]
        if not parts:
            if kind == "replace" or kind == "add":
                doc = op.get("value")
            continue
        cur = doc
        for p in parts[:-1]:
            cur = cur[int(p)] if isinstance(cur, list) else cur[p]
        leaf = parts[-1]
        if isinstance(cur, list):
            idx = len(cur) if leaf == "-" else int(leaf)
            if kind == "add":
                cur.insert(idx, op.get("value"))
            elif kind == "remove":
                cur.pop(idx)
            elif kind == "replace":
                cur[idx] = op.get("value")
        else:
            if kind == "add" or kind == "replace":
                cur[leaf] = op.get("value")
            elif kind == "remove":
                cur.pop(leaf, None)
    return doc


_UNITS = {
    "": 1, "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12, "p": 10**15,
    "ki": 1 << 10, "mi": 1 << 20, "gi": 1 << 30, "ti": 1 << 40,
    "pi": 1 << 50,
}


def _bi_parse_bytes(args):
    s = str(args[0]).strip().lower().removesuffix("b")
    i = 0
    while i < len(s) and (s[i].isdigit() or s[i] in ".-"):
        i += 1
    num, unit = s[:i], s[i:].strip()
    if not num or unit not in _UNITS:
        raise _Undefined()
    return int(float(num) * _UNITS[unit])


def _bi_strings_replace_n(args):
    patterns, s = args
    for old, new in patterns.items():
        s = s.replace(old, new)
    return s


def _to_set_like(v):
    if isinstance(v, _SetVal):
        return list(v)
    return list(v or [])


def _bi_union(args):
    out: list = []
    for s in _to_set_like(args[0]):
        for x in _to_set_like(s):
            if x not in out:
                out.append(x)
    return _SetVal(out)


def _bi_intersection(args):
    sets = [_to_set_like(s) for s in _to_set_like(args[0])]
    if not sets:
        return _SetVal([])
    out = [x for x in sets[0] if all(x in s for s in sets[1:])]
    return _SetVal(out)


def _bi_object_union(args):
    out = dict(args[0])
    out.update(args[1])
    return out


def _bi_numbers_range(args):
    a, b = int(args[0]), int(args[1])
    step = 1 if b >= a else -1
    return list(range(a, b + step, step))


_BUILTINS = {
    "startswith": lambda a: isinstance(a[0], str) and a[0].startswith(a[1]),
    "endswith": lambda a: isinstance(a[0], str) and a[0].endswith(a[1]),
    "contains": lambda a: isinstance(a[0], str) and a[1] in a[0],
    "lower": lambda a: a[0].lower(),
    "upper": lambda a: a[0].upper(),
    "split": lambda a: a[0].split(a[1]),
    "trim": lambda a: a[0].strip(a[1]),
    "trim_space": lambda a: a[0].strip(),
    "trim_prefix": lambda a: a[0].removeprefix(a[1]),
    "trim_suffix": lambda a: a[0].removesuffix(a[1]),
    "replace": lambda a: a[0].replace(a[1], a[2]),
    "sprintf": lambda a: _sprintf(a[0], a[1]),
    "count": lambda a: len(a[0]),
    "concat": lambda a: a[0].join(a[1]),
    "format_int": lambda a: str(int(a[0])),
    "to_number": lambda a: float(a[0]) if "." in str(a[0]) else int(a[0]),
    "abs": lambda a: abs(a[0]),
    "is_string": lambda a: isinstance(a[0], str),
    "is_number": lambda a: isinstance(a[0], (int, float)) and not isinstance(a[0], bool),
    "is_boolean": lambda a: isinstance(a[0], bool),
    "is_null": lambda a: a[0] is None,
    "is_array": lambda a: isinstance(a[0], list),
    "is_object": lambda a: isinstance(a[0], dict),
    "object.get": lambda a: _bi_object_get(a),
    "array.concat": lambda a: list(a[0]) + list(a[1]),
    "regex.match": lambda a: bool(_re.search(a[0], a[1])),
    "re_match": lambda a: bool(_re.search(a[0], a[1])),
    "json.unmarshal": lambda a: json.loads(a[0]),
    "result.new": _bi_result_new,
    # --- r5 stdlib widening (with/time/net/regex/strings/json families,
    # the surface trivy-checks and OPA-test-idiom user policies hit) ---
    "indexof": lambda a: a[0].find(a[1]),
    "substring": lambda a: (
        a[0][a[1] :] if a[2] < 0 else a[0][a[1] : a[1] + a[2]]
    ),
    "ceil": lambda a: -(-int(a[0]) // 1) if a[0] == int(a[0]) else int(a[0]) + (1 if a[0] > 0 else 0),
    "floor": lambda a: int(a[0]) if a[0] >= 0 or a[0] == int(a[0]) else int(a[0]) - 1,
    "round": lambda a: int(a[0] + (0.5 if a[0] >= 0 else -0.5)),
    "sum": lambda a: sum(_to_set_like(a[0])),
    "product": lambda a: __import__("math").prod(_to_set_like(a[0])),
    "max": lambda a: max(_to_set_like(a[0])) if a[0] else _raise_undef(),
    "min": lambda a: min(_to_set_like(a[0])) if a[0] else _raise_undef(),
    "sort": lambda a: sorted(_to_set_like(a[0])),
    "all": lambda a: all(_to_set_like(a[0])),
    "any": lambda a: any(_to_set_like(a[0])),
    "union": _bi_union,
    "intersection": _bi_intersection,
    "numbers.range": _bi_numbers_range,
    "object.keys": lambda a: _SetVal(list(a[0].keys())),
    "object.union": _bi_object_union,
    "object.union_n": lambda a: {
        k: v for o in _to_set_like(a[0]) for k, v in (o or {}).items()
    },
    "object.remove": lambda a: {
        k: v for k, v in a[0].items() if k not in _to_set_like(a[1])
    },
    "object.filter": lambda a: {
        k: v for k, v in a[0].items() if k in _to_set_like(a[1])
    },
    "json.patch": _bi_json_patch,
    "json.marshal": lambda a: json.dumps(a[0], separators=(",", ":")),
    "yaml.unmarshal": lambda a: __import__("yaml").safe_load(a[0]),
    "base64.encode": lambda a: __import__("base64").b64encode(
        a[0].encode()
    ).decode(),
    "base64.decode": lambda a: __import__("base64").b64decode(
        a[0]
    ).decode(errors="replace"),
    "crypto.sha256": lambda a: __import__("hashlib").sha256(
        a[0].encode()
    ).hexdigest(),
    "crypto.md5": lambda a: __import__("hashlib").md5(
        a[0].encode()
    ).hexdigest(),
    "time.now_ns": lambda a: __import__("time").time_ns(),
    "time.parse_rfc3339_ns": _bi_time_parse_rfc3339,
    "time.date": _bi_time_date,
    "time.clock": _bi_time_clock,
    "time.add_date": _bi_time_add_date,
    "net.cidr_contains": _bi_cidr_contains,
    "net.cidr_intersects": _bi_cidr_intersects,
    "net.cidr_is_valid": lambda a: _cidr_valid(a[0]),
    "regex.find_n": lambda a: [
        m.group(0) for m in _re.finditer(a[0], a[1])
    ][: (len(a[1]) + 1 if a[2] < 0 else a[2])],
    "regex.split": lambda a: _re.split(a[0], a[1]),
    "regex.replace": lambda a: _re.sub(a[1], a[2], a[0]),
    "regex.is_valid": lambda a: _regex_valid(a[0]),
    "strings.replace_n": _bi_strings_replace_n,
    "strings.reverse": lambda a: a[0][::-1],
    "strings.count": lambda a: a[0].count(a[1]),
    "strings.any_prefix_match": lambda a: any(
        s.startswith(p)
        for s in _as_list(a[0])
        for p in _as_list(a[1])
    ),
    "strings.any_suffix_match": lambda a: any(
        s.endswith(p)
        for s in _as_list(a[0])
        for p in _as_list(a[1])
    ),
    "units.parse_bytes": _bi_parse_bytes,
    "units.parse": _bi_parse_bytes,
}


def _raise_undef():
    raise _Undefined()


def _as_list(v):
    return [v] if isinstance(v, str) else _to_set_like(v)


def _cidr_valid(s: str) -> bool:
    import ipaddress

    try:
        ipaddress.ip_network(s, strict=False)
        return True
    except ValueError:
        return False


def _regex_valid(s: str) -> bool:
    try:
        _re.compile(s)
        return True
    except _re.error:
        return False


class RegoEngine:
    """Loads modules and evaluates their deny rules against an input doc."""

    def __init__(self) -> None:
        self.modules: list[RegoModule] = []

    def load(self, src: str, source_path: str = "") -> RegoModule:
        mod = parse_module(src, source_path)
        self.modules.append(mod)
        return mod

    def eval_deny(
        self, module: RegoModule, input_doc: Any, data: Any | None = None
    ) -> list[Any]:
        ev = _Evaluator(input_doc, module.rules, data)
        return ev.eval_set_rule("deny")
