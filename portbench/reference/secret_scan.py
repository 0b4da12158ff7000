"""Plain reference of Trivy's secret `Scanner.Scan`, the yardstick of `correct`.

A straightforward reading of aquasecurity/trivy `pkg/fanal/secret/scanner.go`
(`Scan`, `FindLocations`, `FindSubmatchLocations`, `AllowLocation`, the
exclude `Blocks`, `censorLocation`, `toFinding`, `findLocation`) over the
frozen builtin rules in `builtin_rules.json`, with Python's `re` standing in
for Go's `regexp` through the small translation below.

It imports neither the program under test nor JAX, and takes nothing that
the program has made: the rules come from the JSON file beside it, the
inputs from the benchmark's generator.

A scan returns the file's findings in a canonical form (`canonical`):
`()` when there is none, else `(path, findings)` with each finding as the
tuple a user sees in Trivy's report.  The secret entry
(`portbench/entries/secret.py`) reduces the program's `Secret` results to
the same form.

As the reference a configuration names (its `reference` key, `secret_scan`),
the module gives `answers(config, items, control)`: the canonical answer of
each file under the builtin rules.  A configuration with other rules brings
a reference module of its own, which may build a `SecretScanner` over its
rules document.

Divergences from Go, none reachable on the benchmark's ASCII traffic: Python
folds case and matches `.` byte by byte, where Go folds Unicode and steps over
whole UTF-8 characters; `bytes.lower` lowers ASCII only.

`secret_group_spans=False` is the control of `correct` (PERF.md): where a rule
names a secret group it reports the whole match's span instead of the group's,
which is what a verifier that knows only where a match ends would report.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

RULES_FILE = Path(__file__).with_name("builtin_rules.json")
HIGHLIGHT_RADIUS = 2  # scanner.go secretHighlightRadius

_SPACE = r"\t\n\f\r "  # RE2's \s
_CLASS_ESCAPES = {"s": _SPACE, "d": "0-9", "w": "0-9A-Za-z_"}
_ESCAPES = {
    "s": f"[{_SPACE}]", "S": f"[^{_SPACE}]", "d": "[0-9]", "D": "[^0-9]",
    "w": "[0-9A-Za-z_]", "W": "[^0-9A-Za-z_]", "z": r"\Z",
}


def go_regex(pattern: str) -> str:
    """Python `re` source matching what Go's RE2 `pattern` matches.

    - `(?flags)` inside a group covers the rest of that group in Go; Python
      takes global flags only at the start, so it becomes `(?flags:rest)`.
    - `$` outside `(?m)` is the end of the text (`\\Z`), `\\z` likewise.
    - `\\s`, `\\d`, `\\w` and their negations are ASCII classes in RE2.
    """
    out, end = _group(pattern, 0, multiline=False)
    if end != len(pattern):
        raise ValueError(f"unbalanced ')' at {end} in {pattern!r}")
    return out


def _group(s: str, i: int, multiline: bool) -> tuple[str, int]:
    out: list[str] = []
    while i < len(s):
        c = s[i]
        if c == ")":
            return "".join(out), i
        if c == "\\":
            nxt = s[i + 1]
            out.append(_ESCAPES.get(nxt, "\\" + nxt))
            i += 2
        elif c == "[":
            text, i = _char_class(s, i)
            out.append(text)
        elif c == "$":
            out.append("$" if multiline else r"\Z")
            i += 1
        elif c == "(":
            text, i = _open(s, i, multiline, out)
            if text is None:  # `(?flags)`: the rest of the group was consumed
                return "".join(out), i
            out.append(text)
        else:
            out.append(c)
            i += 1
    return "".join(out), i


def _open(s: str, i: int, multiline: bool, out: list[str]) -> tuple[str | None, int]:
    m = re.match(r"\(\?([imsU]*)(?:-([imsU]*))?([:)])", s[i:])
    if m and (m.group(1) or m.group(2)):
        on, off, kind = m.group(1), m.group(2) or "", m.group(3)
        if "U" in on + off:
            raise ValueError("ungreedy mode is not used by the builtin rules")
        inner_ml = ("m" in on) or (multiline and "m" not in off)
        flags = on + (f"-{off}" if off else "")
        body, k = _group(s, i + m.end(), inner_ml)
        if kind == ")":
            out.append(f"(?{flags}:{body})")
            return None, k
        return f"(?{flags}:{body})", k + 1
    if s.startswith("(?:", i):
        head, start = "(?:", i + 3
    elif s.startswith("(?P<", i) or s.startswith("(?<", i):
        close = s.index(">", i)
        name = s[s.index("<", i) + 1 : close]
        head, start = f"(?P<{name}>", close + 1
    elif s.startswith("(?", i):
        raise ValueError(f"group syntax not in RE2: {s[i:i + 4]!r}")
    else:
        head, start = "(", i + 1
    body, k = _group(s, start, multiline)
    if k >= len(s):
        raise ValueError("unterminated group")
    return head + body + ")", k + 1


def _char_class(s: str, i: int) -> tuple[str, int]:
    out = ["["]
    j = i + 1
    if s[j] == "^":
        out.append("^")
        j += 1
    if s[j] == "]":
        out.append(r"\]")
        j += 1
    while s[j] != "]":
        c = s[j]
        if c == "\\":
            nxt = s[j + 1]
            if nxt in "SDW":
                raise ValueError("negated classes inside a class are not used")
            out.append(_CLASS_ESCAPES.get(nxt, "\\" + nxt))
            j += 2
            continue
        out.append("\\[" if c == "[" else c)  # a literal `[` in Go
        j += 1
    out.append("]")
    return "".join(out), j + 1


def _compile(pattern: str) -> re.Pattern[bytes]:
    return re.compile(go_regex(pattern).encode())


class AllowRule:
    def __init__(self, doc: dict):
        self.regex = _compile(doc["regex"]) if doc.get("regex") else None
        self.path = re.compile(go_regex(doc["path"])) if doc.get("path") else None


def _allows_path(rules: list[AllowRule], path: str) -> bool:
    return any(a.path is not None and a.path.search(path) for a in rules)


def _allows_match(rules: list[AllowRule], text: bytes) -> bool:
    return any(a.regex is not None and a.regex.search(text) for a in rules)


def _blocks(content: bytes, regexes: list[re.Pattern[bytes]]) -> list[tuple[int, int]]:
    return [(m.start(), m.end()) for rx in regexes for m in rx.finditer(content)]


class Rule:
    def __init__(self, doc: dict):
        self.id = doc["id"]
        self.category = doc.get("category", "")
        self.title = doc.get("title", "")
        self.severity = doc.get("severity") or "UNKNOWN"
        self.regex = _compile(doc["regex"])
        self.group = doc.get("secret-group-name", "")
        self.keywords = [k.lower().encode() for k in doc.get("keywords") or []]
        self.path = re.compile(go_regex(doc["path"])) if doc.get("path") else None
        self.allow_rules = [AllowRule(a) for a in doc.get("allow-rules") or []]
        self.exclude = [_compile(r) for r in (doc.get("exclude-block") or {}).get("regexes") or []]


class SecretScanner:
    """`scanner.go` `Scanner` over a rules file, or its parsed document: the
    rules, the global allow rules and the global exclude block."""

    def __init__(self, rules: Path | dict = RULES_FILE, secret_group_spans: bool = True):
        doc = rules if isinstance(rules, dict) else json.loads(Path(rules).read_text())
        self.rules = [Rule(r) for r in doc["rules"]]
        self.allow_rules = [AllowRule(a) for a in doc.get("allow-rules") or []]
        self.exclude = [_compile(r) for r in (doc.get("exclude-block") or {}).get("regexes") or []]
        self.secret_group_spans = secret_group_spans

    def _locations(self, rule: Rule, content: bytes) -> list[tuple[int, int]]:
        """FindLocations / FindSubmatchLocations, with AllowLocation."""
        locs = []
        for m in rule.regex.finditer(content):
            text = content[m.start() : m.end()]
            if _allows_match(self.allow_rules, text) or _allows_match(rule.allow_rules, text):
                continue
            if rule.group and self.secret_group_spans:
                for name, idx in rule.regex.groupindex.items():
                    if name == rule.group and m.start(idx) >= 0:
                        locs.append((m.start(idx), m.end(idx)))
            else:
                locs.append((m.start(), m.end()))
        return locs

    def scan(self, path: str, content: bytes) -> tuple:
        """The file's findings in the canonical form."""
        return canonical(path, self.findings(path, content))

    def findings(self, path: str, content: bytes) -> list[tuple]:
        """The file's findings as `_finding` tuples, the match line raw, in
        the order the rules found them."""
        if _allows_path(self.allow_rules, path):
            return []
        lowered = content.lower()
        global_blocks = None
        censored = None
        matched = []
        for rule in self.rules:
            if rule.path is not None and not rule.path.search(path):
                continue
            if _allows_path(rule.allow_rules, path):
                continue
            if rule.keywords and not any(k in lowered for k in rule.keywords):
                continue
            locs = self._locations(rule, content)
            if not locs:
                continue
            if global_blocks is None:
                global_blocks = _blocks(content, self.exclude)
            blocks = global_blocks + _blocks(content, rule.exclude)
            for start, end in locs:
                if any(b0 <= start and end <= b1 for b0, b1 in blocks):
                    continue
                matched.append((rule, start, end))
                if censored is None:
                    censored = bytearray(content)
                censored[start:end] = b"*" * (end - start)
        if not matched:
            return []
        final = bytes(censored)
        return [_finding(rule, start, end, final) for rule, start, end in matched]


def answers(config: dict, items, control: bool = False) -> list[tuple]:
    """The canonical answer of each `(path, content)` of `items` under the
    builtin rules; with `control`, the control's (whole-match spans where a
    rule names a secret group)."""
    scanner = SecretScanner(secret_group_spans=not control)
    return [scanner.scan(path, content) for path, content in items]


def canonical(path: str, findings: list[tuple]) -> tuple:
    """The form both sides are compared in: `()` or `(path, findings)`, the
    findings in Go's order (RuleID, then the raw match line), ties broken by
    the rest of the finding, since Go's `sort.Slice` leaves them unordered;
    the match line then as the report's text."""
    if not findings:
        return ()
    ordered = sorted(findings, key=lambda f: (f[0], f[6], f))
    return (path, tuple(f[:6] + (_text(f[6]),) + f[7:] for f in ordered))


def _text(raw: bytes) -> str:
    return raw.decode("utf-8", errors="replace")


def _finding(rule: Rule, start: int, end: int, content: bytes) -> tuple:
    """toFinding + findLocation: (rule id, category, severity, title, start
    line, end line, raw match line, code lines), each code line (number,
    content, highlighted, is cause, first cause, last cause)."""
    start_line = content.count(b"\n", 0, start)
    line_start = content.rfind(b"\n", 0, start) + 1
    line_end = content.find(b"\n", start)
    if line_end == -1:
        line_end = len(content)
    if line_end - line_start > 100:
        line_start = max(start - 30, 0)
        line_end = min(end + 20, len(content))
    end_line = start_line + content.count(b"\n", start, end)
    lines = content.split(b"\n")
    lo = max(start_line - HIGHLIGHT_RADIUS, 0)
    hi = min(end_line + HIGHLIGHT_RADIUS, len(lines))
    causes = [lo + i for i in range(hi - lo) if start_line <= lo + i <= end_line]
    code = tuple(
        (n + 1, _text(lines[n]), _text(lines[n]), n in causes,
         bool(causes) and n == causes[0], bool(causes) and n == causes[-1])
        for n in range(lo, hi)
    )
    return (rule.id, rule.category, rule.severity, rule.title, start_line + 1,
            end_line + 1, content[line_start:line_end], code)
