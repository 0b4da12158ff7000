r"""Translate Go (RE2) regex patterns to Python `re` patterns over bytes.

Copied from `trivy_tpu/engine/goregex.py`: the port imports nothing from the JAX
package, so it keeps its own copy of this jax-free module.

The reference engine compiles rules with Go's ``regexp`` package (RE2 syntax,
pkg/fanal/secret/scanner.go:61-82).  To reproduce its matches byte-for-byte with
Python's ``re`` on bytes, a few dialect differences must be bridged:

1. **Inline flag scope.** In Go, a mid-pattern ``(?i)`` applies from that point
   to the end of the *enclosing group*; Python only allows global inline flags
   at the very start of a pattern.  We rewrite ``X(?i)Y`` → ``X(?i:Y)`` with the
   correct lexical scope (used by e.g. the `adobe-client-secret` rule
   ``(p8e-)(?i)[a-z0-9]{32}``, builtin-rules.go:293).

2. **``$`` semantics.** Without ``(?m)``, Go's ``$`` matches only at the end of
   the text; Python's ``$`` also matches before a trailing newline.  We rewrite
   ``$`` → ``\Z`` outside multiline scope.  Similarly Go ``\z`` → Python ``\Z``.

3. **``\s`` class.** RE2's ``\s`` is ``[\t\n\f\r ]``; Python's bytes ``\s`` also
   includes ``\v`` (0x0b).  We expand ``\s``/``\S`` explicitly.

Known, documented divergences (irrelevant for the builtin corpus, which is
pure-ASCII, and for content that passes the binary sniff):
  * Go does full Unicode case folding under ``(?i)``; Python bytes patterns
    fold ASCII only.
  * Go treats invalid UTF-8 bytes as U+FFFD for ``.`` and negated classes.
"""

from __future__ import annotations

import re

# RE2 \s (https://github.com/google/re2/wiki/Syntax): [\t\n\f\r ]
_RE2_SPACE = r"\t\n\f\r "
_RE2_NOT_SPACE_CLASS = r"[^\t\n\f\r ]"
_RE2_SPACE_CLASS = r"[\t\n\f\r ]"

_FLAG_CHARS = set("imsU")


class GoRegexError(ValueError):
    pass


def _parse_inline_flags(s: str, i: int) -> tuple[str, str, int] | None:
    """If s[i:] starts an inline-flag construct ``(?flags)`` or ``(?flags:``,
    return (set_flags, clear_flags, end_index_after_construct_open).

    Returns None if this is not a flag construct.
    """
    if not s.startswith("(?", i):
        return None
    j = i + 2
    set_flags = ""
    clear_flags = ""
    clearing = False
    while j < len(s):
        c = s[j]
        if c in _FLAG_CHARS:
            if clearing:
                clear_flags += c
            else:
                set_flags += c
            j += 1
        elif c == "-" and not clearing:
            clearing = True
            j += 1
        elif c in ":)":
            if not set_flags and not clear_flags:
                return None  # e.g. "(?:" plain non-capturing, or "(?P<"
            return set_flags, clear_flags, j
        else:
            return None
    return None


def _apply_flags(flags: frozenset[str], set_f: str, clear_f: str) -> frozenset[str]:
    out = set(flags)
    out.update(set_f)
    out.difference_update(clear_f)
    return frozenset(out)


def _flag_group_prefix(set_f: str, clear_f: str) -> str:
    if "U" in set_f or "U" in clear_f:
        raise GoRegexError("ungreedy flag (?U) is not supported")
    if clear_f:
        return f"(?{set_f}-{clear_f}:" if set_f else f"(?-{clear_f}:"
    return f"(?{set_f}:"


def _translate_class(s: str, i: int) -> tuple[str, int]:
    """Translate a character class starting at s[i] == '['. Returns (text, next_i)."""
    out = ["["]
    j = i + 1
    if j < len(s) and s[j] == "^":
        out.append("^")
        j += 1
    if j < len(s) and s[j] == "]":
        out.append("\\]")  # leading ']' is a literal in Go and Python alike; escape for safety
        j += 1
    while j < len(s):
        c = s[j]
        if c == "]":
            out.append("]")
            return "".join(out), j + 1
        if c == "\\":
            if j + 1 >= len(s):
                raise GoRegexError("trailing backslash in class")
            nxt = s[j + 1]
            if nxt == "s":
                out.append(_RE2_SPACE)
            elif nxt == "S":
                raise GoRegexError(r"\S inside a character class is not supported")
            elif nxt == "d":
                out.append("0-9")
            elif nxt == "w":
                out.append("0-9A-Za-z_")
            elif nxt in ("D", "W"):
                raise GoRegexError(rf"\{nxt} inside a character class is not supported")
            elif nxt == "p" or nxt == "P":
                raise GoRegexError("unicode classes \\p are not supported")
            else:
                out.append("\\" + nxt)
            j += 2
            continue
        if c == "[" and s.startswith("[:", j):
            raise GoRegexError("POSIX classes [:...:] are not supported")
        out.append(c)
        j += 1
    raise GoRegexError("unterminated character class")


_DUP_SEP = "__dup"


_DUP_SUFFIX_RE = re.compile(rf"{_DUP_SEP}\d+$")


def base_group_name(name: str) -> str:
    """Heuristic original Go group name for a deduplicated Python group name.

    Prefer the explicit rename map from :func:`translate` — this suffix
    stripping cannot distinguish a renamed repeat from a user-authored group
    literally named e.g. ``secret__dup2``.  Kept for callers without access
    to the translation's rename map.
    """
    return _DUP_SUFFIX_RE.sub("", name)


def _translate(
    s: str,
    i: int,
    flags: frozenset[str],
    seen_names: dict[str, int],
    renames: dict[str, str],
) -> tuple[str, int]:
    """Translate until an unmatched ')' (not consumed) or end of string."""
    out: list[str] = []
    while i < len(s):
        c = s[i]
        if c == ")":
            return "".join(out), i
        if c == "\\":
            if i + 1 >= len(s):
                raise GoRegexError("trailing backslash")
            nxt = s[i + 1]
            if nxt == "s":
                out.append(_RE2_SPACE_CLASS)
            elif nxt == "S":
                out.append(_RE2_NOT_SPACE_CLASS)
            elif nxt == "z":
                out.append(r"\Z")
            elif nxt in ("p", "P"):
                raise GoRegexError("unicode classes \\p are not supported")
            elif nxt == "Q":
                raise GoRegexError(r"\Q...\E quoting is not supported")
            else:
                out.append("\\" + nxt)
            i += 2
            continue
        if c == "[":
            text, i = _translate_class(s, i)
            out.append(text)
            continue
        if c == "$":
            out.append("$" if "m" in flags else r"\Z")
            i += 1
            continue
        if c == "(":
            fl = _parse_inline_flags(s, i)
            if fl is not None:
                set_f, clear_f, j = fl
                new_flags = _apply_flags(flags, set_f, clear_f)
                prefix = _flag_group_prefix(set_f, clear_f)
                if s[j] == ")":
                    # Scoped to remainder of the enclosing group: wrap the rest.
                    rest, k = _translate(s, j + 1, new_flags, seen_names, renames)
                    out.append(prefix + rest + ")")
                    return "".join(out), k
                # "(?flags: ... )" group
                body, k = _translate(s, j + 1, new_flags, seen_names, renames)
                if k >= len(s) or s[k] != ")":
                    raise GoRegexError("unterminated group")
                out.append(prefix + body + ")")
                i = k + 1
                continue
            # Other group forms: "(?:", "(?P<name>", "(?P=name" (unsupported), "("
            if s.startswith("(?:", i):
                prefix, body_start = "(?:", i + 3
            elif s.startswith("(?P<", i):
                end = s.index(">", i)
                name = s[i + 4 : end]
                n = seen_names.get(name, 0)
                seen_names[name] = n + 1
                if n:
                    # Go RE2 allows duplicate group names; Python re does
                    # not.  Pick an unused dedup name (a user-authored group
                    # may already occupy name__dupN) and record the rename.
                    cand = f"{name}{_DUP_SEP}{n}"
                    while cand in seen_names:
                        n += 1
                        cand = f"{name}{_DUP_SEP}{n}"
                    seen_names[cand] = 1
                    renames[cand] = name
                    name = cand
                prefix, body_start = f"(?P<{name}>", end + 1
            elif s.startswith("(?<", i) or s.startswith("(?'", i):
                raise GoRegexError("unsupported group syntax")
            elif s.startswith("(?P=", i) or s.startswith("(?=", i) or s.startswith("(?!", i):
                raise GoRegexError("lookaround/backreference not in RE2")
            else:
                prefix, body_start = "(", i + 1
            body, k = _translate(s, body_start, flags, seen_names, renames)
            if k >= len(s) or s[k] != ")":
                raise GoRegexError("unterminated group")
            out.append(prefix + body + ")")
            i = k + 1
            continue
        out.append(c)
        i += 1
    return "".join(out), i


def translate(pattern: str) -> tuple[str, dict[str, str]]:
    """Translate a Go RE2 pattern; returns (python pattern, rename map).

    The rename map sends each deduplicated Python group name back to its
    original Go name (duplicate names are legal in RE2, illegal in `re`);
    user-authored names are never entries in the map.
    """
    renames: dict[str, str] = {}
    text, i = _translate(pattern, 0, frozenset(), {}, renames)
    if i != len(pattern):
        raise GoRegexError(f"unbalanced ')' at {i} in {pattern!r}")
    return text, renames


def go_to_python(pattern: str) -> str:
    """Translate a Go RE2 pattern into an equivalent Python re pattern (str form)."""
    return translate(pattern)[0]


def compile_bytes(pattern: str) -> re.Pattern[bytes]:
    """Compile a Go RE2 pattern for matching over bytes content."""
    return re.compile(go_to_python(pattern).encode("utf-8"))


def compile_bytes_renamed(
    pattern: str,
) -> tuple[re.Pattern[bytes], dict[str, str]]:
    """compile_bytes plus the duplicate-group rename map (see translate)."""
    text, renames = translate(pattern)
    return re.compile(text.encode("utf-8")), renames


def compile_str(pattern: str) -> re.Pattern[str]:
    """Compile a Go RE2 pattern for matching over str (file paths)."""
    return re.compile(go_to_python(pattern))
