"""CPU oracle secret engine.

Copied from `trivy_tpu/engine/oracle.py`: the port imports nothing from the JAX
package, so it keeps its own copy of this jax-free module.

An exact re-implementation of the reference scan algorithm
(pkg/fanal/secret/scanner.go:371-537) in Python.  This is the differential-test
oracle for the TPU engine and the CPU fallback path — it must produce
byte-identical findings to Trivy's Go engine.

Algorithm per (file, ruleset), mirroring Scan (scanner.go:371-452):
  1. global allow-path check (:375-380)
  2. per rule: path match (:391), allow-path (:397), keyword prefilter (:403)
  3. FindLocations (:97-121) / FindSubmatchLocations for named groups (:123-143)
  4. allow-regex suppression of matched text (:145-148)
  5. exclude-block suppression (:417)
  6. cumulative censoring of match spans into a copied buffer (:425-430, :454-462)
  7. finding assembly with line numbers, truncated match line, +-2 context
     lines (:464-537)
  8. deterministic sort by (RuleID, Match) (:441-446)
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from trivy_tpu_torch.ftypes import Code, Line, Secret, SecretFinding
from trivy_tpu_torch.rules.model import (
    ExcludeBlock,
    Rule,
    RuleSet,
    SecretConfig,
    build_ruleset,
)

SECRET_HIGHLIGHT_RADIUS = 2  # scanner.go:479


@dataclass(frozen=True)
class Location:
    """Byte-offset span (scanner.go:223-226)."""

    start: int
    end: int

    def contains(self, other: "Location") -> bool:
        # scanner.go:228-230 Location.Match
        return self.start <= other.start and other.end <= self.end


class _Blocks:
    """Lazy exclude-region materialization (scanner.go:232-270)."""

    def __init__(self, content: bytes, regexes: list[re.Pattern[bytes]]):
        self._content = content
        self._regexes = regexes
        self._locs: list[Location] | None = None

    def match(self, loc: Location) -> bool:
        if self._locs is None:
            self._locs = [
                Location(m.start(), m.end())
                for rx in self._regexes
                for m in rx.finditer(self._content)
            ]
        return any(l.contains(loc) for l in self._locs)


class OracleScanner:
    """Mirrors secret.Scanner (scanner.go:23-26) on top of a RuleSet."""

    def __init__(self, ruleset: RuleSet | None = None, config: SecretConfig | None = None):
        self.ruleset = ruleset if ruleset is not None else build_ruleset(config)

    # -- scanner.go:50-58 Global helpers --
    def allow(self, match: bytes) -> bool:
        return self.ruleset.allow(match)

    def allow_path(self, path: str) -> bool:
        return self.ruleset.allow_path(path)

    # -- scanner.go:97-121 --
    def find_locations(self, rule: Rule, content: bytes) -> list[Location]:
        if rule.regex is None:
            return []
        if rule.secret_group_name:
            return self.find_submatch_locations(rule, content)
        locs = []
        for m in rule.regex.finditer(content):
            loc = Location(m.start(), m.end())
            if self.allow_location(rule, content, loc):
                continue
            locs.append(loc)
        return locs

    # -- scanner.go:123-143 --
    def find_submatch_locations(self, rule: Rule, content: bytes) -> list[Location]:
        assert rule.regex is not None
        out: list[Location] = []
        for m in rule.regex.finditer(content):
            whole = Location(m.start(), m.end())
            if self.allow_location(rule, content, whole):
                continue
            # getMatchSubgroupsLocations (scanner.go:150-163): spans of every
            # group whose name equals SecretGroupName.  Go allows duplicate
            # group names; the translator renames repeats and records the
            # renames (goregex.translate), which Rule.original_group_name
            # consults so user-authored lookalike names are never stripped.
            # Deliberate divergence: a group that did not participate in the
            # match (span -1) is skipped — the reference appends Location{-1,-1}
            # and would panic slicing it (latent bug, unreachable via builtins).
            for name in rule.regex.groupindex:
                if rule.original_group_name(name) == rule.secret_group_name:
                    if m.start(name) < 0:
                        continue
                    out.append(Location(m.start(name), m.end(name)))
        return out

    # -- scanner.go:145-148 --
    def allow_location(self, rule: Rule, content: bytes, loc: Location) -> bool:
        match = content[loc.start : loc.end]
        return self.allow(match) or rule.allow(match)

    # -- scanner.go:371-452 --
    def scan(
        self, file_path: str, content: bytes, rule_indices: list[int] | None = None
    ) -> Secret:
        """Scan content.  `rule_indices` optionally restricts the rule loop to a
        subset (in original order); findings are identical to a full scan as
        long as the subset contains every rule that actually matches — this is
        how device-sieve candidates are confirmed without re-running all rules.
        """
        if self.allow_path(file_path):
            return Secret(file_path=file_path)

        censored: bytearray | None = None
        matched: list[tuple[Rule, Location]] = []
        global_excluded = _Blocks(content, self.ruleset.exclude_block.regexes)
        lowered = content.lower()  # shared keyword-prefilter buffer

        rules = (
            self.ruleset.rules
            if rule_indices is None
            else [self.ruleset.rules[i] for i in rule_indices]
        )
        for rule in rules:
            if not rule.match_path(file_path):
                continue
            if rule.allow_path(file_path):
                continue
            if not rule.match_keywords(content, lowered):
                continue

            locs = self.find_locations(rule, content)
            if not locs:
                continue

            local_excluded = _Blocks(content, rule.exclude_block.regexes)
            for loc in locs:
                if global_excluded.match(loc) or local_excluded.match(loc):
                    continue
                matched.append((rule, loc))
                if censored is None:
                    censored = bytearray(content)
                censored[loc.start : loc.end] = b"*" * (loc.end - loc.start)

        if not matched:
            return Secret()

        final = bytes(censored) if censored is not None else content
        findings = [to_finding(rule, loc, final) for rule, loc in matched]
        findings.sort(key=SecretFinding.sort_key)
        return Secret(file_path=file_path, findings=findings)

    def scan_batch(self, items: list[tuple[str, bytes]]) -> list[Secret]:
        """`scan` over (path, content) blobs: the engines' batch interface."""
        return [self.scan(path, content) for path, content in items]


def to_finding(rule: Rule, loc: Location, content: bytes) -> SecretFinding:
    """scanner.go:464-477."""
    start_line, end_line, code, match_line = find_location(loc.start, loc.end, content)
    return SecretFinding(
        rule_id=rule.id,
        category=rule.category,
        severity=rule.severity if rule.severity else "UNKNOWN",
        title=rule.title,
        match=match_line.decode("utf-8", errors="replace"),
        match_bytes=match_line,
        start_line=start_line,
        end_line=end_line,
        code=code,
    )


def find_location(start: int, end: int, content: bytes) -> tuple[int, int, Code, bytes]:
    """scanner.go:481-537 — line numbers, truncated match line, context code.

    The match line is returned as raw bytes (Go keeps it as a string over the
    original bytes); callers decode for display but sort on the bytes."""
    start_line_num = content.count(b"\n", 0, start)

    line_start = content.rfind(b"\n", 0, start)
    if line_start == -1:
        line_start = 0
    else:
        line_start += 1

    line_end = content.find(b"\n", start)
    if line_end == -1:
        line_end = len(content)

    if line_end - line_start > 100:
        line_start = 0 if start - 30 < 0 else start - 30
        line_end = len(content) if end + 20 > len(content) else end + 20
    match_line = content[line_start:line_end]
    end_line_num = start_line_num + content.count(b"\n", start, end)

    code = Code()
    lines = content.split(b"\n")
    code_start = max(start_line_num - SECRET_HIGHLIGHT_RADIUS, 0)
    code_end = min(end_line_num + SECRET_HIGHLIGHT_RADIUS, len(lines))

    raw_lines = lines[code_start:code_end]
    found_first = False
    for i, raw in enumerate(raw_lines):
        text = raw.decode("utf-8", errors="replace")
        real_line = code_start + i
        in_cause = start_line_num <= real_line <= end_line_num
        code.lines.append(
            Line(
                number=code_start + i + 1,
                content=text,
                is_cause=in_cause,
                highlighted=text,
                first_cause=(not found_first) and in_cause,
                last_cause=False,
            )
        )
        found_first = found_first or in_cause
    for ln in reversed(code.lines):
        if ln.is_cause:
            ln.last_cause = True
            break

    return start_line_num + 1, end_line_num + 1, code, match_line
