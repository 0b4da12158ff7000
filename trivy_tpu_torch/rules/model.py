"""Secret-scanning rule model and config loading.

Mirrors the reference's rule/config semantics exactly
(pkg/fanal/secret/scanner.go:28-95, 191-221, 272-359) while compiling the Go
RE2 patterns through trivy_tpu_torch.engine.goregex so Python `re`
reproduces Go `regexp` matches.  A copy of `trivy_tpu/rules/model.py`: PyYAML
is imported only inside `load_config`, and the registry digest hook is gone.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field

from trivy_tpu_torch.engine import goregex

logger = logging.getLogger("trivy_tpu_torch.secret")


@dataclass
class AllowRule:
    """scanner.go:191-196 AllowRule."""

    id: str = ""
    description: str = ""
    regex: re.Pattern[bytes] | None = None
    path: re.Pattern[str] | None = None
    # Original Go-syntax patterns (for NFA compilation / serialization).
    regex_src: str = ""
    path_src: str = ""


@dataclass
class ExcludeBlock:
    """scanner.go:218-221 ExcludeBlock."""

    description: str = ""
    regexes: list[re.Pattern[bytes]] = field(default_factory=list)
    regex_srcs: list[str] = field(default_factory=list)


@dataclass
class Rule:
    """scanner.go:84-95 Rule."""

    id: str
    category: str = ""
    title: str = ""
    severity: str = ""
    regex: re.Pattern[bytes] | None = None
    keywords: list[str] = field(default_factory=list)
    path: re.Pattern[str] | None = None
    allow_rules: list[AllowRule] = field(default_factory=list)
    exclude_block: ExcludeBlock = field(default_factory=ExcludeBlock)
    secret_group_name: str = ""
    regex_src: str = ""
    path_src: str = ""
    # Python->Go group-name rename map from goregex.translate; None means
    # "unknown" (precompiled regex), {} means "no renames were needed".
    group_renames: dict[str, str] | None = None

    # ---- Matching helpers (scanner.go:165-189) ----

    def match_path(self, path: str) -> bool:
        return self.path is None or self.path.search(path) is not None

    def match_keywords(self, content: bytes, lowered: bytes | None = None) -> bool:
        if not self.keywords:
            return True
        low = lowered if lowered is not None else content.lower()
        for kw in self.keywords:
            if kw.lower().encode() in low:
                return True
        return False

    def allow_path(self, path: str) -> bool:
        return allow_rules_allow_path(self.allow_rules, path)

    def allow(self, match: bytes) -> bool:
        return allow_rules_allow(self.allow_rules, match)

    def original_group_name(self, name: str) -> str:
        """Go group name for a Python group name of this rule's regex.

        Uses the translator's explicit rename map (duplicate Go group names
        are renamed for Python `re`, recorded at parse time); a user-authored
        name that merely looks like a dedup name (e.g. ``secret__dup2``)
        maps to itself.  Rules built with a precompiled regex and no rename
        map fall back to the suffix heuristic.
        """
        if self.group_renames is None:
            return goregex.base_group_name(name)
        return self.group_renames.get(name, name)


def allow_rules_allow_path(rules: list[AllowRule], path: str) -> bool:
    """scanner.go:200-207."""
    return any(r.path is not None and r.path.search(path) for r in rules)


def build_combined_allow_path(
    rules: list[AllowRule],
) -> "re.Pattern[str] | None":
    """Union of the allow-rule path regexes as ONE compiled alternation —
    the O(files) gating fast path (one search instead of N; most paths
    match nothing, so every pattern used to run).  Returns None when any
    path rule lacks a translatable source or the joined pattern cannot
    compile (e.g. cross-rule group-name collisions): callers fall back to
    the per-rule loop."""
    pats = []
    for r in rules:
        if r.path is None:
            continue
        if not r.path_src:
            return None
        try:
            pats.append("(?:%s)" % goregex.go_to_python(r.path_src))
        except goregex.GoRegexError:
            return None
    if not pats:
        return None
    try:
        return re.compile("|".join(pats))
    except re.error:
        return None


def allow_rules_allow(rules: list[AllowRule], match: bytes) -> bool:
    """scanner.go:209-216."""
    return any(r.regex is not None and r.regex.search(match) for r in rules)



@dataclass
class SecretConfig:
    """scanner.go:28-42 Config (the trivy-secret.yaml schema)."""

    enable_builtin_rule_ids: list[str] = field(default_factory=list)
    disable_rule_ids: list[str] = field(default_factory=list)
    disable_allow_rule_ids: list[str] = field(default_factory=list)
    custom_rules: list[Rule] = field(default_factory=list)
    custom_allow_rules: list[AllowRule] = field(default_factory=list)
    exclude_block: ExcludeBlock = field(default_factory=ExcludeBlock)


@dataclass
class RuleSet:
    """The assembled global rule state (scanner.go:44-48 Global)."""

    rules: list[Rule] = field(default_factory=list)
    allow_rules: list[AllowRule] = field(default_factory=list)
    exclude_block: ExcludeBlock = field(default_factory=ExcludeBlock)
    # Lazy gating fast path (build_combined_allow_path); rebuilt never —
    # allow_rules are fixed after construction.
    _combined_allow_path: "re.Pattern[str] | None" = field(
        default=None, init=False, repr=False, compare=False
    )
    _combined_built: bool = field(
        default=False, init=False, repr=False, compare=False
    )

    def allow(self, match: bytes) -> bool:
        return allow_rules_allow(self.allow_rules, match)

    def allow_path(self, path: str) -> bool:
        if not self._combined_built:
            self._combined_allow_path = build_combined_allow_path(
                self.allow_rules
            )
            self._combined_built = True
        if self._combined_allow_path is not None:
            return self._combined_allow_path.search(path) is not None
        return allow_rules_allow_path(self.allow_rules, path)


def convert_severity(severity: str) -> str:
    """scanner.go:305-313."""
    if severity.lower() in ("low", "medium", "high", "critical", "unknown"):
        return severity.upper()
    logger.warning("Incorrect severity: %s", severity)
    return "UNKNOWN"


def _compile_bytes(src: str) -> re.Pattern[bytes]:
    return goregex.compile_bytes(src)


def _compile_str(src: str) -> re.Pattern[str]:
    return goregex.compile_str(src)


def _parse_allow_rule(d: dict) -> AllowRule:
    return AllowRule(
        id=d.get("id", ""),
        description=d.get("description", ""),
        regex=_compile_bytes(d["regex"]) if d.get("regex") else None,
        regex_src=d.get("regex", ""),
        path=_compile_str(d["path"]) if d.get("path") else None,
        path_src=d.get("path", ""),
    )


def _parse_exclude_block(d: dict | None) -> ExcludeBlock:
    if not d:
        return ExcludeBlock()
    srcs = d.get("regexes") or []
    return ExcludeBlock(
        description=d.get("description", ""),
        regexes=[_compile_bytes(s) for s in srcs],
        regex_srcs=list(srcs),
    )


def _parse_rule(d: dict) -> Rule:
    regex, renames = (
        goregex.compile_bytes_renamed(d["regex"]) if d.get("regex") else (None, {})
    )
    return Rule(
        id=d.get("id", ""),
        category=d.get("category", ""),
        title=d.get("title", ""),
        severity=d.get("severity", ""),
        regex=regex,
        regex_src=d.get("regex", ""),
        group_renames=renames,
        keywords=list(d.get("keywords") or []),
        path=_compile_str(d["path"]) if d.get("path") else None,
        path_src=d.get("path", ""),
        allow_rules=[_parse_allow_rule(a) for a in (d.get("allow-rules") or [])],
        exclude_block=_parse_exclude_block(d.get("exclude-block")),
        secret_group_name=d.get("secret-group-name", ""),
    )


def load_config(config_path: str) -> SecretConfig | None:
    """scanner.go:272-302 ParseConfig.

    Returns None when no config path is given or the file doesn't exist (use
    builtin rules only).
    """
    if not config_path:
        return None
    if not os.path.exists(config_path):
        logger.debug("No secret config detected: %s", config_path)
        return None

    import yaml

    logger.info("Loading the config file for secret scanning: %s", config_path)
    with open(config_path, encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}

    custom_rules = [_parse_rule(d) for d in (raw.get("rules") or [])]
    for r in custom_rules:
        r.severity = convert_severity(r.severity)

    return SecretConfig(
        enable_builtin_rule_ids=list(raw.get("enable-builtin-rules") or []),
        disable_rule_ids=list(raw.get("disable-rules") or []),
        disable_allow_rule_ids=list(raw.get("disable-allow-rules") or []),
        custom_rules=custom_rules,
        custom_allow_rules=[
            _parse_allow_rule(d) for d in (raw.get("allow-rules") or [])
        ],
        exclude_block=_parse_exclude_block(raw.get("exclude-block")),
    )


def build_ruleset(config: SecretConfig | None = None) -> RuleSet:
    """scanner.go:315-359 NewScanner rule assembly."""
    from trivy_tpu_torch.rules.builtin import BUILTIN_RULES, BUILTIN_ALLOW_RULES

    if config is None:
        return RuleSet(rules=list(BUILTIN_RULES), allow_rules=list(BUILTIN_ALLOW_RULES))

    enabled = list(BUILTIN_RULES)
    if config.enable_builtin_rule_ids:
        enabled = [r for r in enabled if r.id in config.enable_builtin_rule_ids]

    # Custom rules are enabled regardless of enable-builtin-rules.
    enabled = enabled + list(config.custom_rules)
    rules = [r for r in enabled if r.id not in config.disable_rule_ids]

    allow_rules = list(BUILTIN_ALLOW_RULES) + list(config.custom_allow_rules)
    allow_rules = [a for a in allow_rules if a.id not in config.disable_allow_rule_ids]

    return RuleSet(
        rules=rules,
        allow_rules=allow_rules,
        exclude_block=config.exclude_block,
    )
