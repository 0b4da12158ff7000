"""The traffic generator: source trees made from a traffic file and a seed.

A frozen copy of the repository's `bench_corpus.py` generators (token pools,
identifier synthesis, near-miss credential lines), cut loose from their
fixed sizes: a traffic file under `portbench/traffic/`
names a `shape` and its parameters, and `make_tree` builds the tree.

Every seed gets the same multiset of file sizes (and, for the config shape,
of near-miss counts), drawn from the file's `sizes_seed` and put in another
order by the run's seed; the text in each file, and which file gets which
size, follow the run's seed.  The kernel shape's token pool, which each file
is a slice of, comes from the file's `pool_seed`.  So two seeds do the same
amount of work on different bytes.

Shapes:
  kernel  a C source tree, a planted secret every `planted_every` files
  config  a hit-dense config/infra tree: near-miss credential lines in every
          file, a planted secret every `planted_every` files
  <name>  any other shape is the module `portbench/shapes/<name>.py`, whose
          `make(traffic, seed, stop)` builds the tree as `make_tree` does;
          it too may depend on nothing but the traffic file and the seed,
          since the reference's workers rebuild the tree from those

A planted secret is a true positive of one rule of the traffic file's
`planted_rules` (the rules file `portbench/reference/<planted_rules>.json`,
in the reference's JSON form; `builtin_rules` by default), the rules in turn
(`planted_secret`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench import loader

PLANTED_RULES = "builtin_rules"

# --- token pools -----------------------------------------------------------

_STEMS = (
    "buf size len state lock init free alloc read write open close list node "
    "next prev head tail page addr reg dev drv ctl cfg conf mod sub net sock "
    "pkt msg queue task proc thread irq dma mem map phys virt user kern sys "
    "file path name id idx count num max min total cur tmp ptr ref data info "
    "ctx desc attr flag mask bit word byte str char val ret err status code "
    "time clock timer delay wait event signal hash crypt key token auth sign "
    "cert sess sec pass word cred hand shake cache line block sector disk "
    "part vol fs ino dentry super mount ns pid tid uid gid cap prio sched "
    "load store fetch push pop get set add del ins rem find scan walk iter "
    "match test check valid parse fmt print log dbg warn panic assert trace "
).split()

_SUFFIXES = ["", "", "", "", "s", "_t", "_p", "er", "ed", "ing", "es", "ptr"]

_C_KEYWORDS = (
    "static int void const struct unsigned long char if else for while return "
    "switch case break continue goto sizeof typedef enum union extern inline "
    "u8 u16 u32 u64 s32 bool size_t ssize_t "
).split()

_PY_KEYWORDS = (
    "def class return import from if elif else for while try except with as "
    "lambda yield None True False self not and or in is raise pass assert "
).split()

_PUNCT_C = ["(", ")", "{", "}", "[", "]", ";", ",", " = ", " + ", " - ",
            " == ", " != ", " < ", " > ", "->", ".", " & ", " | ", " << ", "*"]
_PUNCT_PY = ["(", ")", "[", "]", ":", ",", " = ", " + ", " == ", " != ",
             ".", " % ", " in ", " if ", " else "]


def _identifiers(rng: np.random.Generator, n: int) -> list[bytes]:
    stems = rng.integers(0, len(_STEMS), size=(n, 2))
    sufs = rng.integers(0, len(_SUFFIXES), size=n)
    styles = rng.integers(0, 4, size=n)
    out = []
    for k in range(n):
        a, b = _STEMS[stems[k, 0]], _STEMS[stems[k, 1]]
        style = styles[k]
        if style == 0:
            name = a + "_" + b
        elif style == 1:
            name = a + b.capitalize()
        elif style == 2:
            name = a
        else:
            name = a.upper() + "_" + b.upper()
        out.append((name + _SUFFIXES[sufs[k]]).encode())
    return out


def _build_pool(rng: np.random.Generator, lang: str, size: int) -> bytes:
    """~`size` bytes of synthetic source with realistic token statistics."""
    idents = _identifiers(rng, 4000)
    if lang == "c":
        kw = [k.encode() for k in _C_KEYWORDS]
        punct = [p.encode() for p in _PUNCT_C]
        comment, eol = b"/* %s %s */", b";\n"
    else:
        kw = [k.encode() for k in _PY_KEYWORDS]
        punct = [p.encode() for p in _PUNCT_PY]
        comment, eol = b"# %s %s", b"\n"

    # token stream: weighted mix, ~55% identifiers, 20% punct, 15% keywords,
    # 5% literals, 5% structure
    tokens: list[bytes] = []
    n_lit = 400
    lits = [b'"%s"' % idents[int(i)] for i in rng.integers(0, len(idents), n_lit)]
    lits += [b"0x%08x" % int(v) for v in rng.integers(0, 2**32, n_lit)]
    lits += [b"%d" % int(v) for v in rng.integers(0, 4096, n_lit)]
    pools = (idents, punct, kw, lits)
    weights = np.array([0.55, 0.20, 0.15, 0.10])
    kinds = rng.choice(4, size=size // 8, p=weights)
    picks = rng.integers(0, 2**31, size=len(kinds))
    line_len = 0
    parts: list[bytes] = []
    total = 0
    for kind, pick in zip(kinds, picks):
        pool = pools[kind]
        tok = pool[pick % len(pool)]
        parts.append(tok)
        parts.append(b" ")
        line_len += len(tok) + 1
        total += len(tok) + 1
        if line_len > 60:
            if rng.random() < 0.06:
                c = comment % (
                    bytes(idents[pick % len(idents)]),
                    bytes(idents[(pick // 7) % len(idents)]),
                )
                parts.append(c)
                total += len(c)
            parts.append(eol)
            total += len(eol)
            line_len = 0
        if total >= size:
            break
    return b"".join(parts)


# --- planted secrets -------------------------------------------------------

_B62 = np.frombuffer(
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789", np.uint8
)


def _rand_chars(rng, alphabet: np.ndarray, n: int) -> bytes:
    return bytes(alphabet[rng.integers(0, len(alphabet), size=n)])


_UPPER_DIGIT = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789", np.uint8)

# One true-positive shape per rule of a rules file (the builtin ruleset,
# `portbench/reference/builtin_rules.json`, unless the traffic file names
# another in that folder): a line drawn from the rule's own regex, read in
# Go's syntax through the reference's translation, kept only where the
# reference over that file finds that rule in it.  Planted secrets cycle through the rules
# in the file's order, so a tree with as many planted files as rules holds
# every rule's shape.

_PRINTABLE = [chr(c) for c in range(0x20, 0x7F)]
_ALNUM = set("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789")
_OPEN_REPEAT = 48  # extra draws past the minimum of an unbounded repeat
_ATTEMPTS = 64
_RULES: dict[Path, list] = {}


def planted_rules(traffic: dict) -> Path:
    """The rules file whose rules `traffic`'s planted secrets are drawn from."""
    return loader.rules_file(traffic.get("planted_rules", PLANTED_RULES))


def _rules(rules_file: Path):
    """[(rule id, parsed regex, keywords, the reference's scanner)] of
    `rules_file`, built once a path (the path as given: a lookup makes no
    system call, which costs on a sandboxed host, once a planted file)."""
    rules_file = Path(rules_file)
    if rules_file not in _RULES:
        import json
        from re import _parser

        from portbench.reference.secret_scan import SecretScanner, go_regex

        doc = json.loads(rules_file.read_text())
        scanner = SecretScanner(doc)
        _RULES[rules_file] = [(r["id"], _parser.parse(go_regex(r["regex"])),
                               r.get("keywords") or [], scanner) for r in doc["rules"]]
    return _RULES[rules_file]


def _class_members(items) -> list[str]:
    from re import _constants as C

    negate = bool(items) and items[0][0] is C.NEGATE
    cats = {C.CATEGORY_DIGIT: str.isdigit, C.CATEGORY_SPACE: str.isspace,
            C.CATEGORY_WORD: lambda ch: ch.isalnum() or ch == "_",
            C.CATEGORY_NOT_DIGIT: lambda ch: not ch.isdigit(),
            C.CATEGORY_NOT_SPACE: lambda ch: not ch.isspace(),
            C.CATEGORY_NOT_WORD: lambda ch: not (ch.isalnum() or ch == "_")}

    def inside(ch):
        for op, av in items:
            if op is C.LITERAL and ord(ch) == av:
                return True
            if op is C.RANGE and av[0] <= ord(ch) <= av[1]:
                return True
            if op is C.CATEGORY and cats[av](ch):
                return True
        return False

    return [ch for ch in _PRINTABLE if inside(ch) != negate]


def _pick(rng, members: list[str]) -> str:
    alnum = [ch for ch in members if ch in _ALNUM]
    pool = alnum if alnum and rng.random() < 0.95 else members
    return pool[int(rng.integers(0, len(pool)))]


def _has_anchor(seq) -> bool:
    from re import _constants as C

    return any(op is C.AT for op, _ in seq)


def _blank(seq) -> bool:
    """Whether `seq` is one character class of blanks alone."""
    from re import _constants as C

    if len(seq) != 1 or seq[0][0] is not C.IN:
        return False
    members = _class_members(seq[0][1])
    return bool(members) and all(ch.isspace() for ch in members)


def _draw(rng, seq) -> str:
    """A string that the parsed regex `seq` matches, with the anchors left
    to the line it goes into."""
    from re import _constants as C

    out = []
    for op, av in seq:
        if op is C.LITERAL:
            out.append(chr(av))
        elif op is C.NOT_LITERAL:
            out.append(_pick(rng, [ch for ch in _PRINTABLE if ord(ch) != av]))
        elif op is C.ANY:
            out.append(" ")
        elif op is C.IN:
            out.append(_pick(rng, _class_members(av)))
        elif op in (C.MAX_REPEAT, C.MIN_REPEAT, C.POSSESSIVE_REPEAT):
            lo, hi, sub = av
            if _blank(sub):  # a run of blanks: one, or none where none will do
                hi = max(lo, 1)
            hi = lo + _OPEN_REPEAT if hi == C.MAXREPEAT else min(hi, lo + 64)
            out.extend(_draw(rng, sub) for _ in range(int(rng.integers(lo, hi + 1))))
        elif op is C.SUBPATTERN:
            out.append(_draw(rng, av[-1]))
        elif op is C.BRANCH:
            branches = [b for b in av[1] if not _has_anchor(b)] or av[1]
            out.append(_draw(rng, branches[int(rng.integers(0, len(branches)))]))
        elif op is C.AT:
            continue
        else:
            raise ValueError(f"no draw for regex op {op}")
    return "".join(out)


def planted_secret(rng: np.random.Generator, kind: int,
                   rules_file: Path = loader.rules_file(PLANTED_RULES)) -> bytes:
    """One planted secret line for rule `kind` (mod the number of rules of
    `rules_file`): a draw from the rule's regex, after one of its keywords
    where the draw holds none, that the reference finds as that rule on its
    own line."""
    rules = _rules(rules_file)
    rule_id, parsed, keywords, scanner = rules[kind % len(rules)]
    for _ in range(_ATTEMPTS):
        text = _draw(rng, parsed)
        if keywords and not any(k.lower() in text.lower() for k in keywords):
            text = f"{keywords[int(rng.integers(0, len(keywords)))]} = {text}"
        line = text.encode() + b"\n"
        found = scanner.scan("deploy/planted.env", line)
        if found and any(f[0] == rule_id for f in found[1]):
            return line
    raise ValueError(f"no line drawn from rule {rule_id} is found as it")


def _near_miss(rng: np.random.Generator, kind: int) -> bytes:
    """A credential-adjacent line that passes the keyword/gram screen but
    fails the full regex — the shape that makes the verify stage do real
    work (the reference pays its regex loop on exactly these lines)."""
    kind = kind % 6
    if kind == 0:  # AKIA prefix, too short for [A-Z0-9]{16}
        return b"arn_hint = AKIA" + _rand_chars(rng, _UPPER_DIGIT, 8) + b"...\n"
    if kind == 1:  # ghp_ prefix, 12 chars instead of 36
        return b"token_stub: ghp_" + _rand_chars(rng, _B62, 12) + b"\n"
    if kind == 2:  # sk_live_ too short
        return b"stripe_test = sk_live_" + _rand_chars(rng, _B62[:50], 6) + b"\n"
    if kind == 3:  # slack webhook path too short
        return b"url: https://hooks.slack.com/services/TEAM/HOOK\n"
    if kind == 4:  # private-key header inside prose, no key body
        return b"# docs mention BEGIN RSA PRIVATE KEY marker format\n"
    return b"ACCESS_KEY_ID placeholder, fill with AKIA value later\n"


# --- tree assembly -------------------------------------------------------

_KERNEL_DIRS = (
    "drivers/net drivers/gpu drivers/usb fs/ext4 fs/btrfs kernel/sched "
    "kernel/irq mm net/ipv4 net/core sound/pci arch/x86/kernel block "
    "crypto security/keys lib include/linux tools/perf"
).split()


def _slice_pool(pool: bytes, rng, size: int) -> bytes:
    off = int(rng.integers(0, max(1, len(pool) - size - 1)))
    return pool[off : off + size]


def _draws(traffic: dict, seed: int, columns: int = 1) -> np.ndarray:
    """[n_files, 1 + columns] int64: each file's size and, for `columns` > 1,
    its near-miss count, drawn from `sizes_seed` and permuted by `seed`."""
    n = int(traffic["n_files"])
    rng = np.random.default_rng(int(traffic["sizes_seed"]))
    sizes = rng.lognormal(np.log(traffic["size_median"]), traffic["size_sigma"], size=n)
    cols = [np.clip(sizes, traffic["size_min"], traffic["size_max"]).astype(np.int64)]
    if columns > 1:
        lo, hi = traffic["near_miss_per_file"]
        cols.append(rng.integers(lo, hi + 1, size=n))
    table = np.stack(cols, axis=1)
    return table[np.random.default_rng([int(seed), 1]).permutation(n)]


def _kernel(traffic: dict, seed: int, stop: int) -> list[tuple[str, bytes]]:
    rng = np.random.default_rng(int(seed))
    # The token pool holds the text's incidental keyword hits (an identifier
    # like `totalTail` holds alibaba's `LTAI`), which set the verify's work:
    # drawn from `pool_seed`, every seed slices the same pool in other places
    # and does the same work.
    pool = _build_pool(np.random.default_rng(int(traffic["pool_seed"])), "c",
                       int(traffic["pool_bytes"]))
    sizes = _draws(traffic, seed)[:, 0]
    every, offset = int(traffic["planted_every"]), int(traffic["planted_offset"])
    rules_file = planted_rules(traffic)
    out = []
    planted = 0
    for i in range(stop):
        d = _KERNEL_DIRS[i % len(_KERNEL_DIRS)]
        path = f"{d}/mod{i % 97}/f{i}.c"
        body = b"// SPDX-License-Identifier: GPL-2.0\n" + _slice_pool(pool, rng, int(sizes[i]))
        if every and i % every == offset:
            cut = body.rfind(b"\n", 0, len(body) // 2) + 1
            body = body[:cut] + planted_secret(rng, planted, rules_file) + body[cut:]
            planted += 1
        out.append((path, body))
    return out


def _config(traffic: dict, seed: int, stop: int) -> list[tuple[str, bytes]]:
    rng = np.random.default_rng(int(seed))
    pool = _build_pool(rng, "py", int(traffic["pool_bytes"]))
    draws = _draws(traffic, seed, columns=2)
    exts = traffic["extensions"]
    every, offset = int(traffic["planted_every"]), int(traffic["planted_offset"])
    rules_file = planted_rules(traffic)
    out = []
    planted = 0
    misses = 0
    for i in range(stop):
        path = f"deploy/env{i % 61}/cfg{i}{exts[i % len(exts)]}"
        body = _slice_pool(pool, rng, int(draws[i, 0]))
        lines = []
        for _ in range(int(draws[i, 1])):
            lines.append(_near_miss(rng, misses))
            misses += 1
        if every and i % every == offset:
            lines.append(planted_secret(rng, planted, rules_file))
            planted += 1
        cut = body.rfind(b"\n", 0, len(body) // 2) + 1
        out.append((path, body[:cut] + b"".join(lines) + body[cut:]))
    return out


SHAPES = {"kernel": _kernel, "config": _config}


def shape(name: str):
    """The function that makes trees of shape `name`: one of `SHAPES`, else the `make` of
    `portbench/shapes/<name>.py`."""
    if name in SHAPES:
        return SHAPES[name]
    return loader.load("shapes", name).make


def make_tree(traffic: dict, seed: int, stop: int | None = None) -> list[tuple[str, bytes]]:
    """The tree of `traffic` for `seed`: [(path, content)] in tree order;
    `stop` builds only the first `stop` files (the same bytes)."""
    n = int(traffic["n_files"])
    return shape(traffic["shape"])(traffic, seed, n if stop is None else min(stop, n))
