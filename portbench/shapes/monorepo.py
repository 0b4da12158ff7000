"""Shape `monorepo`: a vendored monorepo as `trivy fs --scanners
secret,license --license-full` reads it, after `bench_corpus.py`
`make_monorepo_corpus` (BASELINE.json config #5), frozen and extended with
license texts and notices.

The traffic file sets the law (every key below is one of its keys):

- `n_files` files; every `license_every`-th (`i % license_every ==
  license_offset`) is `third_party/pkg<k>/LICENSE`: the packaged SPDX texts
  under `portbench/reference/licenses/` in turn, each under a seeded
  `Copyright (c) <year> <holder>` line;
- the others draw a size (log-normal `size_median`, `size_sigma`, clipped to
  `size_min`..`size_max`), a kind and a language from `sizes_seed`, in exact
  shares (`mix`: binary objects, markdown, vendored sources, tests; the rest
  first-party sources), put in another order by the run's seed, so every
  seed has the same multiset of (size, kind, language);
- every vendored source opens with a license notice in a comment, under a
  seeded copyright line: the `notices` in turn, each cut from its packaged
  text from the line holding the start marker to the first line after it
  holding the end marker (the whole text where the markers are null);
- every `planted_every`-th file that is neither binary, markdown nor a
  LICENSE (`planted_offset` first) holds a planted secret, the planted
  rules in turn (`corpus.planted_secret`), in the middle of its source;
- the source text is slices of pools made from `pool_seed`: `.c` and `.js`
  files slice C-like pools, `.py` files and markdown a Python-like one, so
  the text's incidental license anchors do not follow the run's seed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from portbench.corpus import _STEMS, _build_pool, _slice_pool, planted_rules, planted_secret

LICENSES = Path(__file__).resolve().parents[1] / "reference" / "licenses"
KINDS = ("binary", "markdown", "vendor", "test", "source")
DIRS = ("services/api services/auth services/billing web/src web/components pkg/server "
        "pkg/client internal/db internal/queue cmd/ctl lib/core scripts config "
        "deploy/k8s").split()
_TEXTS: dict[str, str] = {}


def _text(name: str) -> str:
    if name not in _TEXTS:
        _TEXTS[name] = (LICENSES / f"{name}.txt").read_text()
    return _TEXTS[name]


def license_names() -> list[str]:
    """The packaged SPDX texts, in the order LICENSE files take them."""
    return sorted(p.stem for p in LICENSES.glob("*.txt"))


def notice(name: str, start: str | None, end: str | None) -> str:
    """License `name`'s notice for a source file: the lines of its text from
    the one holding `start` to the first one after it holding `end`."""
    text = _text(name)
    if start is None:
        return text
    lines = text.splitlines()
    first = next(k for k, line in enumerate(lines) if start in line)
    last = next(k for k in range(first, len(lines)) if end in lines[k])
    return "\n".join(lines[first:last + 1]) + "\n"


def _comment(text: str, ext: str) -> bytes:
    if ext == "py":
        return "".join(f"# {line}".rstrip() + "\n" for line in text.splitlines()).encode()
    body = "".join(f" * {line}".rstrip() + "\n" for line in text.splitlines())
    return f"/*\n{body} */\n".encode()


def _copyright(rng) -> str:
    year = int(rng.integers(1995, 2026))
    a, b = rng.integers(0, len(_STEMS), size=2)
    return f"Copyright (c) {year} The {_STEMS[a].capitalize()}{_STEMS[b]} Authors\n"


def _table(traffic: dict, seed: int, slots: int) -> np.ndarray:
    """[slots, 3] int64: size, kind and language of each non-LICENSE file,
    drawn from `sizes_seed`, put in the run's seed's order."""
    rng = np.random.default_rng(int(traffic["sizes_seed"]))
    sizes = rng.lognormal(np.log(traffic["size_median"]), traffic["size_sigma"], size=slots)
    sizes = np.clip(sizes, traffic["size_min"], traffic["size_max"]).astype(np.int64)
    counts = [round(traffic["mix"][k] * slots) for k in KINDS[:-1]]
    kinds = rng.permutation(np.repeat(np.arange(len(KINDS)), counts + [slots - sum(counts)]))
    langs = rng.integers(0, 6, size=slots)
    table = np.stack([sizes, kinds, langs], axis=1)
    return table[np.random.default_rng([int(seed), 1]).permutation(slots)]


def make(traffic: dict, seed: int, stop: int) -> list[tuple[str, bytes]]:
    n = int(traffic["n_files"])
    every, offset = int(traffic["license_every"]), int(traffic["license_offset"])
    table = _table(traffic, seed, n - sum(1 for i in range(n) if i % every == offset))
    pool_rng = np.random.default_rng(int(traffic["pool_seed"]))
    pools = {lang: _build_pool(pool_rng, style, int(traffic["pool_bytes"]))
             for lang, style in (("c", "c"), ("py", "py"), ("js", "c"))}
    names = license_names()
    notices = [notice(*spec) for spec in traffic["notices"]]
    rules_file = planted_rules(traffic)
    plant_every, plant_offset = int(traffic["planted_every"]), int(traffic["planted_offset"])
    rng = np.random.default_rng([int(seed), 2])
    out: list[tuple[str, bytes]] = []
    slot = vendored = eligible = planted = 0
    for i in range(stop):
        if i % every == offset:
            k = i // every
            out.append((f"third_party/pkg{k}/LICENSE",
                        (_copyright(rng) + "\n" + _text(names[k % len(names)])).encode()))
            continue
        size, kind, lang = (int(x) for x in table[slot])
        slot += 1
        kind = KINDS[kind]
        if kind == "binary":
            out.append((f"build/obj/m{i % 50}/a{i}.o", b"\x7fELF\x02\x01\x01\x00"
                        + rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()))
            continue
        if kind == "markdown":
            out.append((f"docs/guide{i % 40}/page{i}.md",
                        b"# notes\n\n" + _slice_pool(pools["py"], rng, size)))
            continue
        if kind == "test":
            ext = ("py", "js")[lang % 2]
            path = f"services/api/tests/unit{i % 83}/test_{i}.{ext}"
        elif kind == "vendor":
            ext = ("js", "py", "c")[lang % 3]
            path = f"web/vendor/pkg{i % 211}/lib{i}.{ext}"
        else:
            ext = ("c", "py", "js")[lang % 3]
            path = f"{DIRS[i % len(DIRS)]}/m{i % 131}/f{i}.{ext}"
        body = _slice_pool(pools[ext], rng, size)
        if eligible % plant_every == plant_offset:
            cut = body.rfind(b"\n", 0, len(body) // 2) + 1
            body = body[:cut] + planted_secret(rng, planted, rules_file) + body[cut:]
            planted += 1
        eligible += 1
        if kind == "vendor":
            head = _copyright(rng) + "\n" + notices[vendored % len(notices)]
            body = _comment(head, ext) + b"\n" + body
            vendored += 1
        out.append((path, body))
    return out
