"""The comparison that decides `correct`: every answer of the window against
the plain reference (`portbench/reference/secret_scan.py`).

The reference scans the whole tree once, after the window, in worker
processes started with `spawn` that import only the reference and the
generator: each rebuilds the tree from the traffic file and the seed up to
the end of its slice, checks the slice's digest against the bytes the
program was handed, and scans it.  So the reference never sees anything the
program made, and its cost stays out of set-up.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

from portbench.reference.secret_scan import SecretScanner, canonical

# Top-level module names the reference's workers must not hold.
PROGRAM_MODULES = ("trivy_tpu_torch", "trivy_tpu", "jax", "jaxlib", "flax")


def slice_digest(items) -> str:
    h = hashlib.blake2b(digest_size=16)
    for path, content in items:
        h.update(path.encode())
        h.update(len(content).to_bytes(8, "little"))
        h.update(content)
    return h.hexdigest()


def loaded(names, modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of `names`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".", 1)[0] in names)


def _reference_slice(traffic: dict, seed: int, lo: int, hi: int, digest: str,
                     control: bool) -> list[tuple]:
    from portbench.corpus import make_tree

    items = make_tree(traffic, seed, stop=hi)[lo:hi]
    if slice_digest(items) != digest:
        raise RuntimeError(f"the reference's files {lo}:{hi} differ from the program's")
    scanner = SecretScanner(secret_group_spans=not control)
    out = [scanner.scan(path, content) for path, content in items]
    held = loaded(PROGRAM_MODULES)
    if held:
        raise RuntimeError(f"the reference process loaded {held}")
    return out


def workers() -> int:
    return len(os.sched_getaffinity(0))


def reference_answers(traffic: dict, seed: int, tree, n_workers: int | None = None,
                      control: bool = False) -> list[tuple]:
    """The reference's canonical answer for every file of `tree` (the
    control's, with `control`), computed over `n_workers` spawned processes,
    each joined before this returns."""
    n = len(tree)
    k = max(1, min(n_workers or workers(), n))
    bounds = [n * j // k for j in range(k + 1)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=k, mp_context=ctx) as pool:
        futs = [pool.submit(_reference_slice, traffic, seed, lo, hi,
                            slice_digest(tree[lo:hi]), control)
                for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
        parts = [f.result() for f in futs]
    return [answer for part in parts for answer in part]


def program_answer(secret) -> tuple:
    """A `Secret` result of the program in the reference's canonical form;
    `("unordered", path)` when its findings break Go's order (RuleID, then
    the raw match line), `("garbled", path)` when a finding's match text is
    not its raw match line decoded."""
    findings = secret.findings
    if not findings:
        return ()
    keys = [(f.rule_id, f.match_bytes) for f in findings]
    if keys != sorted(keys):
        return ("unordered", secret.file_path)
    rows = []
    for f in findings:
        if f.match != f.match_bytes.decode("utf-8", errors="replace"):
            return ("garbled", secret.file_path)
        code = tuple((ln.number, ln.content, ln.highlighted, ln.is_cause, ln.first_cause,
                      ln.last_cause) for ln in f.code.lines)
        rows.append((f.rule_id, f.category, f.severity, f.title, f.start_line,
                     f.end_line, f.match_bytes, code))
    return canonical(secret.file_path, rows)


def keep(idxs, results) -> tuple:
    """What the comparison needs of one batch's answers: the file indices,
    the number of answers and those that carry findings (an answer without
    findings compares as `()`, whatever object it is), so the window does
    not hold every empty result for the collector to walk."""
    return idxs, len(results), {j: r for j, r in enumerate(results) if r.findings}


def compare(expected: list[tuple], batches) -> dict:
    """Every answer of the window against the reference's.  `batches` holds
    `keep`'s record of each batch the window sent.  Returns the counts and up
    to three mismatches to print."""
    compared = mismatched = missing = 0
    examples: list[dict] = []
    for idxs, n_answers, found in batches:
        if n_answers != len(idxs):
            missing += len(idxs)
            continue
        for pos, i in enumerate(idxs):
            compared += 1
            got = program_answer(found[pos]) if pos in found else ()
            if got != expected[i]:
                mismatched += 1
                if len(examples) < 3:
                    examples.append({"file": int(i), "program": repr(got)[:600],
                                     "reference": repr(expected[i])[:600]})
    return {"compared": compared, "mismatched": mismatched, "missing": missing,
            "examples": examples}
