"""The comparison that decides `correct`: every answer of the window against
the plain reference the configuration names (its `reference` key: the
module `portbench/reference/<reference>.py`, with `answers(config, items,
control)`; `secret_scan` by default).

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

from portbench import loader

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


def reference_module(config: dict):
    """The configuration's reference, `portbench/reference/<reference>.py`."""
    return loader.load("reference", config.get("reference", "secret_scan"))


def reference_slice(config: dict, items, control: bool = False) -> list[tuple]:
    """The reference's canonical answers of `items` (the control's, with
    `control`), in a process that must hold nothing of the program."""
    out = reference_module(config).answers(config, items, control)
    held = loaded(PROGRAM_MODULES)
    if held:
        raise RuntimeError(f"the reference process loaded {held}")
    return out


def _tree_slice(config: dict, traffic: dict, seed: int, lo: int, hi: int,
                digest: str) -> list[tuple]:
    from portbench.corpus import make_tree

    items = make_tree(traffic, seed, stop=hi)[lo:hi]
    if slice_digest(items) != digest:
        raise RuntimeError(f"the reference's files {lo}:{hi} differ from the program's")
    return reference_slice(config, items)


def workers() -> int:
    return len(os.sched_getaffinity(0))


def reference_answers(config: dict, traffic: dict, seed: int, tree,
                      n_workers: int | None = None) -> list[tuple]:
    """The reference's canonical answer for every file of `tree`, computed
    over `n_workers` spawned processes, each joined before this returns."""
    n = len(tree)
    k = max(1, min(n_workers or workers(), n))
    bounds = [n * j // k for j in range(k + 1)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=k, mp_context=ctx) as pool:
        futs = [pool.submit(_tree_slice, config, traffic, seed, lo, hi,
                            slice_digest(tree[lo:hi]))
                for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
        parts = [f.result() for f in futs]
    return [answer for part in parts for answer in part]


def compare(expected: list[tuple], batches, answer) -> dict:
    """Every answer of the window against the reference's.  `batches` holds
    the entry's `keep` record of each batch the window sent, `answer` turns
    one kept answer into the canonical form.  Returns the counts and up to
    three mismatches to print."""
    compared = mismatched = missing = 0
    examples: list[dict] = []
    for idxs, n_answers, found in batches:
        if n_answers != len(idxs):
            missing += len(idxs)
            continue
        for pos, i in enumerate(idxs):
            compared += 1
            got = answer(found[pos]) if pos in found else ()
            if got != expected[i]:
                mismatched += 1
                if len(examples) < 3:
                    examples.append({"file": int(i), "program": repr(got)[:600],
                                     "reference": repr(expected[i])[:600]})
    return {"compared": compared, "mismatched": mismatched, "missing": missing,
            "examples": examples}
