"""The `secret-license` configuration and its `license.monorepo` cell on the
CPU:

* the cell at 2,000 files of its tree runs `correct` through the harness on
  two seeds (`harness.run(device="cpu")`, in a fresh process as the harness
  runs), and not correct with an entry that drops one license verdict, with
  TF32-sized error (1e-3 of each score) in the similarity product, and with
  an engine whose license corpus (and so its digest) differs;
* the reference's license decision equals the program's `decide_findings(
  device="cpu")` on every planted LICENSE, on every notice (alone and heading
  a vendored file), and on texts edited to score either side of 0.9 and 0.99;
* the configuration names the corpus digest both sides compute;
* the `monorepo` shape gives every seed the same sizes, kinds and languages
  in another order, its LICENSE files and notices where the traffic puts
  them, and the tree it made before (a digest).

Tolerance: the comparison's own (names exact, confidences within one step of
their 4-place rounding, `_license_form.TOLERANCE`).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import compare, corpus, harness, loader
from portbench.corpus import make_tree
from portbench.reference import _license_form, license_scan

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELL = "license.monorepo"
TRAFFIC = json.loads((BENCH / "traffic" / "monorepo.json").read_text())
CONFIG = json.loads((BENCH / "configs" / "secret-license.json").read_text())
shape = loader.load("shapes", "monorepo")

# One run of the cell on the CPU in a fresh process; `{setup}` breaks it.
RUN = """\
import json, sys, time
sys.path.insert(0, {repo!r})
from portbench import harness
program = None
{setup}
rc = harness.run({cell!r}, {seed}, 0.5, False, t0=time.perf_counter(), device="cpu",
                 traffic_overrides={{"n_files": {files}}}, program=program,
                 reference_workers=2)
print(json.dumps({{"rc": rc}}))
"""

DROP_ONE = """\
from portbench import loader
entry = loader.load("entries", "programs")

class Dropping:  # the entry, with the first license verdict of each batch dropped

    build = staticmethod(entry.build)
    keep = staticmethod(entry.keep)
    answer = staticmethod(entry.answer)

    @staticmethod
    def scan(engine, files):
        out = entry.scan(engine, files)
        j = next(j for j, (_, licenses, _) in enumerate(out) if licenses)
        out[j] = (out[j][0], [], out[j][2])
        return out

program = Dropping
"""

TF32_ERROR = """\
import numpy as np
from trivy_tpu_torch.license import classifier
real = classifier.FullTextClassifier._matmul

def noisy(self, fps):
    sims = real(self, fps)
    sign = 1.0 - 2.0 * (np.arange(sims.shape[1]) % 2)
    return sims * (1.0 + 1e-3 * sign)

classifier.FullTextClassifier._matmul = noisy
"""

OTHER_CORPUS = """\
import torch
from trivy_tpu_torch.license import classifier
classifier._shared[torch.device("cpu")] = classifier.FullTextClassifier(
    extra={"LicenseRef-host": "This license text came with the host: copy freely."},
    device="cpu")
"""


def _run(seed: int, setup: str = "", files: int = 2000) -> dict:
    script = RUN.format(repo=str(ROOT), cell=CELL, seed=seed, setup=setup, files=files)
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    lines = [json.loads(line) for line in done.stdout.splitlines() if line.startswith("{")]
    assert lines[-1]["rc"] == 0, done.stderr[-4000:]
    return lines[-2]


@pytest.mark.parametrize("seed", [3_000_000_017, 2_147_483_659])
def test_the_cell_is_correct_on_the_cpu(seed):
    result = _run(seed)
    assert result["correct"] and result["failed"] == 0, result
    assert result["compared"]["mismatched_files"] == {"value": 0, "limit": 0}
    assert result["compared"]["missing_files"] == {"value": 0, "limit": 0}
    assert result["attempted"] >= 2000
    assert {"files_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("setup", [DROP_ONE, TF32_ERROR, OTHER_CORPUS],
                         ids=["drops-a-license", "tf32-sized-error", "other-corpus"])
def test_a_broken_license_half_is_not_correct(setup):
    result = _run(3_000_000_017, setup, files=1000)
    assert not result["correct"] and result["failed"] > 0, result
    number = result["compared"]["mismatched_files"]
    assert number["value"] > number["limit"]


def _program_rows(texts: list[str]) -> list[list[tuple]]:
    from trivy_tpu_torch.license.decide import decide_findings

    return [[(f.name, f.category, f.severity, f.confidence, f.link) for f in found]
            for found in decide_findings(texts, device="cpu")]


def _reference_rows(texts: list[str]) -> list[list[tuple]]:
    clf = license_scan.LicenseClassifier()
    return [[license_scan.finding(*v) for v in clf.decide(t, row)]
            for t, row in zip(texts, clf.cosines(texts))]


def _same(texts: list[str]) -> list[list[tuple]]:
    got, want = _program_rows(texts), _reference_rows(texts)
    for text, a, b in zip(texts, got, want):
        assert _license_form.answer((), a, 0) == _license_form.answer((), b, 0), (text[:80], a, b)
        assert [r[0] for r in a] == [r[0] for r in b]
    return want


def test_the_reference_decides_every_license_and_notice_as_the_program():
    rng = np.random.default_rng(5)
    licenses = [shape._copyright(rng) + "\n" + shape._text(n) for n in shape.license_names()]
    notices = [shape.notice(*spec) for spec in TRAFFIC["notices"]]
    code = corpus._build_pool(np.random.default_rng(3), "c", 1 << 16).decode()
    headed = [shape._comment(shape._copyright(rng) + "\n" + n, ext).decode() + "\n" + code[:size]
              for n in notices for ext, size in (("c", 200), ("py", 2000), ("js", 12000))]
    want = _same(licenses + notices + headed)
    assert sum(1 for w in want[:len(licenses)] if w) >= 20  # the corpus's own texts
    # the GNU and Apache notices by their phrases, MPL's Exhibit A by neither
    # tier ("v. 2.0"), the short texts by their cosine
    assert [w[0][0] if w else None for w in want[len(licenses):len(licenses) + len(notices)]] \
        == ["Apache-2.0", "GPL-2.0", "GPL-3.0", "LGPL-2.1", None, "MIT", "BSD-2-Clause",
            "BSD-3-Clause", "ISC"]


def _edge_texts() -> list[tuple[str, float]]:
    """Corpus texts with code appended, a character at a time, until their
    best cosine falls past each edge: the last text at or above it and the
    first below, with the reference's best cosine."""
    clf = license_scan.LicenseClassifier()
    code = corpus._build_pool(np.random.default_rng(9), "py", 1 << 16).decode()
    out = []
    for name in ("Apache-2.0", "GPL-2.0", "MPL-2.0", "BSD-2-Clause", "MIT"):
        base = shape._text(name) + "\n"
        for edge in (0.99, 0.9):
            lo, hi = 0, len(code)
            if _best(clf, base) < edge:
                continue
            while hi - lo > 1:  # best(lo) >= edge > best(hi)
                mid = (lo + hi) // 2
                lo, hi = (mid, hi) if _best(clf, base + code[:mid]) >= edge else (lo, mid)
            out += [(base + code[:k], _best(clf, base + code[:k])) for k in (lo, hi)]
    return out


def _best(clf, text: str) -> float:
    return float(clf.cosines([text]).max())


def test_the_reference_decides_texts_at_the_edges_as_the_program():
    edges = _edge_texts()
    near = [score for _, score in edges]
    assert any(0.99 <= s < 0.9905 for s in near) and any(0.985 < s < 0.99 for s in near)
    assert any(0.9 <= s < 0.905 for s in near) and any(0.895 < s < 0.9 for s in near)
    want = _same([text for text, _ in edges])
    for (_, score), w in zip(edges, want):
        if score >= 0.9:  # the cosine tier's verdict, at its rounded score
            assert w[0][3] == _license_form.Confidence(round(score, 4)), (score, w)
        else:  # the phrase tier's, or none
            assert not w or w[0][3] == 0.9, (score, w)


def test_the_configuration_names_the_corpus_both_sides_use():
    from trivy_tpu_torch.license.classifier import shared_classifier

    ref = license_scan.LicenseClassifier()
    assert ref.digest == shared_classifier("cpu").corpus_digest == CONFIG["corpus"]["digest"]
    assert ref.names == shared_classifier("cpu").names and len(ref.names) == 24
    assert CONFIG["entry"] == "programs" and CONFIG["reference"] == "license_scan"


def test_the_shape_gives_every_seed_the_same_work():
    t = {**TRAFFIC, "n_files": 3000}
    slots = 3000 - 3000 // t["license_every"]
    tables = [shape._table(t, seed, slots) for seed in (3, 3_200_000_016)]
    assert not np.array_equal(tables[0], tables[1])
    assert sorted(map(tuple, tables[0])) == sorted(map(tuple, tables[1]))
    kinds = np.bincount(tables[0][:, 1], minlength=len(shape.KINDS))
    assert list(kinds[:4]) == [round(t["mix"][k] * slots) for k in shape.KINDS[:4]]
    names = shape.license_names()
    for seed in (3, 3_200_000_016):
        tree = make_tree(t, seed)
        for i, (path, body) in enumerate(tree):
            if i % t["license_every"] == t["license_offset"]:
                k = i // t["license_every"]
                assert path == f"third_party/pkg{k}/LICENSE"
                assert body.decode().endswith(shape._text(names[k % len(names)]))
            elif "/vendor/" in path:
                assert body.startswith((b"/*\n * Copyright (c) ", b"# Copyright (c) "))
        assert sum("/vendor/" in p for p, _ in tree) == kinds[2]


def test_the_shape_makes_the_tree_it_made():
    assert compare.slice_digest(make_tree(TRAFFIC, 2_147_483_659, stop=300)) == \
        "14fd58b71fa2ac2ea083dd65b59f9100"


def test_the_cell_reads_its_files_by_name():
    cell = harness.load_cell(CELL)
    assert cell.workload["chips"] == 1 and cell.traffic["shape"] == "monorepo"
    assert [m["name"] for m in cell.end_to_end] == ["files_per_s", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {
        "program_sieve_s_per_scan", "program_verify_s_per_scan", "secret_resolve_s_per_scan",
        "license_fingerprint_s_per_scan", "license_classify_s_per_scan",
        "license_candidates_per_scan", "license_matmul_roofline_pct"}
    assert compare.reference_module(cell.config).answers is not None


def test_the_roofline_reader_counts_b14_from_the_counters():
    from types import SimpleNamespace

    b14 = loader.load("metrics", "_b14")
    reader = loader.load("metrics", "license_matmul_roofline_pct")
    assert b14.corpus_size() == 24
    rows, calls = 30_000, 2  # a scan
    want = 4.0 * (4096 * rows + calls * 24 * 4096 + 24 * rows) / 3.35e12
    assert b14.bound_s(rows, calls, 24) == pytest.approx(want)  # memory-bound
    assert b14.flops(rows, 24) / 67e12 < want
    trace = {"kernels": 4, "kernel_s": 4 * want, "program_kernels": 0, "files": 100}
    run = SimpleNamespace(devtrace=trace, n_files=100, scans=2.0,
                          stats={"license_classify_rows": 2 * rows, "license_classify_calls": 4})
    assert reader.read(run) == pytest.approx(25.0)
    for broken in ({"devtrace": None}, {"stats": {}},
                   {"devtrace": {**trace, "program_kernels": 1}}):
        assert reader.read(SimpleNamespace(**{**vars(run), **broken})) is None
