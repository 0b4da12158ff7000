"""The multi-program pass's tracing on the CPU (`engine/device.py`
`scan_programs`, `programs/license.py`, `license/classifier.py`,
`license/decide.py`):

* a traced `scan_programs` call opens `programs.scan` once, and inside it
  `programs.sieve`, `programs.verify` (holding the claim-killer's `verify`)
  and one `programs.resolve` a program, the program's id in `program`; the
  secret resolve holds `confirm`, the license resolve `license.fingerprint`,
  `license.classify` (holding the `kernel.license.classify` device phase)
  and `license.decide`, each once;
* the `SieveStats` counters (`program_sieve_s`, `program_verify_s`,
  `secret_resolve_s`, `license_resolve_s`, `license_fingerprint_s`,
  `license_classify_s`, `license_candidate_files`,
  `license_fingerprint_bytes`, `license_classify_rows`,
  `license_classify_calls`) sum over two calls, fill with tracing off, and
  each timed one holds its span's time;
* `license_candidate_files` equals the program table's
  `program_stats["license"]["candidate_files"]`, and `license_classify_rows`
  the rows the similarity product was given;
* `license_fingerprint_bytes` equals the UTF-8 bytes of the candidate texts
  the classifier was given, and the `license.fingerprint` span carries them
  as `bytes`.

Tolerance: span names, nesting and counts exact; a counter against its
spans: the counter's clock holds the span's, by at most 1 ms a call.
"""

import pytest
import torch

import bench_corpus
from trivy_tpu_torch.license import classifier
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import trace as obs_trace
from trivy_tpu_torch.programs import make_program_engine

TIMED = {"program_sieve_s": "programs.sieve", "program_verify_s": "programs.verify",
         "license_fingerprint_s": "license.fingerprint",
         "license_classify_s": "license.classify"}
COUNTERS = tuple(TIMED) + ("secret_resolve_s", "license_resolve_s",
                           "license_candidate_files", "license_fingerprint_bytes",
                           "license_classify_rows", "license_classify_calls")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tracing():
    obs_trace.clear()
    obs_trace.enable()
    yield
    obs_trace.disable()
    obs_trace.clear()
    obs_metrics.drain_device_phases()


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    eng = make_program_engine(device="cpu",
                              rules_cache_dir=str(tmp_path_factory.mktemp("rules")))
    eng.warmup()
    return eng


@pytest.fixture
def rows(monkeypatch):
    """The row count of every similarity product, as it is called."""
    seen: list[int] = []
    real = classifier.FullTextClassifier._matmul

    def counted(self, fps):
        seen.append(int(fps.shape[0]))
        return real(self, fps)

    monkeypatch.setattr(classifier.FullTextClassifier, "_matmul", counted)
    return seen


def _items(seed: int) -> list[tuple[str, bytes]]:
    """Monorepo files (planted secrets, vendored and test paths) and two
    license texts, so both programs have candidates."""
    clf = classifier.shared_classifier("cpu")
    items = bench_corpus.make_monorepo_corpus(160, seed=seed, planted_every=20)
    return items + [(f"third_party/{name}/LICENSE", clf.corpus_text(name).encode())
                    for name in ("Apache-2.0", "MIT")]


def _counters(engine) -> dict:
    return {c: getattr(engine.stats, c) for c in COUNTERS}


def test_a_traced_call_nests_each_span_once(engine, tracing):
    engine.scan_programs(_items(3))
    spans = obs_trace.snapshot()
    by_id = {s.span_id: s for s in spans}
    [root] = [s for s in spans if s.name == "programs.scan"]
    assert root.parent_id == 0 and root.attrs["files"] == 162
    assert root.attrs["bytes"] == sum(len(c) for _, c in _items(3))

    def parent(s):
        return by_id[s.parent_id]

    names = [s.name for s in spans if s.tid == root.tid]
    for name in ("programs.sieve", "programs.verify", "license.fingerprint",
                 "license.classify", "kernel.license.classify", "license.decide"):
        assert names.count(name) == 1, name
    for name in ("programs.sieve", "programs.verify"):
        [s] = [s for s in spans if s.name == name]
        assert parent(s) is root
    resolves = {s.attrs["program"]: s for s in spans if s.name == "programs.resolve"}
    assert sorted(resolves) == ["license", "secret"] and names.count("programs.resolve") == 2
    assert all(parent(s) is root for s in resolves.values())
    [verify] = [s for s in spans if s.name == "verify"]
    assert parent(verify).name == "programs.verify"
    [confirm] = [s for s in spans if s.name == "confirm"]
    assert parent(confirm) is resolves["secret"]
    for name in ("license.fingerprint", "license.classify", "license.decide"):
        [s] = [s for s in spans if s.name == name]
        assert parent(s) is resolves["license"], name
    [phase] = [s for s in spans if s.name == "kernel.license.classify"]
    assert parent(phase).name == "license.classify"
    for s in spans:  # every span inside its parent's interval
        if s.parent_id in by_id:
            p = parent(s)
            assert p.start <= s.start and s.start + s.dur <= p.start + p.dur, s.name
    order = [s.name for s in sorted((s for s in spans if s.parent_id == root.span_id),
                                    key=lambda s: s.start)]
    assert order == ["programs.sieve", "programs.verify", "programs.resolve",
                     "programs.resolve"]


def test_counters_sum_over_calls_and_hold_their_spans(engine, tracing, rows):
    before = _counters(engine)
    per_call = []
    for seed in (5, 6):
        start = _counters(engine)
        engine.scan_programs(_items(seed))
        per_call.append({c: getattr(engine.stats, c) - start[c] for c in COUNTERS})
    total = {c: getattr(engine.stats, c) - before[c] for c in COUNTERS}
    for c in COUNTERS:
        assert total[c] == pytest.approx(sum(call[c] for call in per_call), rel=1e-9), c
        assert all(call[c] > 0 for call in per_call), c
    assert total["license_classify_calls"] == 2 == len(rows)
    assert total["license_classify_rows"] == sum(rows)
    spans = obs_trace.snapshot()
    for counter, name in TIMED.items():
        got = sum(s.dur for s in spans if s.name == name)
        assert got <= total[counter] <= got + 2e-3, counter
    for program in ("secret", "license"):
        got = sum(s.dur for s in spans
                  if s.name == "programs.resolve" and s.attrs["program"] == program)
        assert got <= total[f"{program}_resolve_s"] <= got + 2e-3, program


def test_license_counts_match_the_table_and_the_product(engine, rows):
    obs_trace.clear()
    cand0 = engine.program_stats.get("license", {}).get("candidate_files", 0)
    before = _counters(engine)
    engine.scan_programs(_items(7))
    after = _counters(engine)
    files = after["license_candidate_files"] - before["license_candidate_files"]
    assert files == engine.program_stats["license"]["candidate_files"] - cand0 > 2
    assert after["license_classify_rows"] - before["license_classify_rows"] == rows[-1] == files
    assert after["program_sieve_s"] > before["program_sieve_s"]  # filled with tracing off
    assert obs_trace.snapshot() == []


def test_fingerprint_bytes_are_the_candidates_utf8_bytes(engine, tracing, monkeypatch):
    seen: list[list[str]] = []
    real = classifier.FullTextClassifier.classify_batch

    def recorded(self, texts, *args, **kwargs):
        seen.append(list(texts))
        return real(self, texts, *args, **kwargs)

    monkeypatch.setattr(classifier.FullTextClassifier, "classify_batch", recorded)
    before = _counters(engine)
    engine.scan_programs(_items(8))
    after = _counters(engine)
    [texts] = seen
    want = sum(len(t.encode("utf-8", "surrogatepass")) for t in texts)
    assert len(texts) == after["license_candidate_files"] - before["license_candidate_files"]
    assert after["license_fingerprint_bytes"] - before["license_fingerprint_bytes"] == want > 0
    [span] = [s for s in obs_trace.snapshot() if s.name == "license.fingerprint"]
    assert span.attrs == {"texts": len(texts), "bytes": want}


def test_a_call_without_license_candidates_counts_no_product(engine, rows):
    before = _counters(engine)
    out = engine.scan_programs([("src/a.c", b"int main(void) { return 0; }\n")])
    after = _counters(engine)
    assert out["license"] == [[]] and rows == []
    assert after["license_candidate_files"] == before["license_candidate_files"]
    assert after["license_fingerprint_bytes"] == before["license_fingerprint_bytes"]
    assert after["license_classify_calls"] == before["license_classify_calls"]
    assert after["program_sieve_s"] > before["program_sieve_s"]
