"""The port's license classifier and decision tree
(`trivy_tpu_torch/license/`, on the CPU) against the JAX package's
(`trivy_tpu/license/`):

* the corpus matrix, its `names` and `corpus_digest` are bit-equal (the
  packaged texts are the reference's, byte for byte);
* `classify_batch` gives equal `Match`es on every corpus text, on truncated
  and edited texts and on the AGPL-3.0-vs-GPL-3.0 veto; the raw cosine
  scores of torch's CPU matmul are within 1e-5 (absolute) of numpy's
  `fps @ matrix.T`, the reference's CPU product, whose summation order
  differs;
* `decide_findings` is equal, finding for finding;
* `anchor_tokens`, the phrase table and the license program's
  `verdict_digest` are equal;
* the classifier's default device is the card: without one it raises, and
  the product runs with TF32 held off and restored after.

Tolerance: exact, but for the raw scores (1e-5 absolute, above).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from trivy_tpu.license import classifier as ref_classifier
from trivy_tpu.license import phrases as ref_phrases
from trivy_tpu.license.decide import decide_findings as ref_decide
from trivy_tpu_torch.license import classifier, phrases
from trivy_tpu_torch.license.decide import decide_findings

SCORE_ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clfs():
    return ref_classifier.shared_classifier(), classifier.shared_classifier("cpu")


def _texts(clf) -> list[str]:
    """Every corpus text, each truncated to its first third, each with a
    line edited, the AGPL-3.0 case (GPL-3.0's text naming the Affero license
    and its network clause), phrase-only and non-license texts."""
    full = [clf.corpus_text(n) for n in clf.names]
    out = list(full)
    out += [t[: len(t) // 3] for t in full]
    out += [t.replace("the", "a", 5) + "\nlocal edit: vendored copy\n" for t in full]
    gpl3 = clf.corpus_text("GPL-3.0")
    out.append(gpl3.replace("GNU General Public License",
                            "GNU Affero General Public License")
               + "\n13. Remote Network Interaction; Use with the GNU General Public License.\n")
    out += [
        "Licensed under the Apache License, Version 2.0 (the License).",
        "SPDX: CC0 1.0 Universal, dedicated to the public domain.",
        "int main(void) { return 0; }",
        "",
        "copyright 2024 example corp",
    ]
    return out


def test_corpus_matrix_names_and_digest_are_the_reference(clfs):
    ref, port = clfs
    assert port.names == ref.names and len(port.names) == 24
    assert port.corpus_digest == ref.corpus_digest
    assert port.matrix.dtype == ref.matrix.dtype == np.float32
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    for name in port.names:
        assert port.corpus_text(name) == ref.corpus_text(name)
    assert isinstance(port._matrix_dev, torch.Tensor)
    assert port._matrix_dev.device.type == "cpu"


def test_classify_batch_matches_reference(clfs):
    ref, port = clfs
    texts = _texts(ref)
    got, want = port.classify_batch(texts), ref.classify_batch(texts)
    assert [dataclasses.astuple(m) if m else None for m in got] == [
        dataclasses.astuple(m) if m else None for m in want]
    # the edges are reached: exact corpus matches, near ones, rejections
    scores = [m.confidence for m in want if m]
    assert max(scores) >= 0.99 and min(scores) < 0.99 and None in want
    fps = np.stack([ref_classifier._fingerprint(ref_classifier.normalize_tokens(t))
                    for t in texts])
    np.testing.assert_allclose(port._matmul(fps), fps @ ref.matrix.T, rtol=0,
                               atol=SCORE_ATOL)
    assert port.classify_batch([]) == []
    assert port.classify(texts[0]).license == ref.classify(texts[0]).license


def test_decide_findings_matches_reference(clfs):
    texts = _texts(clfs[0])
    got = decide_findings(texts, device="cpu")
    want = ref_decide(texts)
    assert [[dataclasses.astuple(f) for f in fs] for fs in got] == [
        [dataclasses.astuple(f) for f in fs] for fs in want]
    # the corpus-blind veto named AGPL-3.0 over the GPL-3.0 corpus text
    assert any(fs and fs[0].name == "AGPL-3.0" for fs in got)
    assert decide_findings([], device="cpu") == []


_PHRASE_TABLES = """
import dataclasses, json
from trivy_tpu.license import phrases as ref_phrases
from trivy_tpu.programs import LicenseScanProgram as RefLicenseProgram
from trivy_tpu_torch.license import phrases
from trivy_tpu_torch.programs import LicenseScanProgram

text = "Apache License\\n  Version 2.0, January 2004"
print(json.dumps({
    side: {
        "anchor_tokens": mod.anchor_tokens(),
        "phrases": mod._PHRASES,
        "phrase_anchors": list(mod._PHRASE_ANCHORS.items()),
        "generic_anchors": list(mod._GENERIC_ANCHORS),
        "classify": [dataclasses.astuple(f) for f in mod.classify_text(text)],
        "verdict_digest": prog().verdict_digest(),
    }
    for side, mod, prog in (("port", phrases, LicenseScanProgram),
                            ("ref", ref_phrases, RefLicenseProgram))
}))
"""


def source_order_anchors(module) -> None:
    """Put `module._PHRASE_ANCHORS` back, in place, in the order its source
    lists it.  `monkeypatch.delitem` restores a deleted key at the end of
    the dict, and `anchor_tokens()`, the license program's rule columns and
    its `verdict_digest` follow dict order: the reference's own
    `tests/test_programs.py` deletes "Apache-2.0" that way, so whatever ran
    earlier in the process must not decide the order a test sees."""
    tree = ast.parse(Path(module.__file__).read_text())
    keys = next(
        [k.value for k in node.value.keys]
        for node in tree.body
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", "") == "_PHRASE_ANCHORS"
    )
    table = module._PHRASE_ANCHORS
    if list(table) != keys and set(table) == set(keys):
        items = [(k, table[k]) for k in keys]
        table.clear()
        table.update(items)


def test_anchor_tokens_phrases_and_verdict_digest_are_the_reference():
    """In a fresh interpreter, so that no test that ran before it in this
    process (the reference's anchor-coverage tests reorder its table) can
    change the order either package lists its anchors in."""
    proc = subprocess.run([sys.executable, "-c", _PHRASE_TABLES], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    port, ref = got["port"], got["ref"]
    assert port["anchor_tokens"] == ref["anchor_tokens"]
    assert len(port["anchor_tokens"]) == 18 and "public domain" in port["anchor_tokens"]
    assert port["phrases"] == ref["phrases"]
    assert port["phrase_anchors"] == ref["phrase_anchors"]
    assert port["generic_anchors"] == ref["generic_anchors"]
    assert port["classify"] == ref["classify"] and port["classify"]
    assert port["verdict_digest"] == ref["verdict_digest"]


def test_source_order_anchors_undoes_a_reordering(monkeypatch):
    """The helper above puts a table that `monkeypatch.delitem` reordered
    back in source order, for both packages.  The table starts from source
    order whatever ran earlier in the process (the reference's own tests
    may have left "Apache-2.0" last)."""
    for module in (phrases, ref_phrases):
        monkeypatch.setattr(module, "_PHRASE_ANCHORS", dict(module._PHRASE_ANCHORS))
        source_order_anchors(module)
        want = list(module._PHRASE_ANCHORS.items())
        value = module._PHRASE_ANCHORS.pop("Apache-2.0")
        module._PHRASE_ANCHORS["Apache-2.0"] = value
        assert list(module._PHRASE_ANCHORS.items()) != want
        source_order_anchors(module)
        assert list(module._PHRASE_ANCHORS.items()) == want


def test_classifier_device_and_tf32(clfs, monkeypatch):
    port = clfs[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            classifier.shared_classifier()
        with pytest.raises(RuntimeError, match="cuda"):
            decide_findings(["MIT License"])
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        port.classify_batch(["Permission is hereby granted, free of charge"])
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
