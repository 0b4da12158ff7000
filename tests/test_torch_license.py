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

import dataclasses

import numpy as np
import pytest
import torch

from trivy_tpu.license import classifier as ref_classifier
from trivy_tpu.license import phrases as ref_phrases
from trivy_tpu.license.decide import decide_findings as ref_decide
from trivy_tpu.programs import LicenseScanProgram as RefLicenseProgram
from trivy_tpu_torch.license import classifier, phrases
from trivy_tpu_torch.license.decide import decide_findings
from trivy_tpu_torch.programs import LicenseScanProgram

SCORE_ATOL = 1e-5


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


def test_anchor_tokens_phrases_and_verdict_digest_are_the_reference():
    assert phrases.anchor_tokens() == ref_phrases.anchor_tokens()
    assert len(phrases.anchor_tokens()) == 18 and "public domain" in phrases.anchor_tokens()
    assert phrases._PHRASES == ref_phrases._PHRASES
    assert phrases._PHRASE_ANCHORS == ref_phrases._PHRASE_ANCHORS
    assert phrases._GENERIC_ANCHORS == ref_phrases._GENERIC_ANCHORS
    text = "Apache License\n  Version 2.0, January 2004"
    assert [dataclasses.astuple(f) for f in phrases.classify_text(text)] == [
        dataclasses.astuple(f) for f in ref_phrases.classify_text(text)]
    assert LicenseScanProgram().verdict_digest() == RefLicenseProgram().verdict_digest()


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
