#!/usr/bin/env python3
"""The two readings that set the license confidence limit of the benchmark's
`secret-license` configuration (`portbench/reference/_license_form.py`
`TOLERANCE`): how far the program's license confidences lie from the plain
reference's, and how far they would lie with the similarity product in TF32,
the nearest precision below the float32 the configuration states.

    python3 tools/license_confidence_gap.py --seeds 1 2 3 [--files 100000] [--device cuda]

For each seed it builds the `monorepo` traffic's tree, takes the files the
program's merged sieve makes license candidates (the only files the program
classifies; the cell's own runs check that the reference accepts no other),
and decides their texts three ways: the program's decision tree
(`license/decide.py`, float32 product with TF32 off), the same tree with the
product in TF32 (`allow_tf32` on for the call; on the CPU, where there is no
TF32, the product's inputs rounded to TF32's 10-bit mantissa), and the
reference (`portbench/reference/license_scan.py`, float64).  One JSON line a
seed and way: the files compared, those whose answers differ under the
comparison's limit, names that differ, the largest confidence gap where the
names agree, and the largest gap of the unrounded best cosine.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.corpus import make_tree  # noqa: E402
from portbench.reference import _license_form, license_scan  # noqa: E402
from trivy_tpu_torch.license import classifier  # noqa: E402
from trivy_tpu_torch.license.decide import decide_findings  # noqa: E402
from trivy_tpu_torch.programs import make_program_engine  # noqa: E402

TRAFFIC = ROOT / "portbench" / "traffic" / "monorepo.json"


def _tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 with its mantissa rounded to TF32's 10 bits (to nearest)."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _tf32_matmul(self, fps: np.ndarray) -> np.ndarray:
    a = torch.from_numpy(fps).to(self.device)
    m = self._matrix_dev
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        if a.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            a, m = _tf32_round(a), _tf32_round(m)
        sims = torch.matmul(a, m.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return sims.cpu().numpy()


def _rows(findings) -> list[tuple]:
    return [(f.name, f.category, f.severity, f.confidence, f.link) for f in findings]


def _gap(program: list, reference: list, digest: int) -> dict:
    differ = names = 0
    worst = 0.0
    for got, want in zip(program, reference):
        if _license_form.answer((), got, digest) != _license_form.answer((), want, digest):
            differ += 1
        if [r[0] for r in got] != [r[0] for r in want]:
            names += 1
            continue
        for a, b in zip(got, want):
            worst = max(worst, abs(a[3] - b[3]))
    return {"files": len(program), "differ": differ, "names_differ": names,
            "max_confidence_gap": worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--files", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    traffic = json.loads(TRAFFIC.read_text())
    engine = make_program_engine(device=args.device)
    (_secret, _), (_license, sl) = engine.program_table.slices()
    ref = license_scan.LicenseClassifier()
    for seed in args.seeds:
        tree = make_tree(traffic, seed, stop=args.files)
        cand = np.zeros(len(tree), dtype=bool)
        for lo in range(0, len(tree), 20000):
            part = tree[lo:lo + 20000]
            cand[lo:lo + len(part)] = engine._candidates([c for _, c in part])[:, sl].any(axis=1)
        texts = [tree[i][1].decode("utf-8", errors="replace") for i in np.flatnonzero(cand)]
        cos = ref.cosines(texts)
        want = [[license_scan.finding(*v) for v in ref.decide(t, row)]
                for t, row in zip(texts, cos)]
        f32 = [_rows(f) for f in decide_findings(texts, device=engine.device)]
        real = classifier.FullTextClassifier._matmul
        classifier.FullTextClassifier._matmul = _tf32_matmul
        try:
            tf32 = [_rows(f) for f in decide_findings(texts, device=engine.device)]
        finally:
            classifier.FullTextClassifier._matmul = real
        clf = classifier.shared_classifier(engine.device)
        fps = np.stack([classifier._fingerprint(classifier.normalize_tokens(t)) for t in texts])
        best = cos.max(axis=1)
        for way, got, sims in (("float32", f32, clf._matmul(fps)),
                               ("tf32", tf32, _tf32_matmul(clf, fps))):
            line = {"seed": seed, "way": way, "device": str(engine.device),
                    "limit": _license_form.TOLERANCE, "with_license": sum(1 for w in want if w),
                    **_gap(got, want, ref.digest),
                    "max_score_gap": float(np.abs(sims.max(axis=1) - best).max())}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
