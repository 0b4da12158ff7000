"""Full-text license classification as one batched similarity matmul.

A copy of `trivy_tpu/license/classifier.py` whose one device step, the
cosine product, runs in PyTorch on an explicit device.  The reference
classifies license files with google/licenseclassifier
(pkg/licensing/classifier.go): normalized text against a canonical corpus
with a confidence threshold.  Here every candidate file becomes a hashed
token-trigram histogram (L2-normalized), the corpus is a [L, D] matrix
built once, and classifying a whole scan's worth of license files is a
single [F, D] x [D, L] product (`torch.matmul`, full float32: TF32 is held
off for the call, because scores are rounded to 4 places and held to the
0.9 and 0.99 edges), with cosine scores as confidences.  The corpus matrix
goes to the classifier's device once; there is no quiet numpy fallback on
a CUDA device.

A batch's histograms come from one call of the native library
(`fingerprints`: native/license_fingerprint.cpp), bit-equal to
`_fingerprint(normalize_tokens(text))`, which stays as their plain twin and
builds the corpus matrix.

Corpus sources, in override order: embedded short templates, the packaged
canonical corpus (trivy_tpu_torch/license/corpus/*.txt, the same 24 SPDX
texts as the reference's, byte for byte), then whatever the host's
/usr/share/common-licenses adds on top.
"""

from __future__ import annotations

import os
import re
import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from trivy_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from trivy_tpu_torch.native import load_native
from trivy_tpu_torch.obs import metrics as obs_metrics
from trivy_tpu_torch.obs import trace as obs_trace

DIM = 4096  # histogram buckets; collisions are noise the L2 dot tolerates
DEFAULT_CONFIDENCE = 0.9  # reference classifier's default threshold

_WORD = re.compile(r"[a-z0-9]+")
_COPYRIGHT_LINE = re.compile(r"^.*copyright (\(c\)|©|[0-9]{4}).*$", re.M)

# Short standardized license wordings (public-domain boilerplate).
_EMBEDDED: dict[str, str] = {
    "MIT": """
Permission is hereby granted, free of charge, to any person obtaining a
copy of this software and associated documentation files (the "Software"),
to deal in the Software without restriction, including without limitation
the rights to use, copy, modify, merge, publish, distribute, sublicense,
and/or sell copies of the Software, and to permit persons to whom the
Software is furnished to do so, subject to the following conditions:
The above copyright notice and this permission notice shall be included
in all copies or substantial portions of the Software.
THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS
OR IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF
MERCHANTABILITY, FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT.
IN NO EVENT SHALL THE AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY
CLAIM, DAMAGES OR OTHER LIABILITY, WHETHER IN AN ACTION OF CONTRACT,
TORT OR OTHERWISE, ARISING FROM, OUT OF OR IN CONNECTION WITH THE
SOFTWARE OR THE USE OR OTHER DEALINGS IN THE SOFTWARE.
""",
    "ISC": """
Permission to use, copy, modify, and/or distribute this software for any
purpose with or without fee is hereby granted, provided that the above
copyright notice and this permission notice appear in all copies.
THE SOFTWARE IS PROVIDED "AS IS" AND THE AUTHOR DISCLAIMS ALL WARRANTIES
WITH REGARD TO THIS SOFTWARE INCLUDING ALL IMPLIED WARRANTIES OF
MERCHANTABILITY AND FITNESS. IN NO EVENT SHALL THE AUTHOR BE LIABLE FOR
ANY SPECIAL, DIRECT, INDIRECT, OR CONSEQUENTIAL DAMAGES OR ANY DAMAGES
WHATSOEVER RESULTING FROM LOSS OF USE, DATA OR PROFITS, WHETHER IN AN
ACTION OF CONTRACT, NEGLIGENCE OR OTHER TORTIOUS ACTION, ARISING OUT OF
OR IN CONNECTION WITH THE USE OR PERFORMANCE OF THIS SOFTWARE.
""",
    "BSD-3-Clause": """
Redistribution and use in source and binary forms, with or without
modification, are permitted provided that the following conditions are met:
1. Redistributions of source code must retain the above copyright notice,
this list of conditions and the following disclaimer.
2. Redistributions in binary form must reproduce the above copyright
notice, this list of conditions and the following disclaimer in the
documentation and/or other materials provided with the distribution.
3. Neither the name of the copyright holder nor the names of its
contributors may be used to endorse or promote products derived from this
software without specific prior written permission.
THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
"AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A
PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
HOLDER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED
TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
""",
    "BSD-2-Clause": """
Redistribution and use in source and binary forms, with or without
modification, are permitted provided that the following conditions are met:
1. Redistributions of source code must retain the above copyright notice,
this list of conditions and the following disclaimer.
2. Redistributions in binary form must reproduce the above copyright
notice, this list of conditions and the following disclaimer in the
documentation and/or other materials provided with the distribution.
THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
"AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A
PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
HOLDER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED
TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
""",
    "Unlicense": """
This is free and unencumbered software released into the public domain.
Anyone is free to copy, modify, publish, use, compile, sell, or
distribute this software, either in source code form or as a compiled
binary, for any purpose, commercial or non-commercial, and by any means.
In jurisdictions that recognize copyright laws, the author or authors of
this software dedicate any and all copyright interest in the software to
the public domain. We make this dedication for the benefit of the public
at large and to the detriment of our heirs and successors. We intend
this dedication to be an overt act of relinquishment in perpetuity of
all present and future rights to this software under copyright law.
THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS
OR IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF
MERCHANTABILITY, FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT.
IN NO EVENT SHALL THE AUTHORS BE LIABLE FOR ANY CLAIM, DAMAGES OR OTHER
LIABILITY, WHETHER IN AN ACTION OF CONTRACT, TORT OR OTHERWISE, ARISING
FROM, OUT OF OR IN CONNECTION WITH THE SOFTWARE OR THE USE OR OTHER
DEALINGS IN THE SOFTWARE.
""",
}

# Map /usr/share/common-licenses filenames to SPDX ids.
_SYSTEM_LICENSES = {
    "Apache-2.0": "Apache-2.0",
    "GPL-2": "GPL-2.0",
    "GPL-3": "GPL-3.0",
    "LGPL-2.1": "LGPL-2.1",
    "LGPL-3": "LGPL-3.0",
    "MPL-2.0": "MPL-2.0",
    "CC0-1.0": "CC0-1.0",
    "Artistic": "Artistic-1.0",
}
_SYSTEM_DIR = "/usr/share/common-licenses"


def normalize_tokens(text: str) -> list[str]:
    """licenseclassifier-style normalization: lowercase, copyright lines
    out, words only."""
    text = _COPYRIGHT_LINE.sub(" ", text.lower())
    return _WORD.findall(text)


def _fingerprint(tokens: list[str]) -> np.ndarray:
    """Hashed token-trigram histogram, L2-normalized float32 [DIM]."""
    vec = np.zeros(DIM, dtype=np.float32)
    if len(tokens) < 3:
        return vec
    joined = [" ".join(tokens[i : i + 3]) for i in range(len(tokens) - 2)]
    for gram in joined:
        vec[zlib.crc32(gram.encode()) % DIM] += 1.0
    norm = float(np.linalg.norm(vec))
    if norm > 0:
        vec /= norm
    return vec


def fingerprints(texts: list[str]) -> tuple[np.ndarray, int]:
    """[F, DIM] float32, row f `_fingerprint(normalize_tokens(texts[f]))`
    bit for bit (the norm may round an ulp apart where a row's squared
    counts sum past 2^24), from one call of the native library's
    `license_fingerprint`; and the UTF-8 bytes it read.  A text is encoded
    with "surrogatepass", so any `str` reaches it.  Raises when the library
    does not build."""
    blobs = [t.encode("utf-8", "surrogatepass") for t in texts]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, blobs), dtype=np.int64, count=len(blobs)),
              out=offsets[1:])
    rows = np.empty((len(blobs), DIM), dtype=np.float32)
    load_native().license_fingerprint(b"".join(blobs), offsets.ctypes.data,
                                      len(blobs), rows.ctypes.data)
    return rows, int(offsets[-1])


@dataclass
class Match:
    license: str
    confidence: float


class FullTextClassifier:
    """Corpus matrix built once; classification is one batched matmul on
    `device` (default "cuda"; "cpu" runs the same product on the host)."""

    PACKAGED_DIR = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "corpus"
    )

    def __init__(
        self,
        extra: dict[str, str] | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        corpus: dict[str, str] = dict(_EMBEDDED)
        # Packaged canonical texts (filename = SPDX id): the classifier
        # must work without OS-provided corpora.
        if os.path.isdir(self.PACKAGED_DIR):
            for fname in sorted(os.listdir(self.PACKAGED_DIR)):
                if not fname.endswith(".txt"):
                    continue
                try:
                    with open(
                        os.path.join(self.PACKAGED_DIR, fname),
                        encoding="utf-8", errors="replace",
                    ) as f:
                        # embedded templates are the canonical wordings;
                        # packaged files fill in everything they lack
                        corpus.setdefault(fname[:-4], f.read())
                except OSError:
                    continue
        if os.path.isdir(_SYSTEM_DIR):
            for fname, spdx in _SYSTEM_LICENSES.items():
                path = os.path.join(_SYSTEM_DIR, fname)
                try:
                    with open(path, encoding="utf-8", errors="replace") as f:
                        corpus.setdefault(spdx, f.read())
                except OSError:
                    continue
        corpus.update(extra or {})
        self._corpus = corpus
        self.names = sorted(corpus)
        self.matrix = np.stack(
            [_fingerprint(normalize_tokens(corpus[n])) for n in self.names]
        )  # [L, DIM]
        # Stable digest of the corpus contents: cache keys must change
        # when the host's license corpus does.
        digest = 0
        for n in self.names:
            digest = zlib.crc32(corpus[n].encode(), zlib.crc32(n.encode(), digest))
        self.corpus_digest = digest
        self._matrix_dev = torch.from_numpy(self.matrix).to(self.device)

    def corpus_text(self, name: str) -> str:
        """Raw corpus text for `name` ("" if absent).  The device license
        program audits anchor-token coverage against it at compile time."""
        return self._corpus.get(name, "")

    def classify_batch(
        self,
        texts: list[str],
        confidence: float = DEFAULT_CONFIDENCE,
        stats=None,
    ) -> list[Match | None]:
        """All candidate files at once: [F, DIM] x [DIM, L] -> best
        cosine per file, the product on the classifier's device.  Spans
        `license.fingerprint` (the native histograms, `fingerprints`; its
        `bytes` the UTF-8 bytes read) and `license.classify` (B14 with its
        copies); `stats` (a `SieveStats`) adds their seconds to
        `license_fingerprint_s` and `license_classify_s`, the bytes to
        `license_fingerprint_bytes`, F to `license_classify_rows` and one to
        `license_classify_calls`."""
        if not texts:
            return []
        t0 = time.perf_counter()
        with obs_trace.span("license.fingerprint", texts=len(texts)) as sp:
            fps, nbytes = fingerprints(texts)  # [F, DIM]
            sp.set(bytes=nbytes)
        t1 = time.perf_counter()
        with obs_trace.span("license.classify", rows=len(texts)):
            sims = self._matmul(fps)
        if stats is not None:
            stats.license_fingerprint_s += t1 - t0
            stats.license_fingerprint_bytes += nbytes
            stats.license_classify_s += time.perf_counter() - t1
            stats.license_classify_rows += len(texts)
            stats.license_classify_calls += 1
        return self.matches(sims, confidence)

    def matches(
        self, sims: np.ndarray, confidence: float = DEFAULT_CONFIDENCE
    ) -> list[Match | None]:
        """The best corpus license of each row of cosine scores [F, L], when
        it reaches `confidence`, its score rounded to 4 places."""
        out: list[Match | None] = []
        for row in sims:
            best = int(np.argmax(row))
            score = float(row[best])
            if score >= confidence:
                out.append(Match(self.names[best], round(score, 4)))
            else:
                out.append(None)
        return out

    def _matmul(self, fps: np.ndarray) -> np.ndarray:
        """[F, DIM] x [L, DIM]^T in full float32 on the classifier's device
        (TF32 held off for the call)."""
        a = torch.from_numpy(fps).to(self.device)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            ph = obs_metrics.device_phase("license.classify")
            sims = torch.matmul(a, self._matrix_dev.T)
            ph.done(sims)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return sims.cpu().numpy()

    def classify(
        self, text: str, confidence: float = DEFAULT_CONFIDENCE
    ) -> Match | None:
        return self.classify_batch([text], confidence)[0]


_shared: dict[torch.device, FullTextClassifier] = {}


def shared_classifier(
    device: str | torch.device = DEFAULT_DEVICE,
) -> FullTextClassifier:
    """One classifier per device, built on first use."""
    dev = resolve_device(device)
    clf = _shared.get(dev)
    if clf is None:
        clf = _shared[dev] = FullTextClassifier(device=dev)
    return clf
