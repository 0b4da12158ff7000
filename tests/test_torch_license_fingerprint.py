"""The license classifier's native fingerprints (`trivy_tpu_torch/license/
classifier.py` `fingerprints`, `native/license_fingerprint.cpp`) against
their plain twin `_fingerprint(normalize_tokens(text))`:

* bit-equal rows on the packaged corpus texts, on every LICENSE file and
  notice shape of the monorepo tree (packaged texts under seeded copyright
  lines, notices in C and Python comments), on seeded random texts mixing
  ASCII words with multi-byte characters, and on edge cases one at a time:
  fewer than 3 words, U+212A and U+0130 inside and beside words, copyright
  lines kept and dropped, line ends other than \\n, a lone surrogate, U+FFFD,
  a 256 KiB text;
* the native CRC against `zlib.crc32` on random byte strings;
* a repetitive text whose squared counts pass 2^24: rows within 1e-6, the
  same `Match` through `classify_batch` as through the plain rows;
* a library that does not build raises.

Tolerance: exact (the rows' bits), except the 2^24 case (rtol 1e-6).
"""

import random
import subprocess
import zlib
from pathlib import Path

import numpy as np
import pytest

from trivy_tpu_torch.license import classifier
from trivy_tpu_torch.native import load_native, loader

CORPUS = Path(classifier.FullTextClassifier.PACKAGED_DIR)
NAMES = sorted(p.stem for p in CORPUS.glob("*.txt"))

# The monorepo tree's vendored notices: license, the line that starts the
# notice and the line that ends it (None: the whole text).
NOTICES = [
    ("Apache-2.0", "Copyright [yyyy]", "limitations under the License."),
    ("GPL-2.0", "<one line to give the program's name", "Boston, MA 02110-1301 USA."),
    ("GPL-3.0", "<one line to give the program's name",
     "If not, see <https://www.gnu.org/licenses/>."),
    ("LGPL-2.1", "<one line to give the library's name", "Boston, MA  02110-1301  USA"),
    ("MPL-2.0", "This Source Code Form is subject to the terms", "mozilla.org/MPL/2.0/."),
    ("MIT", None, None),
    ("BSD-2-Clause", None, None),
    ("BSD-3-Clause", None, None),
    ("ISC", None, None),
]

EDGES = {
    "empty": "",
    "one_word": "alpha",
    "two_words": "alpha beta",
    "three_words": "alpha beta gamma",
    "three_words_over_lines": "alpha\n\nbeta\r\n--gamma--",
    "kelvin_inside_and_beside": "ba\u212aer \u212aelvin x\u212a \u212a \u212a\u212a 5\u212a9 y z",
    "dotted_i_inside_and_beside": "\u0130stanbul c\u0130ty d\u0130 \u0130 \u0130\u0130 9\u01309 end",
    "copyright_c_upper": "Copyright (C) 2024 Someone Else\nthe rest of the words",
    "copyright_sign_upper": "COPYRIGHT \u00a9 x y z\nnext words here now",
    "copyright_five_digits": "copyright 20245 holder name\nmore words after it",
    "copyright_two_spaces_kept": "copyright  2024 two spaces\nwords on the next line",
    "copyright_no_space_kept": "copyrightx2024 words\nmore words here",
    "copyright_registered_sign_kept": "copyright \u00ae 2024 words\nmore words here",
    "copyright_inside_a_word": "xcopyright 1999 a b\nc d e f",
    "copyright_last_line_no_newline": "words before the notice\nCopyright 1999 Last Line",
    "copyright_mid_line": "see the copyright (c) notice here\nkept words here",
    "copyright_three_digits_kept": "copyright 123 four words\nand more",
    "copyright_too_short_kept": "alpha beta gamma\ncopyright 199",
    "copyright_dotted_i_kept": "COPYR\u0130GHT 2024 kept words\nnext line",
    "copyright_kelvin_line": "the \u212aelvin line copyright (c) 2001\nk words stay",
    "crlf_endings": "Line one here\r\nCopyright (c) 2020 X\r\nline three words\r\n",
    "line_separator_in_a_line": "alpha beta\u2028Copyright 2001 gamma\ndelta epsilon zeta",
    "next_line_in_a_line": "alpha beta\u0085copyright (c) gamma\ndelta epsilon zeta",
    "carriage_return_in_a_line": "alpha beta\rcopyright \u00a9 gamma\ndelta epsilon zeta",
    "lone_surrogates": "left \ud800 right more words \udfff end \U0001f600 x",
    "replacement_chars": b"abc \xff\xfe def \xc3 ghi jkl\xe2\x84".decode("utf-8", "replace"),
    "punctuation_only": "... --- !!! \u00a9 \u2014 \t\n\r\n",
    "neighbours_of_kelvin_and_dotted_i": "a\u2122b c\u0131d e\u2100f g\u0131\u212a h",
    "digits_and_mixed_case": "ABC123 def456 GHI 789 MixedCase WORDS",
}


def plain(text: str) -> np.ndarray:
    return classifier._fingerprint(classifier.normalize_tokens(text))


def _copyright(rng: random.Random) -> str:
    return f"Copyright (c) {rng.randint(1995, 2025)} The Pkg{rng.randint(0, 999)} Authors\n"


def _notice(name: str, start, end) -> str:
    text = (CORPUS / f"{name}.txt").read_text()
    if start is None:
        return text
    lines = text.splitlines()
    first = next(k for k, line in enumerate(lines) if start in line)
    last = next(k for k in range(first, len(lines)) if end in lines[k])
    return "\n".join(lines[first:last + 1]) + "\n"


def _comment(text: str, style: str) -> str:
    if style == "py":
        return "".join(f"# {line}".rstrip() + "\n" for line in text.splitlines())
    body = "".join(f" * {line}".rstrip() + "\n" for line in text.splitlines())
    return f"/*\n{body} */\n"


def _random_text(seed: int, n_bytes: int) -> str:
    """ASCII words in both cases, digits, punctuation, line ends, copyright
    lines and multi-byte characters (U+212A and U+0130 among them)."""
    rng = random.Random(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    extra = ["\u212a", "\u0130", "\u00e9", "\u00df", "\u00a9", "\u2028", "\u0085",
             "\u65e5\u672c", "\U0001f600", "\ufffd", "\u03a3", "\u0131"]
    seps = [" ", " ", " ", "\n", "\r\n", "\t", ", ", ". ", "(", ")", "-", "'"]
    parts, size = [], 0
    while size < n_bytes:
        roll = rng.random()
        if roll < 0.6:
            part = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))
        elif roll < 0.75:
            part = rng.choice(extra)
        elif roll < 0.78:
            part = rng.choice(["Copyright (c) 2001 X", "COPYRIGHT \u00a9", "copyright 19",
                               "copyright  1999", "Copyright 2024"])
        else:
            part = rng.choice(seps)
        parts.append(part)
        size += len(part)
    return "".join(parts)


def _cases() -> dict[str, str]:
    cases = {f"corpus:{n}": (CORPUS / f"{n}.txt").read_text() for n in NAMES}
    rng = random.Random(26)
    for n in NAMES:
        cases[f"license_file:{n}"] = _copyright(rng) + "\n" + (CORPUS / f"{n}.txt").read_text()
    for name, start, end in NOTICES:
        for style in ("c", "py"):
            body = _comment(_notice(name, start, end), style)
            cases[f"notice:{name}:{style}"] = _comment(_copyright(rng), style) + body + "int x;\n"
    for seed in range(8):
        cases[f"random:{seed}"] = _random_text(seed, 4000 + 3000 * seed)
    cases.update({f"edge:{k}": v for k, v in EDGES.items()})
    cases["edge:256_kib"] = _random_text(256, 256 << 10)
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_rows_equal_the_plain_rows(case):
    text = CASES[case]
    rows, nbytes = classifier.fingerprints([text])
    want = plain(text)
    assert rows.shape == (1, classifier.DIM) and rows.dtype == np.float32
    assert nbytes == len(text.encode("utf-8", "surrogatepass"))
    np.testing.assert_array_equal(rows[0].view(np.uint32), want.view(np.uint32))


def test_a_batch_equals_its_texts_one_by_one():
    texts = [CASES[k] for k in sorted(CASES)]
    rows, nbytes = classifier.fingerprints(texts)
    want = np.stack([plain(t) for t in texts])
    np.testing.assert_array_equal(rows.view(np.uint32), want.view(np.uint32))
    assert nbytes == sum(len(t.encode("utf-8", "surrogatepass")) for t in texts)
    assert classifier.fingerprints([])[0].shape == (0, classifier.DIM)


@pytest.mark.parametrize("seed", range(4))
def test_native_crc_equals_zlib(seed):
    lib = load_native()
    rng = np.random.default_rng(seed)
    for n in range(0, 301, 3):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert lib.license_crc32(data, n) == zlib.crc32(data), n


def test_squared_counts_past_2_24_round_close_and_match_the_same():
    clf = classifier.FullTextClassifier(device="cpu")
    mit = clf.corpus_text("MIT")
    texts = [mit * 600, "a b " * 6000 + "c d e"]
    rows, _ = classifier.fingerprints(texts)
    want = np.stack([plain(t) for t in texts])
    for text in texts:  # the case this test is for: integer sums past float32's exact range
        counts = np.bincount([zlib.crc32(" ".join(g).encode()) % classifier.DIM
                              for g in zip(*(classifier.normalize_tokens(text)[k:]
                                             for k in range(3)))])
        assert int((counts.astype(np.int64) ** 2).sum()) > 2**24
    np.testing.assert_allclose(rows, want, rtol=1e-6, atol=0)
    assert clf.classify_batch(texts) == clf.matches(clf._matmul(want))
    assert clf.classify_batch(texts)[0].license == "MIT"


def test_a_library_that_does_not_build_raises(monkeypatch, tmp_path):
    real = loader._run

    def refuse(cmd):
        if "-shared" in cmd:
            return subprocess.CompletedProcess(cmd, 1, "", "refused: no compiler here")
        return real(cmd)

    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_run", refuse)
    monkeypatch.setenv("TRIVY_TPU_AOT_CACHE", str(tmp_path))
    with pytest.raises(RuntimeError, match="did not build"):
        classifier.fingerprints(["alpha beta gamma"])
