// License fingerprints of the full-text classifier
// (trivy_tpu_torch/license/classifier.py `fingerprints`).
//
// Each text becomes the row `_fingerprint(normalize_tokens(text))` gives,
// bit for bit: a hashed token-trigram histogram over DIM buckets, L2
// normalised, float32.  The texts arrive as one UTF-8 buffer (a `str`
// encoded with "surrogatepass") and F + 1 offsets; row f is written to
// out[f * DIM, (f + 1) * DIM), every element, zeros included.
//
// What Python's `text.lower()`, the copyright-line substitution and
// `[a-z0-9]+` amount to on the bytes:
// - ASCII A-Z fold to a-z; words are maximal runs of [a-z0-9].  Every
//   other code point separates words, except the only two whose lower case
//   holds an ASCII word character: U+212A KELVIN SIGN (E2 84 AA) is the
//   letter k, and U+0130 (C4 B0) is i followed by a separator (it lowers to
//   i + U+0307).  A lead byte never occurs inside a UTF-8 sequence, so
//   these byte runs can only be those code points.
// - A line (split at \n only: `.` takes \r, U+2028 and U+0085) is dropped
//   whole when its lower case holds "copyright " followed directly by
//   "(c)", U+00A9 or four ASCII digits (`_COPYRIGHT_LINE` under re.M).  No
//   non-ASCII code point lowers to a character of that pattern, and U+0130
//   inside the word breaks it, as its U+0307 does in Python.
// - Trigram t_i " " t_{i+1} " " t_{i+2} lands in bucket zlib.crc32 % DIM.
//   Three CRC registers fold the bytes in place as they are read: the
//   trigram that ends at the current word, the one in its middle and the
//   one it starts; their byte steps are independent, so they overlap.
// - Counts are integers, their squares summed exactly in int64 and cast
//   once to float; the norm is sqrtf of that and a row is count / norm, a
//   true division.  numpy's float32 `x.dot(x)` gives the same norm while
//   the sum is at most 2^24 (every partial sum exact); above it the two may
//   round an ulp apart.  (Past 2^24 trigrams in one bucket, numpy's float32
//   `+= 1.0` stops counting; these counts do not.)  A text of fewer than 3
//   words gives a zero row.
//
// No state outlives a call: the CRC table is a constant, the counts live
// on the stack.  One thread.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kDim = 4096;  // classifier.DIM
constexpr uint32_t kCrcInit = 0xFFFFFFFFu;

struct CrcTable {  // zlib's CRC-32: reflected polynomial 0xEDB88320
  uint32_t t[256];
  constexpr CrcTable() : t() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
constexpr CrcTable kCrc;

// A byte's lower-case word character, 1 for the lead bytes of U+212A and
// U+0130 (looked at again), 0 for a separator.
struct ByteClass {
  uint8_t t[256];
  constexpr ByteClass() : t() {
    for (int b = '0'; b <= '9'; ++b) t[b] = uint8_t(b);
    for (int b = 'a'; b <= 'z'; ++b) t[b] = uint8_t(b);
    for (int b = 'A'; b <= 'Z'; ++b) t[b] = uint8_t(b + 32);
    t[0xE2] = 1;
    t[0xC4] = 1;
  }
};
constexpr ByteClass kClass;

inline uint32_t crc_step(uint32_t r, uint8_t b) {
  return kCrc.t[(r ^ b) & 0xFF] ^ (r >> 8);
}

inline bool is_digit(uint8_t b) { return b >= '0' && b <= '9'; }

// Whether a line of n bytes is a copyright line.  `b | 0x20` equals an
// ASCII letter only for that letter in either case.
bool copyright_line(const uint8_t* s, int64_t n) {
  static constexpr char kWord[] = "copyright";
  for (int64_t p = 0; p + 12 <= n; ++p) {  // the shortest match: "copyright ©"
    if ((s[p] | 0x20) != 'c') continue;
    int k = 1;
    while (k < 9 && (s[p + k] | 0x20) == kWord[k]) ++k;
    if (k < 9 || s[p + 9] != ' ') continue;
    const uint8_t* q = s + p + 10;
    const int64_t left = n - p - 10;
    if (q[0] == 0xC2 && q[1] == 0xA9) return true;
    if (left >= 3 && q[0] == '(' && (q[1] | 0x20) == 'c' && q[2] == ')') return true;
    if (left >= 4 && is_digit(q[0]) && is_digit(q[1]) && is_digit(q[2]) && is_digit(q[3]))
      return true;
  }
  return false;
}

// One text's trigram counts: the three registers, the words seen and the
// counts.
struct Histogram {
  uint32_t ending = kCrcInit, middle = kCrcInit, starting = kCrcInit;
  int64_t words = 0;
  bool in_word = false;
  uint32_t count[kDim];

  Histogram() { std::memset(count, 0, sizeof(count)); }

  inline void letter(uint8_t c) {
    ending = crc_step(ending, c);
    middle = crc_step(middle, c);
    starting = crc_step(starting, c);
    in_word = true;
  }

  inline void end_word() {
    if (!in_word) return;
    in_word = false;
    if (++words >= 3) ++count[~ending & (kDim - 1)];
    ending = crc_step(middle, ' ');
    middle = crc_step(starting, ' ');
    starting = kCrcInit;
  }

  void words_of_line(const uint8_t* s, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t b = s[i];
      const uint8_t c = kClass.t[b];
      if (c > 1) {
        letter(c);
      } else if (b == 0xE2 && i + 2 < n && s[i + 1] == 0x84 && s[i + 2] == 0xAA) {
        letter('k');
        i += 2;
      } else if (b == 0xC4 && i + 1 < n && s[i + 1] == 0xB0) {
        letter('i');
        end_word();
        i += 1;
      } else {
        end_word();
      }
    }
    end_word();
  }

  // Writes the row and clears the counts for the next text.
  void write(float* row) {
    int64_t sumsq = 0;
    for (int k = 0; k < kDim; ++k) sumsq += static_cast<int64_t>(count[k]) * count[k];
    if (sumsq == 0) {  // fewer than 3 words
      std::memset(row, 0, kDim * sizeof(float));
    } else {
      const float norm = std::sqrt(static_cast<float>(sumsq));
      for (int k = 0; k < kDim; ++k) row[k] = static_cast<float>(count[k]) / norm;
    }
    std::memset(count, 0, sizeof(count));
    words = 0;
    in_word = false;
    ending = middle = starting = kCrcInit;
  }
};

}  // namespace

extern "C" void license_fingerprint(const uint8_t* buf, const int64_t* offsets,
                                    int64_t n_texts, float* out) {
  Histogram h;
  for (int64_t f = 0; f < n_texts; ++f) {
    const uint8_t* s = buf + offsets[f];
    const uint8_t* end = buf + offsets[f + 1];
    while (s < end) {
      const uint8_t* nl = static_cast<const uint8_t*>(std::memchr(s, '\n', end - s));
      const uint8_t* line_end = nl ? nl : end;
      if (!copyright_line(s, line_end - s)) h.words_of_line(s, line_end - s);
      s = nl ? nl + 1 : end;
    }
    h.write(out + f * kDim);
  }
}

// zlib's CRC-32 of n bytes, for the tests to hold the table to zlib.crc32.
extern "C" uint32_t license_crc32(const uint8_t* s, int64_t n) {
  uint32_t r = kCrcInit;
  for (int64_t i = 0; i < n; ++i) r = crc_step(r, s[i]);
  return ~r;
}
