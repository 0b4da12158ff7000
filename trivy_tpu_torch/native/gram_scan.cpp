// Host pre-sieve of the hybrid secret engine: the fused C scan that turns a
// chunk's file buffers into candidate (file, rule, first, last) quads
// (trivy_tpu_torch/engine/hybrid.py builds the tables,
// trivy_tpu_torch/native/loader.py builds and binds this file).
//
// Copied from the scan section of native/gram_sieve.cpp: the mask-group
// tables at the top of that file, the tri-gram screen, fold_files, the
// per-hit probe-class confirm_hit, scan_files_impl, CandidateSink and the
// per-file-pointer entry point gram_sieve_scan_files; and from its row
// section the row sieve gram_sieve, the host sieve of the device engine's
// sieve="native" (trivy_tpu_torch/native/loader.py gram_sieve_native).  The
// stream sieve and the packed-stream gram_sieve_scan of that file are not
// on the port's path.  Host code, built with g++, not nvcc.
//
// Screen: per distinct gram mask an O(1) membership probe per window
// (16-bit masks: a direct 64K-bit set; other masks: a 2^17-bit bloom with a
// slow-path check over the group's values), behind a 2^20-bit bloom over
// the folded byte triple.  Grams arrive normalized (byte 0 always kept) and
// sorted by (mask, value) so mask groups are contiguous index ranges.

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
#define TRIVY_TPU_AVX512 1
#endif

namespace {

constexpr uint32_t kHashMul = 2654435761u;  // Knuth multiplicative
constexpr int kBloomBits = 17;

struct MaskGroup {
    uint32_t mask;
    int32_t start;  // gram index range [start, end)
    int32_t end;
    int kind;  // 0 = bloom, 1 = direct16 low, 2 = direct16 high
    std::vector<uint64_t> table;
};

inline uint32_t table_index(const MaskGroup& g, uint32_t x) {
    if (g.kind == 1) return x & 0xFFFFu;
    if (g.kind == 2) return x >> 16;
    return (x * kHashMul) >> (32 - kBloomBits);
}

inline bool table_probe(const MaskGroup& g, uint32_t x) {
    const uint32_t idx = table_index(g, x);
    return (g.table[idx >> 6] >> (idx & 63)) & 1u;
}

std::vector<MaskGroup> build_groups(const uint32_t* masks, const uint32_t* vals,
                                    int32_t G) {
    std::vector<MaskGroup> groups;
    int32_t i = 0;
    while (i < G) {
        int32_t j = i;
        while (j < G && masks[j] == masks[i]) ++j;
        MaskGroup g;
        g.mask = masks[i];
        g.start = i;
        g.end = j;
        if (g.mask == 0x0000FFFFu || g.mask == 0xFFFF0000u) {
            g.kind = g.mask == 0x0000FFFFu ? 1 : 2;
            g.table.assign((1u << 16) / 64, 0);
        } else {
            g.kind = 0;
            g.table.assign((1u << kBloomBits) / 64, 0);
        }
        for (int32_t k = i; k < j; ++k) {
            const uint32_t idx = table_index(g, vals[k]);
            g.table[idx >> 6] |= 1ull << (idx & 63);
        }
        groups.push_back(std::move(g));
        i = j;
    }
    return groups;
}

}  // namespace

namespace {

constexpr int kTriBits = 20;

std::vector<uint64_t> build_tri_screen(const uint32_t* masks,
                                       const uint32_t* vals, int32_t G) {
    std::vector<uint64_t> tri_bits((1u << kTriBits) / 64, 0);
    for (int32_t g = 0; g < G; ++g) {
        const uint32_t b0 = vals[g] & 0xFFu;  // byte 0 always kept
        const bool k1 = (masks[g] >> 8 & 0xFFu) == 0xFFu;
        const bool k2 = (masks[g] >> 16 & 0xFFu) == 0xFFu;
        const uint32_t v1 = vals[g] >> 8 & 0xFFu, v2 = vals[g] >> 16 & 0xFFu;
        for (uint32_t b1 = k1 ? v1 : 0; b1 < (k1 ? v1 + 1 : 256); ++b1) {
            for (uint32_t b2 = k2 ? v2 : 0; b2 < (k2 ? v2 + 1 : 256); ++b2) {
                const uint32_t t = b0 | (b1 << 8) | (b2 << 16);
                const uint32_t h = (t * kHashMul) >> (32 - kTriBits);
                tri_bits[h >> 6] |= 1ull << (h & 63);
            }
        }
    }
    return tri_bits;
}

// Fold per-file buffers into one contiguous case-folded stream (with
// >= 4 zero gap bytes between files) inside a reusable thread-local
// scratch.  Replaces the caller-side pack copy: one write pass total.
// Returns the stream length; *out_starts receives per-file offsets.
const uint8_t* fold_files(const uint8_t** file_ptrs, const int64_t* lens,
                          int32_t F, int64_t* out_starts, int64_t* out_n) {
    static thread_local std::vector<uint8_t> folded;
    int64_t total = 4;
    for (int32_t f = 0; f < F; ++f) total += lens[f] + 4;
    if ((int64_t)folded.size() < total) folded.resize(total);
    uint8_t* dst = folded.data();
    int64_t pos = 0;
    for (int32_t f = 0; f < F; ++f) {
        out_starts[f] = pos;
        const uint8_t* src = file_ptrs[f];
        const int64_t n = lens[f];
        int64_t i = 0;
#ifdef TRIVY_TPU_AVX512
        const __m512i vA = _mm512_set1_epi8('A');
        const __m512i v26 = _mm512_set1_epi8(26);
        const __m512i v32 = _mm512_set1_epi8(32);
        for (; i + 64 <= n; i += 64) {
            const __m512i v = _mm512_loadu_si512(src + i);
            const __mmask64 up =
                _mm512_cmplt_epu8_mask(_mm512_sub_epi8(v, vA), v26);
            _mm512_storeu_si512(dst + pos + i,
                                _mm512_mask_add_epi8(v, up, v, v32));
        }
#endif
        for (; i < n; ++i) {
            uint8_t b = src[i];
            dst[pos + i] = b + ((uint8_t)((uint8_t)(b - 'A') < 26) << 5);
        }
        pos += n;
        memset(dst + pos, 0, 4);
        pos += 4;
    }
    *out_n = pos;
    return dst;
}

// Per-hit probe-class confirm: a gram hit at `pos` stands only when the
// owning probe's FULL class sequence matches at the gram's alignment.
// Masked grams are coarse (a hex-class byte is unmaskable: "sk??" fires on
// "task_struct"); the class bitmaps recover the LUT shift-AND sieve's
// precision for one AND per byte.  `stream` may be folded or raw — bytes
// fold per-read (idempotent) and bitmaps hold folded members.  Sequences
// that would cross a file boundary hit the >= 4 zero gap bytes and fail
// (no class admits NUL); start/end guards cover the stream edges.
//
// Returns +1 pass; -1 fail decided INSIDE the window's own 4 bytes (the
// outcome is a function of the window value alone, so the caller may
// dedup/cache it); 0 fail decided by surrounding bytes (position-
// dependent: the same value may confirm elsewhere).
inline int confirm_hit(const uint8_t* stream, int64_t n, int64_t pos,
                       int32_t g, const uint8_t* cls_blob,
                       const int32_t* cls_start, const int32_t* cls_len,
                       const int32_t* cls_align) {
    const int64_t s = pos - cls_align[g];
    const int32_t len = cls_len[g];
    if (s < 0 || s + len > n) return 0;
    const uint8_t* bm = cls_blob + (size_t)cls_start[g] * 32;
    for (int32_t j = 0; j < len; ++j) {
        uint8_t b = stream[s + j];
        b += (uint8_t)((uint8_t)(b - 'A') < 26) << 5;
        if (!((bm[j * 32 + (b >> 3)] >> (b & 7)) & 1u)) {
            const int64_t fj = s + j;
            return (fj >= pos && fj < pos + 4) ? -1 : 0;
        }
    }
    return 1;
}

template <class OnGram, class OnFileClose>
void scan_files_impl(const uint8_t* stream, int64_t n,
                     const int64_t* file_starts, int32_t F,
                     const uint32_t* masks, const uint32_t* vals, int32_t G,
                     OnGram&& on_gram, OnFileClose&& on_close,
                     bool prefolded = false,
                     const uint8_t* cls_blob = nullptr,
                     const int32_t* cls_start = nullptr,
                     const int32_t* cls_len = nullptr,
                     const int32_t* cls_align = nullptr) {
    if (n < 4 || G <= 0 || F <= 0) return;
    std::vector<MaskGroup> groups = build_groups(masks, vals, G);
    const MaskGroup* gp = groups.data();
    const size_t ngroups = groups.size();
    std::vector<uint64_t> tri_bits = build_tri_screen(masks, vals, G);
    const uint64_t* tb = tri_bits.data();

    int32_t cur = 0;
    int64_t next_start = F > 1 ? file_starts[1] : INT64_MAX;
    // Stream position of the last screen-passing window attributed to the
    // open file — updated for deduped (seen/recent) windows too, so it is a
    // sound upper bound on the last gram occurrence even when that
    // occurrence's resolution was dropped as a repeat.  on_close receives it
    // for walk-end trimming (engine/redfa.py).
    int64_t last_pass = -1;
    uint32_t recent[8] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                          0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
    int recent_at = 0;
    uint32_t seen_w[256];
    int32_t seen_file[256];
    for (int k = 0; k < 256; ++k) seen_file[k] = -1;
    // Value -> gram-list cache (position- and file-independent: the group
    // binary searches depend only on the window VALUE).  With the per-hit
    // class confirm, windows whose grams fail confirm cannot enter the
    // per-file seen table (the same value may confirm elsewhere), so their
    // every occurrence re-resolves — this cache turns those repeats into
    // one lookup + the early-exit confirm instead of the binary searches.
    struct VCache {
        uint32_t w;
        int8_t n;  // matched gram count, -1 = empty slot, -2 = overflow
        int32_t g[3];
    };
    std::vector<VCache> vcache(1024);
    for (auto& e : vcache) e.n = -1;
    auto resolve = [&](int64_t i, uint32_t w) {
        const int32_t prev = cur;
        while (cur + 1 < F && i >= file_starts[cur + 1]) ++cur;
        if (cur != prev) {
            on_close(prev, last_pass);
            last_pass = i;
            next_start = cur + 1 < F ? file_starts[cur + 1] : INT64_MAX;
            for (int rk = 0; rk < 8; ++rk) recent[rk] = 0xFFFFFFFFu;
        } else {
            if (i > last_pass) last_pass = i;
            const uint32_t si0 = (w * kHashMul) >> 24;
            if (seen_file[si0] == cur && seen_w[si0] == w) return;
        }
        // Exact resolution: binary search in each mask group's sorted value
        // range (duplicate (mask, val) grams from different probes share a
        // run).  The group's own membership table screens first — the tri
        // pre-screen only constrains bytes 0-2, so windows whose byte 3
        // breaks a full-width gram (~3% of all windows on source text, vs
        // ~0.4% true hits) die here on one bloom load instead of a search.
        // (A per-(file, masked-value) stamp-dedup table was tried here and
        // REGRESSED ~40%: the MB-scale stamp arrays evict the L1/L2-hot
        // bloom tables, costing more than the skipped binary searches.)
        bool pos_dep = false;  // a gram's confirm failed HERE — the same
                               // window elsewhere may confirm, so its
                               // resolution must not be cached/deduped
        const uint32_t vi = (w * kHashMul) >> 22;
        VCache& vc = vcache[vi];
        if (vc.n >= 0 && vc.w == w) {
            for (int8_t k = 0; k < vc.n; ++k) {
                const int32_t g = vc.g[k];
                if (cls_blob != nullptr) {
                    const int cv = confirm_hit(stream, n, i, g, cls_blob,
                                               cls_start, cls_len, cls_align);
                    if (cv <= 0) {
                        pos_dep |= cv == 0;
                        continue;
                    }
                }
                on_gram(cur, g, i);
            }
        } else {
            int8_t cnt = 0;
            int32_t gl[3];
            for (size_t k = 0; k < ngroups; ++k) {
                const uint32_t x = w & gp[k].mask;
                if (!table_probe(gp[k], x)) continue;
                int32_t lo = gp[k].start, hi = gp[k].end;
                while (lo < hi) {
                    const int32_t mid = (lo + hi) >> 1;
                    if (vals[mid] < x) lo = mid + 1; else hi = mid;
                }
                for (int32_t g = lo; g < gp[k].end && vals[g] == x; ++g) {
                    if (cnt >= 0) {
                        if (cnt < 3) gl[cnt] = g;
                        cnt = cnt < 3 ? (int8_t)(cnt + 1) : (int8_t)-2;
                    }
                    if (cls_blob != nullptr) {
                        const int cv = confirm_hit(stream, n, i, g, cls_blob,
                                                   cls_start, cls_len,
                                                   cls_align);
                        if (cv <= 0) {
                            pos_dep |= cv == 0;
                            continue;
                        }
                    }
                    on_gram(cur, g, i);
                }
            }
            if (cnt >= 0) {
                vc.w = w;
                vc.n = cnt;
                for (int8_t k = 0; k < cnt; ++k) vc.g[k] = gl[k];
            }
        }
        if (!pos_dep) {
            // Position-independent outcome (every matched gram confirmed,
            // or none matched at all): repeats of this window in this file
            // are pure re-resolution — cache/dedup them.
            const uint32_t si = (w * kHashMul) >> 24;
            seen_w[si] = w;
            seen_file[si] = cur;
            recent[recent_at] = w;
            recent_at = (recent_at + 1) & 7;
        }
    };

#ifdef TRIVY_TPU_AVX512
    // Fold pass (skipped when the caller already folded, e.g. via
    // fold_files).  Reused scratch: a fresh buffer per call would pay ~n
    // bytes of page faults (the sieve is called once per ~32MB chunk).
    const uint8_t* fp;
    if (prefolded) {
        fp = stream;
    } else {
        static thread_local std::vector<uint8_t> folded;
        if ((int64_t)folded.size() < n) folded.resize(n);
        const __m512i vA = _mm512_set1_epi8('A');
        const __m512i v26 = _mm512_set1_epi8(26);
        const __m512i v32 = _mm512_set1_epi8(32);
        int64_t i = 0;
        for (; i + 64 <= n; i += 64) {
            const __m512i v = _mm512_loadu_si512(stream + i);
            const __mmask64 up = _mm512_cmplt_epu8_mask(
                _mm512_sub_epi8(v, vA), v26);
            _mm512_storeu_si512(folded.data() + i,
                                _mm512_mask_add_epi8(v, up, v, v32));
        }
        for (; i < n; ++i) {
            uint8_t b = stream[i];
            folded[i] = b + ((uint8_t)((uint8_t)(b - 'A') < 26) << 5);
        }
        fp = folded.data();
    }
    const __m512i vmul = _mm512_set1_epi32((int32_t)kHashMul);
    const __m512i vtri = _mm512_set1_epi32(0xFFFFFF);
    const __m512i v31 = _mm512_set1_epi32(31);
    int64_t i = 0;
    for (; i + 19 < n; i += 16) {
        const __m512i b0 = _mm512_cvtepu8_epi32(_mm_loadu_si128((const __m128i*)(fp + i)));
        const __m512i b1 = _mm512_cvtepu8_epi32(_mm_loadu_si128((const __m128i*)(fp + i + 1)));
        const __m512i b2 = _mm512_cvtepu8_epi32(_mm_loadu_si128((const __m128i*)(fp + i + 2)));
        const __m512i b3 = _mm512_cvtepu8_epi32(_mm_loadu_si128((const __m128i*)(fp + i + 3)));
        const __m512i w = _mm512_or_si512(
            _mm512_or_si512(b0, _mm512_slli_epi32(b1, 8)),
            _mm512_or_si512(_mm512_slli_epi32(b2, 16),
                            _mm512_slli_epi32(b3, 24)));
        const __m512i h = _mm512_srli_epi32(
            _mm512_mullo_epi32(_mm512_and_si512(w, vtri), vmul), 32 - kTriBits);
        const __m512i word = _mm512_i32gather_epi32(
            _mm512_srli_epi32(h, 5), tb, 4);
        const __m512i bit = _mm512_srlv_epi32(word, _mm512_and_si512(h, v31));
        __mmask16 m = _mm512_test_epi32_mask(bit, _mm512_set1_epi32(1));
        if (!m) continue;
        if (i + 19 < next_start) {
            // Whole block inside the current file: lanes repeating a
            // recently resolved window are pure re-resolution — drop them
            // vectorized (the dominant case: keyword runs).  Not applied
            // across file boundaries, where attribution must restart.
            const __mmask16 m0 = m;
            m &= ~_mm512_cmpeq_epi32_mask(w, _mm512_set1_epi32((int32_t)recent[0]));
            m &= ~_mm512_cmpeq_epi32_mask(w, _mm512_set1_epi32((int32_t)recent[1]));
            m &= ~_mm512_cmpeq_epi32_mask(w, _mm512_set1_epi32((int32_t)recent[2]));
            m &= ~_mm512_cmpeq_epi32_mask(w, _mm512_set1_epi32((int32_t)recent[3]));
            m &= ~_mm512_cmpeq_epi32_mask(w, _mm512_set1_epi32((int32_t)recent[4]));
            m &= ~_mm512_cmpeq_epi32_mask(w, _mm512_set1_epi32((int32_t)recent[5]));
            m &= ~_mm512_cmpeq_epi32_mask(w, _mm512_set1_epi32((int32_t)recent[6]));
            m &= ~_mm512_cmpeq_epi32_mask(w, _mm512_set1_epi32((int32_t)recent[7]));
            if (m0 != m) {
                // Dropped lanes are still screen passes of the open file:
                // fold the highest into last_pass so walk-end trimming
                // cannot understate the final gram occurrence.
                const int64_t dp =
                    i + (31 - __builtin_clz((uint32_t)(m0 & ~m)));
                if (dp > last_pass) last_pass = dp;
            }
            if (!m) continue;
        }
        uint32_t wv[16];
        _mm512_storeu_si512(wv, w);
        while (m) {
            const int k = __builtin_ctz(m);
            m &= m - 1;
            resolve(i + k, wv[k]);
        }
    }
    // Scalar tail (shares resolve/cur state; anchors stay in order).
    for (; i + 3 < n; ++i) {
        uint32_t w = (uint32_t)fp[i] | ((uint32_t)fp[i + 1] << 8) |
                     ((uint32_t)fp[i + 2] << 16) | ((uint32_t)fp[i + 3] << 24);
        const uint32_t h = ((w & 0xFFFFFFu) * kHashMul) >> (32 - kTriBits);
        if (!((tb[h >> 6] >> (h & 63)) & 1u)) continue;
        resolve(i, w);
    }
#else
    // Scalar path: rolling folded window with a cheap 64K-bit pair
    // pre-screen before the tri probe.
    std::vector<uint64_t> pair_bits((1u << 16) / 64, 0);
    for (int32_t g = 0; g < G; ++g) {
        const uint32_t b0 = vals[g] & 0xFFu;
        if ((masks[g] >> 8 & 0xFFu) == 0xFFu) {
            const uint32_t p = b0 | (vals[g] & 0xFF00u);
            pair_bits[p >> 6] |= 1ull << (p & 63);
        } else {
            for (uint32_t b1 = 0; b1 < 256; ++b1) {
                const uint32_t p = b0 | (b1 << 8);
                pair_bits[p >> 6] |= 1ull << (p & 63);
            }
        }
    }
    const uint64_t* pb = pair_bits.data();
    uint32_t w = 0;
    for (int k = 0; k < 3; ++k) {
        uint8_t b = stream[k];
        b += (uint8_t)((uint8_t)(b - 'A') < 26) << 5;
        w |= (uint32_t)b << (8 * (k + 1));
    }
    for (int64_t i = 0; i + 3 < n; ++i) {
        uint8_t b = stream[i + 3];
        b += (uint8_t)((uint8_t)(b - 'A') < 26) << 5;
        w = (w >> 8) | ((uint32_t)b << 24);
        const uint32_t pair = w & 0xFFFFu;
        if (!((pb[pair >> 6] >> (pair & 63)) & 1u)) continue;
        const uint32_t h = ((w & 0xFFFFFFu) * kHashMul) >> (32 - kTriBits);
        if (!((tb[h >> 6] >> (h & 63)) & 1u)) continue;
        resolve(i, w);
    }
#endif
    on_close(cur, last_pass);
}

// Shared candidate-resolution state for the two fused-scan entry points
// (one definition — the packed-stream and per-file-pointer forms must
// never desynchronize; see dfa_verify_impl for the same pattern).
struct CandidateSink {
    const int64_t* file_starts;
    const int32_t* gram_window;
    int32_t W;
    const int32_t* window_probe;
    const int32_t* probe_n_windows;
    int32_t P;
    const int32_t* gate_ptr;
    const int32_t* gate_probes;
    const int32_t* rule_conj_ptr;
    const int32_t* conj_ptr;
    const int32_t* conj_probes;
    int32_t R;
    int32_t* out_pairs;
    int64_t cap;
    std::vector<uint8_t> win_hit;
    std::vector<uint8_t> probe_hit;
    std::vector<int32_t> cnt;
    bool any_hit = false;
    int32_t first_hit = 0;  // first gram-hit offset within the open file
    int64_t found = 0;

    CandidateSink(const int64_t* starts, const int32_t* gw, int32_t w,
                  const int32_t* wp, const int32_t* pnw, int32_t p,
                  const int32_t* gp_, const int32_t* gpr,
                  const int32_t* rcp, const int32_t* cp,
                  const int32_t* cpr, int32_t r,
                  int32_t* out, int64_t c)
        : file_starts(starts), gram_window(gw), W(w), window_probe(wp),
          probe_n_windows(pnw), P(p), gate_ptr(gp_), gate_probes(gpr),
          rule_conj_ptr(rcp), conj_ptr(cp), conj_probes(cpr), R(r),
          out_pairs(out), cap(c), win_hit(w, 0), probe_hit(p, 0),
          cnt(p, 0) {}

    void on_gram(int32_t f, int32_t g, int64_t pos) {
        win_hit[gram_window[g]] = 1;
        if (!any_hit) {
            any_hit = true;
            first_hit = (int32_t)(pos - file_starts[f]);
        }
    }

    void on_close(int32_t f, int64_t last_pass) {
        if (!any_hit) return;
        any_hit = false;
        const int32_t last_hit = (int32_t)(last_pass - file_starts[f]);
        memset(cnt.data(), 0, (size_t)P * 4);
        for (int32_t w2 = 0; w2 < W; ++w2)
            if (win_hit[w2]) ++cnt[window_probe[w2]];
        memset(win_hit.data(), 0, (size_t)W);
        for (int32_t p = 0; p < P; ++p)
            probe_hit[p] = cnt[p] == probe_n_windows[p];
        for (int32_t r = 0; r < R; ++r) {
            bool ok = gate_ptr[r] == gate_ptr[r + 1];
            for (int32_t k = gate_ptr[r]; !ok && k < gate_ptr[r + 1]; ++k)
                ok = probe_hit[gate_probes[k]];
            if (!ok) continue;
            for (int32_t c = rule_conj_ptr[r];
                 ok && c < rule_conj_ptr[r + 1]; ++c) {
                bool chit = false;
                for (int32_t k = conj_ptr[c]; !chit && k < conj_ptr[c + 1];
                     ++k)
                    chit = probe_hit[conj_probes[k]];
                ok = chit;
            }
            if (!ok) continue;
            if (found < cap) {
                out_pairs[found * 4] = f;
                out_pairs[found * 4 + 1] = r;
                out_pairs[found * 4 + 2] = first_hit;
                out_pairs[found * 4 + 3] = last_hit;
            }
            ++found;
        }
    }
};

}  // namespace

extern "C" {

// Row API: [T, L] rows (zero-padded); out [T, G].  Each row is an
// independent stream (row boundaries here DO cut windows; callers pack rows
// with overlap): out[t, g] = 1 when gram g matches a case-folded window
// starting at one of the row's first L - 3 positions.
void gram_sieve(const uint8_t* rows, int64_t T, int64_t L,
                const uint32_t* masks, const uint32_t* vals, int32_t G,
                uint8_t* out) {
    memset(out, 0, (size_t)T * (size_t)G);
    if (L < 4 || G <= 0) return;
    std::vector<MaskGroup> groups = build_groups(masks, vals, G);
    const MaskGroup* gp = groups.data();
    const size_t ngroups = groups.size();

    for (int64_t t = 0; t < T; ++t) {
        const uint8_t* row = rows + t * L;
        uint8_t* orow = out + t * G;
        uint32_t w = 0;
        for (int64_t i = 0; i < L; ++i) {
            uint8_t b = row[i];
            if (b >= 'A' && b <= 'Z') b += 32;
            w = (w >> 8) | ((uint32_t)b << 24);
            if (i < 3) continue;
            for (size_t k = 0; k < ngroups; ++k) {
                const uint32_t x = w & gp[k].mask;
                if (table_probe(gp[k], x)) {
                    for (int32_t g = gp[k].start; g < gp[k].end; ++g) {
                        if (x == vals[g]) orow[g] = 1;
                    }
                }
            }
        }
    }
}

// Per-file-pointer fused scan: folds straight from the caller's file
// buffers into one case-folded stream (>= 4 zero bytes between files), sieves
// it, resolves each file's candidate rules at file close and writes the
// per-file start offsets to out_starts.  Returns the number of pairs found;
// writes at most `cap` (file, rule, first_hit, last_hit) int32 quads to
// out_pairs (the hit columns are window-start offsets within the file of the
// first and last screen-passing window: the walk-trim hints of the verify
// stage).  A return > cap means: retry with a larger buffer.
int64_t gram_sieve_scan_files(
    const uint8_t** file_ptrs, const int64_t* lens, int32_t F,
    const uint32_t* masks, const uint32_t* vals, int32_t G,
    const int32_t* gram_window, int32_t W,
    const int32_t* window_probe,
    const int32_t* probe_n_windows, int32_t P,
    const int32_t* gate_ptr, const int32_t* gate_probes,
    const int32_t* rule_conj_ptr, const int32_t* conj_ptr,
    const int32_t* conj_probes, int32_t R,
    const uint8_t* cls_blob, const int32_t* cls_start,
    const int32_t* cls_len, const int32_t* cls_align,
    int64_t* out_starts, int32_t* out_pairs, int64_t cap) {
    int64_t n = 0;
    const uint8_t* stream = fold_files(file_ptrs, lens, F, out_starts, &n);
    CandidateSink sink(
        out_starts, gram_window, W, window_probe, probe_n_windows, P,
        gate_ptr, gate_probes, rule_conj_ptr, conj_ptr, conj_probes, R,
        out_pairs, cap);
    scan_files_impl(
        stream, n, out_starts, F, masks, vals, G,
        [&](int32_t f, int32_t g, int64_t pos) { sink.on_gram(f, g, pos); },
        [&](int32_t f, int64_t lp) { sink.on_close(f, lp); },
        /*prefolded=*/true, cls_blob, cls_start, cls_len, cls_align);
    return sink.found;
}

}  // extern "C"
