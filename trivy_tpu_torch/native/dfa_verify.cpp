// Automaton claim-killer of the secret engine: one C walk per candidate
// (file, rule) pair answers whether the rule's search DFA (or bit-parallel
// NFA-64) accepts anywhere in the file, so the byte-exact Python confirm
// only sees pairs that can match (trivy_tpu_torch/engine/redfa.py builds the
// tables, trivy_tpu_torch/native/loader.py builds and binds this file).
//
// Copied from the DFA section of native/gram_sieve.cpp (skip_to_start,
// dfa_verify_impl and its two extern "C" entry points, with the AVX-512
// guard skip_to_start needs); the host gram sieve of that file is not on
// the port's path.  Host code, built with g++, not nvcc.

#include <cstdint>
#include <cstring>

#if defined(__AVX512F__) && defined(__AVX512BW__)
#include <immintrin.h>
#define TRIVY_TPU_AVX512 1
#endif

namespace {

// Fast-forward to the next byte that can leave the rule's start state.
// Start sets are tiny in practice (83/86 builtin rules have 1-2 bytes):
// one byte -> glibc memchr (vectorized), 2-4 bytes -> AVX-512 compares,
// else the generic table walk.  sb/nsb: explicit start-byte list (nsb 0
// when the set is too large to enumerate).
inline const uint8_t* skip_to_start(const uint8_t* p, const uint8_t* end,
                                    const uint8_t* sok, const uint8_t* sb,
                                    int32_t nsb) {
    if (nsb == 1) {
        const void* q = memchr(p, sb[0], (size_t)(end - p));
        return q ? (const uint8_t*)q : end;
    }
#ifdef TRIVY_TPU_AVX512
    if (nsb >= 2 && nsb <= 4) {
        const __m512i v0 = _mm512_set1_epi8((char)sb[0]);
        const __m512i v1 = _mm512_set1_epi8((char)sb[1]);
        const __m512i v2 = _mm512_set1_epi8((char)sb[nsb > 2 ? 2 : 1]);
        const __m512i v3 = _mm512_set1_epi8((char)sb[nsb > 3 ? 3 : 1]);
        while (p + 64 <= end) {
            const __m512i v = _mm512_loadu_si512(p);
            const __mmask64 m = _mm512_cmpeq_epi8_mask(v, v0) |
                                _mm512_cmpeq_epi8_mask(v, v1) |
                                _mm512_cmpeq_epi8_mask(v, v2) |
                                _mm512_cmpeq_epi8_mask(v, v3);
            if (m) return p + __builtin_ctzll(m);
            p += 64;
        }
    }
#endif
    while (p < end && !sok[*p]) ++p;
    return p;
}

}  // namespace

namespace {

// Automaton verification of candidate (file, rule) pairs (engine/redfa.py).
// mode[r]: 0 = no automaton (stay verified=1, oracle confirms), 1 = search
// DFA (one class lookup + one transition lookup per byte), 2 = bit-parallel
// NFA-64 (rules whose subset construction explodes, e.g. counted runs whose
// alphabet overlaps their prefix: AKIA[A-Z0-9]{16}).  Early exit on the
// first accepting step.  FileAt(f) -> base pointer of file f's ORIGINAL
// (unfolded) bytes; shared by the packed-stream and per-file-pointer
// entry points below.
template <class FileAt>
void dfa_verify_impl(FileAt&& file_at,
                      const int64_t* file_lens, const int32_t* pair_file,
                      const int32_t* pair_rule, const int32_t* pair_hint,
                      const int32_t* pair_hint_last,
                      int64_t npairs,
                      const int32_t* prefix_bound,  // [R]; INT32_MAX = no trim
                      const uint8_t* mode,          // [R]
                      const uint8_t* cls_luts,      // [R, 256]
                      const uint16_t* trans_blob, const int64_t* trans_off,
                      const uint8_t* accept_blob, const int64_t* accept_off,
                      const int32_t* n_classes,
                      const uint64_t* follow_blob, const int64_t* follow_off,
                      const uint64_t* cmask_blob, const int64_t* cmask_off,
                      const uint64_t* nfa_first, const uint64_t* nfa_last,
                      const uint8_t* start_ok,      // [R, 256]: byte can leave
                                                    //   the start state
                      const uint8_t* start_bytes,   // [R, 4] enumerated set
                      const int32_t* start_nbytes,  // [R]; 0 = use start_ok
                      uint8_t* out_verified) {
    for (int64_t k = 0; k < npairs; ++k) {
        const int32_t r = pair_rule[k];
        if (mode[r] == 0) {
            out_verified[k] = 1;
            continue;
        }
        const uint8_t* lut = cls_luts + (size_t)r * 256;
        const uint8_t* sok = start_ok + (size_t)r * 256;
        const int32_t f = pair_file[k];
        // Sound walk trims: any match contains a gram occurrence, the
        // file's gram hits span [pair_hint, pair_hint_last], and a
        // bounded-length rule's match starts at most prefix_bound before
        // its gram occurrence and ends at most prefix_bound after it
        // (prefix_bound is max_len of the whole regex).
        int64_t skip = 0;
        int64_t walk_end = file_lens[f];
        if (pair_hint && prefix_bound[r] != INT32_MAX) {
            skip = (int64_t)pair_hint[k] - prefix_bound[r];
            if (skip < 0) skip = 0;
            if (skip > file_lens[f]) skip = file_lens[f];
            if (pair_hint_last) {
                const int64_t e =
                    (int64_t)pair_hint_last[k] + prefix_bound[r] + 8;
                if (e < walk_end) walk_end = e;
            }
        }
        const uint8_t* fbase = file_at(f);
        const uint8_t* p = fbase + skip;
        const uint8_t* end = fbase + walk_end;
        uint8_t ok = 0;
        const uint8_t* sb = start_bytes + (size_t)r * 4;
        const int32_t nsb = start_nbytes[r];
        // In the start state, fast-forward to the next byte that can begin
        // a match (the RE2 memchr trick, vectorized — see skip_to_start):
        // on miss-dominated files almost every byte is skipped at memchr
        // speed instead of an automaton step.  The skip run re-engages
        // whenever the automaton falls back to its start state.
#define TRIVY_TPU_SKIP_RUN()                                   \
        do {                                                   \
            p = skip_to_start(p, end, sok, sb, nsb);           \
        } while (0)
        if (mode[r] == 1) {
            const uint16_t* trans = trans_blob + trans_off[r];
            const uint8_t* accept = accept_blob + accept_off[r];
            const int32_t c = n_classes[r];
            uint32_t s = 0;
            while (p < end) {
                if (s == 0) {
                    TRIVY_TPU_SKIP_RUN();
                    if (p >= end) break;
                }
                s = trans[s * c + lut[*p]];
                ++p;
                if (accept[s]) {
                    ok = 1;
                    break;
                }
            }
        } else {
            const uint64_t* follow = follow_blob + follow_off[r];
            const uint64_t* cmask = cmask_blob + cmask_off[r];
            const uint64_t first = nfa_first[r], last = nfa_last[r];
            uint64_t s = 0;
            while (p < end) {
                if (s == 0) {
                    TRIVY_TPU_SKIP_RUN();
                    if (p >= end) break;
                }
                uint64_t reach = 0, t = s;
                while (t) {
                    reach |= follow[__builtin_ctzll(t)];
                    t &= t - 1;
                }
                s = (reach | first) & cmask[lut[*p]];
                ++p;
                if (s & last) {
                    ok = 1;
                    break;
                }
            }
        }
#undef TRIVY_TPU_SKIP_RUN
        out_verified[k] = ok;
    }
}

}  // namespace

extern "C" {

void dfa_verify_pairs(const uint8_t* stream, const int64_t* file_starts,
                      const int64_t* file_lens, const int32_t* pair_file,
                      const int32_t* pair_rule, const int32_t* pair_hint,
                      const int32_t* pair_hint_last,
                      int64_t npairs,
                      const int32_t* prefix_bound,
                      const uint8_t* mode,
                      const uint8_t* cls_luts,
                      const uint16_t* trans_blob, const int64_t* trans_off,
                      const uint8_t* accept_blob, const int64_t* accept_off,
                      const int32_t* n_classes,
                      const uint64_t* follow_blob, const int64_t* follow_off,
                      const uint64_t* cmask_blob, const int64_t* cmask_off,
                      const uint64_t* nfa_first, const uint64_t* nfa_last,
                      const uint8_t* start_ok,
                      const uint8_t* start_bytes,
                      const int32_t* start_nbytes,
                      uint8_t* out_verified) {
    dfa_verify_impl(
        [&](int32_t f) { return stream + file_starts[f]; },
        file_lens, pair_file, pair_rule, pair_hint, pair_hint_last, npairs,
        prefix_bound, mode, cls_luts, trans_blob, trans_off, accept_blob,
        accept_off, n_classes, follow_blob, follow_off, cmask_blob,
        cmask_off, nfa_first, nfa_last, start_ok, start_bytes, start_nbytes,
        out_verified);
}

// Per-file-pointer form: walks the caller's ORIGINAL file buffers (the
// sieve's folded scratch must never be verified against — case-sensitive
// rules need real bytes).
void dfa_verify_pairs_files(
                      const uint8_t** file_ptrs,
                      const int64_t* file_lens, const int32_t* pair_file,
                      const int32_t* pair_rule, const int32_t* pair_hint,
                      const int32_t* pair_hint_last,
                      int64_t npairs,
                      const int32_t* prefix_bound,
                      const uint8_t* mode,
                      const uint8_t* cls_luts,
                      const uint16_t* trans_blob, const int64_t* trans_off,
                      const uint8_t* accept_blob, const int64_t* accept_off,
                      const int32_t* n_classes,
                      const uint64_t* follow_blob, const int64_t* follow_off,
                      const uint64_t* cmask_blob, const int64_t* cmask_off,
                      const uint64_t* nfa_first, const uint64_t* nfa_last,
                      const uint8_t* start_ok,
                      const uint8_t* start_bytes,
                      const int32_t* start_nbytes,
                      uint8_t* out_verified) {
    dfa_verify_impl(
        [&](int32_t f) { return file_ptrs[f]; },
        file_lens, pair_file, pair_rule, pair_hint, pair_hint_last, npairs,
        prefix_bound, mode, cls_luts, trans_blob, trans_off, accept_blob,
        accept_off, n_classes, follow_blob, follow_off, cmask_blob,
        cmask_off, nfa_first, nfa_last, start_ok, start_bytes, start_nbytes,
        out_verified);
}

}  // extern "C"
