// The step of a 64-position Glushkov search automaton, shared by the device
// NFA verify kernels K5 and K6 (csrc/nfa_verify.cu) so the two cannot
// disagree:
//
//     S' = (reach(S) | first) & accept[symbol],
//     reach(S) = ((S & fwd) << 1) | (S & self) | OR over p in S & exc of residual[p],
//
// which is exactly the OR of follow[p] over the set bits p of S.  The
// Glushkov numbering makes concatenation the edge p -> p + 1 (bit p of
// fwd) and a starred atom p -> p (bit p of self); the residual rows hold
// every other edge, and exc marks the positions that have one.  Across the
// builtin rules ~45 of ~76 follow edges a rule are p -> p + 1 and the
// residual rows sit on ~6 positions (median 2), so the common step is a
// few branch-free 64-bit operations and the loop runs only over the live
// exception positions.  The host builds these words from the follow words
// (ops/nfa_verify.py `step_words`).

#pragma once

#include <cstdint>

namespace nfa_step {

// Word offsets of a rule's step: five words, then residual[64].  A K5 stack
// image holds each of them for every slot, word-major (word w of slot s at
// w * width + s); a K6 rule row holds them once (stride 1).
constexpr int kFwd = 0;
constexpr int kSelf = 1;
constexpr int kExc = 2;
constexpr int kFirst = 3;
constexpr int kLast = 4;
constexpr int kResidual = 5;
constexpr int kRuleWords = kResidual + 64;

struct Rule {
  uint64_t fwd, self, exc, first, last;
  const uint64_t* residual;  // residual[p] at residual[p * stride]
  int stride;
};

// The rule whose words start at `w`, word k at w[k * stride].
__device__ __forceinline__ Rule load_rule(const uint64_t* w, int stride) {
  return Rule{w[kFwd * stride], w[kSelf * stride], w[kExc * stride],
              w[kFirst * stride], w[kLast * stride], w + kResidual * stride, stride};
}

// kExceptions false: the caller knows exc is 0 (no residual rows), and the
// loop and its branch are left out.
template <bool kExceptions = true>
__device__ __forceinline__ uint64_t reach(const Rule& r, uint64_t s) {
  uint64_t out = ((s & r.fwd) << 1) | (s & r.self);
  if (kExceptions) {  // 32-bit halves: a shorter ctz a trip
    uint32_t lo = static_cast<uint32_t>(s) & static_cast<uint32_t>(r.exc);
    uint32_t hi = static_cast<uint32_t>(s >> 32) & static_cast<uint32_t>(r.exc >> 32);
    if (lo | hi) {
      for (; lo; lo &= lo - 1) out |= r.residual[(__ffs(lo) - 1) * r.stride];
      for (; hi; hi &= hi - 1) out |= r.residual[(__ffs(hi) + 31) * r.stride];
    }
  }
  return out;
}

// One symbol: `accept` is the symbol's accept word, looked up by the caller
// (it depends on the input alone, so it can be loaded ahead of the chain).
template <bool kExceptions = true>
__device__ __forceinline__ uint64_t step(const Rule& r, uint64_t s, uint64_t accept) {
  return (reach<kExceptions>(r, s) | r.first) & accept;
}

// The step without `first`.  Since reach distributes over union, a walk
// that enters a span with state T and one that enters it empty (S = 0)
// differ by exactly the excess G that `excess_step` carries from G = T:
// at every later position the first walk's state is the second's OR G.
// So a span can be walked speculatively from the empty state and fixed up
// afterwards by walking G alone, which on real data dies within a few bytes.
template <bool kExceptions = true>
__device__ __forceinline__ uint64_t excess_step(const Rule& r, uint64_t g, uint64_t accept) {
  return reach<kExceptions>(r, g) & accept;
}

}  // namespace nfa_step
