// The per-row compare loop shared by gram_sieve.cu (K1/K2) and megakernel.cu
// (K3/K4): one block tests every (mask, val) pair against every 4-byte
// window of one row held in shared memory, and ORs the hits into per-row
// bit words, bit d of word d / 32 for pair d.
//
// Each thread holds the 32-bit windows of PPT positions in registers (PPT =
// 1..16, chosen by `sieve_ppt` so the block covers a 4096-byte row in one
// pass and a short row without idle threads), tests every pair against all of
// them, and sets one bit per pair in a register word; a warp OR-reduce and a
// shared-memory atomicOr merge the words.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sieve_row {

constexpr int kThreads = 256;
constexpr int kMaxPosPerThread = 16;

__device__ __forceinline__ uint8_t fold(uint8_t b) {
  return (b >= 0x41 && b <= 0x5A) ? static_cast<uint8_t>(b + 32) : b;
}

// Fewest positions per thread that cover a row of `length` bytes with one
// block pass.
inline int sieve_ppt(int length) {
  int ppt = 1;
  while (ppt < kMaxPosPerThread && ppt * kThreads < length) ppt *= 2;
  return ppt;
}

// Enough whole warps to give each thread `ppt` positions of the row.
inline int sieve_threads(int length, int ppt) {
  const int per_thread = (length + ppt - 1) / ppt;
  return min(kThreads, max(32, (per_thread + 31) / 32 * 32));
}

// Called by every thread of the block, after a __syncthreads() that follows
// staging: `s_row` holds the row's `length` bytes plus 3 tail bytes (what the
// last windows read past the row end), and `s_hit[n_words]` is zeroed.  The
// caller synchronises again before it reads `s_hit`.
template <int PPT>
__device__ __forceinline__ void sieve_row(const uint8_t* s_row, int length,
                                          const uint32_t* s_mask,
                                          const uint32_t* s_val, int n_pairs,
                                          int n_words, uint32_t* s_hit) {
  const int nthreads = blockDim.x;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < length; base += nthreads * PPT) {
    const int p0 = base + threadIdx.x;
    const bool active = p0 < length;
    uint32_t win[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      // Positions past the row repeat the thread's first window, which
      // leaves the OR over positions unchanged.
      const int p = p0 + k * nthreads;
      if (!active) {
        win[k] = 0;
      } else if (p < length) {
        win[k] = static_cast<uint32_t>(s_row[p]) |
                 (static_cast<uint32_t>(s_row[p + 1]) << 8) |
                 (static_cast<uint32_t>(s_row[p + 2]) << 16) |
                 (static_cast<uint32_t>(s_row[p + 3]) << 24);
      } else {
        win[k] = win[0];
      }
    }
    for (int w = 0; w < n_words; ++w) {
      uint32_t word = 0;
      const int first = 32 * w;
      const int count = min(32, n_pairs - first);
      for (int b = 0; b < count; ++b) {
        const uint32_t m = s_mask[first + b];
        const uint32_t v = s_val[first + b];
        bool hit = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k) hit |= (win[k] & m) == v;
        word |= static_cast<uint32_t>(hit) << b;
      }
      if (!active) word = 0;
      word = __reduce_or_sync(0xffffffffu, word);
      if (lane == 0 && word) atomicOr(&s_hit[w], word);
    }
  }
}

}  // namespace sieve_row
