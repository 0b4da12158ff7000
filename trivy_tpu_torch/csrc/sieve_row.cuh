// The table core ("shift-AND" over pair sets) shared by gram_sieve.cu (K1/K2)
// and megakernel.cu (K3/K4).
//
// What it replaces.  The Pallas kernels `_make_bitplane_kernel`
// (trivy_tpu/ops/gram_sieve_pallas.py:132) and the megakernel body
// (trivy_tpu/ops/megakernel.py:327) build each distinct (offset, byte) test
// once and share it across grams; `_make_window_kernel` (:204) compares
// masked windows.  All three ask, per row: which distinct (mask, val) pairs
// d match some 4-symbol window (s0, s1, s2, s3) of the row?
//
// The test separates byte by byte: (w & m) == v holds iff, for every
// offset k, (s_k & m_k) == v_k.  So the host builds, once per sieve object,
// a pair-set table: bit d of tab[k][s] is set iff pair d accepts symbol s at
// offset k (the case fold of raw bytes baked in, bits d >= D zero), and a
// position's hits are AND_k tab[k][row[p + k]], ORed over the positions.
// That is 4 lookups and ANDs per word of pairs and position (about 40
// integer operations at 7 words) in place of the ~600 of a per-pair compare
// loop.
//
// What bounds it on an H100.  The lookups: each position reads 4 x 8 words
// of shared memory, and an SM's shared memory serves 32 banks x 4 bytes a
// clock, so a warp of 32 positions costs 32 wavefronts at best: about one
// clock per position per SM, ~0.5 ms for the 1.3e8
// positions of a 32,768 x 4,096 bucket, far above the bytes bound (each row
// byte is read once).  The integer ALUs do ~2 LOP3 per word and position,
// a quarter of that.  Bank conflicts are the other cost, so the layout is
// word-major, tab[slice][k][w][s]: one LDS.32 per word, and the 32 lanes of
// a lookup read word w of 32 symbols whose bank is s mod 32.  Symbols below
// 32 (4-bit class ids, and every class id K1 sees in class space) never
// conflict; equal symbols broadcast.  6-bit ids can pair up 2-way, raw
// bytes more.  Entry-major 16-byte loads would cut instructions but not
// wavefronts, and conflict at 8 symbols.
//
// Layout and passes.  kSliceWords = 8 words of pairs (256 pairs) per pass
// stay in registers; a ruleset of more pairs runs ceil(Dw / 8) passes
// ("slices") over the rows, each with its own table slice, so any D is
// served.  The table of a slice is 4 x 8 x S words (S = 256 raw symbols:
// 32 KB; 16 or 64 class ids: 2 or 8 KB), staged into shared memory once per block:
// the kernels are persistent, a few blocks per SM walking rows.
//
// Rows never pass through shared memory: each row byte is read by one lane,
// 16 symbols (a "chunk") with one vector load plus the first word of the
// next chunk, so the lanes of a warp read neighbouring addresses.  Symbol n
// of a chunk is bits [B n, B n + B) of the little-endian byte stream, which
// serves raw bytes (B = 8) and the link codec's 4- and 6-bit packings alike.
// No cp.async double buffer: a chunk's load is followed by 4 x 8 x 16
// lookups, and the other warps of the SM (32 at 4 blocks) keep the
// shared-memory pipe busy meanwhile; K1 runs at ~93% of its lookup bound
// (PERF.md).  Staging rows would only add shared-memory traffic.
//
// Why not tensor cores.  The TPU kernel used its MXU only to transpose bytes
// into bit planes; Hopper needs no transpose, and what is left is lookups
// and bitwise work, which belongs to shared memory and the integer ALUs.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sieve_row {

constexpr int kThreads = 256;         // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;         // blocks an SM holds: <= 64 registers
constexpr int kChunk = 16;            // positions a lane sieves per step
constexpr int kSyms = kChunk + 3;     // symbols those positions' windows read
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSliceWords = 8;        // words of pair bits per pass

// Words of one table slice: 4 offsets x kSliceWords words x S symbols.
template <int S>
__host__ __device__ constexpr int table_words() { return 4 * kSliceWords * S; }

// The symbols of chunk c of a row: positions 16c .. 16c + 15 and the 3 the
// last windows read past them.  B bits a symbol, `row_bytes` = L * B / 8,
// a multiple of 2B; `row` 16-byte aligned for B = 8, 8 for B = 4, 4 for
// B = 6.  Past the row end the symbols are the row's own head (WRAP) or 0.
template <int B, bool WRAP>
__device__ __forceinline__ void fetch_chunk(const uint8_t* __restrict__ row,
                                            int row_bytes, int c,
                                            uint32_t (&sym)[kSyms]) {
  constexpr int kBytes = 2 * B;  // 16 symbols
  constexpr int kWords = kBytes / 4;
  uint32_t x[kWords + 1];
  const uint8_t* p = row + c * kBytes;
  if constexpr (B == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (B == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      x[i] = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
    }
  }
  const int next = (c + 1) * kBytes;
  if (next < row_bytes) {
    x[kWords] = __ldg(reinterpret_cast<const uint32_t*>(row + next));
  } else {
    x[kWords] = WRAP ? __ldg(reinterpret_cast<const uint32_t*>(row)) : 0u;
  }
#pragma unroll
  for (int n = 0; n < kSyms; ++n) {
    const int bit = B * n;
    const int wi = bit / 32;
    const int sh = bit % 32;
    const int hi = wi < kWords ? wi + 1 : wi;
    const uint32_t v = sh + B <= 32 ? x[wi] >> sh
                                    : __funnelshift_r(x[wi], x[hi], sh);
    sym[n] = v & ((1u << B) - 1u);
  }
}

// Raw bytes of any length and alignment (rows whose length is not a
// multiple of 16, or that start off a 16-byte boundary): byte loads.
template <bool WRAP>
__device__ __forceinline__ void fetch_chunk_bytes(
    const uint8_t* __restrict__ row, int length, int c,
    uint32_t (&sym)[kSyms]) {
#pragma unroll
  for (int n = 0; n < kSyms; ++n) {
    const int p = c * kChunk + n;
    if (p < length) {
      sym[n] = row[p];
    } else {
      sym[n] = WRAP ? row[p % length] : 0u;
    }
  }
}

// ORs into acc the pairs of this slice that match at the first `n_pos`
// positions of a chunk.  `s_tab` is the staged slice, word-major:
// s_tab[(k * kSliceWords + w) * S + s].
template <int S>
__device__ __forceinline__ void sieve_chunk(const uint32_t* s_tab,
                                            const uint32_t (&sym)[kSyms],
                                            int n_pos,
                                            uint32_t (&acc)[kSliceWords]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < n_pos) {
      const uint32_t* t0 = s_tab + sym[j];
      const uint32_t* t1 = s_tab + kSliceWords * S + sym[j + 1];
      const uint32_t* t2 = s_tab + 2 * kSliceWords * S + sym[j + 2];
      const uint32_t* t3 = s_tab + 3 * kSliceWords * S + sym[j + 3];
#pragma unroll
      for (int w = 0; w < kSliceWords; ++w) {
        acc[w] |= t0[w * S] & t1[w * S] & t2[w * S] & t3[w * S];
      }
    }
  }
}

// Copies `words` (a multiple of 4) from a 16-byte aligned table slice in
// device memory to shared memory; every thread of the block calls it.
__device__ __forceinline__ void stage_table(uint32_t* s_tab,
                                            const uint32_t* __restrict__ g,
                                            int words) {
  const uint4* src = reinterpret_cast<const uint4*>(g);
  uint4* dst = reinterpret_cast<uint4*>(s_tab);
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) {
    dst[i] = __ldg(src + i);
  }
}

// Blocks of a persistent launch: kMinBlocks per SM (what __launch_bounds__
// guarantees to fit: at most 64 registers a thread, and the tables stay far
// below a quarter of an SM's shared memory), and no more than
// `work_blocks`.  Returns 0 and sets *err when the runtime refuses.
template <typename Kernel>
inline int persistent_blocks(Kernel kernel, size_t smem, int work_blocks,
                             cudaError_t* err) {
  int dev = 0;
  int sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (*err == cudaSuccess && smem > 48 * 1024) {
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  }
  if (*err != cudaSuccess) return 0;
  const int fit = sms * kMinBlocks;
  return work_blocks < fit ? (work_blocks > 0 ? work_blocks : 1) : fit;
}

}  // namespace sieve_row
