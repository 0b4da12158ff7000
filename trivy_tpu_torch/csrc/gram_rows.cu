// B5, the row gram sieve for Hopper (sm_90a): rows [T, L] uint8 -> hit words
// [T, Gp / 32] uint32, bit g set when the caller's gram g (mask, val) matches
// some window of the row that lies inside it, `(window & mask) == val` over
// the case-folded bytes (0x41..0x5A read as lowercase).
//
// Replaces the XLA program trivy_tpu/ops/gram_sieve.py `gram_sieve_rows`
// (:36, jitted at :57), the reference engine's kernel="xla": only the L - 3
// windows inside the row, bits in the caller's gram order, the padding grams
// of `pad_grams` included (mask 0xFFFFFFFF, val 0xFF000000: they fire on a
// window 00 00 00 FF exactly as the compare does).  A row shorter than 4
// bytes hits nothing.
//
// Design.  The host (`ops/gram_sieve.py` `row_tables`) dedupes the grams to
// distinct (mask, val) pairs (195 in the builtin ruleset's class ids, 199 in
// raw bytes, against 288 padded grams) and sieves those, 256 a pass: one
// pass, NW = 7 words, where sieving the grams themselves took two of 8.  The
// test separates by offset: a window (s0, s1, s2, s3) hits pair d iff every
// s_k is accepted at offset k, so a position's pair bits are
// AND_k tab_k[s_k], ORed over the positions.  Symbols with equal columns at
// offset k share a class (at most 17 per offset in class ids, 35 in raw
// bytes), and one shared-memory word per symbol packs its four per-offset
// class ids, so one load serves a symbol at every offset.  tab_k is
// class-major with an odd stride ST = NW | 1: word w of class c at
// c * ST + w, so the lanes of a lookup hit distinct banks for distinct
// classes below 32 (c and c + 32 share one: at most 2-way in raw bytes), and
// w is an immediate offset.  Per position: 4 x NW LDS.32 (28 at NW = 7; the
// symbol map adds 19 a 16-position chunk), 2 LOP3 a word, 4 shifts and 4
// IMADs for the addresses.  After the lanes of a row OR their words, the
// epilogue expands pair bits to gram order through the gram -> pair index
// in shared memory: one ballot per 32 grams (for a 32-lane row), a few
// hundred bit moves a row, not a position.
//
// Work split (as K1's table core, csrc/sieve_row.cuh): persistent blocks of
// 8 warps stage the pass's tables once; a group of lanes (32 for rows of 512
// bytes or more, fewer for short rows, several rows a warp) sieves one row,
// 16 positions a lane per step, symbols fetched 16 bytes at a time when the
// row length is a multiple of 16 and the rows start 16-byte aligned, byte by
// byte otherwise.  More than 256 distinct pairs run one launch per pass; a
// later pass ORs its grams' bits into the words the first wrote (stream
// order; the same gram never lies in two passes).
//
// Bound on an H100: the bytes (T * L read, T * Gp / 32 * 4 written, 0.005 ms
// at [4096, 4096]) and the integer work of the table form, 2 LOP3 a word of
// distinct pairs and window (chip_smoke.py derives both from its inputs).
// This design's own floor is its shared loads: 4 x NW + 19 / 16 a position
// at one wavefront a clock per SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "sieve_row.cuh"

namespace {

using sieve_row::kChunk;
using sieve_row::kFull;
using sieve_row::kSyms;
using sieve_row::kThreads;
using sieve_row::kWarps;

constexpr int kHeader = 8;  // words of a pass block before what is staged

template <int NW, bool VEC>
__global__ void __launch_bounds__(kThreads, sieve_row::kMinBlocks)
gram_rows_kernel(const uint8_t* __restrict__ rows, int n_rows, int length,
                 const uint32_t* __restrict__ block, int staged, int n_out,
                 int accumulate, int group, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  constexpr int ST = NW | 1;
  const uint32_t* s_map = reinterpret_cast<const uint32_t*>(smem4);
  const uint32_t* s_tab = s_map + 256;
  const int base1 = ST * __ldg(block + 0);
  const int base2 = base1 + ST * __ldg(block + 1);
  const int base3 = base2 + ST * __ldg(block + 2);
  const uint16_t* s_idx =
      reinterpret_cast<const uint16_t*>(s_tab + base3 + ST * __ldg(block + 3));
  sieve_row::stage_table(reinterpret_cast<uint32_t*>(smem4), block + kHeader, staged);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (group - 1);
  const int lead = lane & ~(group - 1);  // the group's first lane
  const uint32_t gmask = group == 32 ? kFull : (1u << group) - 1u;
  const int rows_per_warp = 32 / group;
  const int n_pos_total = length - 3;  // windows inside the row; length >= 4
  const int n_chunks = (n_pos_total + kChunk - 1) / kChunk;
  const int n_groups = (n_rows + rows_per_warp - 1) / rows_per_warp;

  // g is the same for every lane of a warp: the ballots below see all 32
  for (int g = blockIdx.x + gridDim.x * warp; g < n_groups; g += gridDim.x * kWarps) {
    const int row = g * rows_per_warp + lane / group;
    const bool active = row < n_rows;
    const uint8_t* src = rows + static_cast<size_t>(row) * length;
    uint32_t acc[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[w] = 0;
    for (int c0 = 0; c0 < n_chunks; c0 += group) {
      const int c = c0 + sub;
      if (!active || c >= n_chunks) continue;
      uint32_t sym[kSyms];
      if constexpr (VEC) {
        sieve_row::fetch_chunk<8, false>(src, length, c, sym);
      } else {
        sieve_row::fetch_chunk_bytes<false>(src, length, c, sym);
      }
#pragma unroll
      for (int n = 0; n < kSyms; ++n) sym[n] = s_map[sym[n]];  // 4 class ids
      const int n_pos = min(kChunk, n_pos_total - c * kChunk);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n_pos) {
          const uint32_t* t0 = s_tab + (sym[j] & 0xFFu) * ST;
          const uint32_t* t1 = s_tab + base1 + ((sym[j + 1] >> 8) & 0xFFu) * ST;
          const uint32_t* t2 = s_tab + base2 + ((sym[j + 2] >> 16) & 0xFFu) * ST;
          const uint32_t* t3 = s_tab + base3 + (sym[j + 3] >> 24) * ST;
#pragma unroll
          for (int w = 0; w < NW; ++w) acc[w] |= t0[w] & t1[w] & t2[w] & t3[w];
        }
      }
    }
    for (int o = group / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[w] |= __shfl_xor_sync(kFull, acc[w], o);
    }
    // Pair bits -> gram order: lane `sub` of a group fetches gram
    // 32 ow + i + sub's pair bit, and a ballot gathers the group's bits.
    uint32_t* dst = out + static_cast<size_t>(row) * n_out;
    for (int ow = 0; ow < n_out; ++ow) {
      uint32_t word = 0;
      for (int i = 0; i < 32; i += group) {
        const int p = s_idx[ow * 32 + i + sub];  // 0xFFFF: another pass's pair
        uint32_t v = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) v = (p >> 5) == w ? acc[w] : v;
        const uint32_t b = __ballot_sync(kFull, (v >> (p & 31)) & 1u);
        word |= ((b >> lead) & gmask) << i;
      }
      if (active && (ow & (group - 1)) == sub) dst[ow] = accumulate ? dst[ow] | word : word;
    }
  }
}

// Lanes that sieve one row: enough for its 16-position chunks, at most 32.
int lanes_per_row(int length) {
  const int chunks = (length - 3 + kChunk - 1) / kChunk;
  int group = 1;
  while (group < 32 && group < chunks) group *= 2;
  return group;
}

template <int NW, bool VEC>
int launch_kernel(const void* rows, int n_rows, int length, const void* block,
                  int staged, int n_out, int accumulate, void* out,
                  cudaStream_t stream) {
  auto kernel = gram_rows_kernel<NW, VEC>;
  const int group = lanes_per_row(length);
  const int rows_per_warp = 32 / group;
  const int n_groups = (n_rows + rows_per_warp - 1) / rows_per_warp;
  const size_t smem = static_cast<size_t>(staged) * 4;
  cudaError_t err;
  const int blocks = sieve_row::persistent_blocks(
      kernel, smem, (n_groups + kWarps - 1) / kWarps, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(rows), n_rows, length,
      static_cast<const uint32_t*>(block), staged, n_out, accumulate, group,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_words(const void* rows, int n_rows, int length, const void* block,
                 int staged, int n_out, int accumulate, void* out,
                 cudaStream_t stream) {
  const bool vec = length % kChunk == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  return vec ? launch_kernel<NW, true>(rows, n_rows, length, block, staged, n_out,
                                       accumulate, out, stream)
             : launch_kernel<NW, false>(rows, n_rows, length, block, staged, n_out,
                                        accumulate, out, stream);
}

}  // namespace

extern "C" {

// One pass of B5.  `block` is a pass block of `row_tables` (16-byte
// aligned), `nw` its pair words (1..8), `staged` its words after the
// header; out [n_rows, n_out] uint32, written (accumulate = 0) or ORed into
// (a later pass).  Returns the cudaError_t of the launch.
int gram_sieve_rows(const void* rows, int n_rows, int length, const void* block,
                    int nw, int staged, int n_out, int accumulate, void* out,
                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  if (length < 4) {
    if (accumulate) return static_cast<int>(cudaSuccess);
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(n_rows) * n_out * 4, stream));
  }
  switch (nw) {
    case 1: return launch_words<1>(rows, n_rows, length, block, staged, n_out, accumulate, out, stream);
    case 2: return launch_words<2>(rows, n_rows, length, block, staged, n_out, accumulate, out, stream);
    case 3: return launch_words<3>(rows, n_rows, length, block, staged, n_out, accumulate, out, stream);
    case 4: return launch_words<4>(rows, n_rows, length, block, staged, n_out, accumulate, out, stream);
    case 5: return launch_words<5>(rows, n_rows, length, block, staged, n_out, accumulate, out, stream);
    case 6: return launch_words<6>(rows, n_rows, length, block, staged, n_out, accumulate, out, stream);
    case 7: return launch_words<7>(rows, n_rows, length, block, staged, n_out, accumulate, out, stream);
    case 8: return launch_words<8>(rows, n_rows, length, block, staged, n_out, accumulate, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of B5 one SM holds at once for `nw` pair words and `staged` words
// of shared memory (16-byte aligned rows of a multiple of 16 bytes).  -1 on
// an error.
int gram_rows_blocks_per_sm(int nw, int staged) {
  const size_t smem = static_cast<size_t>(staged) * 4;
  int per_sm = 0;
  cudaError_t err = cudaErrorInvalidValue;
  auto query = [&](auto kernel) {
    // raise the limit only past the default, as a launch does: never lower it
    err = smem > 48 * 1024
              ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(smem))
              : cudaSuccess;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    }
  };
  switch (nw) {
    case 1: query(gram_rows_kernel<1, true>); break;
    case 2: query(gram_rows_kernel<2, true>); break;
    case 3: query(gram_rows_kernel<3, true>); break;
    case 4: query(gram_rows_kernel<4, true>); break;
    case 5: query(gram_rows_kernel<5, true>); break;
    case 6: query(gram_rows_kernel<6, true>); break;
    case 7: query(gram_rows_kernel<7, true>); break;
    case 8: query(gram_rows_kernel<8, true>); break;
    default: break;
  }
  return err == cudaSuccess ? per_sm : -1;
}

}  // extern "C"
