// Masked 4-gram sieve for Hopper (sm_90a): rows [T, L] uint8 -> per-row hit
// words [T, Dw] int32 (uint32 bit patterns), bit d set when distinct
// (mask, val) pair d matches at some position of the row.
//
// Replaces the two Pallas TPU kernels of trivy_tpu/ops/gram_sieve_pallas.py:
//   * WRAP = true  -> `_sieve_bitplane` (pallas_call at :271, body
//     `_make_bitplane_kernel` :132).  Positions p + k >= L read the row's own
//     position p + k - L, as the TPU kernel's lane rotation does (`_lane_next`
//     :117).  Its table holds the whole-byte pairs the bit-sliced byte tests
//     compare (`byte_test_constants`).
//   * WRAP = false -> `_sieve_window` (pallas_call at :311, body
//     `_make_window_kernel` :204).  Positions past the row end read zero.
// (B5, the reference's XLA `gram_sieve_rows`, has its own kernel:
// gram_rows.cu.)
// Both fold bytes 0x41..0x5A to lowercase; the fold is baked into the table
// (256 symbols, since a row may hold any byte), so the kernel folds nothing.
//
// Design: the table core of sieve_row.cuh.  Persistent blocks of 8 warps
// stage the table slice once and walk the rows; a group of lanes (32 for
// rows of 512 bytes or more, fewer for short rows, several rows a warp)
// sieves one row, 16 positions a lane per step, and ORs the lanes' words
// with shuffles.  Row r goes to block r mod grid first, so rows spread over
// the SMs evenly whatever T is.  Rows whose length is a multiple of 16 and
// that start 16-byte aligned load 16 bytes a lane; any other row takes byte
// loads (same result).
//
// Bound on an H100: the function reads T*L bytes and writes T*Dw*4, about
// 0.04 ms at 3.35 TB/s for T = 32768, L = 4096.  The kernel is bound by its
// shared-memory lookups instead: 4 x 8 LDS.32 per position at the builtin
// ruleset's Dw = 7 (padded to 8), one wavefront each, about one clock per
// position per SM, ~0.5 ms at that shape in class space (no bank conflicts
// there); raw bytes can conflict.

#include <cstdint>
#include <cuda_runtime.h>

#include "sieve_row.cuh"

namespace {

using sieve_row::kChunk;
using sieve_row::kSliceWords;
using sieve_row::kSyms;
using sieve_row::kWarps;

constexpr int kSymbols = 256;

template <bool WRAP, bool VEC>
__global__ void __launch_bounds__(sieve_row::kThreads, sieve_row::kMinBlocks)
gram_sieve_kernel(const uint8_t* __restrict__ rows, int n_rows, int length,
                  const uint32_t* __restrict__ table, int n_slices,
                  int n_words, int group, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem4);
  constexpr int kTab = sieve_row::table_words<kSymbols>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (group - 1);
  const int rows_per_warp = 32 / group;
  const int n_chunks = (length + kChunk - 1) / kChunk;
  const int n_groups = (n_rows + rows_per_warp - 1) / rows_per_warp;

  for (int sl = 0; sl < n_slices; ++sl) {
    __syncthreads();  // every lookup of the previous slice is done
    sieve_row::stage_table(s_tab, table + static_cast<size_t>(sl) * kTab, kTab);
    __syncthreads();
    for (int g = blockIdx.x + gridDim.x * warp; g < n_groups;
         g += gridDim.x * kWarps) {
      const int row = g * rows_per_warp + lane / group;
      const bool active = row < n_rows;
      const uint8_t* src = rows + static_cast<size_t>(row) * length;
      uint32_t acc[kSliceWords];
#pragma unroll
      for (int w = 0; w < kSliceWords; ++w) acc[w] = 0;
      for (int c0 = 0; c0 < n_chunks; c0 += group) {
        const int c = c0 + sub;
        if (active && c < n_chunks) {
          uint32_t sym[kSyms];
          if constexpr (VEC) {
            sieve_row::fetch_chunk<8, WRAP>(src, length, c, sym);
            sieve_row::sieve_chunk<kSymbols>(s_tab, sym, kChunk, acc);
          } else {
            sieve_row::fetch_chunk_bytes<WRAP>(src, length, c, sym);
            sieve_row::sieve_chunk<kSymbols>(
                s_tab, sym, min(kChunk, length - c * kChunk), acc);
          }
        }
      }
      for (int o = group / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int w = 0; w < kSliceWords; ++w) {
          acc[w] |= __shfl_xor_sync(sieve_row::kFull, acc[w], o);
        }
      }
      if (active) {
        uint32_t* dst = out + static_cast<size_t>(row) * n_words;
#pragma unroll
        for (int w = 0; w < kSliceWords; ++w) {
          const int wi = sl * kSliceWords + w;
          if ((w & (group - 1)) == sub && wi < n_words) dst[wi] = acc[w];
        }
      }
    }
  }
}

// Lanes that sieve one row: enough for its 16-position chunks, at most 32.
int lanes_per_row(int length) {
  const int chunks = (length + kChunk - 1) / kChunk;
  int group = 1;
  while (group < 32 && group < chunks) group *= 2;
  return group;
}

template <bool WRAP, bool VEC>
int launch_kernel(const void* rows, int n_rows, int length, const void* table,
                  int n_words, void* out, cudaStream_t stream) {
  auto kernel = gram_sieve_kernel<WRAP, VEC>;
  const int group = lanes_per_row(length);
  const int rows_per_warp = 32 / group;
  const int n_groups = (n_rows + rows_per_warp - 1) / rows_per_warp;
  const size_t smem = sieve_row::table_words<kSymbols>() * 4;
  cudaError_t err;
  const int blocks = sieve_row::persistent_blocks(
      kernel, smem, (n_groups + kWarps - 1) / kWarps, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, sieve_row::kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(rows), n_rows, length,
      static_cast<const uint32_t*>(table),
      (n_words + kSliceWords - 1) / kSliceWords, n_words,
      group, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool WRAP>
int launch(const void* rows, int n_rows, int length, const void* table,
           int n_words, void* out, void* stream_ptr) {
  if (n_rows == 0 || length == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = length % kChunk == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  return vec ? launch_kernel<WRAP, true>(rows, n_rows, length, table, n_words,
                                         out, stream)
             : launch_kernel<WRAP, false>(rows, n_rows, length, table, n_words,
                                          out, stream);
}

}  // namespace

extern "C" {

// Bitplane-sieve twin (row-tail wrap).  `table` is the pair-set table
// [ceil(n_words / 8), 4, 8, 256] uint32 of the whole-byte pairs.  Returns
// the cudaError_t of the launch.
int gram_sieve_bitplane(const void* rows, int n_rows, int length,
                        const void* table, int n_words, void* out,
                        void* stream) {
  return launch<true>(rows, n_rows, length, table, n_words, out, stream);
}

// Window-sieve twin (zero-filled row tail), over the pairs as they are.
int gram_sieve_window(const void* rows, int n_rows, int length,
                      const void* table, int n_words, void* out,
                      void* stream) {
  return launch<false>(rows, n_rows, length, table, n_words, out, stream);
}

}  // extern "C"
