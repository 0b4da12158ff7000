// The packed shift-AND (LUT) probe sieve for Hopper (sm_90a): tiles [T, L]
// uint8 x a LUT [J, 256, Pw] uint32 -> per-tile probe-hit words [T, Pw],
//
//     acc[t, i] = AND_{j < J} lut[j, tiles[t, i + j]]   for i < L - J + 1,
//     hits[t]   = OR_i acc[t, i],
//
// bit p of word w set when probe 32 w + p matches at some position of the
// tile.  Rows j past a probe's length are all ones (`ProbeSet.build_lut`),
// so a probe shorter than J needs no special case: the kernel reads the LUT
// as it is.
//
// Replaces the XLA program trivy_tpu/ops/sieve.py `sieve_tiles` (:27, B6,
// jitted at :43), the reference engine's sieve="lut".  XLA fuses its J
// gathers and ANDs; in PyTorch's eager mode each step would write a
// [T, L - J + 1, Pw] intermediate to device memory.
//
// Design.  The LUT, word-major as the host lays it out (`lut_table`:
// [slices, J, 8, 256], word w of symbol s at [(j * 8 + w) * 256 + s]), sits
// in dynamic shared memory (J = 12: 96 KB a slice of 8 words, above the 48 KB
// default, so the launch raises the limit), staged once per persistent
// block.  A block takes a tile at a time: the tile's bytes go to shared
// memory, each thread sieves positions i = tid, tid + 256, ..., and a
// position stops at the first j where every word of its AND is zero (most
// positions fail at j = 0 or 1).  The threads OR their words in registers,
// a warp ORs them with shuffles, and one atomicOr a warp and word meets in
// shared memory; the block writes the tile's words.  A ruleset of more than
// 256 probes runs one pass a slice.
//
// Bound on an H100: the bytes (T * L read once, T * Pw * 4 written, the LUT)
// at 3.35 TB/s, and the shared-memory loads the data needs (Pw words for
// each step a position takes before it dies) at 32 lanes a clock per SM;
// chip_smoke.py derives both from its inputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSliceWords = 8;  // probe words a pass: 256 probes
constexpr int kSymbols = 256;
constexpr int kMaxJ = 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
lut_sieve_kernel(const uint8_t* __restrict__ tiles, int n_tiles, int length,
                 const uint32_t* __restrict__ table, int jmax, int n_slices,
                 int n_words, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem4);
  const int tab_words = jmax * kSliceWords * kSymbols;
  uint32_t* s_acc = s_tab + tab_words;
  uint8_t* s_row = reinterpret_cast<uint8_t*>(s_acc + 4 * ((kSliceWords + 3) / 4));
  const int lv = length - jmax + 1;
  const int lane = threadIdx.x & 31;
  const bool vec = length % 16 == 0 && reinterpret_cast<uintptr_t>(tiles) % 16 == 0;
  for (int sl = 0; sl < n_slices; ++sl) {
    const int sw = min(kSliceWords, n_words - sl * kSliceWords);
    __syncthreads();  // every lookup of the previous slice is done
    const uint4* src = reinterpret_cast<const uint4*>(table + static_cast<size_t>(sl) * tab_words);
    for (int i = threadIdx.x; i < tab_words / 4; i += kThreads) smem4[i] = __ldg(src + i);
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      __syncthreads();  // the previous tile's bytes and words are read
      const uint8_t* row = tiles + static_cast<size_t>(t) * length;
      if (vec) {
        for (int i = threadIdx.x; i < length / 16; i += kThreads) {
          reinterpret_cast<uint4*>(s_row)[i] = __ldg(reinterpret_cast<const uint4*>(row) + i);
        }
      } else {
        for (int i = threadIdx.x; i < length; i += kThreads) s_row[i] = row[i];
      }
      if (threadIdx.x < kSliceWords) s_acc[threadIdx.x] = 0;
      __syncthreads();
      uint32_t acc[kSliceWords];
#pragma unroll
      for (int w = 0; w < kSliceWords; ++w) acc[w] = 0;
      for (int i = threadIdx.x; i < lv; i += kThreads) {
        uint32_t a[kSliceWords];
        const uint32_t* t0 = s_tab + s_row[i];
#pragma unroll
        for (int w = 0; w < kSliceWords; ++w) a[w] = w < sw ? t0[w * kSymbols] : 0u;
        for (int j = 1; j < jmax; ++j) {
          uint32_t any = 0;
#pragma unroll
          for (int w = 0; w < kSliceWords; ++w) any |= a[w];
          if (!any) break;
          const uint32_t* tj = s_tab + j * kSliceWords * kSymbols + s_row[i + j];
#pragma unroll
          for (int w = 0; w < kSliceWords; ++w) {
            if (w < sw) a[w] &= tj[w * kSymbols];
          }
        }
#pragma unroll
        for (int w = 0; w < kSliceWords; ++w) acc[w] |= a[w];
      }
#pragma unroll
      for (int w = 0; w < kSliceWords; ++w) {
        for (int o = 16; o > 0; o >>= 1) acc[w] |= __shfl_xor_sync(kFull, acc[w], o);
        if (lane == 0 && acc[w]) atomicOr(s_acc + w, acc[w]);
      }
      __syncthreads();
      if (threadIdx.x < sw) {
        out[static_cast<size_t>(t) * n_words + sl * kSliceWords + threadIdx.x] =
            s_acc[threadIdx.x];
      }
    }
  }
}

}  // namespace

extern "C" {

// B6.  tiles [n_tiles, length] uint8, table the LUT's word-major slices
// [ceil(n_words / 8), jmax, 8, 256] uint32 (16-byte aligned), out
// [n_tiles, n_words] uint32; 1 <= jmax <= length and jmax <= 32.  Returns
// the first cudaError_t of the launch.
int lut_sieve(const void* tiles, int n_tiles, int length, const void* table,
              int jmax, int n_words, void* out, void* stream) {
  if (jmax < 1 || jmax > kMaxJ || jmax > length || n_words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const int n_slices = (n_words + kSliceWords - 1) / kSliceWords;
  const size_t smem = static_cast<size_t>(jmax) * kSliceWords * kSymbols * 4 +
                      16 * ((kSliceWords + 3) / 4) + (length + 15) / 16 * 16;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(lut_sieve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lut_sieve_kernel, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = n_tiles < fit ? n_tiles : fit;
  lut_sieve_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tiles), n_tiles, length,
      static_cast<const uint32_t*>(table), jmax, n_slices, n_words,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the LUT sieve one SM holds at once for `jmax` and `length`.
// -1 on an error.
int lut_sieve_blocks_per_sm(int jmax, int length) {
  const size_t smem = static_cast<size_t>(jmax) * kSliceWords * kSymbols * 4 +
                      16 * ((kSliceWords + 3) / 4) + (length + 15) / 16 * 16;
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      lut_sieve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lut_sieve_kernel, kThreads,
                                                        smem);
  }
  return err == cudaSuccess ? per_sm : -1;
}

}  // extern "C"
