// Masked 4-gram sieve for Hopper (sm_90a): rows [T, L] uint8 -> per-row hit
// words [T, Dw] int32 (uint32 bit patterns), bit d set when distinct
// (mask, val) pair d matches at some position of the row.
//
// Replaces the two Pallas TPU kernels of trivy_tpu/ops/gram_sieve_pallas.py:
//   * WRAP = true  -> `_sieve_bitplane` (pallas_call at :271, body
//     `_make_bitplane_kernel` :132).  Positions p + k >= L read the row's own
//     position p + k - L, as the TPU kernel's lane rotation does (`_lane_next`
//     :117).  The wrapper hands it (mask, val) pairs already widened to whole
//     bytes, which is what the bit-sliced byte tests compare.
//   * WRAP = false -> `_sieve_window` (pallas_call at :311, body
//     `_make_window_kernel` :204).  Positions past the row end read zero.
// Both fold bytes 0x41..0x5A to lowercase and only those, before windowing.
//
// Design: one block per row, of up to 256 threads.  The block stages the
// folded row (plus a 3-byte tail: the row head for WRAP, zeros otherwise) and
// the gram constants in shared memory, runs the compare loop of
// sieve_row.cuh, and writes its row's [Dw] words.
//
// Bound on an H100: the function reads T*L staged bytes and writes T*Dw*4,
// about 0.04 ms at 3.35 TB/s for T = 32768, L = 4096.  This simple design
// does T*L*D masked compares (an AND, a compare and an OR each), about
// 2.6e10 compares for the builtin ruleset's D = 194..198, so it is
// compute-bound by its per-pair loop, far above the bytes bound.  Sharing
// (offset, byte) tests across pairs with __ballot_sync bit planes, and
// staging rows with wide loads, is the way down, left to a later change.

#include <cstdint>
#include <cuda_runtime.h>

#include "sieve_row.cuh"

namespace {

using sieve_row::fold;

template <bool WRAP, int PPT>
__global__ void __launch_bounds__(sieve_row::kThreads)
gram_sieve_kernel(const uint8_t* __restrict__ rows, int length,
                  const uint32_t* __restrict__ masks,
                  const uint32_t* __restrict__ vals, int n_pairs, int n_words,
                  uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_mask = smem;
  uint32_t* s_val = smem + n_pairs;
  uint32_t* s_hit = smem + 2 * n_pairs;
  uint8_t* s_row = reinterpret_cast<uint8_t*>(smem + 2 * n_pairs + n_words);
  const int nthreads = blockDim.x;

  const uint8_t* src = rows + static_cast<size_t>(blockIdx.x) * length;
  for (int i = threadIdx.x; i < n_pairs; i += nthreads) {
    s_mask[i] = masks[i];
    s_val[i] = vals[i];
  }
  for (int i = threadIdx.x; i < n_words; i += nthreads) s_hit[i] = 0;
  for (int i = threadIdx.x; i < length; i += nthreads) s_row[i] = fold(src[i]);
  __syncthreads();
  if (threadIdx.x < 3) {
    s_row[length + threadIdx.x] =
        WRAP ? s_row[threadIdx.x % length] : static_cast<uint8_t>(0);
  }
  __syncthreads();

  sieve_row::sieve_row<PPT>(s_row, length, s_mask, s_val, n_pairs, n_words,
                            s_hit);
  __syncthreads();
  uint32_t* dst = out + static_cast<size_t>(blockIdx.x) * n_words;
  for (int i = threadIdx.x; i < n_words; i += nthreads) dst[i] = s_hit[i];
}

template <bool WRAP, int PPT>
int launch_ppt(const void* rows, int n_rows, int length, const void* masks,
               const void* vals, int n_pairs, int n_words, void* out,
               cudaStream_t stream) {
  const int threads = sieve_row::sieve_threads(length, PPT);
  const size_t smem = (2 * static_cast<size_t>(n_pairs) + n_words) * 4 +
                      static_cast<size_t>(length) + 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gram_sieve_kernel<WRAP, PPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_sieve_kernel<WRAP, PPT><<<n_rows, threads, smem, stream>>>(
      static_cast<const uint8_t*>(rows), length,
      static_cast<const uint32_t*>(masks), static_cast<const uint32_t*>(vals),
      n_pairs, n_words, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <bool WRAP>
int launch(const void* rows, int n_rows, int length, const void* masks,
           const void* vals, int n_pairs, int n_words, void* out,
           void* stream_ptr) {
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (sieve_row::sieve_ppt(length)) {
    case 1:
      return launch_ppt<WRAP, 1>(rows, n_rows, length, masks, vals, n_pairs,
                                 n_words, out, stream);
    case 2:
      return launch_ppt<WRAP, 2>(rows, n_rows, length, masks, vals, n_pairs,
                                 n_words, out, stream);
    case 4:
      return launch_ppt<WRAP, 4>(rows, n_rows, length, masks, vals, n_pairs,
                                 n_words, out, stream);
    case 8:
      return launch_ppt<WRAP, 8>(rows, n_rows, length, masks, vals, n_pairs,
                                 n_words, out, stream);
    default:
      return launch_ppt<WRAP, 16>(rows, n_rows, length, masks, vals, n_pairs,
                                  n_words, out, stream);
  }
}

}  // namespace

extern "C" {

// Bitplane-sieve twin (row-tail wrap).  Returns the cudaError_t of the launch.
int gram_sieve_bitplane(const void* rows, int n_rows, int length,
                        const void* masks, const void* vals, int n_pairs,
                        int n_words, void* out, void* stream) {
  return launch<true>(rows, n_rows, length, masks, vals, n_pairs, n_words, out,
                      stream);
}

// Window-sieve twin (zero-filled row tail).
int gram_sieve_window(const void* rows, int n_rows, int length,
                      const void* masks, const void* vals, int n_pairs,
                      int n_words, void* out, void* stream) {
  return launch<false>(rows, n_rows, length, masks, vals, n_pairs, n_words,
                       out, stream);
}

}  // extern "C"
