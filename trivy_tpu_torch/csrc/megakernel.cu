// The megakernel for Hopper (sm_90a): coded link rows -> per-file distinct
// gram counts -> packed verdict bits.
//
// Replaces the two Pallas TPU programs of trivy_tpu/ops/megakernel.py:
//   * `mega_mask` -> `MegaGramSieve._invoke(emit="mask")` (pallas_call at
//     :435, kernel :403, body :327): unpack, sieve, per-file counts, then
//     `derive_counts_to_mask` (:74) and `pack_mask_bits` (:108).
//   * `mega_count` -> `_invoke(emit="acc")` (pallas_call at :483, kernel
//     :462): the counts alone, row ids offset by the shard's `base`.
//   * `mega_epilogue` is the derive + pack on their own, which the split
//     path (`make_sharded_megakernel`, :543) runs after summing partials.
//
// Count kernel: one block per row.  The block first lists the files whose
// inclusive row range [lo_f, hi_f] holds the row's global id base + r, and
// leaves at once when there is none (padding rows).  It then unpacks the
// row into shared memory with the algebra of `_unpack_to_lanes` (:126):
// 4-bit symbol 2i is the low nibble of byte i and 2i+1 the high one, 6-bit
// takes 3 bytes to 4 symbols, raw bytes fold 0x41..0x5A to lowercase (class
// ids never fold).  The last 3 positions read the row's own head, as the TPU
// kernel's lane rotation does.  The compare loop of sieve_row.cuh gives the
// row's distinct-pair hit bits (whole-byte pairs, K1's semantics), and for
// every listed file and set bit d the block adds 1 to acc[f, d] with an int32
// atomicAdd: integer atomics are exact and order-free, so the counts equal
// the TPU kernel's int8 MXU counts whatever order the blocks run in.  The
// caller zeroes `acc`.
//
// Epilogue kernel: one block per file.  It thresholds the counts (gh = acc >
// 0 & valid), then runs the derive chain as integer loops over the int8
// constants in device memory (L2-resident after the first blocks):
// win = any(gh . dw), ph = (win . pm >= pw) | ng, gate_ok = !ga | ph . gm > 0,
// conj_ok over k < K with column stride K, each product accumulated in int32
// exactly as the TPU's int8 x int8 -> int32 dots.  Each loop skips the terms
// whose 0/1 left operand is 0, which leaves the sums unchanged.  It packs the
// verdicts MSB-first: bit b of byte j is rule 8j + b at position 7 - b (the
// np.packbits order).  `mega_mask` launches the count kernel and then the
// epilogue on one stream, so every count is final before any threshold; no
// partial count is ever thresholded.
//
// Bound on an H100, at the slice's shape (T = 4096 coded rows of 2048 bytes,
// Fp = 2048 files, D = 194 pairs): the function reads 8.4 MB and writes
// 22 KB, about 2.5 us at 3.35 TB/s.  The count stage does T*L*D masked
// compares (3.3e9 at L = 4096) in the per-pair loop, as K1 does, and the
// epilogue about 170k int8 multiply-adds a file written as scalar loops, so
// this simple design is compute-bound far above its bytes bound.  Sharing
// (offset, byte) tests across pairs, int8 mma.sync for the epilogue and
// shared-memory partial counts per row block are the way down, left to a
// later change.

#include <cstdint>
#include <cuda_runtime.h>

#include "sieve_row.cuh"

namespace {

constexpr int kEpilogueThreads = 256;

template <int PPT>
__global__ void __launch_bounds__(sieve_row::kThreads)
mega_count_kernel(const uint8_t* __restrict__ coded, int coded_cols,
                  int length, int sym_bits, const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ hi,
                  const int32_t* __restrict__ base, int fp,
                  const uint32_t* __restrict__ masks,
                  const uint32_t* __restrict__ vals, int n_pairs, int n_words,
                  int32_t* __restrict__ acc) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_nfiles;
  uint32_t* s_mask = smem;
  uint32_t* s_val = smem + n_pairs;
  uint32_t* s_hit = smem + 2 * n_pairs;
  int* s_files = reinterpret_cast<int*>(smem + 2 * n_pairs + n_words);
  uint8_t* s_row =
      reinterpret_cast<uint8_t*>(smem + 2 * n_pairs + n_words + fp);
  const int nthreads = blockDim.x;
  const int row = blockIdx.x;
  const int rid = (base != nullptr ? base[0] : 0) + row;

  if (threadIdx.x == 0) s_nfiles = 0;
  __syncthreads();
  for (int f = threadIdx.x; f < fp; f += nthreads) {
    if (lo[f] <= rid && rid <= hi[f]) s_files[atomicAdd(&s_nfiles, 1)] = f;
  }
  __syncthreads();
  const int n_files = s_nfiles;
  if (n_files == 0) return;  // a row of no file adds nothing

  for (int i = threadIdx.x; i < n_pairs; i += nthreads) {
    s_mask[i] = masks[i];
    s_val[i] = vals[i];
  }
  for (int i = threadIdx.x; i < n_words; i += nthreads) s_hit[i] = 0;
  const uint8_t* src = coded + static_cast<size_t>(row) * coded_cols;
  if (sym_bits == 4) {
    for (int i = threadIdx.x; i < coded_cols; i += nthreads) {
      const uint8_t b = src[i];
      s_row[2 * i] = b & 0x0F;
      s_row[2 * i + 1] = b >> 4;
    }
  } else if (sym_bits == 6) {
    for (int g = threadIdx.x; g < coded_cols / 3; g += nthreads) {
      const uint32_t b0 = src[3 * g];
      const uint32_t b1 = src[3 * g + 1];
      const uint32_t b2 = src[3 * g + 2];
      s_row[4 * g] = static_cast<uint8_t>(b0 & 0x3F);
      s_row[4 * g + 1] = static_cast<uint8_t>((b0 >> 6) | ((b1 & 0x0F) << 2));
      s_row[4 * g + 2] = static_cast<uint8_t>((b1 >> 4) | ((b2 & 0x03) << 4));
      s_row[4 * g + 3] = static_cast<uint8_t>(b2 >> 2);
    }
  } else {
    for (int i = threadIdx.x; i < length; i += nthreads) {
      s_row[i] = sieve_row::fold(src[i]);
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) s_row[length + threadIdx.x] = s_row[threadIdx.x];
  __syncthreads();

  sieve_row::sieve_row<PPT>(s_row, length, s_mask, s_val, n_pairs, n_words,
                            s_hit);
  __syncthreads();

  const int total = n_files * n_pairs;
  for (int i = threadIdx.x; i < total; i += nthreads) {
    const int d = i % n_pairs;
    if ((s_hit[d >> 5] >> (d & 31)) & 1u) {
      atomicAdd(&acc[static_cast<size_t>(s_files[i / n_pairs]) * n_pairs + d],
                1);
    }
  }
}

__global__ void __launch_bounds__(kEpilogueThreads)
mega_epilogue_kernel(const int32_t* __restrict__ acc,
                     const int8_t* __restrict__ valid, int d,
                     const int8_t* __restrict__ dw, int w,
                     const int8_t* __restrict__ pm, int p,
                     const int32_t* __restrict__ pw,
                     const int8_t* __restrict__ ng,
                     const int8_t* __restrict__ gm, int r,
                     const int8_t* __restrict__ ga,
                     const int8_t* __restrict__ cm, int k,
                     const int8_t* __restrict__ ca, int mask_bytes,
                     uint8_t* __restrict__ out) {
  extern __shared__ uint8_t sbytes[];
  uint8_t* s_gh = sbytes;       // [d]
  uint8_t* s_win = s_gh + d;    // [w]
  uint8_t* s_ph = s_win + w;    // [p]
  uint8_t* s_cand = s_ph + p;   // [mask_bytes * 8]
  const int nthreads = blockDim.x;
  const int f = blockIdx.x;
  const bool vf = valid[f] > 0;

  for (int i = threadIdx.x; i < d; i += nthreads) {
    s_gh[i] = vf && acc[static_cast<size_t>(f) * d + i] > 0;
  }
  for (int c = threadIdx.x; c < mask_bytes * 8; c += nthreads) s_cand[c] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += nthreads) {
    int sum = 0;
    for (int i = 0; i < d; ++i) {
      if (s_gh[i]) sum += dw[static_cast<size_t>(i) * w + j];
    }
    s_win[j] = sum > 0;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < p; q += nthreads) {
    int sum = 0;
    for (int j = 0; j < w; ++j) {
      if (s_win[j]) sum += pm[static_cast<size_t>(j) * p + q];
    }
    s_ph[q] = sum >= pw[q] || ng[q] > 0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < r; c += nthreads) {
    int gate = 0;
    for (int q = 0; q < p; ++q) {
      if (s_ph[q]) gate += gm[static_cast<size_t>(q) * r + c];
    }
    bool ok = ga[c] == 0 || gate > 0;
    for (int kk = 0; kk < k; ++kk) {
      int conj = 0;
      for (int q = 0; q < p; ++q) {
        if (s_ph[q]) conj += cm[static_cast<size_t>(q) * r * k + c * k + kk];
      }
      ok = ok && (ca[kk * r + c] == 0 || conj > 0);
    }
    s_cand[c] = ok && vf;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < mask_bytes; j += nthreads) {
    uint32_t byte = 0;
    for (int b = 0; b < 8; ++b) {
      if (s_cand[8 * j + b]) byte |= 0x80u >> b;
    }
    out[static_cast<size_t>(f) * mask_bytes + j] = static_cast<uint8_t>(byte);
  }
}

template <int PPT>
int launch_count_ppt(const void* coded, int n_rows, int coded_cols,
                     int length, int sym_bits, const void* lo, const void* hi,
                     const void* base, int fp, const void* masks,
                     const void* vals, int n_pairs, void* acc,
                     cudaStream_t stream) {
  const int n_words = (n_pairs + 31) / 32;
  const int threads = sieve_row::sieve_threads(length, PPT);
  const size_t smem =
      (2 * static_cast<size_t>(n_pairs) + n_words + fp) * 4 +
      static_cast<size_t>(length) + 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mega_count_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mega_count_kernel<PPT><<<n_rows, threads, smem, stream>>>(
      static_cast<const uint8_t*>(coded), coded_cols, length, sym_bits,
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(base), fp,
      static_cast<const uint32_t*>(masks), static_cast<const uint32_t*>(vals),
      n_pairs, n_words, static_cast<int32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

int launch_count(const void* coded, int n_rows, int coded_cols, int length,
                 int sym_bits, const void* lo, const void* hi,
                 const void* base, int fp, const void* masks, const void* vals,
                 int n_pairs, void* acc, cudaStream_t stream) {
  if (n_rows == 0 || fp == 0) return static_cast<int>(cudaSuccess);
  switch (sieve_row::sieve_ppt(length)) {
    case 1:
      return launch_count_ppt<1>(coded, n_rows, coded_cols, length, sym_bits,
                                 lo, hi, base, fp, masks, vals, n_pairs, acc,
                                 stream);
    case 2:
      return launch_count_ppt<2>(coded, n_rows, coded_cols, length, sym_bits,
                                 lo, hi, base, fp, masks, vals, n_pairs, acc,
                                 stream);
    case 4:
      return launch_count_ppt<4>(coded, n_rows, coded_cols, length, sym_bits,
                                 lo, hi, base, fp, masks, vals, n_pairs, acc,
                                 stream);
    case 8:
      return launch_count_ppt<8>(coded, n_rows, coded_cols, length, sym_bits,
                                 lo, hi, base, fp, masks, vals, n_pairs, acc,
                                 stream);
    default:
      return launch_count_ppt<16>(coded, n_rows, coded_cols, length, sym_bits,
                                  lo, hi, base, fp, masks, vals, n_pairs, acc,
                                  stream);
  }
}

int launch_epilogue(const void* acc, const void* valid, int fp, int d,
                    const void* dw, int w, const void* pm, int p,
                    const void* pw, const void* ng, const void* gm, int r,
                    const void* ga, const void* cm, int k, const void* ca,
                    int mask_bytes, void* out, cudaStream_t stream) {
  if (fp == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(d) + w + p + 8 * mask_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mega_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mega_epilogue_kernel<<<fp, kEpilogueThreads, smem, stream>>>(
      static_cast<const int32_t*>(acc), static_cast<const int8_t*>(valid), d,
      static_cast<const int8_t*>(dw), w, static_cast<const int8_t*>(pm), p,
      static_cast<const int32_t*>(pw), static_cast<const int8_t*>(ng),
      static_cast<const int8_t*>(gm), r, static_cast<const int8_t*>(ga),
      static_cast<const int8_t*>(cm), k, static_cast<const int8_t*>(ca),
      mask_bytes, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4: adds the per-file distinct-pair counts of rows [base, base + n_rows)
// into `acc` [fp, n_pairs] int32 (zeroed by the caller).  `base` points at
// one int32 on the device, or is null for 0.  sym_bits is 4, 6, or 0 for raw
// bytes.  Returns the cudaError_t of the launch.
int mega_count(const void* coded, int n_rows, int coded_cols, int length,
               int sym_bits, const void* lo, const void* hi, const void* base,
               int fp, const void* masks, const void* vals, int n_pairs,
               void* acc, void* stream) {
  return launch_count(coded, n_rows, coded_cols, length, sym_bits, lo, hi,
                      base, fp, masks, vals, n_pairs, acc,
                      static_cast<cudaStream_t>(stream));
}

// The derive + pack epilogue alone: final counts [fp, d] -> mask
// [fp, mask_bytes] uint8.
int mega_epilogue(const void* acc, const void* valid, int fp, int d,
                  const void* dw, int w, const void* pm, int p,
                  const void* pw, const void* ng, const void* gm, int r,
                  const void* ga, const void* cm, int k, const void* ca,
                  int mask_bytes, void* out, void* stream) {
  return launch_epilogue(acc, valid, fp, d, dw, w, pm, p, pw, ng, gm, r, ga,
                         cm, k, ca, mask_bytes, out,
                         static_cast<cudaStream_t>(stream));
}

// K3: the count kernel into the zeroed scratch `acc`, then the epilogue, in
// stream order.
int mega_mask(const void* coded, int n_rows, int coded_cols, int length,
              int sym_bits, const void* lo, const void* hi, const void* valid,
              int fp, const void* masks, const void* vals, int n_pairs,
              void* acc, const void* dw, int w, const void* pm, int p,
              const void* pw, const void* ng, const void* gm, int r,
              const void* ga, const void* cm, int k, const void* ca,
              int mask_bytes, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_count(coded, n_rows, coded_cols, length, sym_bits, lo,
                               hi, nullptr, fp, masks, vals, n_pairs, acc, s);
  if (err != 0) return err;
  return launch_epilogue(acc, valid, fp, n_pairs, dw, w, pm, p, pw, ng, gm, r,
                         ga, cm, k, ca, mask_bytes, out, s);
}

}  // extern "C"
