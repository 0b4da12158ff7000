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
// Count kernel: the table core of sieve_row.cuh, persistent blocks of 8
// warps.  A block takes a run of 8 consecutive rows, one a warp (run i goes
// to block i mod grid first, so the rows, and the padding rows among them,
// spread over the SMs), and its threads list once the files whose
// inclusive row range [lo_f, hi_f] meets the run, up to 1,024 files in
// shared memory; a run of more files lists nothing, and its rows scan every
// range instead.  Scanning all Fp ranges for every row cost ~30% of the
// count stage at Fp = 2,048 on an H100; a run pays it once for 8 rows.
// Each warp then picks from the run's list the files that hold its row's
// global id base + r (a ballot, up to 32 files kept in shared memory; a row
// shared by more picks them again when it adds), and skips the row when
// there is none (padding rows).  Its lanes then read the row's symbols straight from the coded bytes (16 a
// lane: 8 bytes at 4 bits, 12 at 6, 16 raw; `_unpack_to_lanes` :126 is the
// same algebra), with the row's own head past its end, as the TPU kernel's
// lane rotation does.  The table holds the whole-byte pairs (K1's
// semantics) over the 16 or 64 class ids, or over 256 raw bytes with the
// case fold baked in (class ids never fold).  A warp OR gives the row's
// hit bits; lane b then adds 1 to acc[f, 32 w + b] for every listed file f
// and set bit, with an int32 atomicAdd: integer atomics are exact and
// order-free, so the counts equal the TPU kernel's int8 MXU counts whatever
// order the warps run in.  The caller zeroes `acc`.
//
// Epilogue kernel: one warp a file (persistent, interleaved as above), on
// bitsets.  The host packs the 0/1 derive constants as bit rows: dw
// [W][ceil(D/32)], pm [P][ceil(W/32)], gm [R][ceil(P/32)], cm
// [R*K][ceil(P/32)].  Then gh = ballot(acc > 0 & valid), win_j =
// (gh & dw_j) != 0, ph_q = popc(win & pm_q) >= pw_q | ng_q, gate_c = !ga_c
// | (ph & gm_c) != 0, conj likewise per k: with 0/1 operands each int8 dot
// of the TPU kernel is the popcount of an AND, so the verdicts are exact.
// It packs them MSB-first: bit b of byte j is rule 8j + b at position 7 - b
// (the np.packbits order).  `mega_mask` launches the count kernel and then
// the epilogue on one stream, so every count is final before any
// threshold; no partial count is ever thresholded.
//
// Bound on an H100, at the serve shape (T = 4096 coded rows of 2048 bytes,
// Fp = 2048 files, D = 194 pairs): the function reads 8.4 MB and writes
// 22 KB, about 2.5 us at 3.35 TB/s.  The count stage is bound by the
// table lookups as K1 is (4 x 8 LDS.32 a position; 4-bit class ids never
// conflict), ~0.07 ms for 4096 full rows; the listing adds a scan of the
// Fp ranges per run of 8 rows and the adds one atomic per (file, set bit).
// The epilogue is ~5k word operations a file.

#include <cstdint>
#include <cuda_runtime.h>

#include "sieve_row.cuh"

namespace {

using sieve_row::kChunk;
using sieve_row::kFull;
using sieve_row::kSliceWords;
using sieve_row::kSyms;
using sieve_row::kWarps;

constexpr int kFileCap = 32;   // files a warp keeps listed for its row
constexpr int kRunCap = 1024;  // files a block keeps listed for its run

// Lane b adds 1 to acc[f, d0 + 32 w] for each word w of the row's hits whose
// bit b is set (d0 = the slice's first pair + b).
__device__ __forceinline__ void add_hits(int32_t* __restrict__ acc, int f,
                                         int n_pairs, int d0, int lane,
                                         const uint32_t (&hit)[kSliceWords]) {
  int32_t* dst = acc + static_cast<size_t>(f) * n_pairs + d0;
#pragma unroll
  for (int w = 0; w < kSliceWords; ++w) {
    if (((hit[w] >> lane) & 1u) && d0 + 32 * w < n_pairs) {
      atomicAdd(dst + 32 * w, 1);
    }
  }
}

template <int B>
__global__ void __launch_bounds__(sieve_row::kThreads, sieve_row::kMinBlocks)
mega_count_kernel(const uint8_t* __restrict__ coded, int n_rows,
                  int coded_cols, int length, const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ hi,
                  const int32_t* __restrict__ base, int fp,
                  const uint32_t* __restrict__ table, int n_slices,
                  int n_pairs, int32_t* __restrict__ acc) {
  constexpr int S = 1 << B;
  constexpr int kTab = sieve_row::table_words<S>();
  extern __shared__ uint4 smem4[];
  __shared__ int s_n_run;
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* s_run = reinterpret_cast<int*>(s_tab + kTab);
  int* s_files = s_run + kRunCap + warp * kFileCap;
  const int rid0 = base != nullptr ? __ldg(base) : 0;
  const int n_chunks = length / kChunk;
  const unsigned below = (1u << lane) - 1u;

  for (int sl = 0; sl < n_slices; ++sl) {
    __syncthreads();  // every lookup of the previous slice is done
    sieve_row::stage_table(s_tab, table + static_cast<size_t>(sl) * kTab, kTab);
    for (int r0 = blockIdx.x * kWarps; r0 < n_rows; r0 += gridDim.x * kWarps) {
      const int first = rid0 + r0;
      const int last = rid0 + min(r0 + kWarps, n_rows) - 1;
      if (threadIdx.x == 0) s_n_run = 0;
      __syncthreads();  // the table is staged, the last run's lists are done
      for (int f = threadIdx.x; f < fp; f += blockDim.x) {
        const int a = __ldg(lo + f);
        const int b = __ldg(hi + f);
        if (a <= b && a <= last && first <= b) {
          const int at = atomicAdd(&s_n_run, 1);
          if (at < kRunCap) s_run[at] = f;
        }
      }
      __syncthreads();
      // The row's candidates: the run's files, or every lane when the run
      // has more than the list holds.  pick(i) is candidate i's file when
      // it holds the row, else -1.
      const bool listed = s_n_run <= kRunCap;
      const int n_cand = listed ? s_n_run : fp;
      const int row = r0 + warp;
      const int rid = rid0 + row;
      auto pick = [&](int i) {
        if (i >= n_cand) return -1;
        const int f = listed ? s_run[i] : i;
        return __ldg(lo + f) <= rid && rid <= __ldg(hi + f) ? f : -1;
      };
      int n_files = 0;
      for (int i0 = 0; row < n_rows && i0 < n_cand; i0 += 32) {
        const int f = pick(i0 + lane);
        const unsigned b = __ballot_sync(kFull, f >= 0);
        const int at = n_files + __popc(b & below);
        if (f >= 0 && at < kFileCap) s_files[at] = f;
        n_files += __popc(b);
      }
      __syncwarp();
      if (n_files > 0) {  // a row of no file adds nothing
        const uint8_t* src = coded + static_cast<size_t>(row) * coded_cols;
        uint32_t hit[kSliceWords];
#pragma unroll
        for (int w = 0; w < kSliceWords; ++w) hit[w] = 0;
        for (int c = lane; c < n_chunks; c += 32) {
          uint32_t sym[kSyms];
          sieve_row::fetch_chunk<B, true>(src, coded_cols, c, sym);
          sieve_row::sieve_chunk<S>(s_tab, sym, kChunk, hit);
        }
#pragma unroll
        for (int w = 0; w < kSliceWords; ++w) {
          hit[w] = __reduce_or_sync(kFull, hit[w]);
        }

        const int d0 = sl * kSliceWords * 32 + lane;
        if (n_files <= kFileCap) {
          for (int i = 0; i < n_files; ++i) {
            add_hits(acc, s_files[i], n_pairs, d0, lane, hit);
          }
        } else {
          for (int i0 = 0; i0 < n_cand; i0 += 32) {
            const int f = pick(i0 + lane);
            unsigned b = __ballot_sync(kFull, f >= 0);
            while (b) {
              add_hits(acc, __shfl_sync(kFull, f, __ffs(b) - 1), n_pairs, d0,
                       lane, hit);
              b &= b - 1;
            }
          }
        }
      }
      __syncthreads();  // the lists are rewritten for the next run
    }
  }
}

__global__ void __launch_bounds__(sieve_row::kThreads, sieve_row::kMinBlocks)
mega_epilogue_kernel(const int32_t* __restrict__ acc,
                     const int8_t* __restrict__ valid, int fp, int d,
                     const uint32_t* __restrict__ dw, int w,
                     const uint32_t* __restrict__ pm, int p,
                     const int32_t* __restrict__ pw,
                     const int8_t* __restrict__ ng,
                     const uint32_t* __restrict__ gm, int r,
                     const int8_t* __restrict__ ga,
                     const uint32_t* __restrict__ cm, int k,
                     const int8_t* __restrict__ ca, int mask_bytes,
                     uint8_t* __restrict__ out) {
  extern __shared__ uint32_t s_bits[];
  const int dwords = (d + 31) / 32;
  const int wwords = (w + 31) / 32;
  const int pwords = (p + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* s_gh = s_bits + warp * (dwords + wwords + pwords);
  uint32_t* s_win = s_gh + dwords;
  uint32_t* s_ph = s_win + wwords;

  for (int f = blockIdx.x + gridDim.x * warp; f < fp;
       f += gridDim.x * kWarps) {
    const bool vf = valid[f] > 0;
    const int32_t* row = acc + static_cast<size_t>(f) * d;
    for (int i = 0; i < dwords; ++i) {
      const int x = 32 * i + lane;
      const unsigned b = __ballot_sync(kFull, vf && x < d && row[x] > 0);
      if (lane == 0) s_gh[i] = b;
    }
    __syncwarp();
    for (int i = 0; i < wwords; ++i) {
      const int j = 32 * i + lane;
      bool on = false;
      if (j < w) {
        const uint32_t* col = dw + static_cast<size_t>(j) * dwords;
        for (int x = 0; x < dwords; ++x) on |= (s_gh[x] & __ldg(col + x)) != 0;
      }
      const unsigned b = __ballot_sync(kFull, on);
      if (lane == 0) s_win[i] = b;
    }
    __syncwarp();
    for (int i = 0; i < pwords; ++i) {
      const int q = 32 * i + lane;
      bool on = false;
      if (q < p) {
        const uint32_t* col = pm + static_cast<size_t>(q) * wwords;
        int n = 0;
        for (int x = 0; x < wwords; ++x) n += __popc(s_win[x] & __ldg(col + x));
        on = n >= __ldg(pw + q) || ng[q] > 0;
      }
      const unsigned b = __ballot_sync(kFull, on);
      if (lane == 0) s_ph[i] = b;
    }
    __syncwarp();
    auto any_ph = [&](const uint32_t* col) {
      bool on = false;
      for (int x = 0; x < pwords; ++x) on |= (s_ph[x] & __ldg(col + x)) != 0;
      return on;
    };
    for (int i = 0; 32 * i < r; ++i) {
      const int c = 32 * i + lane;
      bool ok = vf && c < r;
      if (ok && ga[c] != 0) ok = any_ph(gm + static_cast<size_t>(c) * pwords);
      for (int kk = 0; kk < k && ok; ++kk) {
        if (ca[kk * r + c] != 0) {
          ok = any_ph(cm + (static_cast<size_t>(c) * k + kk) * pwords);
        }
      }
      const unsigned b = __ballot_sync(kFull, ok);
      // byte m of the ballot is rules 32i + 8m .. + 7, LSB first
      const int j = 4 * i + lane;
      if (lane < 4 && j < mask_bytes) {
        out[static_cast<size_t>(f) * mask_bytes + j] =
            static_cast<uint8_t>(__brev((b >> (8 * lane)) & 0xFFu) >> 24);
      }
    }
    __syncwarp();  // the bitsets are rewritten for the next file
  }
}

template <int B>
int launch_count_kernel(const void* coded, int n_rows, int coded_cols,
                        int length, const void* lo, const void* hi,
                        const void* base, int fp, const void* table,
                        int n_pairs, void* acc, cudaStream_t stream) {
  auto kernel = mega_count_kernel<B>;
  const size_t smem = sieve_row::table_words<(1 << B)>() * 4 +
                      static_cast<size_t>(kRunCap + kWarps * kFileCap) * 4;
  cudaError_t err;
  const int blocks = sieve_row::persistent_blocks(
      kernel, smem, (n_rows + kWarps - 1) / kWarps, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_words = (n_pairs + 31) / 32;
  kernel<<<blocks, sieve_row::kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(coded), n_rows, coded_cols, length,
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(base), fp,
      static_cast<const uint32_t*>(table),
      (n_words + kSliceWords - 1) / kSliceWords, n_pairs,
      static_cast<int32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

int launch_count(const void* coded, int n_rows, int coded_cols, int length,
                 int sym_bits, const void* lo, const void* hi,
                 const void* base, int fp, const void* table, int n_pairs,
                 void* acc, cudaStream_t stream) {
  if (n_rows == 0 || fp == 0) return static_cast<int>(cudaSuccess);
  switch (sym_bits) {
    case 4:
      return launch_count_kernel<4>(coded, n_rows, coded_cols, length, lo, hi,
                                    base, fp, table, n_pairs, acc, stream);
    case 6:
      return launch_count_kernel<6>(coded, n_rows, coded_cols, length, lo, hi,
                                    base, fp, table, n_pairs, acc, stream);
    case 0:
      return launch_count_kernel<8>(coded, n_rows, coded_cols, length, lo, hi,
                                    base, fp, table, n_pairs, acc, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_epilogue(const void* acc, const void* valid, int fp, int d,
                    const void* dw, int w, const void* pm, int p,
                    const void* pw, const void* ng, const void* gm, int r,
                    const void* ga, const void* cm, int k, const void* ca,
                    int mask_bytes, void* out, cudaStream_t stream) {
  if (fp == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kWarps) * 4 *
                      ((d + 31) / 32 + (w + 31) / 32 + (p + 31) / 32);
  cudaError_t err;
  const int blocks = sieve_row::persistent_blocks(
      mega_epilogue_kernel, smem, (fp + kWarps - 1) / kWarps, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  mega_epilogue_kernel<<<blocks, sieve_row::kThreads, smem, stream>>>(
      static_cast<const int32_t*>(acc), static_cast<const int8_t*>(valid), fp,
      d, static_cast<const uint32_t*>(dw), w, static_cast<const uint32_t*>(pm),
      p, static_cast<const int32_t*>(pw), static_cast<const int8_t*>(ng),
      static_cast<const uint32_t*>(gm), r, static_cast<const int8_t*>(ga),
      static_cast<const uint32_t*>(cm), k, static_cast<const int8_t*>(ca),
      mask_bytes, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K4: adds the per-file distinct-pair counts of rows [base, base + n_rows)
// into `acc` [fp, n_pairs] int32 (zeroed by the caller).  `base` points at
// one int32 on the device, or is null for 0.  sym_bits is 4, 6, or 0 for raw
// bytes; `table` is the pair-set table [ceil(Dw / 8), 4, 8, 2^sym_bits or
// 256] uint32 of the whole-byte pairs, and `coded` starts 16-byte aligned.
// Returns the cudaError_t of the launch.
int mega_count(const void* coded, int n_rows, int coded_cols, int length,
               int sym_bits, const void* lo, const void* hi, const void* base,
               int fp, const void* table, int n_pairs, void* acc,
               void* stream) {
  return launch_count(coded, n_rows, coded_cols, length, sym_bits, lo, hi,
                      base, fp, table, n_pairs, acc,
                      static_cast<cudaStream_t>(stream));
}

// The derive + pack epilogue alone: final counts [fp, d] -> mask
// [fp, mask_bytes] uint8.  dw, pm, gm and cm are the packed bit rows.
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
              int fp, const void* table, int n_pairs, void* acc,
              const void* dw, int w, const void* pm, int p,
              const void* pw, const void* ng, const void* gm, int r,
              const void* ga, const void* cm, int k, const void* ca,
              int mask_bytes, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_count(coded, n_rows, coded_cols, length, sym_bits, lo,
                               hi, nullptr, fp, table, n_pairs, acc, s);
  if (err != 0) return err;
  return launch_epilogue(acc, valid, fp, n_pairs, dw, w, pm, p, pw, ng, gm, r,
                         ga, cm, k, ca, mask_bytes, out, s);
}

}  // extern "C"
