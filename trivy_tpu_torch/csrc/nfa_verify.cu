// Device NFA verify for Hopper (sm_90a): bit-parallel 64-position search
// automata over candidate bytes, one byte a step,
//
//     S' = (reach(S) | first) & accept[symbol],   hit = (S' & last) != 0,
//
// reach(S) = OR of follow[p] over the set bits p of S (a ctz loop, as the
// host claim-killer's NFA-64 walk in native/dfa_verify.cpp does it).
//
// Replaces the XLA device programs of trivy_tpu/engine/nfa_device.py, which
// step the same automata as float matrix products of 0/1 tensors under
// lax.scan (exact on 0/1 values, so the bits agree):
//   * nfa_stream_kernel (K5) -> NfaVerifier._stream_multi_impl (:393) and
//     _pack_rule_flags (:436), behind _run_stream_multi (:364): rows [N, L]
//     raw bytes x a stack of rb <= 32 rule slots -> flags [ceil(rb/8), N,
//     L/32] uint8, bit k of byte p (LSB-first) for slot 8p + k, set when a
//     match ends in that 32-byte block.  The same kernel serves the flags
//     of the associative-scan variant _stream_assoc_impl (:452): its
//     summaries only shorten the TPU scan's serial depth.
//   * nfa_fused_verdict_kernel (K5v) -> the verdict half of _run_fused
//     (:572): a lane table (row, slot, b0, b1) -> keep bits, np.packbits
//     order (MSB-first), lane i kept when a flag of (row, slot) is set in a
//     block of [b0, b1).
//   * nfa_padded_kernel (K6) -> _run (:325): class ids [G, Bg, L] x per-group
//     rule -> matched [G, Bg]; each lane walks its whole length, the zero
//     padding past its window included, as the reference does.
//
// Rule words (host-packed by trivy_tpu_torch/ops/nfa_verify.py from the same
// 0/1 tensors the plain versions read) arrive as int64 and are read as
// uint64: K5's rule is follow[64], accept_b[256] (byte 0 forced dead), first,
// last (2,576 bytes); K6's is follow[64], classmask[64], first, last.
//
// Design.  K5: one warp lane per (row, rule slot); the rule stack sits in
// shared memory word-major by slot (word w of slot s at [w * W + s], W the
// slot group width, a power of two >= rb), so the lanes of a group that
// step the same byte read consecutive words.  A warp holds 32 / W rows;
// the lanes of a row load its 32-byte blocks with two 16-byte loads
// (broadcast within the group), step them from registers, and combine
// their hit bits with one ballot a block; lanes s < ceil(rb/8) store the
// flag bytes.  Persistent blocks walk the rows, so the stack is staged once
// per block.  K6: one block per group, one thread per lane, the group's
// rule words in shared memory.  K5v: one thread per lane and one ballot per
// 32 lanes for the packed byte.
//
// Bound on an H100.  Bytes: K5 reads N * L row bytes and writes N * L / 32
// * ceil(rb/8) flag bytes (~0.04 ms for 8,192 rows of 16,384 bytes at
// 3.35 TB/s).  The kernel is bound instead by its serial per-byte chain:
// a shared-memory load of accept[byte] and the reach loop (one dependent
// shared load per active state), ~10-20 instructions a byte and lane, so
// rows x L x rb lane-steps over the card's integer issue rate.  No tensor
// core helps a data-dependent bit-set walk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;          // positions a flag covers
constexpr int kMaxSlots = 32;       // rule slots a launch serves
constexpr int kStreamWords = 322;   // follow[64] accept_b[256] first last
constexpr int kAcceptB = 64;
constexpr int kFirst = 320;
constexpr int kLast = 321;
constexpr int kPaddedWords = 130;   // follow[64] classmask[64] first last
constexpr int kClassMask = 64;
constexpr int kPFirst = 128;
constexpr int kPLast = 129;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// OR of follow[p * stride] over the set bits p of s.
__device__ __forceinline__ uint64_t reach(const uint64_t* follow, int stride,
                                          uint64_t s) {
  uint64_t r = 0;
  while (s) {
    r |= follow[(__ffsll(static_cast<long long>(s)) - 1) * stride];
    s &= s - 1;
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
nfa_stream_kernel(const uint8_t* __restrict__ rows, int n_rows, int length,
                  const uint64_t* __restrict__ words, int rb, int width,
                  uint8_t* __restrict__ flags) {
  extern __shared__ uint64_t s_w[];  // [kStreamWords][width]
  for (int i = threadIdx.x; i < kStreamWords * width; i += blockDim.x) {
    const int w = i / width, slot = i % width;
    s_w[i] = slot < rb ? words[static_cast<size_t>(slot) * kStreamWords + w] : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane & (width - 1);
  const int sub = lane / width;              // row of this lane in the warp
  const int rows_per_warp = 32 / width;
  const int n_groups = (n_rows + rows_per_warp - 1) / rows_per_warp;
  const int n_blocks = length / kBlock;
  const int n_bytes = (rb + 7) / 8;          // flag bytes per block
  const unsigned group_mask = width == 32 ? kFull : ((1u << width) - 1u);
  const uint64_t first = s_w[kFirst * width + slot];
  const uint64_t last = s_w[kLast * width + slot];
  const uint64_t* acc = s_w + kAcceptB * width + slot;
  const uint64_t* fol = s_w + slot;
  for (int g = blockIdx.x * kWarps + warp; g < n_groups; g += gridDim.x * kWarps) {
    const int row = g * rows_per_warp + sub;
    const bool active = row < n_rows;
    const uint4* src = reinterpret_cast<const uint4*>(
        rows + static_cast<size_t>(active ? row : 0) * length);
    uint64_t s = 0;
    for (int j = 0; j < n_blocks; ++j) {
      bool hit = false;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 v = active ? src[2 * j + h] : make_uint4(0, 0, 0, 0);
        const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const uint32_t b = (q[k >> 2] >> (8 * (k & 3))) & 0xFFu;
          s = (reach(fol, width, s) | first) & acc[b * width];
          hit |= (s & last) != 0;
        }
      }
      const unsigned ballot = __ballot_sync(kFull, hit);
      if (active && slot < n_bytes) {
        const unsigned bits = (ballot >> (sub * width)) & group_mask;
        flags[(static_cast<size_t>(slot) * n_rows + row) * n_blocks + j] =
            static_cast<uint8_t>(bits >> (8 * slot));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nfa_fused_verdict_kernel(const uint8_t* __restrict__ flags, int n_bytes,
                         int n_rows, int n_blocks,
                         const int* __restrict__ lane_row,
                         const int* __restrict__ lane_slot,
                         const int* __restrict__ lane_b0,
                         const int* __restrict__ lane_b1, int n_lanes,
                         uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool keep = false;
  if (i < n_lanes) {
    const int row = lane_row[i], slot = lane_slot[i];
    const int b0 = max(lane_b0[i], 0), b1 = min(lane_b1[i], n_blocks);
    if (row >= 0 && row < n_rows && slot >= 0 && slot < 8 * n_bytes) {
      const uint8_t* f =
          flags + (static_cast<size_t>(slot >> 3) * n_rows + row) * n_blocks;
      const uint8_t bit = static_cast<uint8_t>(1u << (slot & 7));
      for (int j = b0; j < b1 && !keep; ++j) keep = (f[j] & bit) != 0;
    }
  }
  const unsigned ballot = __ballot_sync(kFull, keep);
  const int lane = threadIdx.x & 31;
  if (i < n_lanes && (lane & 7) == 0) {
    // lanes 8k .. 8k + 7 -> one byte, lane 8k in its most significant bit
    out[i >> 3] = static_cast<uint8_t>(__brev((ballot >> lane) & 0xFFu) >> 24);
  }
}

__global__ void __launch_bounds__(64)
nfa_padded_kernel(const uint8_t* __restrict__ classes, int bg, int length,
                  const int* __restrict__ gids, const uint64_t* __restrict__ words,
                  int n_rules, bool* __restrict__ matched) {
  __shared__ uint64_t s_w[kPaddedWords];
  const int grp = blockIdx.x;
  const int r = gids[grp];
  const bool valid = r >= 0 && r < n_rules;
  for (int k = threadIdx.x; k < kPaddedWords; k += blockDim.x) {
    s_w[k] = valid ? words[static_cast<size_t>(r) * kPaddedWords + k] : 0;
  }
  __syncthreads();
  const uint64_t first = s_w[kPFirst], last = s_w[kPLast];
  for (int b = threadIdx.x; b < bg; b += blockDim.x) {
    const uint4* src = reinterpret_cast<const uint4*>(
        classes + (static_cast<size_t>(grp) * bg + b) * length);
    uint64_t s = 0;
    bool m = false;
    for (int t = 0; t < length / 16; ++t) {
      const uint4 v = src[t];
      const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t c = (q[k >> 2] >> (8 * (k & 3))) & 0xFFu;
        const uint64_t cmask = c < 64 ? s_w[kClassMask + c] : 0;
        s = (reach(s_w, 1, s) | first) & cmask;
        m |= (s & last) != 0;
      }
    }
    matched[static_cast<size_t>(grp) * bg + b] = m;
  }
}

// Blocks to launch: enough for the work, at most what the SMs hold at once.
template <class Kernel>
int grid_size(Kernel kernel, int threads, size_t smem, int work_blocks,
              cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (*err == cudaSuccess && smem > 48 * 1024) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  if (*err == cudaSuccess) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                         smem);
  }
  if (*err != cudaSuccess) return 0;
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  return work_blocks < fit ? (work_blocks > 0 ? work_blocks : 1) : fit;
}

}  // namespace

extern "C" {

// K5.  rows [n_rows, length] uint8 (length a multiple of 32, 16-byte
// aligned), words [rb, 322] uint64 bit patterns (1 <= rb <= 32), flags
// [ceil(rb/8), n_rows, length/32] uint8, every byte written.  Returns the
// cudaError_t of the launch.
int nfa_stream(const void* rows, int n_rows, int length, const void* words,
               int rb, void* flags, void* stream) {
  if (rb < 1 || rb > kMaxSlots || length % kBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0 || length == 0) return static_cast<int>(cudaSuccess);
  int width = 1;
  while (width < rb) width *= 2;
  const size_t smem = static_cast<size_t>(kStreamWords) * width * sizeof(uint64_t);
  const int rows_per_warp = 32 / width;
  const int n_groups = (n_rows + rows_per_warp - 1) / rows_per_warp;
  cudaError_t err;
  const int blocks = grid_size(nfa_stream_kernel, kThreads, smem,
                               (n_groups + kWarps - 1) / kWarps, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  nfa_stream_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), n_rows, length,
      static_cast<const uint64_t*>(words), rb, width,
      static_cast<uint8_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

// K5v.  flags [n_bytes, n_rows, n_blocks] uint8, lane tables [n_lanes] int32
// (n_lanes a multiple of 8), out [n_lanes / 8] uint8.  A lane outside the
// flags keeps nothing.
int nfa_fused_verdict(const void* flags, int n_bytes, int n_rows, int n_blocks,
                      const void* lane_row, const void* lane_slot,
                      const void* lane_b0, const void* lane_b1, int n_lanes,
                      void* out, void* stream) {
  if (n_lanes % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  nfa_fused_verdict_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flags), n_bytes, n_rows, n_blocks,
      static_cast<const int*>(lane_row), static_cast<const int*>(lane_slot),
      static_cast<const int*>(lane_b0), static_cast<const int*>(lane_b1), n_lanes,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K6.  classes [g, bg, length] uint8 (length a multiple of 16, 16-byte
// aligned, ids < 64), gids [g] int32, words [n_rules, 130] uint64 bit
// patterns, matched [g, bg] bool.  A group id outside the rules matches
// nothing.
int nfa_padded(const void* classes, int g, int bg, int length, const void* gids,
               const void* words, int n_rules, void* matched, void* stream) {
  if (length % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (g == 0 || bg == 0) return static_cast<int>(cudaSuccess);
  nfa_padded_kernel<<<g, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(classes), bg, length,
      static_cast<const int*>(gids), static_cast<const uint64_t*>(words), n_rules,
      static_cast<bool*>(matched));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
