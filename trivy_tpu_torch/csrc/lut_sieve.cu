// The packed shift-AND (LUT) probe sieve for Hopper (sm_90a): tiles [T, L]
// uint8 x a LUT [J, 256, Pw] uint32 -> per-tile probe-hit words [T, Pw],
//
//     acc[t, i] = AND_{j < J} lut[j, tiles[t, i + j]]   for i < L - J + 1,
//     hits[t]   = OR_i acc[t, i],
//
// bit p of word w set when probe 32 w + p matches at some position of the
// tile.  Rows j past a probe's length are all ones (`ProbeSet.build_lut`),
// so a probe shorter than J needs no special case.
//
// Replaces the XLA program trivy_tpu/ops/sieve.py `sieve_tiles` (:27, B6,
// jitted at :43), the reference engine's sieve="lut".  XLA fuses its J
// gathers and ANDs; in PyTorch's eager mode each step would write a
// [T, L - J + 1, Pw] intermediate to device memory.
//
// Design.
// * Byte classes.  Bytes whose LUT columns are equal at every offset share
//   a class (67 for the builtin ruleset's 176 probes, J = 12, Pw = 6); the
//   host (`ops/lut_sieve.py` `lut_tables`) numbers them so that frequent
//   text bytes get ids below 32.  The table is [J, C, ST] words with an odd
//   stride ST = Pw | 1: word w of class c at offset j lies at
//   (j C + c) ST + w, so lanes that look up distinct classes below 32 hit
//   distinct banks (c and c + 32 share one), and w is an immediate offset.
//   ~22 KB where the 256-symbol table took 96 KB.  A tile's bytes are mapped
//   to class ids once, as the tile is staged; a step reads Pw words only.
// * Survivor compaction.  Each thread takes steps 0 and 1 of its positions
//   (i = tid, tid + 256, ...).  A position whose AND is still non-zero goes,
//   with its next step and its Pw words, into its warp's queue in shared
//   memory (slots from `__ballot_sync` and `__popc`); whenever 32 wait, the
//   warp takes those 32 kWalk = 4 steps further, each stopping at its first
//   all-zero AND, and queues the ones still alive again; at the tile's end
//   the queue is drained the same way, up to 32 at a time.  Most positions
//   die at step 0 or 1 (43% and 82% on kernel-tree text), and a warp no
//   longer steps on for its one long-lived lane: on 256 kernel-tree tiles a
//   warp issues 2.97 steps a position (live: 1.89; the first cut 4.26).  A
//   shared-memory wavefront costs the same for 1 lane as for 32, so the
//   queue's traffic (Pw + 1 words a push and a drain) is part of the cost:
//   2-step batches issue fewer steps (2.79) but push more often, and
//   measured slower on an H100, as did walking survivors to their end.
// * Double-buffered tiles.  A persistent block stages its table once, then
//   walks tiles t, t + grid, ...; while tile t is sieved, tile t + grid
//   arrives by `cp.async` (16-byte rows) into the other buffer.
// * More than 256 probes run one launch per pass of 8 words, each writing
//   its own words of the output.
// The threads OR their words in registers, a warp ORs them with shuffles,
// and one atomicOr a warp and word meets in shared memory; the block writes
// the tile's words.
//
// Bound on an H100: the bytes (T * L read once, T * Pw * 4 written, the LUT)
// at 3.35 TB/s, and the shared-memory loads the data needs (Pw words for
// each step a position takes before it dies) at 32 lanes a clock per SM;
// chip_smoke.py derives both from its inputs, and beside them this design's
// floor: the steps a warp issues (steps 0 and 1 of every position, and the
// longest walk of each batch of 32 survivors), which `ops/lut_sieve.py`
// `walk_steps` counts with kThreads, kQueue and kWalk as `lut_sieve_policy`
// reports them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 64;  // survivor slots a warp: < 32 waiting + 32 new
constexpr int kWalk = 4;  // steps a queued position takes before it queues again
constexpr int kMaxJ = 32;
constexpr int kHeader = 4;  // words of a pass block before what is staged
constexpr int kMapWords = 64;  // the 256-byte class map
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tile bytes -> shared memory: 16-byte cp.async (VEC), else byte loads.
template <bool VEC>
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ src,
                                          uint8_t* dst, int length) {
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < length / 16; i += kThreads) {
      cp_async16(dst + 16 * i, src + 16 * i);
    }
  } else {
    for (int i = threadIdx.x; i < length; i += kThreads) dst[i] = src[i];
  }
}

template <int PW>
__device__ __forceinline__ bool any_bits(const uint32_t (&a)[PW]) {
  uint32_t any = 0;
#pragma unroll
  for (int w = 0; w < PW; ++w) any |= a[w];
  return any != 0;
}

// A warp's queue of surviving positions in shared memory: `key` (position
// | next step << 24) at key[s] and word w of the AND so far at
// words[w * kQueue + s], for slots s < count (count warp-uniform).
struct Queue {
  uint32_t* key;
  uint32_t* words;
};

// Every lane of the warp: the lanes with `alive` append (key, a) in lane
// order.  Returns the new count.
template <int PW>
__device__ __forceinline__ int push(Queue q, int count, bool alive, uint32_t key,
                                    const uint32_t (&a)[PW]) {
  const unsigned live = __ballot_sync(kFull, alive);
  if (alive) {
    const int slot = count + __popc(live & ((1u << (threadIdx.x & 31)) - 1u));
    q.key[slot] = key;
#pragma unroll
    for (int w = 0; w < PW; ++w) q.words[w * kQueue + slot] = a[w];
  }
  return count + __popc(live);
}

// Every lane of the warp: the top n <= 32 queued positions take up to kWalk
// more steps, one a lane; those still alive short of J go back on the
// queue, the others OR what is left into acc.  Returns the new count.
template <int PW, int ST>
__device__ __forceinline__ int drain(Queue q, int count, int n, const uint32_t* s_tab,
                                     const uint8_t* s_cls, int jstride, int jmax,
                                     uint32_t (&acc)[PW]) {
  const int lane = threadIdx.x & 31;
  count -= n;
  __syncwarp();  // the pushes are visible
  uint32_t key = 0;
  uint32_t a[PW];
#pragma unroll
  for (int w = 0; w < PW; ++w) a[w] = 0;
  if (lane < n) {
    key = q.key[count + lane];
#pragma unroll
    for (int w = 0; w < PW; ++w) a[w] = q.words[w * kQueue + count + lane];
  }
  __syncwarp();  // read before the pushes below reuse the slots
  const int pos = key & 0xFFFFFFu;
  int j = key >> 24;
  for (int s = 0; s < kWalk && j < jmax && any_bits(a); ++s, ++j) {
    const uint32_t* tj = s_tab + j * jstride + s_cls[pos + j] * ST;
#pragma unroll
    for (int w = 0; w < PW; ++w) a[w] &= tj[w];
  }
  const bool again = j < jmax && any_bits(a);
  if (!again) {
#pragma unroll
    for (int w = 0; w < PW; ++w) acc[w] |= a[w];
  }
  return push(q, count, again, static_cast<uint32_t>(pos) | (static_cast<uint32_t>(j) << 24), a);
}

size_t smem_bytes(int length, int nw, int staged) {
  const size_t lpad = static_cast<size_t>(length + 15) / 16 * 16;
  return static_cast<size_t>(staged) * 4 + 3 * lpad +
         static_cast<size_t>(kWarps) * (nw + 1) * kQueue * 4 + 32;
}

// 4 blocks an SM: at most 64 registers a thread, and ~49 KB of shared
// memory a block for the builtin LUT at tile 4096.
template <int PW, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
lut_class_kernel(const uint8_t* __restrict__ tiles, int n_tiles, int length,
                 const uint32_t* __restrict__ block, int jmax, int staged,
                 int n_words, int word0, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  constexpr int ST = PW | 1;
  uint32_t* s_stage = reinterpret_cast<uint32_t*>(smem4);
  const uint8_t* s_cmap = reinterpret_cast<const uint8_t*>(s_stage);
  const uint32_t* s_tab = s_stage + kMapWords;
  const int lpad = (length + 15) & ~15;
  uint8_t* s_raw = reinterpret_cast<uint8_t*>(s_stage + staged);  // 2 buffers
  uint8_t* s_cls = s_raw + 2 * lpad;
  uint32_t* s_queue = reinterpret_cast<uint32_t*>(s_cls + lpad);
  uint32_t* s_acc = s_queue + kWarps * (PW + 1) * kQueue;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Queue queue{s_queue + warp * (PW + 1) * kQueue,
                    s_queue + warp * (PW + 1) * kQueue + kQueue};
  const int jstride = __ldg(block) * ST;  // words of one offset's rows
  const int lv = length - jmax + 1;
  const int rounds = (lv + kThreads - 1) / kThreads;

  const uint4* src = reinterpret_cast<const uint4*>(block + kHeader);
  for (int i = threadIdx.x; i < staged / 4; i += kThreads) smem4[i] = __ldg(src + i);
  int t = blockIdx.x;
  load_tile<VEC>(tiles + static_cast<size_t>(t) * length, s_raw, length);
  cp_async_commit();

  for (int buf = 0; t < n_tiles; t += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; the previous tile is done with
    const uint8_t* raw = s_raw + buf * lpad;
    if constexpr (VEC) {
      for (int i = threadIdx.x; i < length / 4; i += kThreads) {
        const uint32_t x = reinterpret_cast<const uint32_t*>(raw)[i];
        reinterpret_cast<uint32_t*>(s_cls)[i] =
            s_cmap[x & 0xFFu] | (s_cmap[(x >> 8) & 0xFFu] << 8) |
            (s_cmap[(x >> 16) & 0xFFu] << 16) | (static_cast<uint32_t>(s_cmap[x >> 24]) << 24);
      }
    } else {
      for (int i = threadIdx.x; i < length; i += kThreads) s_cls[i] = s_cmap[raw[i]];
    }
    if (threadIdx.x < PW) s_acc[threadIdx.x] = 0;
    if (t + static_cast<int>(gridDim.x) < n_tiles) {
      load_tile<VEC>(tiles + static_cast<size_t>(t + gridDim.x) * length,
                     s_raw + (buf ^ 1) * lpad, length);
    }
    cp_async_commit();
    __syncthreads();  // class ids and the zeroed words are in place

    uint32_t acc[PW];
#pragma unroll
    for (int w = 0; w < PW; ++w) acc[w] = 0;
    int count = 0;  // survivors waiting in the warp's queue (warp-uniform)
    for (int r = 0; r < rounds; ++r) {
      const int i = r * kThreads + threadIdx.x;
      uint32_t a[PW];
      if (i < lv) {
        const uint32_t* t0 = s_tab + s_cls[i] * ST;
#pragma unroll
        for (int w = 0; w < PW; ++w) a[w] = t0[w];
        if (jmax > 1) {
          const uint32_t* t1 = s_tab + jstride + s_cls[i + 1] * ST;
#pragma unroll
          for (int w = 0; w < PW; ++w) a[w] &= t1[w];
        }
      } else {
#pragma unroll
        for (int w = 0; w < PW; ++w) a[w] = 0;
      }
      if (jmax <= 2) {
#pragma unroll
        for (int w = 0; w < PW; ++w) acc[w] |= a[w];
        continue;
      }
      count = push(queue, count, any_bits(a), static_cast<uint32_t>(i) | (2u << 24), a);
      while (count >= 32) {
        count = drain<PW, ST>(queue, count, 32, s_tab, s_cls, jstride, jmax, acc);
      }
    }
    while (count > 0) {
      count = drain<PW, ST>(queue, count, min(count, 32), s_tab, s_cls, jstride, jmax, acc);
    }
#pragma unroll
    for (int w = 0; w < PW; ++w) {
      for (int o = 16; o > 0; o >>= 1) acc[w] |= __shfl_xor_sync(kFull, acc[w], o);
      if (lane == 0 && acc[w]) atomicOr(s_acc + w, acc[w]);
    }
    __syncthreads();
    if (threadIdx.x < PW) {
      out[static_cast<size_t>(t) * n_words + word0 + threadIdx.x] = s_acc[threadIdx.x];
    }
  }
}

template <int PW, bool VEC>
int launch_kernel(const void* tiles, int n_tiles, int length, const void* block,
                  int jmax, int staged, int n_words, int word0, void* out,
                  cudaStream_t stream) {
  auto kernel = lut_class_kernel<PW, VEC>;
  const size_t smem = smem_bytes(length, PW, staged);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = n_tiles < fit ? n_tiles : fit;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(tiles), n_tiles, length,
      static_cast<const uint32_t*>(block), jmax, staged, n_words, word0,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int PW>
int launch_words(const void* tiles, int n_tiles, int length, const void* block,
                 int jmax, int staged, int n_words, int word0, void* out,
                 cudaStream_t stream) {
  const bool vec = length % 16 == 0 && reinterpret_cast<uintptr_t>(tiles) % 16 == 0;
  return vec ? launch_kernel<PW, true>(tiles, n_tiles, length, block, jmax, staged,
                                       n_words, word0, out, stream)
             : launch_kernel<PW, false>(tiles, n_tiles, length, block, jmax, staged,
                                        n_words, word0, out, stream);
}

}  // namespace

extern "C" {

// One pass of B6.  tiles [n_tiles, length] uint8, `block` a pass block of
// `lut_tables` (16-byte aligned) with `nw` probe words (1..8) and `staged`
// words after its header; writes words [word0, word0 + nw) of out
// [n_tiles, n_words] uint32.  1 <= jmax <= length and jmax <= 32.  Returns
// the first cudaError_t of the launch.
int lut_sieve(const void* tiles, int n_tiles, int length, const void* block,
              int jmax, int nw, int staged, int n_words, int word0, void* out,
              void* stream_ptr) {
  if (jmax < 1 || jmax > kMaxJ || jmax > length || nw < 1 || nw > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (nw) {
    case 1: return launch_words<1>(tiles, n_tiles, length, block, jmax, staged, n_words, word0, out, stream);
    case 2: return launch_words<2>(tiles, n_tiles, length, block, jmax, staged, n_words, word0, out, stream);
    case 3: return launch_words<3>(tiles, n_tiles, length, block, jmax, staged, n_words, word0, out, stream);
    case 4: return launch_words<4>(tiles, n_tiles, length, block, jmax, staged, n_words, word0, out, stream);
    case 5: return launch_words<5>(tiles, n_tiles, length, block, jmax, staged, n_words, word0, out, stream);
    case 6: return launch_words<6>(tiles, n_tiles, length, block, jmax, staged, n_words, word0, out, stream);
    case 7: return launch_words<7>(tiles, n_tiles, length, block, jmax, staged, n_words, word0, out, stream);
    default: return launch_words<8>(tiles, n_tiles, length, block, jmax, staged, n_words, word0, out, stream);
  }
}

// The walk's constants, for `ops/lut_sieve.py` to hold its model of the
// walk to: 0 threads a block, 1 queue slots a warp, 2 steps a queued
// position takes at a time.  -1 for another `what`.
int lut_sieve_policy(int what) {
  return what == 0 ? kThreads : what == 1 ? kQueue : what == 2 ? kWalk : -1;
}

// Blocks of one B6 pass (`nw` probe words, `staged` words) one SM holds at
// once for tiles of `length` bytes (16-byte rows).  -1 on an error.
int lut_sieve_blocks_per_sm(int length, int nw, int staged) {
  const size_t smem = smem_bytes(length, nw, staged);
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
    case 1: query(lut_class_kernel<1, true>); break;
    case 2: query(lut_class_kernel<2, true>); break;
    case 3: query(lut_class_kernel<3, true>); break;
    case 4: query(lut_class_kernel<4, true>); break;
    case 5: query(lut_class_kernel<5, true>); break;
    case 6: query(lut_class_kernel<6, true>); break;
    case 7: query(lut_class_kernel<7, true>); break;
    case 8: query(lut_class_kernel<8, true>); break;
    default: break;
  }
  return err == cudaSuccess ? per_sm : -1;
}

}  // extern "C"
