// Device NFA verify for Hopper (sm_90a): bit-parallel 64-position search
// automata over candidate bytes, one byte a step,
//
//     S' = (reach(S) | first) & accept[symbol],   hit = (S' & last) != 0,
//
// with reach(S) the OR of follow[p] over the set bits p of S, computed as
// a shift, a mask and a loop over the live exception positions only
// (csrc/nfa_step.cuh, shared by K5 and K6).
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
//   * the same kernel in fused mode (`nfa_stream_verdict`: K5 with the verdict
//     in its walk) -> _run_fused (:572), K5 and its verdict half in one
//     launch: rows x stack x a lane table (row, slot, b0, b1) -> keep bits,
//     np.packbits order (MSB-first), lane i kept when a match of its slot
//     ends in a block of [b0, b1) of its row.  No flags are written.
//   * nfa_padded_kernel (K6) -> _run (:325): class ids [G, Bg, L] x per-group
//     rule -> matched [G, Bg]: some match ends anywhere in the lane, the
//     zero padding past its window included, as the reference walks it.
//
// Tables (host-built by trivy_tpu_torch/ops/nfa_verify.py `NfaStack` and
// `NfaTables` from the same words the plain versions read unpacked; int64
// on the host, read as uint64):
//   * K5, one image of the stack as it sits in shared memory, for the
//     `width` live slots (1 + the last slot with a non-zero word), word w
//     of slot s at [w * width + s]: fwd, self, exc, first, last,
//     residual[64], then class words ctab[C] (the distinct accept columns
//     of the live slots), then the byte -> class map (256 bytes).
//   * K6, a row of 133 words a rule: fwd, self, exc, first, last,
//     residual[64], classmask[64].
//
// Design.  K5: one warp lane per (row, live slot), 32 / width rows a warp;
// the image is staged once per persistent block, so the lanes of a row
// read consecutive words.  The lanes of a row load its 32-byte blocks with
// two 16-byte loads (broadcast, the next block's in flight), look up each
// byte's class word (a byte load and a word load that depend on the input
// alone), step from registers, OR the states of the block and test `last`
// once, and combine their hit bits with one ballot a block.  When byte 0
// is dead in every live slot (`skip_zero`), a 16-byte load of zeros sets
// S = 0 and flags nothing without being stepped: the zero padding rows and
// the zero tails of rows cost a load.  K6: 32 lanes a block, the group's
// rule row in shared memory (class masks padded to 256 entries, so an id
// needs no bounds check); a walk first finds its end (one past its last
// non-zero 16-byte chunk, read backwards 8 chunks at a time), walks to it
// with the next chunk's load in flight, stops once it has matched, and
// past its end (class 0 only) stops at the first step that leaves S
// unchanged: from a fixed point under a constant input every later step
// gives the same state and the same hit.  A rule without exception
// positions walks without the loop.
//
// Fused mode (the verdict in the walk).  A fused dispatch only wants one
// keep bit a lane, so K5 writes no flags: the host sorts the lanes of each
// (row, live slot) by b0 and passes a CSR index (`LaneIndex`: offsets a
// (row, slot), then per lane b0, b1, `reach` = the largest b1 of the lanes
// up to it in that order, and its id).  When a lane's walk flags block b,
// it binary-searches the first lane whose reach passes b (every lane
// before it ends at or before b) and sets, with an atomicOr on the 32-bit
// word that holds the bit, the keep bit of every lane from there on whose
// [b0, b1) holds b, until b0 passes b.  Neighbouring lanes may share a
// boundary block and lanes may nest: each flag keeps all of them.  The
// search is stateless, so a segment that starts mid-row needs no cursor
// and the walk holds no extra register; it runs only on a flagged block,
// in a function of its own (`keep_block`).  The fix-up does the same for
// the matches it adds.
//
// Segments.  A walk is a serial chain, so a launch of few long rows (K5)
// or lanes (K6) leaves most of the card idle however short the step.  Each
// row or lane is cut into as many segments as keep the card's resident
// warps busy (`nfa_stream_segments`, `nfa_padded_segments`; one when the
// rows alone fill it), and every segment but the first is walked from the
// empty state.  That is exact after a fix-up: the step distributes over
// union, so the true walk's state is the speculative one OR an excess that
// evolves by the step without `first` from the state the segment really
// enters with (nfa_step.cuh `excess_step`).  A second kernel carries the
// excess across the boundaries, a thread per (row, slot) or lane, until
// it dies, and adds the matches it reaches; on real data it dies within a
// few bytes.
//
// Bound on an H100.  Bytes: K5 reads N * L row bytes and writes N * L / 32
// * ceil(rb/8) flag bytes (fused: the lane index and N_lanes / 8 keep bytes).  The kernels are bound instead by integer work:
// K5 by its lane-steps (the live slots x the bytes of the non-zero chunks)
// x the step's ~18 integer instructions (sm_90a SASS) over the SMs' 64
// INT32 lanes; K6 likewise by its lanes' steps to their ends, and without
// segments by the serial chain of its longest lane.  No tensor core helps
// a data-dependent bit-set walk.

#include <cstdint>
#include <cuda_runtime.h>

#include "nfa_step.cuh"

namespace {

constexpr int kBlock = 32;          // positions a flag covers
constexpr int kMaxSlots = 32;       // rule slots a launch serves
constexpr int kMaxClasses = 256;
constexpr int kMapWords = 256 / 8;  // the byte -> class map, in uint64 words
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStreamBlocksPerSm = 4;  // caps registers at 64 a thread
constexpr int kPaddedLanes = 32;    // K6 threads a block
constexpr int kPaddedRuleWords = nfa_step::kRuleWords + 64;  // + classmask[64]
// K6's shared rule: the rule words, then classmask[256] (ids >= 64 zero), so a
// class id indexes it without a bounds check
constexpr int kPaddedSharedWords = nfa_step::kRuleWords + 256;
constexpr int kEndProbe = 8;        // 16-byte chunks K6 reads at once for the end
constexpr int kMinSegmentBlocks = 4;   // K5 segments: at least 128 bytes
constexpr int kMinSegmentChunks = 16;  // K6 segments: at least 256 ids
constexpr unsigned kFull = 0xffffffffu;

// Words of K5's stack image for `width` slots and `n_classes` classes.
__host__ __device__ constexpr int image_words(int width, int n_classes) {
  return (nfa_step::kRuleWords + n_classes) * width + kMapWords;
}

// Fused mode's lane index (host-built by ops/nfa_verify.py `LaneIndex`):
// the lanes of (row, slot) are [off[row * width + slot], off[... + 1]),
// sorted by b0; reach[i] is the largest b1 of that (row, slot)'s lanes up to
// i, so it never falls within a (row, slot).  keep: N_lanes / 8 bytes in
// whole 32-bit words, zeroed before the launch.
struct LaneIndex {
  const int* off;
  const int* b0;
  const int* b1;
  const int* reach;
  const int* id;
  unsigned* keep;
};

// Sets the keep bit of every lane of (row, slot) `key` whose blocks [b0, b1)
// hold block b.  Out of line: it runs only on a flagged block, and the
// walk's registers stay the walk's.
__device__ __noinline__ void keep_block(const LaneIndex li, int key, int b) {
  const int r1 = li.off[key + 1];
  int lo = li.off[key], hi = r1;
  while (lo < hi) {  // the first lane whose reach passes b
    const int m = (lo + hi) >> 1;
    if (li.reach[m] > b) {
      hi = m;
    } else {
      lo = m + 1;
    }
  }
  for (int i = lo; i < r1 && li.b0[i] <= b; ++i) {
    if (li.b1[i] > b) {
      // lane n: byte n / 8, bit 7 - n % 8 (MSB first), in little-endian words
      const int n = li.id[i];
      atomicOr(li.keep + (n >> 5), 1u << (8 * ((n >> 3) & 3) + 7 - (n & 7)));
    }
  }
}

// K5's 16 steps over one 16-byte load; `seen` collects every state.
template <bool kSkipZero>
__device__ __forceinline__ void step_chunk(const nfa_step::Rule& rule,
                                           const uint64_t* ctab, int width,
                                           const uint8_t* cmap, uint4 v,
                                           uint64_t& s, uint64_t& seen) {
  if (kSkipZero && (v.x | v.y | v.z | v.w) == 0) {
    s = 0;  // byte 0 is dead in every live slot
    return;
  }
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t b = (q[k >> 2] >> (8 * (k & 3))) & 0xFFu;
    s = nfa_step::step(rule, s, ctab[cmap[b] * width]);
    seen |= s;
  }
}

// Phase 1 of K5: items (group of rows_per_warp rows, segment k), a warp
// each; segment k of a row covers blocks [k * seg_blocks, ...) (the last
// one to the row's end) and is walked from the empty state.  For k <
// n_segments - 1 the state at its end goes to ends[k][row][slot], for the
// fix-up (`nfa_stream_fix_kernel`).  kFused: a flagged block keeps its
// lanes (`keep_block`) instead of setting flags, and `flags` is unused.
template <bool kSkipZero, bool kFused>
__global__ void __launch_bounds__(kThreads, kStreamBlocksPerSm)
nfa_stream_kernel(const uint8_t* __restrict__ rows, int n_rows, int length,
                  const uint64_t* __restrict__ image, int width, int n_classes,
                  int n_bytes, int n_segments, uint64_t* __restrict__ ends,
                  uint8_t* __restrict__ flags, const LaneIndex lanes) {
  extern __shared__ uint64_t s_img[];
  const int n_words = image_words(width, n_classes);
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_img[i] = image[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per_warp = 32 / width;
  const int sub = lane / width;              // row of this lane in the warp
  const int slot = lane - sub * width;
  const bool used = sub < rows_per_warp;     // lanes past the last row idle
  const int n_groups = (n_rows + rows_per_warp - 1) / rows_per_warp;
  const int n_blocks = length / kBlock;
  const int seg_blocks = n_blocks / n_segments;
  const unsigned group_mask = width == 32 ? kFull : ((1u << width) - 1u);
  const nfa_step::Rule rule = nfa_step::load_rule(s_img + slot, width);
  const uint64_t* ctab = s_img + nfa_step::kRuleWords * width + slot;
  const uint8_t* cmap =
      reinterpret_cast<const uint8_t*>(s_img + (nfa_step::kRuleWords + n_classes) * width);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int n_items = n_groups * n_segments;
  for (int it = blockIdx.x * kWarps + warp; it < n_items; it += gridDim.x * kWarps) {
    const int g = it / n_segments;
    const int k = it - g * n_segments;
    const int row = g * rows_per_warp + sub;
    const bool active = used && row < n_rows;
    const int j0 = k * seg_blocks;
    const int j1 = k + 1 < n_segments ? j0 + seg_blocks : n_blocks;
    const uint4* src = reinterpret_cast<const uint4*>(
        rows + static_cast<size_t>(active ? row : 0) * length);
    uint64_t s = 0;
    uint4 n0 = active ? src[2 * j0] : zero;
    uint4 n1 = active ? src[2 * j0 + 1] : zero;
    for (int j = j0; j < j1; ++j) {
      const uint4 v0 = n0;
      const uint4 v1 = n1;
      if (active && j + 1 < j1) {  // the next block's load in flight
        n0 = src[2 * j + 2];
        n1 = src[2 * j + 3];
      }
      uint64_t seen = 0;
      step_chunk<kSkipZero>(rule, ctab, width, cmap, v0, s, seen);
      step_chunk<kSkipZero>(rule, ctab, width, cmap, v1, s, seen);
      if constexpr (kFused) {
        if (active && (seen & rule.last) != 0) keep_block(lanes, row * width + slot, j);
      } else {
        const unsigned ballot = __ballot_sync(kFull, (seen & rule.last) != 0);
        if (active) {
          const unsigned bits = (ballot >> (sub * width)) & group_mask;
          for (int p = slot; p < n_bytes; p += width) {  // slots 8p .. 8p + 7
            flags[(static_cast<size_t>(p) * n_rows + row) * n_blocks + j] =
                static_cast<uint8_t>(bits >> (8 * p));
          }
        }
      }
    }
    if (active && k + 1 < n_segments) {
      ends[(static_cast<size_t>(k) * n_rows + row) * width + slot] = s;
    }
  }
}

// Phase 2 of K5 (n_segments > 1): a thread per (row, live slot) carries the
// excess over the speculative start across the segment boundaries: entering
// segment k the row's true state is ends[k - 1] (exact for k = 1) OR the
// excess still alive; the excess is walked (`excess_step`) until it dies or
// the segment ends, and each match it adds sets its flag bit (atomicOr on
// the flag word: the flags buffer is a whole number of 32-bit words;
// kFused: the keep bits of the block's lanes).  The tables are read from
// device memory: on real data the walks are short.
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
nfa_stream_fix_kernel(const uint8_t* __restrict__ rows, int n_rows, int length,
                      const uint64_t* __restrict__ image, int width, int n_classes,
                      int n_segments, const uint64_t* __restrict__ ends,
                      uint8_t* __restrict__ flags, const LaneIndex lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * width) return;
  const int row = i / width;
  const int slot = i - row * width;
  const nfa_step::Rule rule = nfa_step::load_rule(image + slot, width);
  const uint64_t* ctab = image + nfa_step::kRuleWords * width + slot;
  const uint8_t* cmap =
      reinterpret_cast<const uint8_t*>(image + (nfa_step::kRuleWords + n_classes) * width);
  const uint8_t* src = rows + static_cast<size_t>(row) * length;
  const int n_blocks = length / kBlock;
  const int seg_len = (n_blocks / n_segments) * kBlock;
  const size_t flag_row = (static_cast<size_t>(slot >> 3) * n_rows + row) * n_blocks;
  const unsigned bit = 1u << (slot & 7);
  uint64_t g = ends[static_cast<size_t>(row) * width + slot];
  for (int k = 1; k < n_segments; ++k) {
    const int t1 = k + 1 < n_segments ? (k + 1) * seg_len : length;
    for (int t = k * seg_len; g && t < t1; ++t) {
      g = nfa_step::excess_step(rule, g, ctab[cmap[src[t]] * width]);
      if (g & rule.last) {
        if constexpr (kFused) {
          keep_block(lanes, i, t / kBlock);
        } else {
          const size_t o = flag_row + t / kBlock;
          atomicOr(reinterpret_cast<unsigned*>(flags + (o & ~size_t{3})),
                   bit << (8 * (o & 3)));
        }
      }
    }
    if (k + 1 < n_segments) g |= ends[(static_cast<size_t>(k) * n_rows + row) * width + slot];
  }
}

// What one K6 segment walk leaves: whether a match ended in it, the state
// at its end, and its local end (16-byte chunks up to its last non-zero one).
struct SegmentWalk {
  bool matched;
  uint64_t state;
  int end;
};

// One K6 segment of `n16` 16-byte chunks of class ids, walked from the empty
// state (cm: the class masks, 256 entries).  It stops once it has matched,
// and past its local end (ids 0 to the segment's end) at the first step
// that leaves S unchanged: from a fixed point under a constant input every
// later step gives the same state and the same hit.
template <bool kExceptions>
__device__ SegmentWalk walk_segment(const nfa_step::Rule& rule, const uint64_t* cm,
                                    const uint4* src, int n16) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // end: one past the last 16-byte chunk holding a non-zero id, read
  // backwards kEndProbe chunks at a time
  int end = n16;
  while (end > 0) {
    const int lo = end > kEndProbe ? end - kEndProbe : 0;
    uint4 v[kEndProbe];
#pragma unroll
    for (int k = 0; k < kEndProbe; ++k) v[k] = lo + k < end ? src[lo + k] : zero;
    int found = -1;
#pragma unroll
    for (int k = 0; k < kEndProbe; ++k) {
      if ((v[k].x | v[k].y | v[k].z | v[k].w) != 0) found = lo + k;
    }
    if (found >= 0) {
      end = found + 1;
      break;
    }
    end = lo;
  }
  uint64_t s = 0, seen = 0;
  uint4 next = end > 0 ? src[0] : zero;
  for (int t = 0; t < end; ++t) {
    const uint4 v = next;
    if (t + 1 < end) next = src[t + 1];
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t c = (q[k >> 2] >> (8 * (k & 3))) & 0xFFu;
      s = nfa_step::step<kExceptions>(rule, s, cm[c]);
      seen |= s;
    }
    if (seen & rule.last) return {true, s, end};  // matched is an OR: done
  }
  const uint64_t cm0 = cm[0];
  for (int t = end * 16; t < n16 * 16; ++t) {
    const uint64_t next_s = nfa_step::step<kExceptions>(rule, s, cm0);
    if (next_s & rule.last) return {true, next_s, end};
    if (next_s == s) break;  // an orbit with no fixed point walks to the end
    s = next_s;
  }
  return {false, s, end};
}

// Phase 1 of K6: items (lane, segment), 32 a block, all of one group (its
// rule row in shared memory, the class masks padded to 256 entries so an
// id needs no bounds check).  With one segment an item writes its lane's
// verdict; with more, each segment walks from the empty state and leaves
// its result in `ends` / `info` (-1 for a match, else its local end) for
// the fix-up (`nfa_padded_fix_kernel`).
__global__ void __launch_bounds__(kPaddedLanes)
nfa_padded_kernel(const uint8_t* __restrict__ classes, int bg, int length,
                  const int* __restrict__ gids, const uint64_t* __restrict__ table,
                  int n_rules, int n_segments, uint64_t* __restrict__ ends,
                  int* __restrict__ info, bool* __restrict__ matched) {
  __shared__ uint64_t s_r[kPaddedSharedWords];
  const int items = bg * n_segments;
  const int per_group = (items + kPaddedLanes - 1) / kPaddedLanes;
  const int grp = blockIdx.x / per_group;
  const int idx = (blockIdx.x - grp * per_group) * kPaddedLanes + threadIdx.x;
  const int r = gids[grp];
  const bool valid = r >= 0 && r < n_rules;
  for (int k = threadIdx.x; k < kPaddedSharedWords; k += blockDim.x) {
    s_r[k] = valid && k < kPaddedRuleWords
                 ? table[static_cast<size_t>(r) * kPaddedRuleWords + k] : 0;
  }
  __syncthreads();
  if (idx >= items) return;
  const int b = idx / n_segments;
  const int seg = idx - b * n_segments;
  const int seg16 = length / 16 / n_segments;
  const int n16 = seg + 1 < n_segments ? seg16 : length / 16 - seg * seg16;
  const nfa_step::Rule rule = nfa_step::load_rule(s_r, 1);
  const uint64_t* cm = s_r + nfa_step::kRuleWords;
  const size_t lane = static_cast<size_t>(grp) * bg + b;
  const uint4* src =
      reinterpret_cast<const uint4*>(classes + lane * length) + seg * seg16;
  const SegmentWalk w = rule.exc ? walk_segment<true>(rule, cm, src, n16)
                                 : walk_segment<false>(rule, cm, src, n16);
  if (n_segments == 1) {
    matched[lane] = w.matched;
  } else {
    ends[lane * n_segments + seg] = w.state;
    info[lane * n_segments + seg] = w.matched ? -1 : w.end;
  }
}

// Phase 2 of K6 (n_segments > 1): a thread per lane.  A lane matched when a
// segment matched; else the excess over each segment's empty start is
// walked across the boundaries (as K5's fix-up does) until it dies, stops
// at a fixed point past the segment's local end, or the segment ends; a
// match it reaches matches the lane.
__global__ void __launch_bounds__(kThreads)
nfa_padded_fix_kernel(const uint8_t* __restrict__ classes, int g, int bg, int length,
                      const int* __restrict__ gids, const uint64_t* __restrict__ table,
                      int n_rules, int n_segments, const uint64_t* __restrict__ ends,
                      const int* __restrict__ info, bool* __restrict__ matched) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g * bg) return;
  const size_t lane = i;
  bool m = false;
  for (int k = 0; k < n_segments; ++k) m |= info[lane * n_segments + k] < 0;
  const int r = gids[i / bg];
  if (!m && r >= 0 && r < n_rules) {
    const uint64_t* row = table + static_cast<size_t>(r) * kPaddedRuleWords;
    const nfa_step::Rule rule = nfa_step::load_rule(row, 1);
    const uint64_t* cm = row + nfa_step::kRuleWords;
    const uint8_t* src = classes + lane * length;
    const int seg_len = length / 16 / n_segments * 16;
    uint64_t x = ends[lane * n_segments];
    for (int k = 1; k < n_segments && !m; ++k) {
      const int t0 = k * seg_len;
      const int t1 = k + 1 < n_segments ? t0 + seg_len : length;
      const int zeros_from = t0 + 16 * info[lane * n_segments + k];
      for (int t = t0; x && t < t1; ++t) {
        const uint32_t c = src[t];
        const uint64_t next = nfa_step::excess_step(rule, x, c < 64 ? cm[c] : 0);
        if (next & rule.last) {
          m = true;
          break;
        }
        if (t >= zeros_from && next == x) break;  // fixed to the segment's end
        x = next;
      }
      x |= ends[lane * n_segments + k];
    }
  }
  matched[lane] = m;
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

// Segments to split each K5 row into: the largest power of two that keeps
// the (row group, segment) items within what the SMs hold at once and each
// segment at least kMinSegmentBlocks long.  0 on an error.
int nfa_stream_segments(int n_rows, int length, int width, int n_classes) {
  if (width < 1 || width > kMaxSlots || n_classes < 1 || n_classes > kMaxClasses) return 0;
  const size_t smem = static_cast<size_t>(image_words(width, n_classes)) * sizeof(uint64_t);
  cudaError_t err;
  const int resident = grid_size(nfa_stream_kernel<true, false>, kThreads, smem, 1 << 30, &err);
  if (err != cudaSuccess) return 0;
  const int rows_per_warp = 32 / width;
  const long n_groups = (n_rows + rows_per_warp - 1) / rows_per_warp;
  const int n_blocks = length / kBlock;
  int n = 1;
  while (2 * n * kMinSegmentBlocks <= n_blocks &&
         n_groups * 2 * n <= static_cast<long>(resident) * kWarps) {
    n *= 2;
  }
  return n;
}

}  // extern "C"

namespace {

// K5's launches: phase 1, then the fix-up when the rows are segmented.
template <bool kFused>
int launch_stream(const void* rows, int n_rows, int length, const void* image,
                  int width, int n_classes, int rb, int skip_zero, int n_segments,
                  void* ends, void* flags, const LaneIndex& lanes, cudaStream_t s) {
  if (rb < 1 || rb > kMaxSlots || width < 1 || width > rb || n_classes < 1 ||
      n_classes > kMaxClasses || length % kBlock || n_segments < 1 ||
      n_segments > length / kBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0 || length == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(image_words(width, n_classes)) * sizeof(uint64_t);
  const int rows_per_warp = 32 / width;
  const int n_groups = (n_rows + rows_per_warp - 1) / rows_per_warp;
  const int work = (n_groups * n_segments + kWarps - 1) / kWarps;
  auto kernel = skip_zero ? nfa_stream_kernel<true, kFused> : nfa_stream_kernel<false, kFused>;
  cudaError_t err;
  const int blocks = grid_size(kernel, kThreads, smem, work, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(rows), n_rows, length,
      static_cast<const uint64_t*>(image), width, n_classes, (rb + 7) / 8, n_segments,
      static_cast<uint64_t*>(ends), static_cast<uint8_t*>(flags), lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_segments == 1) return static_cast<int>(err);
  nfa_stream_fix_kernel<kFused><<<(n_rows * width + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(rows), n_rows, length,
      static_cast<const uint64_t*>(image), width, n_classes, n_segments,
      static_cast<const uint64_t*>(ends), static_cast<uint8_t*>(flags), lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K5.  rows [n_rows, length] uint8 (length a multiple of 32, 16-byte
// aligned), image the stack's shared-memory image (`image_words(width,
// n_classes)` uint64 words; 1 <= width <= rb <= 32, 1 <= n_classes <= 256),
// skip_zero non-zero when byte 0 is dead in every live slot, n_segments
// >= 1 (`nfa_stream_segments`) with ends scratch [n_segments - 1, n_rows,
// width] uint64, flags [ceil(rb/8), n_rows, length/32] uint8 in a buffer
// of whole 32-bit words, every byte written (slots >= width get zero
// bits).  Returns the first cudaError_t of the launches.
int nfa_stream(const void* rows, int n_rows, int length, const void* image,
               int width, int n_classes, int rb, int skip_zero, int n_segments,
               void* ends, void* flags, void* stream) {
  return launch_stream<false>(rows, n_rows, length, image, width, n_classes, rb, skip_zero,
                              n_segments, ends, flags, LaneIndex{},
                              static_cast<cudaStream_t>(stream));
}

// K5 in fused mode: the arguments of `nfa_stream` without the flags, then
// the lane index (`LaneIndex`; off [n_rows * width + 1], the other four
// [off[n_rows * width]] int32) and keep, n_keep_words uint32 words that
// hold the keep bits of the lane ids (zeroed here first).
int nfa_stream_verdict(const void* rows, int n_rows, int length, const void* image,
                       int width, int n_classes, int rb, int skip_zero, int n_segments,
                       void* ends, const void* off, const void* b0, const void* b1,
                       const void* reach, const void* id, void* keep, int n_keep_words,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(keep, 0, static_cast<size_t>(n_keep_words) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const LaneIndex lanes{static_cast<const int*>(off), static_cast<const int*>(b0),
                        static_cast<const int*>(b1), static_cast<const int*>(reach),
                        static_cast<const int*>(id), static_cast<unsigned*>(keep)};
  return launch_stream<true>(rows, n_rows, length, image, width, n_classes, rb, skip_zero,
                             n_segments, ends, nullptr, lanes, s);
}

// Segments to split each K6 lane into: the largest power of two that keeps
// the (lane, segment) items within what the SMs hold at once and each
// segment at least kMinSegmentChunks 16-byte chunks long.  0 on an error.
int nfa_padded_segments(int g, int bg, int length) {
  cudaError_t err;
  const int resident = grid_size(nfa_padded_kernel, kPaddedLanes, 0, 1 << 30, &err);
  if (err != cudaSuccess) return 0;
  const long lanes = static_cast<long>(g) * bg;
  int n = 1;
  while (2 * n * kMinSegmentChunks <= length / 16 &&
         lanes * 2 * n <= static_cast<long>(resident) * kPaddedLanes) {
    n *= 2;
  }
  return n;
}

// K6.  classes [g, bg, length] uint8 (length a multiple of 16, 16-byte
// aligned, ids < 64), gids [g] int32, table [n_rules, 133] uint64 rule rows,
// n_segments >= 1 (`nfa_padded_segments`) with scratch ends [g * bg,
// n_segments] uint64 and info [g * bg, n_segments] int32, matched [g, bg]
// bool.  A group id outside the rules matches nothing.
int nfa_padded(const void* classes, int g, int bg, int length, const void* gids,
               const void* table, int n_rules, int n_segments, void* ends, void* info,
               void* matched, void* stream) {
  if (length % 16 || n_segments < 1 || n_segments > length / 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g == 0 || bg == 0) return static_cast<int>(cudaSuccess);
  const int blocks = g * ((bg * n_segments + kPaddedLanes - 1) / kPaddedLanes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nfa_padded_kernel<<<blocks, kPaddedLanes, 0, s>>>(
      static_cast<const uint8_t*>(classes), bg, length,
      static_cast<const int*>(gids), static_cast<const uint64_t*>(table), n_rules,
      n_segments, static_cast<uint64_t*>(ends), static_cast<int*>(info),
      static_cast<bool*>(matched));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_segments == 1) return static_cast<int>(err);
  nfa_padded_fix_kernel<<<(g * bg + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(classes), g, bg, length,
      static_cast<const int*>(gids), static_cast<const uint64_t*>(table), n_rules,
      n_segments, static_cast<const uint64_t*>(ends), static_cast<const int*>(info),
      static_cast<bool*>(matched));
  return static_cast<int>(cudaGetLastError());
}

// Blocks one SM holds at once: K5 (kernel 0, its skip-zero form) with an
// image of `smem_bytes`, or K6 (kernel 1).  -1 on an error.
int nfa_blocks_per_sm(int kernel, int smem_bytes) {
  int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (kernel == 0) {
    if (smem_bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(nfa_stream_kernel<true, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, nfa_stream_kernel<true, false>, kThreads, smem_bytes);
    }
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nfa_padded_kernel,
                                                        kPaddedLanes, 0);
  }
  return err == cudaSuccess ? per_sm : -1;
}

}  // extern "C"
