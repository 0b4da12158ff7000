// Span assembly of the device verify's stream
// (trivy_tpu_torch/engine/nfa_device.py `assemble_spans`).
//
// Lanes come in file order (a file's lanes consecutive), each with its walk
// window [start, stop) and its rule's slot in the dispatch's stack (-1: a
// rule beyond the stack).  Per file, the span is [min start, max stop) of
// its slotted lanes, clipped to the file's bytes as a slice would be.  The
// span takes the smallest tier (row length) it fits; a span longer than the
// largest tier, or one that holds a 0x00 byte (the dead separator), goes to
// the overflow with its lanes.  Spans first-fit into their tier's one open
// row, a new row opening when the span does not fit after the cursor, and
// one 0x00 separator byte follows each span.  Each placed lane gets its
// tier, row and the 32-byte block range [rs0 / block, ceil(rs1 / block)) of
// its window inside the row.
//
// Two passes: `span_place` places every lane and sizes each tier's rows;
// the caller allocates one zeroed [rows, length] array a tier; `span_copy`
// copies the spans into them.  Both read the files through a pointer array
// and never copy a byte outside the spans.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" void span_place(
    const char* const* bufs, const int64_t* buf_lens,
    const int64_t* lane_file, const int32_t* lane_slot,
    const int64_t* lane_start, const int64_t* lane_stop, int64_t n,
    const int64_t* tiers, int32_t n_tiers, int64_t block,
    int32_t* la_tier, int64_t* la_row, int32_t* la_b0, int32_t* la_b1,
    int64_t* overflow,
    int64_t* sp_file, int64_t* sp_src, int64_t* sp_len, int32_t* sp_tier, int64_t* sp_dst,
    int64_t* rows, int64_t* counts) {
  // la_*: [n], tier -1 for a lane that is not placed.  overflow: [n], the
  // positions of the overflow lanes, in order: a file's unslotted lanes,
  // then its slotted ones when its span was refused.  sp_*: [n], one entry
  // a placed span (file, offset in the file, length, tier, offset in the
  // tier's array).  rows: [n_tiers].  counts: overflow lanes, spans, span
  // bytes.
  int64_t n_over = 0, n_spans = 0, span_bytes = 0;
  std::vector<int64_t> cur(n_tiers, -1), cpos(n_tiers);  // each tier's open row
  for (int32_t t = 0; t < n_tiers; ++t) {
    rows[t] = 0;
    cpos[t] = tiers[t] + 1;
  }
  for (int64_t i = 0; i < n; ++i) la_tier[i] = -1;
  for (int64_t p0 = 0, p1; p0 < n; p0 = p1) {
    const int64_t f = lane_file[p0];
    int64_t s = INT64_MAX, e = INT64_MIN, kept = 0;
    for (p1 = p0; p1 < n && lane_file[p1] == f; ++p1) {
      if (lane_slot[p1] < 0) {
        overflow[n_over++] = p1;
        continue;
      }
      s = std::min(s, lane_start[p1]);
      e = std::max(e, lane_stop[p1]);
      ++kept;
    }
    if (!kept) continue;
    const int64_t flen = buf_lens[f];
    const int64_t cs = std::min(s, flen), len = std::min(e, flen) - cs;
    int32_t t = 0;
    while (t < n_tiers && len > tiers[t]) ++t;
    if (t == n_tiers || std::memchr(bufs[f] + cs, 0, static_cast<size_t>(len)) != nullptr) {
      for (int64_t p = p0; p < p1; ++p)
        if (lane_slot[p] >= 0) overflow[n_over++] = p;
      continue;
    }
    const int64_t length = tiers[t];
    if (cur[t] < 0 || cpos[t] + len > length) {
      cur[t] = rows[t]++;
      cpos[t] = 0;
    }
    const int64_t row = cur[t], at = cpos[t];
    sp_file[n_spans] = f;
    sp_src[n_spans] = cs;
    sp_len[n_spans] = len;
    sp_tier[n_spans] = t;
    sp_dst[n_spans] = row * length + at;
    ++n_spans;
    for (int64_t p = p0; p < p1; ++p) {
      if (lane_slot[p] < 0) continue;
      const int64_t rs0 = at + lane_start[p] - s, rs1 = at + lane_stop[p] - s;
      la_tier[p] = t;
      la_row[p] = row;
      la_b0[p] = static_cast<int32_t>(rs0 / block);
      la_b1[p] = static_cast<int32_t>((rs1 + block - 1) / block);
    }
    cpos[t] = at + len + 1;  // one 0x00 separator byte between spans
    span_bytes += len;
  }
  counts[0] = n_over;
  counts[1] = n_spans;
  counts[2] = span_bytes;
}

extern "C" void span_copy(
    const char* const* bufs,
    const int64_t* sp_file, const int64_t* sp_src, const int64_t* sp_len,
    const int32_t* sp_tier, const int64_t* sp_dst, int64_t n_spans,
    uint8_t* const* tier_rows) {
  for (int64_t i = 0; i < n_spans; ++i)
    std::memcpy(tier_rows[sp_tier[i]] + sp_dst[i], bufs[sp_file[i]] + sp_src[i],
                static_cast<size_t>(sp_len[i]));
}
