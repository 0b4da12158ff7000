// The fused K5's lane index (trivy_tpu_torch/ops/nfa_verify.py `LaneIndex`).
//
// From a [4, N] int32 lane table (row, slot, b0, b1), the lanes that can
// keep (row in [0, n_rows), slot in [0, width), a non-empty block range once
// clamped to [0, n_blocks)) grouped by key = row * width + slot and, within
// a key, ordered by b0 (ties in lane order): CSR offsets over the keys, then
// per indexed lane its clamped b0, b1, `reach` (the largest b1 of its key's
// lanes up to it) and its lane id.  A counting sort by key, then a sort of
// each key's few lanes by b0 where they are not in order already (the
// engine emits each row's lanes in file order, so mostly they are): O(N +
// keys) in two passes over the table.

#include <algorithm>
#include <array>
#include <cstdint>
#include <vector>

extern "C" int64_t lane_index(const int32_t* table, int64_t n, int64_t n_rows,
                              int64_t n_blocks, int64_t width, int32_t* out) {
  // out: [n_rows * width + 1 + 4 * n] int32.  Returns m, the lanes indexed:
  // the offsets fill out[0, keys], then b0, b1, reach and ids take m words
  // each from out + keys + 1.
  const int32_t* row = table;
  const int32_t* slot = table + n;
  const int32_t* b0 = table + 2 * n;
  const int32_t* b1 = table + 3 * n;
  const int64_t n_keys = n_rows * width;
  int32_t* off = out;
  std::fill(off, off + n_keys + 1, 0);
  auto key_of = [&](int64_t i) -> int64_t {
    if (row[i] < 0 || row[i] >= n_rows || slot[i] < 0 || slot[i] >= width) return -1;
    int32_t lo = std::max<int32_t>(b0[i], 0);
    int32_t hi = static_cast<int32_t>(std::min<int64_t>(b1[i], n_blocks));
    return lo < hi ? int64_t(row[i]) * width + slot[i] : -1;
  };
  for (int64_t i = 0; i < n; ++i) {
    int64_t k = key_of(i);
    if (k >= 0) ++off[k + 1];
  }
  for (int64_t k = 0; k < n_keys; ++k) off[k + 1] += off[k];
  const int64_t m = off[n_keys];
  int32_t* o_b0 = out + n_keys + 1;
  int32_t* o_b1 = o_b0 + m;
  int32_t* o_reach = o_b1 + m;
  int32_t* o_id = o_reach + m;
  // scatter in lane order; each lane's key waits in the reach slot
  std::vector<int32_t> cursor(off, off + n_keys);
  for (int64_t i = 0; i < n; ++i) {
    int64_t k = key_of(i);
    if (k < 0) continue;
    int32_t p = cursor[k]++;
    o_b0[p] = std::max<int32_t>(b0[i], 0);
    o_b1[p] = static_cast<int32_t>(std::min<int64_t>(b1[i], n_blocks));
    o_reach[p] = static_cast<int32_t>(k);
    o_id[p] = static_cast<int32_t>(i);
  }
  // each key's lanes are a run: order it by b0 where it is not in order,
  // then its running max of b1
  std::vector<std::array<int32_t, 3>> tmp;
  for (int64_t r0 = 0, r1; r0 < m; r0 = r1) {
    bool sorted = true;
    for (r1 = r0 + 1; r1 < m && o_reach[r1] == o_reach[r0]; ++r1)
      sorted = sorted && o_b0[r1 - 1] <= o_b0[r1];
    if (!sorted) {
      // lanes entered in id order: (b0, id) is the stable order by b0
      tmp.clear();
      for (int64_t p = r0; p < r1; ++p) tmp.push_back({o_b0[p], o_id[p], o_b1[p]});
      std::sort(tmp.begin(), tmp.end());
      for (int64_t p = r0; p < r1; ++p) {
        o_b0[p] = tmp[p - r0][0];
        o_id[p] = tmp[p - r0][1];
        o_b1[p] = tmp[p - r0][2];
      }
    }
    int32_t reach = 0;
    for (int64_t p = r0; p < r1; ++p) o_reach[p] = reach = std::max(reach, o_b1[p]);
  }
  return m;
}
