// Count compaction of the frontier on a device mesh: the shards' summed
// per-round, per-stripe change counts [m, t_total] -> the next step's ids
// array: the stripes whose round-m count is > 0, ascending; their count at
// [t_total]; the changed total at [t_total + 1] (wrapping like an int32
// sum); for m > 1 the max over stripes of the last round that changed it
// at [t_total + 2]. Cells past the count are left unwritten. The window
// fold does the same from the agreed window stats [2, t_total] (row 0 the
// changed entries, summed over the shards; row 1 the last changed round,
// maxed over them): the stripes whose row 1 is m, the total of row 0, the
// max of row 1.
//
// Replaces: bullet_tpu/ops/packed.py::_compact_counts_kernel (m = 1),
// ::_compact_counts_multiround_kernel (m > 1) and
// ::_compact_counts_window_kernel (the window fold).
//
// Bound on the H100: launch latency. It reads m x t_total int32 (at most
// 8 x 8192 x 4 B = 256 KB; 2 x t_total for the window fold) and writes
// t_total + 3.
// Design: one block of 1024 threads, deterministic. The TPU's sequential
// grid appended stripes in order for free; here the block walks the
// stripes in chunks of 1024, thread t folds stripe t's counts (sum, last
// changed round), and bt::ordered_compact (frontier.cuh, the
// single-device frontier's compaction too) places the survivors in
// ascending order with an exclusive block scan of the keep flags.
#include "frontier.cuh"

namespace {

__global__ void compact_counts_kernel(const int32_t* counts, int32_t* ids, int m,
                                      int t_total) {
  // stripe t: the sum of its m counts and the last round with a count > 0
  bt::ordered_compact(t_total, t_total, m, ids, [&](int t) {
    bt::StripeFold f{t, 0u, 0};
    for (int r = 0; r < m; ++r) {
      const int32_t c = counts[(int64_t)r * t_total + t];
      f.changed += (unsigned)c;
      if (c > 0) f.last = r + 1;
    }
    return f;
  });
}

__global__ void compact_counts_window_kernel(const int32_t* stats, int32_t* ids, int m,
                                             int t_total) {
  // stripe t: its changed entries and its last changed round, as agreed
  bt::ordered_compact(t_total, t_total, m, ids, [&](int t) {
    return bt::StripeFold{t, (unsigned)stats[t], stats[(int64_t)t_total + t]};
  });
}

}  // namespace

// counts: [m, t_total] int32 on the device; ids: [t_total + 2] (m = 1) or
// [t_total + 3] (m > 1) int32 on the device.
extern "C" cudaError_t bt_compact_counts(const void* counts, void* ids, int m, int t_total,
                                         void* stream) {
  if (m < 1 || t_total < 0) return cudaErrorInvalidValue;
  compact_counts_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(ids), m, t_total);
  return cudaGetLastError();
}

// stats: [2, t_total] int32 on the device; ids: [t_total + 3] int32 on the
// device; m >= 2 is the window's depth.
extern "C" cudaError_t bt_compact_counts_window(const void* stats, void* ids, int m,
                                                int t_total, void* stream) {
  if (m < 2 || t_total < 0) return cudaErrorInvalidValue;
  compact_counts_window_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(stats), static_cast<int32_t*>(ids), m, t_total);
  return cudaGetLastError();
}
