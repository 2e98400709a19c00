// Count fold and compaction of the frontier on a device mesh: the S shards'
// per-round, per-stripe change counts [S, m, t_total] -> the next step's ids
// array. Stripe t's round-r count is the shards' sum (wrapping like an
// int32 psum); the ids array holds the stripes whose round-m count is > 0,
// ascending; their count at [t_total]; the changed total at [t_total + 1]
// (wrapping like an int32 sum); for m > 1 the max over stripes of the last
// round that changed it at [t_total + 2]. Cells past the count are left
// unwritten. The window fold does the same from the shards' window stats
// [S, 2, t_total] (row 0 the changed entries, summed over the shards; row 1
// the last changed round, maxed over them): the stripes whose row 1 is m,
// the total of row 0, the max of row 1 (at least 0). Both zero the cells
// they read, so the caller's buffer is ready for the next step's per-shard
// kernels, which store or add into it.
//
// Replaces: bullet_tpu/ops/packed.py::_compact_counts_kernel (m = 1),
// ::_compact_counts_multiround_kernel (m > 1) and
// ::_compact_counts_window_kernel (the window fold), with the psum (pmax)
// over the shards that the reference's shard_map runs before them
// (bullet_tpu/parallel/shardmap_gossip.py).
//
// Bound on the H100: launch latency. It reads S x m x t_total int32 (512 KB
// at S = 4, m = 8 and the packed main path's 4096 stripes; S x 2 x t_total
// for the window fold), writes as many zeros and t_total + 3 ids.
// Design: one launch a mesh step, one block of 1024 threads,
// deterministic. The TPU's sequential grid appended stripes in order for
// free; here the block walks the stripes in chunks of 1024, thread t folds
// stripe t's counts over the shards and rounds (sum, last changed round)
// and clears them, and bt::ordered_compact (frontier.cuh, the
// single-device frontier's compaction too) places the survivors in
// ascending order with an exclusive block scan of the keep flags. The sum
// over the shards, which the host ran as one zeroed tensor and S adds (the
// window: S adds and S maximums) before this launch, and the zeroing of
// the shards' outputs happen here.
#include "frontier.cuh"

namespace {

__global__ void compact_counts_kernel(int32_t* counts, int32_t* ids, int shards, int m,
                                      int t_total) {
  const int64_t plane = (int64_t)m * t_total;  // one shard's counts
  // stripe t: the sum of its m counts and the last round with a count > 0
  bt::ordered_compact(t_total, t_total, m, ids, [&](int t) {
    bt::StripeFold f{t, 0u, 0};
    for (int r = 0; r < m; ++r) {
      int32_t* cell = counts + (int64_t)r * t_total + t;
      unsigned c = 0;
      for (int s = 0; s < shards; ++s) c += (unsigned)cell[s * plane];
      for (int s = 0; s < shards; ++s) cell[s * plane] = 0;
      f.changed += c;
      if ((int32_t)c > 0) f.last = r + 1;
    }
    return f;
  });
}

__global__ void compact_counts_window_kernel(int32_t* stats, int32_t* ids, int shards, int m,
                                             int t_total) {
  const int64_t plane = 2 * (int64_t)t_total;  // one shard's stats
  // stripe t: its changed entries summed and its last changed round maxed
  bt::ordered_compact(t_total, t_total, m, ids, [&](int t) {
    int32_t* changed = stats + t;
    int32_t* last = stats + t_total + t;
    bt::StripeFold f{t, 0u, last[0]};
    for (int s = 0; s < shards; ++s) {
      f.changed += (unsigned)changed[s * plane];
      f.last = max(f.last, last[s * plane]);
    }
    for (int s = 0; s < shards; ++s) changed[s * plane] = last[s * plane] = 0;
    return f;
  });
}

}  // namespace

// counts: [shards, m, t_total] int32 on the device, zeroed by the call;
// ids: [t_total + 2] (m = 1) or [t_total + 3] (m > 1) int32 on the device.
extern "C" cudaError_t bt_compact_counts(void* counts, void* ids, int shards, int m,
                                         int t_total, void* stream) {
  if (shards < 1 || m < 1 || t_total < 0) return cudaErrorInvalidValue;
  compact_counts_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(counts), static_cast<int32_t*>(ids), shards, m, t_total);
  return cudaGetLastError();
}

// stats: [shards, 2, t_total] int32 on the device, zeroed by the call; ids:
// [t_total + 3] int32 on the device; m >= 2 is the window's depth.
extern "C" cudaError_t bt_compact_counts_window(void* stats, void* ids, int shards, int m,
                                                int t_total, void* stream) {
  if (shards < 1 || m < 2 || t_total < 0) return cudaErrorInvalidValue;
  compact_counts_window_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(stats), static_cast<int32_t*>(ids), shards, m, t_total);
  return cudaGetLastError();
}
