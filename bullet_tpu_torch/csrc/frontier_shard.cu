// Per-shard frontier step on a device mesh: m ring rounds, in place, on the
// active slot stripes of one shard's [b, n] rows, given the neighbour
// shards' boundary rows taken before the step; emits the uncompacted
// per-round, per-stripe change counts of the shard's rows [m, t_total]. The
// caller sums the shards' counts and compacts them into the next ids array
// (compact_counts.cu).
//
// Replaces: bullet_tpu/ops/ring_kernel.py::_frontier_shard_kernel_dense
// (m = 1, one boundary row each way) and
// ::_frontier_shard_multiround_kernel_dense (8 fused rounds, 8 boundary
// rows each way), at nf = 7 (reference or lww order) and nf = 4 (lean)
// (bt_frontier_shard); bullet_tpu/ops/packed.py::_frontier_halo_kernel_counts
// (m = 1: the reference pads its boundary rows to 8 and reads row 7 above
// and row 0 below; here the one row is passed) and
// ::_frontier_shard_multiround_kernel_packed (m = 8), at nf = 3 (packed),
// 2 (rank) and 1 (rank1) (bt_frontier_shard_packed).
//
// Bound on the H100: device memory. Each round reads and writes each entry
// of an active stripe (8 x nf bytes per entry per round) plus the 2 s
// snapshot rows; a settled stripe costs nothing.
// Design: block j owns stripe ids[j], thread c column c of it. The thread
// sweeps its EXTENDED column, the s snapshot rows above (tops, [s, n]),
// the shard's b rows, and the s snapshot rows below (bottoms, [s, n]), as
// one ring of 2 s + b rows (bt::sweep_ext, frontier.cuh), m <= s times. A
// chain's global ends arrive as zeroed snapshots: an all-zero row is the
// bottom of every priority order, so it adds nothing the classic round's
// zero neighbour would not. Only the shard's rows count. The snapshot rows
// are the caller's per-call scratch: the sweep overwrites them. Counts
// land per round with one block reduction, at counts[k * t_total +
// stripe]; stripes not in ids keep the caller's zeros.
#include "frontier.cuh"

namespace {

template <typename E>
__global__ void __launch_bounds__(bt::kMaxTile)
    frontier_shard_kernel(bt::Fields<E::NF> mid, bt::Fields<E::NF> top,
                          bt::Fields<E::NF> bot, const int32_t* ids, int b, int s,
                          int64_t n, int tile_n, int t_total, int m, int32_t* counts) {
  const int j = blockIdx.x;
  if (j >= ids[t_total]) return;  // uniform across the block
  const int stripe = ids[j];
  const int64_t col = (int64_t)stripe * tile_n + threadIdx.x;
  const bool live = threadIdx.x < tile_n && col < n;
  const bt::ExtColumn<E::NF> c{top, mid, bot, s, b, n, col};
  for (int k = 0; k < m; ++k) {
    unsigned changed = 0;
    if (live) {
      bt::sweep_ext<E>(c, [&](int r, unsigned wins) {
        if (r >= s && r < s + b) changed += wins;
      });
    }
    changed = bt::block_sum(changed);
    if (threadIdx.x == 0) counts[(int64_t)k * t_total + stripe] = (int32_t)changed;
  }
}

template <typename E>
struct FrontierShard {
  static cudaError_t run(void* const* fields, void* const* tops, void* const* bottoms,
                         const void* ids, void* counts, int b, int s, long long n,
                         int tile_n, int t_total, int m, cudaStream_t st) {
    constexpr int NF = E::NF;
    if (tile_n < 32 || tile_n > bt::kMaxTile || tile_n % 32 || m < 1 || m > s || b < 1) {
      return cudaErrorInvalidValue;
    }
    if (t_total == 0) return cudaSuccess;
    frontier_shard_kernel<E><<<t_total, tile_n, 0, st>>>(
        bt::fields_of<NF>(fields), bt::fields_of<NF>(tops), bt::fields_of<NF>(bottoms),
        static_cast<const int32_t*>(ids), b, s, n, tile_n, t_total, m,
        static_cast<int32_t*>(counts));
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to the shard's [b, n] int32
// rows (updated in place): the 7 fields of a dense table, or its 4 value
// keys when nf = 4 (lww ignored). tops / bottoms: nf device pointers each
// to [s, n] int32 scratch holding the rows above / below the shard (zeros
// at a chain's ends), overwritten. ids: [t_total + 2] or [t_total + 3]
// int32 (the active stripes and their count at [t_total]). counts:
// [m, t_total] zeroed int32. 1 <= m <= s; tile_n is a multiple of 32, at
// most bt::kMaxTile, and divides n.
extern "C" cudaError_t bt_frontier_shard(void* const* fields, void* const* tops,
                                         void* const* bottoms, const void* ids,
                                         void* counts, int b, int s, long long n,
                                         int tile_n, int t_total, int m, int lww, int nf,
                                         void* stream) {
  return bt::dispatch_dense<FrontierShard>(nf, lww, fields, tops, bottoms, ids, counts, b,
                                           s, n, tile_n, t_total, m,
                                           static_cast<cudaStream_t>(stream));
}

// The same for a packed-family shard of nf = 3, 2 or 1 fields (lexmax.cuh's
// PackedEntry, RankEntry, Rank1Entry).
extern "C" cudaError_t bt_frontier_shard_packed(void* const* fields, void* const* tops,
                                                void* const* bottoms, const void* ids,
                                                void* counts, int b, int s, long long n,
                                                int tile_n, int t_total, int m, int nf,
                                                void* stream) {
  return bt::dispatch_nf<FrontierShard>(nf, fields, tops, bottoms, ids, counts, b, s, n,
                                        tile_n, t_total, m,
                                        static_cast<cudaStream_t>(stream));
}
