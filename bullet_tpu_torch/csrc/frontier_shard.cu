// Per-shard frontier step of the dense table on a device mesh: m ring
// rounds, in place, on the active slot stripes of one shard's [b, n] rows,
// given the neighbour shards' boundary rows taken before the step; emits
// the uncompacted per-round, per-stripe change counts of the shard's rows
// [m, t_total]. The caller sums the shards' counts and compacts them into
// the next ids array (compact_counts.cu).
//
// Replaces: bullet_tpu/ops/ring_kernel.py::_frontier_shard_kernel_dense
// (m = 1, one boundary row each way) and
// ::_frontier_shard_multiround_kernel_dense (8 fused rounds, 8 boundary
// rows each way), at nf = 7 (reference or lww order) and nf = 4 (lean).
//
// Bound on the H100: device memory. Each round reads and writes each entry
// of an active stripe (8 x nf bytes per entry per round) plus the 2 s
// snapshot rows; a settled stripe costs nothing.
// Design: block j owns stripe ids[j], thread c column c of it. The thread
// sweeps its EXTENDED column, the s snapshot rows above (tops, [s, n]),
// the shard's b rows, and the s snapshot rows below (bottoms, [s, n]), as
// one ring of 2 s + b rows (the sweep of bt::sweep_column, wrapping inside
// the extended column). After round k the rows [k, 2 s + b - k) are exact
// (the trapezoid of the reference's time tiling), so m <= s rounds leave
// the shard's rows exact; garbage from the internal wrap never reaches
// them. A chain's global ends arrive as zeroed snapshots: an all-zero row
// is the bottom of every priority order, so it adds nothing the classic
// round's zero neighbour would not. Only the shard's rows count. The
// snapshot rows are the caller's per-call scratch: the sweep overwrites
// them. Counts land per round with one block reduction, at
// counts[k * t_total + stripe]; stripes not in ids keep the caller's
// zeros.
#include "frontier.cuh"

namespace {

// One shard's extended column: s rows of top, b rows of mid, s rows of
// bot, every segment row-major with row stride n.
template <int NF>
struct ExtColumn {
  bt::Fields<NF> top, mid, bot;
  int s, b;
  int64_t n, col;

  // r is uniform across a warp, so the segment branches never diverge
  __device__ __forceinline__ void load(int32_t (&v)[NF], int r) const {
    if (r < s) {
      bt::load_entry(v, top, (int64_t)r * n + col);
    } else if (r < s + b) {
      bt::load_entry(v, mid, (int64_t)(r - s) * n + col);
    } else {
      bt::load_entry(v, bot, (int64_t)(r - s - b) * n + col);
    }
  }
  __device__ __forceinline__ void store(int r, const int32_t (&v)[NF]) const {
    if (r < s) {
      bt::store_entry(top, (int64_t)r * n + col, v);
    } else if (r < s + b) {
      bt::store_entry(mid, (int64_t)(r - s) * n + col, v);
    } else {
      bt::store_entry(bot, (int64_t)(r - s - b) * n + col, v);
    }
  }
};

// One round on the extended column as a ring, in place (the pre-round rows
// r - 1 and r and the original row 0 stay in registers, as in
// bt::sweep_column). Returns the changed count of the rows [s, s + b).
template <typename E>
__device__ __forceinline__ unsigned sweep_ext(const ExtColumn<E::NF>& c) {
  constexpr int NF = E::NF;
  const int len = 2 * c.s + c.b;
  int32_t row0[NF], up[NF], cur[NF], down[NF];
  c.load(row0, 0);
  c.load(up, len - 1);
  bt::copy_entry(cur, row0);
  unsigned changed = 0;
  for (int r = 0; r < len; ++r) {
    if (r + 1 < len) {
      c.load(down, r + 1);
    } else {
      bt::copy_entry(down, row0);
    }
    const unsigned mine = (r >= c.s && r < c.s + c.b) ? 1u : 0u;
    int32_t m[NF];
    bt::copy_entry(m, cur);
    if (E::gt(up, m)) {
      bt::copy_entry(m, up);
      changed += mine;
    }
    if (E::gt(down, m)) {
      bt::copy_entry(m, down);
      changed += mine;
    }
    c.store(r, m);
    bt::copy_entry(up, cur);
    bt::copy_entry(cur, down);
  }
  return changed;
}

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
  const ExtColumn<E::NF> c{top, mid, bot, s, b, n, col};
  for (int k = 0; k < m; ++k) {
    unsigned changed = live ? sweep_ext<E>(c) : 0u;
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
