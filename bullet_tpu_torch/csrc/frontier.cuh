// Compacting frontier step, shared by every layout: m ring/chain rounds, in
// place, on the active slot stripes only, then the next round's ids array.
// frontier_dense.cu and frontier_packed.cu instantiate it for their entry
// types (lexmax.cuh). Also the ordered compaction (compact_counts.cu) and
// the extended-column sweep of the per-shard steps on a device mesh
// (frontier_shard.cu, frontier_shard_window.cu).
//
// ids layout (as the reference's ops/packed.py frontier loops use it):
//   [0, count)    active stripe ids, ascending
//   [t_total]     count
//   [t_total+1]   entries changed by the step that produced this array
//   [t_total+2]   max over stripes of the last round that changed it (m > 1)
//
// Design: block j owns stripe ids[j]; thread c of the block owns column c
// of that stripe and runs m in-place column sweeps (bt::sweep_column) back
// to back. Columns are independent under ring gossip, so no block-wide sync
// is needed between rounds. The grid is t_total blocks; blocks with
// j >= ids[t_total] exit at once, so the host never reads the count to size
// the grid. The TPU appended ids in its sequential grid order; CUDA blocks
// run in no order, so the round kernel writes each stripe's changed count
// and last-changed round to scratch, and a second single-block kernel
// compacts the surviving stripes (last == m) in ascending order with a
// block prefix scan and writes the count, the changed total (wrapping mod
// 2^32 like an int32 sum) and max(last).
#pragma once

#include "lexmax.cuh"

namespace bt {

// widest stripe a block takes (one thread per column); the wrappers'
// FRONTIER_TILE_MAX
constexpr int kMaxTile = 256;

template <typename E>
__global__ void __launch_bounds__(kMaxTile)
    frontier_round_kernel(Fields<E::NF> t, const int32_t* ids, int p, int64_t n,
                          int tile_n, int t_total, int m, int wrap,
                          unsigned* stripe_changed, int32_t* stripe_last) {
  const int j = blockIdx.x;
  if (j >= ids[t_total]) return;  // uniform across the block
  const int64_t col = (int64_t)ids[j] * tile_n + threadIdx.x;
  unsigned total = 0;
  int last = 0;
  if (threadIdx.x < tile_n && col < n) {
    for (int k = 1; k <= m; ++k) {
      const unsigned c = sweep_column<E>(t, col, p, n, wrap != 0);
      total += c;
      if (c) last = k;
    }
  }
  total = block_sum(total);
  last = block_max(last);
  if (threadIdx.x == 0) {
    stripe_changed[j] = total;
    stripe_last[j] = last;
  }
}

// Exclusive prefix sum of a 0/1 flag over the block; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int flag, int* total) {
  __shared__ int warp_part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = flag;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  __syncthreads();
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    int w = (lane < warps) ? warp_part[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    warp_part[lane] = w;  // inclusive prefix over warps
  }
  __syncthreads();
  const int before = (warp > 0) ? warp_part[warp - 1] : 0;
  *total = warp_part[(blockDim.x >> 5) - 1];
  return before + incl - flag;
}

// What ordered_compact needs of item j: its id, its changed count and the
// last round (1..m, 0 for none) that changed it.
struct StripeFold {
  int id;
  unsigned changed;
  int last;
};

// Ordered compaction by one block: walks the items j < count in chunks of
// blockDim.x, folds each (fold(j) -> StripeFold), and appends the id of
// every item whose last changed round is m to ids_out in ascending j with
// an exclusive block scan of the keep flags. Then writes the kept count
// at [t_total], the changed total at [t_total + 1] (wrapping mod 2^32
// like an int32 sum) and, for m > 1, the max last round at [t_total + 2].
// count is uniform across the block, so every thread reaches each scan.
template <typename Fold>
__device__ __forceinline__ void ordered_compact(int count, int t_total, int m,
                                                int32_t* ids_out, Fold fold) {
  int next = 0;
  unsigned changed = 0;
  int max_last = 0;
  for (int start = 0; start < count; start += blockDim.x) {
    const int j = start + threadIdx.x;
    int flag = 0;
    int id = 0;
    if (j < count) {
      const StripeFold f = fold(j);
      id = f.id;
      flag = (f.last == m) ? 1 : 0;
      changed += f.changed;
      max_last = max(max_last, f.last);
    }
    int chunk_total;
    const int pos = block_exclusive_scan(flag, &chunk_total);
    if (flag) ids_out[next + pos] = id;
    next += chunk_total;
  }
  changed = block_sum(changed);
  max_last = block_max(max_last);
  if (threadIdx.x == 0) {
    ids_out[t_total] = next;
    ids_out[t_total + 1] = (int32_t)changed;
    if (m > 1) ids_out[t_total + 2] = max_last;
  }
}

// One shard's extended column (frontier_shard.cu, frontier_shard_window.cu):
// s rows of top, b rows of mid, s rows of bot, every segment row-major with
// row stride n.
template <int NF>
struct ExtColumn {
  Fields<NF> top, mid, bot;
  int s, b;
  int64_t n, col;

  // r is uniform across a warp, so the segment branches never diverge
  __device__ __forceinline__ void load(int32_t (&v)[NF], int r) const {
    if (r < s) {
      load_entry(v, top, (int64_t)r * n + col);
    } else if (r < s + b) {
      load_entry(v, mid, (int64_t)(r - s) * n + col);
    } else {
      load_entry(v, bot, (int64_t)(r - s - b) * n + col);
    }
  }
  __device__ __forceinline__ void store(int r, const int32_t (&v)[NF]) const {
    if (r < s) {
      store_entry(top, (int64_t)r * n + col, v);
    } else if (r < s + b) {
      store_entry(mid, (int64_t)(r - s) * n + col, v);
    } else {
      store_entry(bot, (int64_t)(r - s - b) * n + col, v);
    }
  }
};

// One round on the extended column as a ring, in place (the pre-round rows
// r - 1 and r and the original row 0 stay in registers, as in
// sweep_column). After round k the rows [k, 2 s + b - k) are exact (the
// trapezoid of the reference's time tiling), so m <= s rounds leave the
// shard's rows exact; garbage from the internal wrap never reaches them.
// Calls on_row(r, wins) for every row r, wins being how many of its two
// neighbours beat it in turn (0, 1 or 2; nonzero iff the row changed).
template <typename E, typename OnRow>
__device__ __forceinline__ void sweep_ext(const ExtColumn<E::NF>& c, OnRow on_row) {
  constexpr int NF = E::NF;
  const int len = 2 * c.s + c.b;
  int32_t row0[NF], up[NF], cur[NF], down[NF];
  c.load(row0, 0);
  c.load(up, len - 1);
  copy_entry(cur, row0);
  for (int r = 0; r < len; ++r) {
    if (r + 1 < len) {
      c.load(down, r + 1);
    } else {
      copy_entry(down, row0);
    }
    int32_t m[NF];
    unsigned wins = 0;
    copy_entry(m, cur);
    if (E::gt(up, m)) {
      copy_entry(m, up);
      ++wins;
    }
    if (E::gt(down, m)) {
      copy_entry(m, down);
      ++wins;
    }
    c.store(r, m);
    on_row(r, wins);
    copy_entry(up, cur);
    copy_entry(cur, down);
  }
}

// internal linkage: every source that includes this header gets its own
namespace {

__global__ void frontier_compact_kernel(const int32_t* ids, int32_t* ids_out,
                                        const unsigned* stripe_changed,
                                        const int32_t* stripe_last,
                                        int t_total, int m) {
  ordered_compact(ids[t_total], t_total, m, ids_out, [&](int j) {
    return StripeFold{ids[j], stripe_changed[j], stripe_last[j]};
  });
}

}  // namespace

// fields: host array of E::NF device pointers to [p, n] int32 (updated in
// place). ids: [t_total + 2] (m = 1) or [t_total + 3] (m > 1) int32 on the
// device; ids_out: a separate array of the same length. stripe_changed and
// stripe_last: [t_total] int32 scratch. tile_n divides n; tile_n is a
// multiple of 32 and at most kMaxTile.
template <typename E>
cudaError_t launch_frontier_round(void* const* fields, const void* ids, void* ids_out,
                                  void* stripe_changed, void* stripe_last, int p,
                                  long long n, int tile_n, int t_total, int m,
                                  int wrap, cudaStream_t s) {
  if (tile_n < 32 || tile_n > kMaxTile || tile_n % 32 || m < 1) {
    return cudaErrorInvalidValue;
  }
  auto* in = static_cast<const int32_t*>(ids);
  auto* sc = static_cast<unsigned*>(stripe_changed);
  auto* sl = static_cast<int32_t*>(stripe_last);
  if (t_total > 0) {
    frontier_round_kernel<E><<<t_total, tile_n, 0, s>>>(
        fields_of<E::NF>(fields), in, p, n, tile_n, t_total, m, wrap, sc, sl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  frontier_compact_kernel<<<1, 1024, 0, s>>>(
      in, static_cast<int32_t*>(ids_out), sc, sl, t_total, m);
  return cudaGetLastError();
}

}  // namespace bt
