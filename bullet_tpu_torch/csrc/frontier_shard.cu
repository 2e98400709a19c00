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
// Bound on the H100: device memory. A step must read each entry of an
// active stripe once, write it once, and read the 2 s boundary rows
// (nf x 4 bytes an entry); a settled stripe costs nothing.
// Design: block j owns stripe ids[j], thread c column c of it, which it
// walks as its EXTENDED column: the s boundary rows above (tops, [s, n]),
// the shard's b rows, and the s boundary rows below (bottoms, [s, n])
// (bt::ExtColumn, frontier.cuh). A chain's global ends arrive as zeroed
// boundary rows: an all-zero row is the bottom of every priority order, so
// it adds nothing the classic round's zero neighbour would not. Only the
// shard's rows count and only they are stored: the boundary rows are read
// only at m = 1 and m = kPipeDepth. Three modes:
// - m = kPipeDepth (HALO_FUSE, the loops' fused depth): one pipelined pass
//   (shard_pipe_kernel) over the extended rows [s - M, s + b + M), each
//   read once, the shard's rows each written once, per-round counts in
//   registers and M block sums at the end;
// - m = 1: one sweep of the extended column as a ring (bt::sweep_ext);
// - any other m <= s: m such sweeps, in place, the boundary rows the
//   caller's scratch for all but the last.
// Counts land at counts[k * t_total + stripe]; stripes not in ids keep the
// caller's zeros.
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
      bt::sweep_ext<E>(c, k + 1 < m, [&](int r, unsigned wins) {
        if (r >= s && r < s + b) changed += wins;
      });
    }
    changed = bt::block_sum(changed);
    if (threadIdx.x == 0) counts[(int64_t)k * t_total + stripe] = (int32_t)changed;
  }
}

// Input e of the shard's pipelined pass: extended row s - M + e, encoded.
template <typename E, int M>
__device__ __forceinline__ void shard_input(int32_t (&v)[E::NF], const bt::ExtColumn<E::NF>& c,
                                            int e) {
  c.load(v, c.s - M + e);
  bt::PipeKey<E>::encode(v);
}

// Step e of the shard's pass (bt::pipe_stages), R = e mod 3. The pass's
// row j is extended row s - M + j, so the shard's rows are j in [M, M + b).
// EDGE: test each stage's row against them, and whether input e + 1
// exists. STORE: stage M's row e - M is a shard row, stored at shard row
// e - 2 M.
template <typename E, int M, int R, bool EDGE, bool STORE>
__device__ __forceinline__ void shard_step(int32_t (&h)[M][3][E::NF], int32_t (&next)[E::NF],
                                           unsigned (&cnt)[M], const bt::ExtColumn<E::NF>& c,
                                           int e) {
  constexpr int NF = E::NF;
  bt::copy_entry(h[0][R], next);
  if (!EDGE || e + 1 < c.b + 2 * M) shard_input<E, M>(next, c, e + 1);
  int32_t out[NF];
  bt::pipe_stages<E, M, R>(h, cnt, out, e, [&](int row, int32_t(&)[NF]) {
    return !EDGE || (row >= M && row < M + c.b);
  });
  if (STORE) {
    bt::PipeKey<E>::decode(out);
    bt::store_entry(c.mid, (int64_t)(e - 2 * M) * c.n + c.col, out);
  }
}

template <typename E, int M, bool EDGE, bool STORE>
__device__ __forceinline__ void shard_steps(int32_t (&h)[M][3][E::NF], int32_t (&next)[E::NF],
                                            unsigned (&cnt)[M], const bt::ExtColumn<E::NF>& c,
                                            int e, int end) {
  bt::rotated_steps(e, end, [&](auto slot, int step) {
    shard_step<E, M, decltype(slot)::value, EDGE, STORE>(h, next, cnt, c, step);
  });
}

// M rounds of the shard in one pass per column: bt::frontier_pipe_kernel's
// stages over the chain of the b + 2 M extended rows [s - M, s + b + M),
// which are all that M rounds of the shard's rows depend on (all 2 s + b
// rows when s = M). Step e reads input e, stage k emits round k at pass
// row e - k, and stage M's row e - M is a shard row for every e >= 2 M,
// so the pass has exactly b + 2 M steps. Before the chain's first row the
// stages hold encoded zeros, and past its ends nothing is read: y_k[j] is
// exact for j in [k, b + 2 M - k) (the trapezoid), which holds the
// shard's rows [M, M + b) at every stage, so each stage counts exactly the
// classic round's wins there, and the rest never reaches them. Parts:
// - head, steps [0, 2 M): no store (stage M is still in the upper
//   boundary rows), the counted rows tested;
// - body, steps [2 M, b + M]: every stage's row e - k (k = 1..M) lies in
//   [M, M + b) and input e + 1 exists (e + 1 <= b + M + 1 < b + 2 M), so no
//   test at all; empty when b < M;
// - tail, the rest up to b + 2 M: rows and input e + 1 tested.
// The counts stay in registers, one per stage, and meet in M block sums.
template <typename E, int M>
__global__ void __launch_bounds__(bt::kMaxTile)
    shard_pipe_kernel(bt::Fields<E::NF> mid, bt::Fields<E::NF> top, bt::Fields<E::NF> bot,
                      const int32_t* ids, int b, int s, int64_t n, int tile_n, int t_total,
                      int32_t* counts) {
  constexpr int NF = E::NF;
  const int j = blockIdx.x;
  if (j >= ids[t_total]) return;  // uniform across the block
  const int stripe = ids[j];
  const int64_t col = (int64_t)stripe * tile_n + threadIdx.x;
  unsigned cnt[M];
#pragma unroll
  for (int k = 0; k < M; ++k) cnt[k] = 0;
  if (threadIdx.x < tile_n && col < n) {
    const bt::ExtColumn<NF> c{top, mid, bot, s, b, n, col};
    int32_t h[M][3][NF];
    int32_t zero[NF];
    bt::zero_entry(zero);
    bt::PipeKey<E>::encode(zero);
#pragma unroll
    for (int k = 0; k < M; ++k) {
#pragma unroll
      for (int r = 0; r < 3; ++r) bt::copy_entry(h[k][r], zero);
    }
    int32_t next[NF];
    shard_input<E, M>(next, c, 0);
    const int body = max(2 * M, b + M + 1);
    shard_steps<E, M, true, false>(h, next, cnt, c, 0, 2 * M);
    shard_steps<E, M, false, true>(h, next, cnt, c, 2 * M, body);
    shard_steps<E, M, true, true>(h, next, cnt, c, body, b + 2 * M);
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const unsigned total = bt::block_sum(cnt[k]);
    if (threadIdx.x == 0) counts[(int64_t)k * t_total + stripe] = (int32_t)total;
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
    const auto mid = bt::fields_of<NF>(fields), top = bt::fields_of<NF>(tops),
               bot = bt::fields_of<NF>(bottoms);
    const auto* in = static_cast<const int32_t*>(ids);
    auto* out = static_cast<int32_t*>(counts);
    if (m == bt::kPipeDepth) {
      shard_pipe_kernel<E, bt::kPipeDepth>
          <<<t_total, tile_n, 0, st>>>(mid, top, bot, in, b, s, n, tile_n, t_total, out);
    } else {
      frontier_shard_kernel<E>
          <<<t_total, tile_n, 0, st>>>(mid, top, bot, in, b, s, n, tile_n, t_total, m, out);
    }
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to the shard's [b, n] int32
// rows (updated in place): the 7 fields of a dense table, or its 4 value
// keys when nf = 4 (lww ignored). tops / bottoms: nf device pointers each
// to [s, n] int32 holding the rows above / below the shard (zeros at a
// chain's ends): read only at m = 1 and m = bt::kPipeDepth, scratch at
// any other m. ids: [t_total + 2] or [t_total + 3] int32 (the active
// stripes and their count at [t_total]). counts: [m, t_total] zeroed
// int32. 1 <= m <= s; tile_n is a multiple of 32, at most bt::kMaxTile,
// and divides n.
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
