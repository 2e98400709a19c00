// Per-shard window frontier step of the packed family on a device mesh: m
// ring rounds per boundary exchange (m <= 63 on the sim's route), in place,
// on the active slot stripes of one shard's [b, n] rows, given the m-row
// slabs of the neighbour shards taken before the step. Emits the window
// stats [2, t_total]: row 0 counts the shard's entries of the stripe whose
// value the step changed, row 1 is the last round (1..m) in which any of
// them changed, 0 for none. The caller sums row 0 and maxes row 1 over the
// shards and compacts them (compact_counts.cu, the window fold).
//
// Replaces: bullet_tpu/ops/packed.py::_frontier_shard_window_kernel_packed,
// at nf = 3 (packed), 2 (rank) and 1 (rank1).
//
// Bound on the H100: device memory. The function reads and writes each
// entry of an active stripe once and reads the 2 m slab rows:
// (2 b + 2 m) x 4 nf bytes per column.
// Design: the reference's distance chain, on chip. A block takes kCols
// columns of one stripe (a stripe spans tile_n / kCols blocks) and holds
// a row tile of their extended column [m slab | b rows | m slab] in shared
// memory, loaded once with cp.async: nf value planes and a distance word,
// [rows][kCols] each, twice (ping-pong). It joins the tile to radius m in
// the reference's doubling steps (s = min(m - r, r + 1), a +s and a -s
// join each: 12 joins at m = 63, against 126 compares an entry for 63
// classic rounds, the reason this design beats running the rounds on
// chip), every entry keeping its least distance to a source of its value:
// a strict win takes the candidate's distance + s, equal keys the smaller
// one, exactly as _window_dist_chain; shifted-out rows are the all-zero
// entry at distance 1 << 24 (the plain version's fill). Bit 30 of the
// distance word is the changed flag, the OR of the entry's strict wins:
// the lattice is monotone, so it equals "final beats original", and the
// last changed round of a changed entry is its distance. The tile's shard
// rows go back to device memory once; row 0 and row 1 are reduced over the
// block and added (atomicAdd) and maxed (atomicMax) into the zeroed stats,
// which is order-free, so the result is deterministic. A tile of h rows
// leaves its m-row margins inexact and writes the h - 2 m rows between
// (the trapezoid), so a shard whose extended column exceeds the
// shared-memory budget (b = 1024 at nf = 3) runs as consecutive tiles in
// the same block, overlapping by 2 m rows: before its joins a tile copies
// the PRE-CALL values of its last 2 m rows to a carry area, the next
// tile's first rows, so no tile ever reads a row that an earlier one has
// written, and every row is read from device memory once. The slabs are
// read only.
#include <cuda_pipeline.h>

#include "frontier.cuh"

namespace {

// columns a block takes; a warp covers 32 / kCols rows of them, so its
// shared-memory accesses are 32 consecutive words (no bank conflict)
constexpr int kCols = 16;
constexpr int kThreads = 512;
constexpr int32_t kFlag = 1 << 30;       // the distance word's changed flag
constexpr int32_t kDistMask = kFlag - 1;
constexpr int32_t kFill = 1 << 24;       // a shifted-out row's distance

// One join of the chain over a tile of `rows` rows: row r takes the
// candidate at r - shift (the plain version's line shift by `shift`), read
// from src, written to dst.
template <typename E>
__device__ __forceinline__ void window_join(const int32_t* src, int32_t* dst, int rows,
                                            int shift, int s, int plane) {
  constexpr int NF = E::NF;
  const int c = threadIdx.x % kCols;
  for (int r = threadIdx.x / kCols; r < rows; r += kThreads / kCols) {
    const int32_t* own_p = src + r * kCols + c;
    int32_t own[NF], cand[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) own[f] = own_p[f * plane];
    int32_t word = own_p[NF * plane];
    int32_t cand_dist = kFill;
    const int from = r - shift;
    if (from >= 0 && from < rows) {
      const int32_t* q = src + from * kCols + c;
#pragma unroll
      for (int f = 0; f < NF; ++f) cand[f] = q[f * plane];
      cand_dist = (q[NF * plane] & kDistMask) + s;
    } else {
      bt::zero_entry(cand);
    }
    if (E::gt(cand, own)) {
      bt::copy_entry(own, cand);
      word = cand_dist | kFlag;
    } else if (E::eq(cand, own)) {
      word = min(word & kDistMask, cand_dist) | (word & kFlag);
    }
    int32_t* out = dst + r * kCols + c;
#pragma unroll
    for (int f = 0; f < NF; ++f) out[f * plane] = own[f];
    out[NF * plane] = word;
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    frontier_shard_window_kernel(bt::Fields<E::NF> mid, bt::Fields<E::NF> top,
                                 bt::Fields<E::NF> bot, const int32_t* ids, int b, int m,
                                 int64_t n, int tile_n, int t_total, int h_max,
                                 int32_t* stats) {
  constexpr int NF = E::NF;
  extern __shared__ int32_t smem[];
  const int groups = tile_n / kCols;
  const int slot = blockIdx.x / groups;
  if (slot >= ids[t_total]) return;  // uniform across the block
  const int stripe = ids[slot];
  const int c = threadIdx.x % kCols;
  const int64_t col = (int64_t)stripe * tile_n + (blockIdx.x % groups) * kCols + c;
  const int first = threadIdx.x / kCols, step = kThreads / kCols;
  const int len = b + 2 * m;
  const int inner = h_max - 2 * m;  // shard rows a tile writes
  const int plane = h_max * kCols;
  int32_t* const buf[2] = {smem, smem + (NF + 1) * plane};
  int32_t* const carry = smem + 2 * (NF + 1) * plane;  // [NF][2 m][kCols]
  unsigned changed = 0;
  int last = 0;
  for (int base = 0; base < b; base += inner) {  // the tile: extended rows [base, base + rows)
    const int rows = min(h_max, len - base);
    const int kept = base > 0 ? 2 * m : 0;
    for (int r = first; r < rows; r += step) {
      int32_t* dst = buf[0] + r * kCols + c;
      if (r < kept) {
#pragma unroll
        for (int f = 0; f < NF; ++f) dst[f * plane] = carry[(f * 2 * m + r) * kCols + c];
      } else {
        const int x = base + r;  // the extended row: slab, shard or slab
        const int seg = x < m ? 0 : (x < m + b ? 1 : 2);
        const int64_t idx = (int64_t)(seg == 0 ? x : (seg == 1 ? x - m : x - m - b)) * n + col;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int32_t* src = seg == 0 ? top.f[f] : (seg == 1 ? mid.f[f] : bot.f[f]);
          __pipeline_memcpy_async(dst + f * plane, src + idx, sizeof(int32_t));
        }
      }
      dst[NF * plane] = 0;  // distance 0, unchanged
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (base + inner < b) {
      // the next tile's first 2 m rows, pre-call: copied before the second
      // join overwrites buf[0] (the first join's barrier orders them)
      for (int r = first; r < 2 * m; r += step) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          carry[(f * 2 * m + r) * kCols + c] = buf[0][f * plane + (inner + r) * kCols + c];
        }
      }
    }
    int cur = 0;
    for (int reach = 0; reach < m;) {
      const int s = min(m - reach, reach + 1);
      window_join<E>(buf[cur], buf[cur ^ 1], rows, s, s, plane);
      __syncthreads();
      window_join<E>(buf[cur ^ 1], buf[cur], rows, -s, s, plane);
      __syncthreads();
      reach += s;
    }
    const int h = min(inner, b - base);
    for (int r = m + first; r < m + h; r += step) {
      const int32_t* v = buf[cur] + r * kCols + c;
      const int64_t idx = (int64_t)(base + r - m) * n + col;
#pragma unroll
      for (int f = 0; f < NF; ++f) mid.f[f][idx] = v[f * plane];
      const int32_t word = v[NF * plane];
      if (word & kFlag) {
        ++changed;
        last = max(last, word & kDistMask);
      }
    }
    __syncthreads();  // the next tile's loads overwrite buf[0]
  }
  changed = bt::block_sum(changed);
  last = bt::block_max(last);
  if (threadIdx.x == 0) {
    if (changed) atomicAdd(reinterpret_cast<unsigned*>(stats) + stripe, changed);
    if (last) atomicMax(stats + (int64_t)t_total + stripe, last);
  }
}

template <typename E>
struct FrontierShardWindow {
  static cudaError_t run(void* const* fields, void* const* tops, void* const* bottoms,
                         const void* ids, void* stats, int b, int m, long long n, int tile_n,
                         int t_total, cudaStream_t st) {
    constexpr int NF = E::NF;
    if (tile_n < 32 || tile_n > bt::kMaxTile || tile_n % 32 || m < 1 || b < 1) {
      return cudaErrorInvalidValue;
    }
    if (t_total == 0) return cudaSuccess;
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    // the rest of the block's shared memory: block_sum's and block_max's
    const int budget = optin - 1024;
    const int len = b + 2 * m;
    const int row_bytes = 2 * (NF + 1) * kCols * (int)sizeof(int32_t);
    const int carry_bytes = NF * 2 * m * kCols * (int)sizeof(int32_t);
    int h_max = min(len, budget / row_bytes);
    int smem = h_max * row_bytes;
    if (h_max < len) {  // tiles: make room for the carry
      h_max = (budget - carry_bytes) / row_bytes;
      smem = h_max * row_bytes + carry_bytes;
    }
    if (h_max <= 2 * m) return cudaErrorInvalidValue;
    auto* kernel = frontier_shard_window_kernel<E>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<t_total * (tile_n / kCols), kThreads, smem, st>>>(
        bt::fields_of<NF>(fields), bt::fields_of<NF>(tops), bt::fields_of<NF>(bottoms),
        static_cast<const int32_t*>(ids), b, m, n, tile_n, t_total, h_max,
        static_cast<int32_t*>(stats));
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to the shard's [b, n] int32 rows
// (updated in place); tops / bottoms: nf device pointers each to [m, n]
// int32 holding the m rows above / below the shard (zeros at a chain's
// ends), read only. ids: [t_total + 2] or [t_total + 3] int32 (the active
// stripes and their count at [t_total]). stats: [2, t_total] zeroed int32
// (stripes not in ids keep the zeros). 1 <= m <= 63 on the sim's route
// (any m whose 2 m + 1 rows fit the shared-memory tile); tile_n is a
// multiple of 32, at most bt::kMaxTile, and divides n; nf = 3, 2 or 1.
extern "C" cudaError_t bt_frontier_shard_window(void* const* fields, void* const* tops,
                                                void* const* bottoms, const void* ids,
                                                void* stats, int b, int m, long long n,
                                                int tile_n, int t_total, int nf,
                                                void* stream) {
  return bt::dispatch_nf<FrontierShardWindow>(nf, fields, tops, bottoms, ids, stats, b, m, n,
                                              tile_n, t_total,
                                              static_cast<cudaStream_t>(stream));
}
