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
// Design: the TPU kernel held a [m + b + m, tile] block in VMEM and joined
// it to radius m in O(log m) doubling steps, tracking each entry's
// distance to the source of its value. A thread that owns a column cannot
// hold that block in registers, so this kernel runs the m classic rounds
// instead: m in-place sweeps of the extended column [m slab | b rows |
// m slab] (bt::sweep_ext, the trapezoid of frontier_shard.cu with s = m;
// zeroed slabs at a chain's ends are exact, zero being the bottom of every
// order). The stats need no distances. The lattice is monotone, so an
// entry's final value differs from its original iff some round changed it,
// and its last change is the round in which its final value arrived (its
// distance to that value's source). Row 0 counts the entries marked, on
// their first change, in a per-call bitmask [ceil(b / 32), n] (bit r % 32
// of word [r / 32, col]; only the column's thread touches it); row 1 is the
// last round that changed any entry of the stripe, reduced over the block.
// Every sweep rereads the column from device memory, so a call costs about
// m times its bound; the slabs are the caller's per-call scratch, which the
// sweeps overwrite.
#include "frontier.cuh"

namespace {

template <typename E>
__global__ void __launch_bounds__(bt::kMaxTile)
    frontier_shard_window_kernel(bt::Fields<E::NF> mid, bt::Fields<E::NF> top,
                                 bt::Fields<E::NF> bot, const int32_t* ids, int b, int m,
                                 int64_t n, int tile_n, int t_total, uint32_t* marks,
                                 int32_t* stats) {
  const int j = blockIdx.x;
  if (j >= ids[t_total]) return;  // uniform across the block
  const int stripe = ids[j];
  const int64_t col = (int64_t)stripe * tile_n + threadIdx.x;
  unsigned changed = 0;
  int last = 0;
  if (threadIdx.x < tile_n && col < n) {
    const bt::ExtColumn<E::NF> c{top, mid, bot, m, b, n, col};
    for (int k = 1; k <= m; ++k) {
      bool any = false;
      bt::sweep_ext<E>(c, [&](int r, unsigned wins) {
        const int row = r - m;  // the shard's row
        if (wins == 0 || row < 0 || row >= b) return;
        any = true;
        uint32_t* word = marks + (int64_t)(row >> 5) * n + col;
        const uint32_t bit = 1u << (row & 31);
        const uint32_t w = *word;
        if (!(w & bit)) {
          *word = w | bit;
          ++changed;
        }
      });
      if (any) last = k;
    }
  }
  changed = bt::block_sum(changed);
  last = bt::block_max(last);
  if (threadIdx.x == 0) {
    stats[stripe] = (int32_t)changed;
    stats[(int64_t)t_total + stripe] = last;
  }
}

template <typename E>
struct FrontierShardWindow {
  static cudaError_t run(void* const* fields, void* const* tops, void* const* bottoms,
                         const void* ids, void* stats, void* marks, int b, int m,
                         long long n, int tile_n, int t_total, cudaStream_t st) {
    constexpr int NF = E::NF;
    if (tile_n < 32 || tile_n > bt::kMaxTile || tile_n % 32 || m < 1 || b < 1) {
      return cudaErrorInvalidValue;
    }
    if (t_total == 0) return cudaSuccess;
    frontier_shard_window_kernel<E><<<t_total, tile_n, 0, st>>>(
        bt::fields_of<NF>(fields), bt::fields_of<NF>(tops), bt::fields_of<NF>(bottoms),
        static_cast<const int32_t*>(ids), b, m, n, tile_n, t_total,
        static_cast<uint32_t*>(marks), static_cast<int32_t*>(stats));
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to the shard's [b, n] int32 rows
// (updated in place); tops / bottoms: nf device pointers each to [m, n]
// int32 scratch holding the m rows above / below the shard (zeros at a
// chain's ends), overwritten. ids: [t_total + 2] or [t_total + 3] int32 (the
// active stripes and their count at [t_total]). stats: [2, t_total] zeroed
// int32 (stripes not in ids keep the zeros). marks: [ceil(b / 32), n]
// zeroed int32 scratch. m >= 1; tile_n is a multiple of 32, at most
// bt::kMaxTile, and divides n; nf = 3, 2 or 1.
extern "C" cudaError_t bt_frontier_shard_window(void* const* fields, void* const* tops,
                                                void* const* bottoms, const void* ids,
                                                void* stats, void* marks, int b, int m,
                                                long long n, int tile_n, int t_total, int nf,
                                                void* stream) {
  return bt::dispatch_nf<FrontierShardWindow>(nf, fields, tops, bottoms, ids, stats, marks,
                                              b, m, n, tile_n, t_total,
                                              static_cast<cudaStream_t>(stream));
}
