// Compacting frontier step over a packed-layout table (khi, klo, cv): m
// ring/chain rounds, in place, on the active slot stripes only, then the
// next round's ids array (frontier.cuh, shared with the dense layout).
//
// Replaces: bullet_tpu/ops/packed.py::_frontier_round_kernel_packed
// (m = 1, ids [t_total + 2]) and ::_frontier_multiround_kernel_packed
// (m > 1, ids [t_total + 3] with max(stripe_last)); being column-owning it
// also computes what the peer-tile variants ::_frontier_halo_kernel_packed
// and ::_frontier_halo_multiround_kernel_packed compute, for any P.
//
// Bound on the H100: device memory. A fused step reads and writes each
// entry of an active stripe once per round (24 bytes per entry per round);
// a settled stripe costs nothing. A block's stripe is P x tile_n x 12 bytes
// (3 MB at P = 1024, tile_n = 256), re-read from L2 in later fused rounds
// while it stays resident.
#include "frontier.cuh"

// fields: host array of 3 device pointers (see bt::launch_frontier_round).
extern "C" cudaError_t bt_frontier_round_packed(
    void* const* fields, const void* ids, void* ids_out, void* stripe_changed,
    void* stripe_last, int p, long long n, int tile_n, int t_total, int m,
    int wrap, void* stream) {
  return bt::launch_frontier_round<bt::PackedEntry>(
      fields, ids, ids_out, stripe_changed, stripe_last, p, n, tile_n, t_total,
      m, wrap, static_cast<cudaStream_t>(stream));
}
