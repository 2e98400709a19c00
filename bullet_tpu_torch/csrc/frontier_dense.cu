// Compacting frontier step over the dense table: m ring/chain rounds, in
// place, on the active slot stripes only, then the next round's ids array
// (frontier.cuh, shared with the packed layout).
//
// Replaces: bullet_tpu/ops/ring_kernel.py::_frontier_fullp_kernel_dense
// (nf = 7, m = 1 and m > 1).
//
// Bound on the H100: device memory. A fused step reads and writes each
// entry of an active stripe once per round (56 bytes per entry per round);
// a settled stripe costs nothing. The P x tile_n x 7 x 4 byte stripe of a
// block (7 MB at P = 1024, tile_n = 256) is re-read from L2 in later fused
// rounds while it stays resident.
#include "frontier.cuh"

// fields: host array of 7 device pointers (see bt::launch_frontier_round).
extern "C" cudaError_t bt_frontier_round_dense(
    void* const* fields, const void* ids, void* ids_out, void* stripe_changed,
    void* stripe_last, int p, long long n, int tile_n, int t_total, int m,
    int wrap, int lww, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (lww) {
    return bt::launch_frontier_round<bt::DenseEntry<true>>(
        fields, ids, ids_out, stripe_changed, stripe_last, p, n, tile_n,
        t_total, m, wrap, s);
  }
  return bt::launch_frontier_round<bt::DenseEntry<false>>(
      fields, ids, ids_out, stripe_changed, stripe_last, p, n, tile_n, t_total,
      m, wrap, s);
}
