// Compacting frontier step over the dense table: m ring/chain rounds, in
// place, on the active slot stripes only, then the next round's ids array
// (frontier.cuh, shared with the packed layout).
//
// Replaces: bullet_tpu/ops/ring_kernel.py::_frontier_fullp_kernel_dense
// (nf = 7 full metadata and nf = 4 lean, m = 1 and m > 1).
//
// Bound on the H100: device memory. A fused step reads and writes each
// entry of an active stripe once per round (8 x nf bytes per entry per
// round: 56 full, 32 lean); a settled stripe costs nothing. The
// P x tile_n x nf x 4 byte stripe of a block (7 MB at P = 1024,
// tile_n = 256, nf = 7) is re-read from L2 in later fused rounds while it
// stays resident.
#include "frontier.cuh"

namespace {

template <typename E>
struct FrontierRound {
  static cudaError_t run(void* const* fields, const void* ids, void* ids_out,
                         void* stripe_changed, void* stripe_last, int p, long long n,
                         int tile_n, int t_total, int m, int wrap, cudaStream_t s) {
    return bt::launch_frontier_round<E>(fields, ids, ids_out, stripe_changed, stripe_last,
                                        p, n, tile_n, t_total, m, wrap, s);
  }
};

}  // namespace

// fields: host array of nf device pointers: the 7 fields of a dense table,
// or its 4 value keys (cls, khi, klo, vid) when nf = 4 (see
// bt::launch_frontier_round).
extern "C" cudaError_t bt_frontier_round_dense(
    void* const* fields, const void* ids, void* ids_out, void* stripe_changed,
    void* stripe_last, int p, long long n, int tile_n, int t_total, int m,
    int wrap, int lww, int nf, void* stream) {
  return bt::dispatch_dense<FrontierRound>(
      nf, lww, fields, ids, ids_out, stripe_changed, stripe_last, p, n, tile_n,
      t_total, m, wrap, static_cast<cudaStream_t>(stream));
}
