// Compacting frontier step over the dense table: m ring/chain rounds, in
// place, on the active slot stripes only, then the next round's ids array
// (frontier.cuh, shared with the packed layout).
//
// Replaces: bullet_tpu/ops/ring_kernel.py::_frontier_fullp_kernel_dense
// (nf = 7 full metadata and nf = 4 lean, m = 1 and m > 1).
//
// Bound on the H100: device memory. A step reads and writes each entry of
// an active stripe once (8 x nf bytes per entry: 56 full, 32 lean),
// whatever m: m = 8 is one pipelined pass that keeps the last two rows of
// every round in registers (frontier.cuh, frontier_pipe_kernel; 112 int32
// of history at nf = 7); a settled stripe costs nothing.
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
