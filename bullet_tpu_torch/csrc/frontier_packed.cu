// Compacting frontier step over a packed-family table (packed (khi, klo,
// cv), rank (rank, cv) or rank1 (rank)): m ring/chain rounds, in place, on
// the active slot stripes only, then the next round's ids array
// (frontier.cuh, shared with the dense layout).
//
// Replaces: bullet_tpu/ops/packed.py::_frontier_round_kernel_packed
// (m = 1, ids [t_total + 2]) and ::_frontier_multiround_kernel_packed
// (m > 1, ids [t_total + 3] with max(stripe_last)); being column-owning it
// also computes what the peer-tile variants ::_frontier_halo_kernel_packed
// and ::_frontier_halo_multiround_kernel_packed compute, for any P.
//
// Bound on the H100: device memory. A step reads and writes each entry of
// an active stripe once (2 x NF x 4 bytes per entry), whatever m: m = 8 is
// one pipelined pass that keeps the last two rows of every round in
// registers (frontier.cuh, frontier_pipe_kernel); a settled stripe costs
// nothing.
#include "frontier.cuh"

namespace {

template <typename E>
struct Launch {
  static cudaError_t run(void* const* fields, const void* ids, void* ids_out,
                         void* stripe_changed, void* stripe_last, int p, long long n,
                         int tile_n, int t_total, int m, int wrap, cudaStream_t s) {
    return bt::launch_frontier_round<E>(fields, ids, ids_out, stripe_changed, stripe_last,
                                        p, n, tile_n, t_total, m, wrap, s);
  }
};

}  // namespace

// fields: host array of nf device pointers (see bt::launch_frontier_round).
// nf: 3 = packed, 2 = rank, 1 = rank1.
extern "C" cudaError_t bt_frontier_round_packed(
    void* const* fields, const void* ids, void* ids_out, void* stripe_changed,
    void* stripe_last, int p, long long n, int tile_n, int t_total, int m,
    int wrap, int nf, void* stream) {
  return bt::dispatch_nf<Launch>(nf, fields, ids, ids_out, stripe_changed, stripe_last,
                                 p, n, tile_n, t_total, m, wrap,
                                 static_cast<cudaStream_t>(stream));
}
