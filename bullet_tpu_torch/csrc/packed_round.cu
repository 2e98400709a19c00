// Ring or chain gossip rounds over a whole packed-family table (packed
// (khi, klo, cv), rank (rank, cv) or rank1 (rank)), in place: m rounds of
// row p <- lexmax(lexmax(row p, row p-1), row p+1) from the pre-round
// table, plus the changed count summed over the m rounds; or, in
// count-only mode, the count one round would produce with nothing written.
//
// Replaces: bullet_tpu/ops/packed.py::_fullp_round_kernel_packed (m = 1),
// ::_fullp_multiround_kernel_packed (m = M), ::_changes_round_kernel_packed
// (count-only) and ::_halo_round_kernel_packed (the same round on peer
// tiles, which the TPU takes where a full-P stripe does not fit VMEM). A
// CUDA thread owns a whole column, so one kernel covers every P.
//
// Bound on the H100: device memory. Each entry is read once and written
// once per pass (2 x NF x 4 bytes per entry); the count-only probe reads
// NF x 4 bytes per entry and writes nothing.
// Design: m = 1 and the probe: thread j sweeps column j from row 0 to row
// P-1 (bt::sweep_column), holding the pre-round rows p-1 and p and the
// original row 0 in registers; a warp's 32 threads read 32 neighbouring
// columns of one row, so every load is coalesced. m = 8q + r rounds: q
// pipelined passes of bt::kPipeDepth = 8 rounds each (frontier.cuh's
// frontier_pipe_kernel over every stripe of bt::kMaxTile columns, the
// compacting frontier's pass with a total count in place of its stripe
// counts: stage k runs round k one row behind stage k - 1, so a pass reads
// and writes each entry once, where m sweeps re-read a column that does not
// stay in L2), then r sweeps. Every launch adds its count, reduced per
// block, with one atomicAdd per block into the zeroed int32 (mod 2^32, like
// the reference's int32 sum); the launches run in order on the stream.
#include "frontier.cuh"

namespace {

template <typename E, bool STORE>
__global__ void packed_round_kernel(bt::Fields<E::NF> t, int p, int64_t n,
                                    int m, int wrap, unsigned* count) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned changed = 0;
  if (col < n) {
    for (int k = 0; k < m; ++k) {
      changed += bt::sweep_column<E, STORE>(t, col, p, n, wrap != 0);
    }
  }
  changed = bt::block_sum(changed);
  if (threadIdx.x == 0 && changed) atomicAdd(count, changed);
}

template <typename E>
struct Launch {
  static cudaError_t run(void* const* fields, void* count, int p, long long n, int m,
                         int wrap, int count_only, cudaStream_t s) {
    const auto t = bt::fields_of<E::NF>(fields);
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    auto* c = static_cast<unsigned*>(count);
    if (count_only) {
      packed_round_kernel<E, false><<<(unsigned)blocks, threads, 0, s>>>(t, p, n, m, wrap, c);
      return cudaGetLastError();
    }
    const long long stripes = (n + bt::kMaxTile - 1) / bt::kMaxTile;
    for (int q = 0; q < m / bt::kPipeDepth; ++q) {
      const cudaError_t err = bt::launch_pipe<E>(fields, p, n, bt::kMaxTile, stripes, wrap,
                                                 bt::TotalCount{c}, s);
      if (err != cudaSuccess) return err;
    }
    if (m % bt::kPipeDepth) {
      packed_round_kernel<E, true><<<(unsigned)blocks, threads, 0, s>>>(
          t, p, n, m % bt::kPipeDepth, wrap, c);
    }
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to [p, n] int32 (updated in
// place unless count_only). count: one zeroed device int32. m >= 1 rounds;
// count_only requires m == 1. nf: 3 = packed, 2 = rank, 1 = rank1. An
// empty table launches nothing.
extern "C" cudaError_t bt_packed_round(void* const* fields, void* count, int p,
                                       long long n, int m, int wrap,
                                       int count_only, int nf, void* stream) {
  if (m < 1 || (count_only && m != 1)) return cudaErrorInvalidValue;
  if (p <= 0 || n <= 0) return cudaSuccess;
  return bt::dispatch_nf<Launch>(nf, fields, count, p, n, m, wrap, count_only,
                                 static_cast<cudaStream_t>(stream));
}
