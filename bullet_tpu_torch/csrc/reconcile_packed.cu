// Direct reconcile of a packed-family table (packed, rank or rank1), in
// place: every row of a column becomes the lexmax of that whole column.
//
// Replaces: bullet_tpu/ops/packed.py::_reconcile_kernel_packed, which runs
// ceil(log2 P) doubling joins (roll by 1, 2, 4, ... with wrap-around) per
// stripe. After them every row holds the join of all P rows of its column,
// for any P >= 1, and each packed-family key chain is a total order on
// entries (equal keys mean an equal entry), so that join is the column's
// lexmax: this kernel computes it directly.
//
// Bound on the H100: device memory. One read and one write of the table
// (2 x NF x 4 bytes per entry), against log2 P reads and writes of the
// doubling form.
// Design: thread j owns column j: it scans rows 0..P-1 keeping the running
// lexmax in registers, then writes it to every row. A warp's 32 threads
// touch 32 neighbouring columns of one row, so every access is coalesced.
// Any P, N >= 1 is taken.
#include "lexmax.cuh"

namespace {

template <typename E>
__global__ void reconcile_packed_kernel(bt::Fields<E::NF> t, int p, int64_t n) {
  constexpr int NF = E::NF;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  int32_t best[NF], cur[NF];
  bt::load_entry(best, t, col);
  for (int r = 1; r < p; ++r) {
    bt::load_entry(cur, t, (int64_t)r * n + col);
    if (E::gt(cur, best)) bt::copy_entry(best, cur);
  }
  for (int r = 0; r < p; ++r) bt::store_entry(t, (int64_t)r * n + col, best);
}

template <typename E>
struct Launch {
  static cudaError_t run(void* const* fields, int p, long long n, cudaStream_t s) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    reconcile_packed_kernel<E><<<(unsigned)blocks, threads, 0, s>>>(
        bt::fields_of<E::NF>(fields), p, n);
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to [p, n] int32 (updated in
// place). nf: 3 = packed, 2 = rank, 1 = rank1.
extern "C" cudaError_t bt_reconcile_packed(void* const* fields, int p, long long n,
                                           int nf, void* stream) {
  return bt::dispatch_nf<Launch>(nf, fields, p, n, static_cast<cudaStream_t>(stream));
}
