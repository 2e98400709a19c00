// One ring or chain gossip round over the whole dense table, in place:
// row p <- lexmax(lexmax(row p, row p-1), row p+1) from the pre-round
// table, plus the changed count sum(gt1) + sum(gt2).
//
// Replaces: bullet_tpu/ops/ring_kernel.py::_fullp_round_kernel (full-P
// stripes) and ::_ring_round_kernel (peer tiles with 8-row halos), through
// bt_ring_round; ::_fullp_round_kernel_lean and ::_halo_round_kernel_lean,
// the lean round on the four value keys (cls, khi, klo, vid), through
// bt_ring_round_lean, which never reads or writes writer, ctr or tick. One
// kernel covers both tilings: a CUDA thread owns a whole column, so no
// shape needs a halo variant.
//
// Bound on the H100: device memory. Each entry is read once and written
// once per round (7 + 7 int32 = 56 bytes per entry; 32 for the lean
// round), against three reads and a write for a round composed of two
// generic merges.
// Design: thread j sweeps column j from row 0 to row P-1 (bt::sweep_column),
// holding the pre-round rows p-1 and p and the original row 0 in
// registers, so the round runs in place with no second table and no halo
// reads; a warp's 32 threads read 32 neighbouring columns of one row, which
// keeps every load coalesced. The count reduces per block and lands with one
// atomicAdd per block. Any P, N >= 1 is taken (P = 1 and 2 included: the
// sweep reads every neighbour before it overwrites it).
#include "lexmax.cuh"

namespace {

template <typename E>
__global__ void ring_round_kernel(bt::Fields<E::NF> t, int p, int64_t n, int wrap,
                                  unsigned* count) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned changed = 0;
  if (col < n) changed = bt::sweep_column<E>(t, col, p, n, wrap != 0);
  changed = bt::block_sum(changed);
  if (threadIdx.x == 0 && changed) atomicAdd(count, changed);
}

template <typename E>
struct RingRound {
  static cudaError_t run(void* const* fields, void* count, int p, long long n, int wrap,
                         cudaStream_t s) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    ring_round_kernel<E><<<(unsigned)blocks, threads, 0, s>>>(
        bt::fields_of<E::NF>(fields), p, n, wrap, static_cast<unsigned*>(count));
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of 7 device pointers to [p, n] int32 (updated in
// place). count: one zeroed device int32.
extern "C" cudaError_t bt_ring_round(void* const* fields, void* count, int p,
                                     long long n, int wrap, int lww,
                                     void* stream) {
  return bt::dispatch_dense<RingRound>(7, lww, fields, count, p, n, wrap,
                                       static_cast<cudaStream_t>(stream));
}

// fields: host array of the 4 device pointers (cls, khi, klo, vid) of a
// dense table, each [p, n] int32 (updated in place). count: one zeroed
// device int32.
extern "C" cudaError_t bt_ring_round_lean(void* const* fields, void* count, int p,
                                          long long n, int wrap, void* stream) {
  return bt::dispatch_dense<RingRound>(4, 0, fields, count, p, n, wrap,
                                       static_cast<cudaStream_t>(stream));
}
