// One ring or chain gossip round over the whole dense table, in place:
// row p <- lexmax(lexmax(row p, row p-1), row p+1) from the pre-round
// table, plus the changed count sum(gt1) + sum(gt2).
//
// Replaces: bullet_tpu/ops/ring_kernel.py::_fullp_round_kernel (full-P
// stripes) and ::_ring_round_kernel (peer tiles with 8-row halos). One
// kernel covers both: a CUDA thread owns a whole column, so no shape needs
// a halo variant.
//
// Bound on the H100: device memory. Each entry is read once and written
// once per round (7 + 7 int32 = 56 bytes per entry), against three reads
// and a write for a round composed of two generic merges.
// Design: thread j sweeps column j from row 0 to row P-1 (bt::sweep_column),
// holding the pre-round rows p-1 and p and the original row 0 in
// registers, so the round runs in place with no second table and no halo
// reads; a warp's 32 threads read 32 neighbouring columns of one row, which
// keeps every load coalesced. The count reduces per block and lands with one
// atomicAdd per block. Any P, N >= 1 is taken (P = 1 and 2 included: the
// sweep reads every neighbour before it overwrites it).
#include "lexmax.cuh"

namespace {

template <bool LWW>
__global__ void ring_round_kernel(bt::Fields<7> t, int p, int64_t n, int wrap,
                                  unsigned* count) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned changed = 0;
  if (col < n) changed = bt::sweep_column<bt::DenseEntry<LWW>>(t, col, p, n, wrap != 0);
  changed = bt::block_sum(changed);
  if (threadIdx.x == 0 && changed) atomicAdd(count, changed);
}

}  // namespace

// fields: host array of 7 device pointers to [p, n] int32 (updated in
// place). count: one zeroed device int32.
extern "C" cudaError_t bt_ring_round(void* const* fields, void* count, int p,
                                     long long n, int wrap, int lww,
                                     void* stream) {
  const bt::Fields<7> t = bt::fields_of<7>(fields);
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned*>(count);
  if (lww) {
    ring_round_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(t, p, n, wrap, c);
  } else {
    ring_round_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(t, p, n, wrap, c);
  }
  return cudaGetLastError();
}
