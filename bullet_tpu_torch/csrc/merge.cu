// Elementwise two-table merge: out = lexmax(a, b) under the mode's priority
// order, plus the count of entries where b strictly won.
//
// Replaces: bullet_tpu/ops/merge.py::_merge_kernel (merge_tables_pallas).
// At nf = 4 it is the lean merge of the value keys (cls, khi, klo, vid),
// which the reference computes in XLA (the lean reconcile and closure join
// of bullet_tpu/models/netsim.py).
//
// Bound on the H100: device memory. There is no arithmetic to speak of;
// each entry reads 2 x nf int32 and writes nf, i.e. 84 bytes per entry
// (48 lean).
// Design: one grid-stride pass over the flattened [P, N] fields, so every
// field is streamed exactly once with neighbouring threads on neighbouring
// addresses; the strict-win count is reduced in registers and shared memory
// and lands with one atomicAdd per block into a zeroed device int32, which
// wraps mod 2^32 like the reference's int32 sum. Any P, N >= 1 is taken;
// the ragged edge is the loop bound. A thread reads both entries before it
// writes, so out may be a (in place).
#include "lexmax.cuh"

namespace {

template <typename E>
__global__ void merge_kernel(bt::CFields<E::NF> a, bt::CFields<E::NF> b,
                             bt::Fields<E::NF> out, unsigned* count, int64_t n) {
  constexpr int NF = E::NF;
  unsigned wins = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t va[NF], vb[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      va[f] = a.f[f][i];
      vb[f] = b.f[f][i];
    }
    const bool take_b = E::gt(vb, va);
#pragma unroll
    for (int f = 0; f < NF; ++f) out.f[f][i] = take_b ? vb[f] : va[f];
    wins += take_b ? 1u : 0u;
  }
  wins = bt::block_sum(wins);
  if (threadIdx.x == 0 && wins) atomicAdd(count, wins);
}

template <typename E>
struct Merge {
  static cudaError_t run(void* const* a, void* const* b, void* const* out, void* count,
                         long long n, cudaStream_t s) {
    constexpr int NF = E::NF;
    bt::CFields<NF> fa, fb;
    for (int f = 0; f < NF; ++f) {
      fa.f[f] = static_cast<const int32_t*>(a[f]);
      fb.f[f] = static_cast<const int32_t*>(b[f]);
    }
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    const long long cap = 8LL * bt::sm_count();
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    merge_kernel<E><<<(unsigned)blocks, threads, 0, s>>>(
        fa, fb, bt::fields_of<NF>(out), static_cast<unsigned*>(count), n);
    return cudaGetLastError();
  }
};

}  // namespace

// a, b, out: host arrays of nf device pointers, each to n int32 values: the
// 7 fields of a dense table, or its 4 value keys when nf = 4 (lww ignored).
// out may equal a. count: one zeroed device int32. lww: 0 = reference
// order, 1 = lww.
extern "C" cudaError_t bt_merge(void* const* a, void* const* b,
                                void* const* out, void* count, long long n,
                                int lww, int nf, void* stream) {
  return bt::dispatch_dense<Merge>(nf, lww, a, b, out, count, n,
                                   static_cast<cudaStream_t>(stream));
}
