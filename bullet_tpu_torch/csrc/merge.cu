// Elementwise two-table merge: out = lexmax(a, b) under the mode's priority
// order, plus the count of entries where b strictly won.
//
// Replaces: bullet_tpu/ops/merge.py::_merge_kernel (merge_tables_pallas).
//
// Bound on the H100: device memory. There is no arithmetic to speak of;
// each entry reads 14 int32 and writes 7, i.e. 84 bytes per entry.
// Design: one grid-stride pass over the flattened [P, N] fields, so every
// field is streamed exactly once with neighbouring threads on neighbouring
// addresses; the strict-win count is reduced in registers and shared memory
// and lands with one atomicAdd per block into a zeroed device int32, which
// wraps mod 2^32 like the reference's int32 sum. Any P, N >= 1 is taken;
// the ragged edge is the loop bound.
#include "lexmax.cuh"

namespace {

template <bool LWW>
__global__ void merge_kernel(bt::CFields<7> a, bt::CFields<7> b, bt::Fields<7> out,
                             unsigned* count, int64_t n) {
  using E = bt::DenseEntry<LWW>;
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

}  // namespace

// a, b, out: host arrays of 7 device pointers, each to n int32 values.
// count: one zeroed device int32. lww: 0 = reference order, 1 = lww.
extern "C" cudaError_t bt_merge(void* const* a, void* const* b,
                                void* const* out, void* count, long long n,
                                int lww, void* stream) {
  bt::CFields<7> fa, fb;
  for (int f = 0; f < 7; ++f) {
    fa.f[f] = static_cast<const int32_t*>(a[f]);
    fb.f[f] = static_cast<const int32_t*>(b[f]);
  }
  const bt::Fields<7> fo = bt::fields_of<7>(out);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 8LL * bt::sm_count();
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned*>(count);
  if (lww) {
    merge_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(fa, fb, fo, c, n);
  } else {
    merge_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(fa, fb, fo, c, n);
  }
  return cudaGetLastError();
}
