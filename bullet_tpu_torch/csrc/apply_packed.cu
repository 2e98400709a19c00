// Apply K pre-reduced write ops to a packed-layout table (khi, klo, cv),
// in place: op i lands at (peer_i, slot_i) iff it carries a live value
// (cls = cv >> 28 > 0) and its key strictly beats the entry there, plus
// the count of ops that landed.
//
// Replaces: bullet_tpu/ops/packed.py::_chunk_apply_kernel (16-op chunks
// over block-sorted (8, 128) table blocks) and ::_window_apply_kernel
// (128-op one-hot windows over (8, 1024) blocks). Both exist because
// XLA:TPU's scatter is slow and copies its operand; both compute "apply K
// unique ops, return the win count".
//
// Bound on the H100: memory latency, then bytes. Each op reads its 20 bytes
// and touches three 32-byte sectors of the table to read and, if it wins,
// three to write: K x (20 + 6 x 32) bytes, 222 MB at K = 2^20, 0.07 ms at
// 3.35 TB/s. The accesses are scattered, so latency dominates.
// Design: one thread per op (grid-stride). The host's lattice pre-reduction
// (reduce_flat_ops) leaves at most one op per (peer, slot), so no two
// threads touch one entry and there is no write-write race: the TPU's
// consecutive-grid-step read-modify-write of a resident block does not
// carry over. Ops outside [0, p) x [0, n) are dropped, as the reference's
// scatter drops its out-of-range padding rows. The win count reduces per
// block and lands with one atomicAdd per block into a zeroed int32.
#include "lexmax.cuh"

namespace {

using Entry = bt::PackedEntry;

__global__ void apply_packed_kernel(bt::Fields<Entry::NF> t, const int32_t* ops,
                                    int64_t k, int p, int64_t n, unsigned* count) {
  constexpr int NF = Entry::NF;
  unsigned wins = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < k; i += stride) {
    const int32_t peer = ops[i];
    const int32_t slot = ops[k + i];
    if (peer < 0 || peer >= p || slot < 0 || slot >= n) continue;
    int32_t op[NF], cur[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) op[f] = ops[(2 + f) * k + i];
    const int64_t idx = (int64_t)peer * n + slot;
    bt::load_entry(cur, t, idx);
    if (Entry::present(op) && Entry::gt(op, cur)) {
      bt::store_entry(t, idx, op);
      ++wins;
    }
  }
  wins = bt::block_sum(wins);
  if (threadIdx.x == 0 && wins) atomicAdd(count, wins);
}

}  // namespace

// fields: host array of 3 device pointers to [p, n] int32 (updated in
// place). ops: [5, k] int32 on the device, rows peer, slot, khi, klo, cv,
// with unique (peer, slot) pairs. count: one zeroed device int32.
extern "C" cudaError_t bt_apply_packed(void* const* fields, const void* ops,
                                       long long k, int p, long long n,
                                       void* count, void* stream) {
  if (k <= 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (k + threads - 1) / threads;
  const long long cap = 16LL * bt::sm_count();
  if (blocks > cap) blocks = cap;
  apply_packed_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      bt::fields_of<Entry::NF>(fields), static_cast<const int32_t*>(ops), k, p, n,
      static_cast<unsigned*>(count));
  return cudaGetLastError();
}
