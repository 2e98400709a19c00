// Apply K pre-reduced write ops to a packed-family table, in place: op i
// lands at (peer_i, slot_i) iff it carries a live value (E::present) and
// its key strictly beats the entry there, plus the count of ops that
// landed. Instantiated for the packed (khi, klo, cv), rank (rank, cv) and
// rank1 (rank) layouts.
//
// Replaces: bullet_tpu/ops/packed.py::_chunk_apply_kernel (16-op chunks
// over block-sorted (8, 128) table blocks) and ::_window_apply_kernel
// (128-op one-hot windows over (8, 1024) blocks). Both exist because
// XLA:TPU's scatter is slow and copies its operand; both compute "apply K
// unique ops, return the win count".
//
// Bound on the H100: device memory, reckoned in 32-byte sectors, the least
// a scattered access moves: the op rows read once, a sector of each entry
// plane its compare needs, and a sector a plane of each entry that an op
// lands on, written back. The sectors lie far apart, and what holds the
// kernel is not bytes but the rate at which the card serves scattered
// accesses: on an H100, at 0.9 M ops on a 1024 x 2^20 table, some 20 G
// sector reads a second, the rate of torch's own gather of the same
// entries (index_select). Sorted or shuffled ops and tables of 2^18 to
// 2^22 columns run at that rate (no locality or address translation
// effect), and a kernel with 4 ops a thread and every load issued first
// ran slower (0.08 against 0.07 ms at rank1): more requests in flight do
// not help. A read of a second plane at the same index costs little
// beside the first; a third, or a dependent one, does.
// Design: one thread per op (grid-stride, 16 blocks of 256 an SM at
// most). A dead op (E::present false) reads no entry. The entry's planes
// are read most significant key first and only as far as the compare
// needs (E::gt_at): the packed layout reads cv (its class decides most
// compares), then khi and klo only on ties; the rank layouts read the
// rank alone (their cv is payload that no compare reads). An op that
// lands writes every plane. The host's lattice pre-reduction (reduce_flat_ops /
// reduce_flat_ops_rank) leaves at most one op per (peer, slot), so no two
// threads touch one entry and there is no write-write race: the TPU's
// consecutive-grid-step read-modify-write of a resident block does not
// carry over. Ops outside [0, p) x [0, n) are dropped, as the reference's
// scatter drops its out-of-range padding rows. The win count reduces per
// block and lands with one atomicAdd per block into a zeroed int32
// (wrapping mod 2^32).
#include "lexmax.cuh"

namespace {

template <typename E>
__global__ void apply_packed_kernel(bt::Fields<E::NF> t, const int32_t* ops, int64_t k, int p,
                                    int64_t n, unsigned* count) {
  constexpr int NF = E::NF;
  unsigned wins = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < k; i += stride) {
    const int32_t peer = ops[i];
    const int32_t slot = ops[k + i];
    if (peer < 0 || peer >= p || slot < 0 || slot >= n) continue;
    int32_t op[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) op[f] = ops[(2 + f) * k + i];
    const int64_t idx = (int64_t)peer * n + slot;
    if (E::present(op) && E::gt_at(op, [&](int f) { return t.f[f][idx]; })) {
      bt::store_entry(t, idx, op);
      ++wins;
    }
  }
  wins = bt::block_sum(wins);
  if (threadIdx.x == 0 && wins) atomicAdd(count, wins);
}

template <typename E>
struct Launch {
  static cudaError_t run(void* const* fields, const void* ops, long long k, int p,
                         long long n, void* count, cudaStream_t s) {
    const int threads = 256;
    long long blocks = (k + threads - 1) / threads;
    const long long cap = 16LL * bt::sm_count();
    if (blocks > cap) blocks = cap;
    apply_packed_kernel<E><<<(unsigned)blocks, threads, 0, s>>>(
        bt::fields_of<E::NF>(fields), static_cast<const int32_t*>(ops), k, p, n,
        static_cast<unsigned*>(count));
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to [p, n] int32 (updated in
// place). ops: [2 + nf, k] int32 on the device, rows peer, slot, then the
// table's fields, with unique (peer, slot) pairs. count: one zeroed device
// int32. nf: 3 = packed, 2 = rank, 1 = rank1.
extern "C" cudaError_t bt_apply_packed(void* const* fields, const void* ops,
                                       long long k, int p, long long n,
                                       void* count, int nf, void* stream) {
  if (k <= 0) return cudaSuccess;
  return bt::dispatch_nf<Launch>(nf, fields, ops, k, p, n, count,
                                 static_cast<cudaStream_t>(stream));
}
