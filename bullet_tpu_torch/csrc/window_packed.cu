// m ring or chain gossip rounds over a packed-family table (packed
// (khi, klo, cv), rank (rank, cv) or rank1 (rank)) as one window join, in
// place: every row becomes the lexmax of its radius-(m-1) window along the
// peer axis (wrapped on a ring, clipped to [0, P-1] on a chain), then one
// classic round runs on that result. The count is that last round's
// winner-select count sum(gt1) + sum(gt2), as bt::sweep_column counts it,
// summed mod 2^32: the classic round-m residual, not an m-round total.
//
// Replaces: bullet_tpu/ops/packed.py::_fullp_window_kernel_packed (the
// window join on a full-P VMEM stripe) and ::_halo_window_kernel_packed
// (the same join on peer tiles with m-row boundary snapshots, which the
// TPU takes where a full-P stripe does not fit VMEM). A thread owns a
// whole column here, so one kernel covers every P.
//
// Why a window: the merge is an idempotent lattice join and equal keys
// mean equal entries in every packed-family layout, so m Jacobi rounds
// equal the radius-m window join, and any way of computing that join gives
// the same bits. The radius grows by the reference's greedy schedule
// (_window_chain): from radius r a 3-way join with the rows r' = p - s and
// p + s (s <= 2r + 1) covers radius r + s, so radius m - 1 takes
// O(log m) steps. A chain clamps the shifted rows to rows 0 and P-1,
// whose accumulated windows are the edge-clipped ones (zero-filling would
// lose coverage). The final step is bt::sweep_column, so its count is
// bit-identical to the classic loop's round-m residual.
//
// Bound on the H100: device memory. The floor is one read and one write of
// the table (2 x NF x 4 bytes per entry). This simple design reads three
// entries and writes one per entry and doubling step, ping-ponging between
// the table and one table-sized scratch that the caller allocates, then
// reads and writes once more for the final round: several times the floor
// at m = 120 (6 steps). A design that keeps O(m) rows of each column on
// chip would reach one pass.
#include "lexmax.cuh"

namespace {

// dst[r] <- lexmax(src[r], src[r - s], src[r + s]) on column `col`, the
// shifted rows wrapped (ring) or clamped to rows 0 and P-1 (chain).
template <typename E>
__global__ void window_step_kernel(bt::Fields<E::NF> src, bt::Fields<E::NF> dst, int p,
                                   int64_t n, long long s, int wrap) {
  constexpr int NF = E::NF;
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const long long ring_s = s % p;
  for (int r = 0; r < p; ++r) {
    long long lo, hi;
    if (wrap) {
      lo = r - ring_s;
      if (lo < 0) lo += p;
      hi = r + ring_s;
      if (hi >= p) hi -= p;
    } else {
      lo = r - s < 0 ? 0 : r - s;
      hi = r + s > p - 1 ? p - 1 : r + s;
    }
    int32_t best[NF], cand[NF];
    bt::load_entry(best, src, (int64_t)r * n + col);
    bt::load_entry(cand, src, lo * n + col);
    if (E::gt(cand, best)) bt::copy_entry(best, cand);
    bt::load_entry(cand, src, hi * n + col);
    if (E::gt(cand, best)) bt::copy_entry(best, cand);
    bt::store_entry(dst, (int64_t)r * n + col, best);
  }
}

// The final classic round from src into dst (the same table or not).
template <typename E>
__global__ void window_round_kernel(bt::Fields<E::NF> src, bt::Fields<E::NF> dst, int p,
                                    int64_t n, int wrap, unsigned* count) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned changed = 0;
  if (col < n) changed = bt::sweep_column<E>(src, dst, col, p, n, wrap != 0);
  changed = bt::block_sum(changed);
  if (threadIdx.x == 0 && changed) atomicAdd(count, changed);
}

template <typename E>
struct Launch {
  static cudaError_t run(void* const* fields, void* const* scratch, void* count, int p,
                         long long n, long long m, int wrap, cudaStream_t s) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    const auto table = bt::fields_of<E::NF>(fields);
    auto cur = table;
    auto other = table;
    if (m > 1) other = bt::fields_of<E::NF>(scratch);
    // grow the radius to m - 1 (the reference's _window_chain)
    for (long long r = 0; r < m - 1;) {
      const long long step = (m - 1 - r < 2 * r + 1) ? m - 1 - r : 2 * r + 1;
      window_step_kernel<E><<<blocks, threads, 0, s>>>(cur, other, p, n, step, wrap);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const auto t = cur;
      cur = other;
      other = t;
      r += step;
    }
    window_round_kernel<E><<<blocks, threads, 0, s>>>(cur, table, p, n, wrap,
                                                      static_cast<unsigned*>(count));
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to [p, n] int32 (updated in
// place). scratch: host array of nf device pointers to [p, n] int32 the
// kernel may overwrite (read only when m > 1). count: one zeroed device
// int32. m >= 1 rounds. nf: 3 = packed, 2 = rank, 1 = rank1.
extern "C" cudaError_t bt_window_packed(void* const* fields, void* const* scratch,
                                        void* count, int p, long long n, long long m,
                                        int wrap, int nf, void* stream) {
  if (m < 1 || p < 1) return cudaErrorInvalidValue;
  return bt::dispatch_nf<Launch>(nf, fields, scratch, count, p, n, m, wrap,
                                 static_cast<cudaStream_t>(stream));
}
