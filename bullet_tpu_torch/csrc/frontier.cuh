// Compacting frontier step, shared by every layout: m ring/chain rounds, in
// place, on the active slot stripes only, then the next round's ids array.
// frontier_dense.cu and frontier_packed.cu instantiate it for their entry
// types (lexmax.cuh). Also the ordered compaction (compact_counts.cu), the
// extended column of the per-shard step on a device mesh (frontier_shard.cu:
// its sweep, and its pipelined pass on pipe_stages) and the whole table's
// m-round pass (packed_round.cu: frontier_pipe_kernel with a total count).
//
// ids layout (as the reference's ops/packed.py frontier loops use it):
//   [0, count)    active stripe ids, ascending
//   [t_total]     count
//   [t_total+1]   entries changed by the step that produced this array
//   [t_total+2]   max over stripes of the last round that changed it (m > 1)
//
// Design: block j owns stripe ids[j]; thread c of the block owns column c
// of that stripe (lane = column, so a warp reads 32 consecutive int32 of a
// row per field). Columns are independent under ring gossip, so no
// block-wide sync is needed between rounds. The grid is t_total blocks;
// blocks with j >= ids[t_total] exit at once, so the host never reads the
// count to size the grid. The TPU appended ids in its sequential grid
// order; CUDA blocks run in no order, so the round kernel writes each
// stripe's changed count and last-changed round to scratch, and a second
// single-block kernel compacts the surviving stripes (last == m) in
// ascending order with a block prefix scan and writes the count, the
// changed total (wrapping mod 2^32 like an int32 sum) and max(last).
//
// m = 1 is one in-place sweep (bt::sweep_column). m = kPipeDepth (the
// wrappers' STRIPE_FUSE, the only fused depth the frontier loops send) is
// one pipelined pass (frontier_pipe_kernel): stage k of the thread runs
// round k one row behind stage k - 1, so the column is read once and
// written once whatever m; the stripe (3 MB packed, 7 MB dense at
// P = 1024) no longer has to survive in L2 across m sweeps. Any other m
// runs m sweeps back to back.
#pragma once

#include <utility>

#include "lexmax.cuh"

namespace bt {

// widest stripe a block takes (one thread per column); the wrappers'
// FRONTIER_TILE_MAX
constexpr int kMaxTile = 256;
// the fused depth of the pipelined pass: the wrappers' STRIPE_FUSE
constexpr int kPipeDepth = 8;

template <typename E>
__global__ void __launch_bounds__(kMaxTile)
    frontier_round_kernel(Fields<E::NF> t, const int32_t* ids, int p, int64_t n,
                          int tile_n, int t_total, int m, int wrap,
                          unsigned* stripe_changed, int32_t* stripe_last) {
  const int j = blockIdx.x;
  if (j >= ids[t_total]) return;  // uniform across the block
  const int64_t col = (int64_t)ids[j] * tile_n + threadIdx.x;
  unsigned total = 0;
  int last = 0;
  if (threadIdx.x < tile_n && col < n) {
    for (int k = 1; k <= m; ++k) {
      const unsigned c = sweep_column<E>(t, col, p, n, wrap != 0);
      total += c;
      if (c) last = k;
    }
  }
  total = block_sum(total);
  last = block_max(last);
  if (threadIdx.x == 0) {
    stripe_changed[j] = total;
    stripe_last[j] = last;
  }
}

// The pipelined pass compares every value three times (as a stage's
// `down`, `cur` and `up`), so it holds values in an order-preserving
// encoding whose compare is cheapest. A one-word key (rank, rank1) is the
// entry itself. A longer key is held as unsigned words, most significant
// first, and b beats a iff a - b borrows: one subtract with borrow a word
// (borrow_gt), against a chain of compares and branches.
template <typename E>
struct PipeKey {
  __device__ __forceinline__ static void encode(int32_t (&)[E::NF]) {}
  __device__ __forceinline__ static void decode(int32_t (&)[E::NF]) {}
  __device__ __forceinline__ static bool gt(const int32_t (&b)[E::NF],
                                            const int32_t (&a)[E::NF]) {
    return E::gt(b, a);
  }
};

// b > a as unsigned numbers of 3, 4 or 6 words, most significant first:
// the borrow out of a - b
__device__ __forceinline__ bool borrow_gt(int32_t b0, int32_t b1, int32_t b2, int32_t a0,
                                          int32_t a1, int32_t a2) {
  uint32_t borrow;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %2;\n\t"
      "subc.cc.u32 t, %3, %4;\n\t"
      "subc.cc.u32 t, %5, %6;\n\t"
      "subc.u32 %0, 0, 0;\n\t}"
      : "=r"(borrow)
      : "r"(a2), "r"(b2), "r"(a1), "r"(b1), "r"(a0), "r"(b0));
  return borrow != 0;
}

__device__ __forceinline__ bool borrow_gt(int32_t b0, int32_t b1, int32_t b2, int32_t b3,
                                          int32_t a0, int32_t a1, int32_t a2, int32_t a3) {
  uint32_t borrow;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %2;\n\t"
      "subc.cc.u32 t, %3, %4;\n\t"
      "subc.cc.u32 t, %5, %6;\n\t"
      "subc.cc.u32 t, %7, %8;\n\t"
      "subc.u32 %0, 0, 0;\n\t}"
      : "=r"(borrow)
      : "r"(a3), "r"(b3), "r"(a2), "r"(b2), "r"(a1), "r"(b1), "r"(a0), "r"(b0));
  return borrow != 0;
}

__device__ __forceinline__ bool borrow_gt(int32_t b0, int32_t b1, int32_t b2, int32_t b3,
                                          int32_t b4, int32_t b5, int32_t a0, int32_t a1,
                                          int32_t a2, int32_t a3, int32_t a4, int32_t a5) {
  uint32_t borrow;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %2;\n\t"
      "subc.cc.u32 t, %3, %4;\n\t"
      "subc.cc.u32 t, %5, %6;\n\t"
      "subc.cc.u32 t, %7, %8;\n\t"
      "subc.cc.u32 t, %9, %10;\n\t"
      "subc.cc.u32 t, %11, %12;\n\t"
      "subc.u32 %0, 0, 0;\n\t}"
      : "=r"(borrow)
      : "r"(a5), "r"(b5), "r"(a4), "r"(b4), "r"(a3), "r"(b3), "r"(a2), "r"(b2), "r"(a1),
        "r"(b1), "r"(a0), "r"(b0));
  return borrow != 0;
}

// Packed (khi, klo, cv) is keyed (cls, khi, klo, vid): 4 + 32 + 32 + 28 =
// 96 bits, held as three words w0 w1 w2 = cls' khi' klo' vid, the signed
// fields biased (cls ^ 8 on its 4 bits, khi and klo ^ 2^31) so that the
// unsigned order is the signed one.
template <>
struct PipeKey<PackedEntry> {
  __device__ __forceinline__ static void encode(int32_t (&v)[3]) {
    const uint32_t cls = ((uint32_t)v[2] >> kCvShift) ^ 8u;
    const uint32_t hi = (uint32_t)v[0] ^ 0x80000000u, lo = (uint32_t)v[1] ^ 0x80000000u;
    v[0] = (int32_t)__funnelshift_r(hi, cls, 4);
    v[1] = (int32_t)__funnelshift_r(lo, hi, 4);
    v[2] = (int32_t)((lo << kCvShift) | ((uint32_t)v[2] & 0x0fffffffu));
  }
  __device__ __forceinline__ static void decode(int32_t (&v)[3]) {
    const uint32_t w0 = v[0], w1 = v[1], w2 = v[2];
    v[0] = (int32_t)(__funnelshift_l(w1, w0, 4) ^ 0x80000000u);
    v[1] = (int32_t)(__funnelshift_l(w2, w1, 4) ^ 0x80000000u);
    v[2] = (int32_t)((((w0 >> kCvShift) ^ 8u) << kCvShift) | (w2 & 0x0fffffffu));
  }
  __device__ __forceinline__ static bool gt(const int32_t (&b)[3], const int32_t (&a)[3]) {
    return borrow_gt(b[0], b[1], b[2], a[0], a[1], a[2]);
  }
};

// Dense (7 fields, 6 of them keyed; tick carried) and lean (4 keyed): the
// key words biased by 2^31.
template <bool LWW>
struct PipeKey<DenseEntry<LWW>> {
  __device__ __forceinline__ static void encode(int32_t (&v)[7]) {
#pragma unroll
    for (int f = 0; f < 6; ++f) v[f] ^= INT32_MIN;
  }
  __device__ __forceinline__ static void decode(int32_t (&v)[7]) { encode(v); }
  __device__ __forceinline__ static bool gt(const int32_t (&b)[7], const int32_t (&a)[7]) {
    if (LWW) {
      return borrow_gt(b[5], b[0], b[1], b[2], b[3], b[4], a[5], a[0], a[1], a[2], a[3], a[4]);
    }
    return borrow_gt(b[0], b[1], b[2], b[3], b[4], b[5], a[0], a[1], a[2], a[3], a[4], a[5]);
  }
};

template <>
struct PipeKey<LeanEntry> {
  __device__ __forceinline__ static void encode(int32_t (&v)[4]) {
#pragma unroll
    for (int f = 0; f < 4; ++f) v[f] ^= INT32_MIN;
  }
  __device__ __forceinline__ static void decode(int32_t (&v)[4]) { encode(v); }
  __device__ __forceinline__ static bool gt(const int32_t (&b)[4], const int32_t (&a)[4]) {
    return borrow_gt(b[0], b[1], b[2], b[3], a[0], a[1], a[2], a[3]);
  }
};

// Input e of the pipelined pass over the extended sequence of p + 2 M rows,
// real row (e - M) mod p, encoded (PipeKey): a ring reads rows p - M..p - 1
// (mod p) before any store and, for e >= p + M, its original rows 0..M - 1
// (mod p) from the thread's copy in shared memory (saved[(r * NF + f) *
// blockDim.x + tid]), since the pass has overwritten them by then; a chain
// takes the all-zero entry outside [M, p + M).
template <typename E, int M>
__device__ __forceinline__ void pipe_input(int32_t (&v)[E::NF], const Fields<E::NF>& t,
                                           int32_t* saved, int e, int p, int64_t n,
                                           int64_t col, bool wrap) {
  constexpr int NF = E::NF;
  const int r = e - M;
  if (!wrap) {
    if (r < 0 || r >= p) {
      zero_entry(v);
    } else {
      load_entry(v, t, (int64_t)r * n + col);
    }
    PipeKey<E>::encode(v);
    return;
  }
  if (r >= p) {
#pragma unroll
    for (int f = 0; f < NF; ++f) v[f] = saved[((r % p) * NF + f) * blockDim.x + threadIdx.x];
    return;
  }
  const int real = r < 0 ? ((r % p) + p) % p : r;
  load_entry(v, t, (int64_t)real * n + col);
  PipeKey<E>::encode(v);
  if (r >= 0 && r < M) {
#pragma unroll
    for (int f = 0; f < NF; ++f) saved[(r * NF + f) * blockDim.x + threadIdx.x] = v[f];
  }
}

// The M stages of step e of a pipelined pass, R = e mod 3. h[k] holds
// stage k's last three inputs in rotation: in_e(k) in slot e mod 3, so at
// step e slot R + 1 holds in_{e-2} (its pre-round `up`) and slot R + 2
// in_{e-1} (`cur`), all mod 3, and slot R the input just put there (stage
// 0's: input e; stage k's: stage k - 1's output, `down`). Stage k + 1
// emits round k + 1 at row e - k - 1 of the pass straight into slot R of
// stage k + 1, whose old value in_{e-3} is dead, so no value ever moves
// between registers; the last stage's output lands in out. edge(row, v)
// says whether stage k + 1's output v at that row counts (cnt[k] += its
// wins) and may rewrite v (a chain's zero rows).
template <typename E, int M, int R, typename Edge>
__device__ __forceinline__ void pipe_stages(int32_t (&h)[M][3][E::NF], unsigned (&cnt)[M],
                                            int32_t (&out)[E::NF], int e, Edge edge) {
  constexpr int NF = E::NF;
  using K = PipeKey<E>;
#pragma unroll
  for (int k = 0; k < M; ++k) {  // stage k + 1 emits y_{k+1}[e - k - 1]
    const int32_t(&up)[NF] = h[k][(R + 1) % 3];
    const int32_t(&cur)[NF] = h[k][(R + 2) % 3];
    const int32_t(&down)[NF] = h[k][R];
    int32_t v[NF];
    const bool g1 = K::gt(up, cur);
#pragma unroll
    for (int f = 0; f < NF; ++f) v[f] = g1 ? up[f] : cur[f];
    const bool g2 = K::gt(down, v);
#pragma unroll
    for (int f = 0; f < NF; ++f) v[f] = g2 ? down[f] : v[f];
    if (edge(e - k - 1, v)) cnt[k] += (unsigned)g1 + (unsigned)g2;
    if (k + 1 < M) {
      copy_entry(h[k + 1][R], v);
    } else {
      copy_entry(out, v);
    }
  }
}

template <int R>
struct Slot {
  static constexpr int value = R;
};

// step(Slot<U>(), e + U) for each U of the sequence (if TEST, those with
// e + U < end)
template <bool TEST, typename Step, int... U>
__device__ __forceinline__ void rotated_turn(Step& step, int e, int end,
                                             std::integer_sequence<int, U...>) {
  ((!TEST || e + U < end ? step(Slot<U>(), e + U) : void()), ...);
}

// step(Slot<e mod R>(), e) for e mod R != 0 (U runs over 0..R-2)
template <int R, typename Step, int... U>
__device__ __forceinline__ void rotated_step(Step& step, int e,
                                             std::integer_sequence<int, U...>) {
  ((e % R == U + 1 ? step(Slot<U + 1>(), e) : void()), ...);
}

// Steps [e, end) of a pass over a ring of R slots as step(Slot<e mod R>(),
// e), each step's slot a compile-time constant: single steps up to a
// multiple of R, then the body unrolled by R without a test, then at most
// R - 1 steps, each tested. The pipelined passes rotate their history by 3
// (the default); the m = 1 shard sweep its ring of prefetched rows.
template <int R = 3, typename Step>
__device__ __forceinline__ void rotated_steps(int e, int end, Step step) {
  for (; e < end && e % R != 0; ++e) {
    rotated_step<R>(step, e, std::make_integer_sequence<int, R - 1>());
  }
  for (; e + R <= end; e += R) {
    rotated_turn<false>(step, e, end, std::make_integer_sequence<int, R>());
  }
  rotated_turn<true>(step, e, end, std::make_integer_sequence<int, R - 1>());
}

// Step e of the compacting frontier's pass (pipe_stages), R = e mod 3:
// takes input e into stage 0's slot, reads input e + 1, runs the stages and
// stores stage M's row. cnt[k] counts stage k's wins in the central copy.
// EDGE = false is a step e in [2 M, p + M], where every stage's row lies in
// the central copy and input e + 1 exists: no row test at all.
template <typename E, int M, int R, bool EDGE>
__device__ __forceinline__ void pipe_step(int32_t (&h)[M][3][E::NF], int32_t (&next)[E::NF],
                                          unsigned (&cnt)[M], const int32_t (&zero)[E::NF],
                                          const Fields<E::NF>& t, int32_t* saved, int e, int p,
                                          int64_t n, int64_t col, bool ring) {
  constexpr int NF = E::NF;
  copy_entry(h[0][R], next);
  if (!EDGE || e + 1 < p + 2 * M) pipe_input<E, M>(next, t, saved, e + 1, p, n, col, ring);
  int32_t out[NF];
  pipe_stages<E, M, R>(h, cnt, out, e, [&](int row, int32_t(&v)[NF]) {
    if (!EDGE || (row >= M && row < p + M)) return true;
    if (!ring) copy_entry(v, zero);
    return false;
  });
  if (!EDGE || e >= 2 * M) {
    PipeKey<E>::decode(out);
    store_entry(t, (int64_t)(e - 2 * M) * n + col, out);
  }
}

// Steps [e, end) of the compacting frontier's pass (rotated_steps).
template <typename E, int M, bool EDGE>
__device__ __forceinline__ void pipe_steps(int32_t (&h)[M][3][E::NF], int32_t (&next)[E::NF],
                                           unsigned (&cnt)[M], const int32_t (&zero)[E::NF],
                                           const Fields<E::NF>& t, int32_t* saved, int e,
                                           int end, int p, int64_t n, int64_t col, bool ring) {
  rotated_steps(e, end, [&](auto slot, int step) {
    pipe_step<E, M, decltype(slot)::value, EDGE>(h, next, cnt, zero, t, saved, step, p, n,
                                                 col, ring);
  });
}

// Where the blocks of a pipelined pass (frontier_pipe_kernel) take their
// stripes and leave their counts. The compacting frontier: block j takes
// stripe ids[j], none past the count, and writes its changed total and
// last changed round for frontier_compact_kernel.
struct StripeCounts {
  const int32_t* ids;
  int t_total;
  unsigned* stripe_changed;
  int32_t* stripe_last;

  __device__ __forceinline__ bool active() const { return (int)blockIdx.x < ids[t_total]; }
  __device__ __forceinline__ int64_t stripe() const { return ids[blockIdx.x]; }
  __device__ __forceinline__ void finish(unsigned total, int last) const {
    total = block_sum(total);
    last = block_max(last);
    if (threadIdx.x == 0) {
      stripe_changed[blockIdx.x] = total;
      stripe_last[blockIdx.x] = last;
    }
  }
};

// The whole table (packed_round.cu): block j takes stripe j, and its
// changed total lands in *count with one atomicAdd (mod 2^32, like the
// reference's int32 sum).
struct TotalCount {
  unsigned* count;

  __device__ __forceinline__ bool active() const { return true; }
  __device__ __forceinline__ int64_t stripe() const { return blockIdx.x; }
  __device__ __forceinline__ void finish(unsigned total, int) const {
    total = block_sum(total);
    if (threadIdx.x == 0 && total) atomicAdd(count, total);
  }
};

// M rounds in one pass per column. Step e reads input e (y_0[e]); stage k
// (1..M) holds round k - 1's outputs y_{k-1}[e - k - 1] and y_{k-1}[e - k]
// (its pre-round `up` and `cur`), receives y_{k-1}[e - k + 1] from stage
// k - 1 as `down`, and emits y_k[e - k] to stage k + 1. Stage M's output
// row e - M is real row e - 2 M, stored for e in [2 M, p + 2 M): each row is
// read once and written once, after stage M. On a ring, y_k[j] is exact
// for j in [k, p + 2 M - k) (the trapezoid), which holds the central copy
// j in [M, p + M) at every stage; rows outside it are garbage that never
// reaches it. On a chain the rows outside the central copy are the
// constant all-zero neighbours: stage 1 reads zeros there and every stage
// writes zeros there, which are still compared, as in sweep_column. Only
// the central copy counts: a thread's total sums gt(up) + gt(down) over
// rounds and rows (an entry can count twice, wrapping mod 2^32), and its
// last is the last round with a nonzero count, exactly as m classic sweeps
// count them; out (StripeCounts, TotalCount) picks each block's stripe of
// tile_n columns (columns past n take no part) and reduces the counts. The
// steps run unrolled by 3, the period of the history's rotation
// (pipe_stages), those in [2 M, p + M] without any row test. Dynamic shared
// memory: M x NF x blockDim.x int32 for the ring's saved rows, each
// thread's own, so that every block of a grid keeps its rows 0..M - 1 as
// they were before the pass.
template <typename E, int M, typename Out>
__global__ void __launch_bounds__(kMaxTile)
    frontier_pipe_kernel(Fields<E::NF> t, int p, int64_t n, int tile_n, int wrap, Out out) {
  constexpr int NF = E::NF;
  extern __shared__ int32_t saved[];
  if (!out.active()) return;  // uniform across the block
  const int64_t col = out.stripe() * tile_n + threadIdx.x;
  const bool ring = wrap != 0;
  unsigned total = 0;
  int last = 0;
  if (threadIdx.x < tile_n && col < n) {
    int32_t zero[NF];
    zero_entry(zero);
    PipeKey<E>::encode(zero);
    int32_t h[M][3][NF];
    unsigned cnt[M];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      cnt[k] = 0;
#pragma unroll
      for (int s = 0; s < 3; ++s) copy_entry(h[k][s], zero);
    }
    const int len = p + 2 * M;
    int32_t next[NF];
    pipe_input<E, M>(next, t, saved, 0, p, n, col, ring);
    const int head = min(2 * M, len), body = max(head, p + M + 1);
    pipe_steps<E, M, true>(h, next, cnt, zero, t, saved, 0, head, p, n, col, ring);
    pipe_steps<E, M, false>(h, next, cnt, zero, t, saved, head, body, p, n, col, ring);
    pipe_steps<E, M, true>(h, next, cnt, zero, t, saved, body, len, p, n, col, ring);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      total += cnt[k];
      if (cnt[k]) last = k + 1;
    }
  }
  out.finish(total, last);
}

// One launch of the pipelined pass of kPipeDepth rounds: `blocks` blocks
// of tile_n threads, out as in frontier_pipe_kernel.
template <typename E, typename Out>
cudaError_t launch_pipe(void* const* fields, int p, long long n, int tile_n, long long blocks,
                        int wrap, Out out, cudaStream_t s) {
  auto* kernel = frontier_pipe_kernel<E, kPipeDepth, Out>;
  const int smem = kPipeDepth * E::NF * tile_n * (int)sizeof(int32_t);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, tile_n, smem, s>>>(fields_of<E::NF>(fields), p, n, tile_n, wrap,
                                                out);
  return cudaGetLastError();
}

// Exclusive prefix sum of a 0/1 flag over the block; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int flag, int* total) {
  __shared__ int warp_part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = flag;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  __syncthreads();
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    int w = (lane < warps) ? warp_part[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    warp_part[lane] = w;  // inclusive prefix over warps
  }
  __syncthreads();
  const int before = (warp > 0) ? warp_part[warp - 1] : 0;
  *total = warp_part[(blockDim.x >> 5) - 1];
  return before + incl - flag;
}

// What ordered_compact needs of item j: its id, its changed count and the
// last round (1..m, 0 for none) that changed it.
struct StripeFold {
  int id;
  unsigned changed;
  int last;
};

// Ordered compaction by one block: walks the items j < count in chunks of
// blockDim.x, folds each (fold(j) -> StripeFold), and appends the id of
// every item whose last changed round is m to ids_out in ascending j with
// an exclusive block scan of the keep flags. Then writes the kept count
// at [t_total], the changed total at [t_total + 1] (wrapping mod 2^32
// like an int32 sum) and, for m > 1, the max last round at [t_total + 2].
// count is uniform across the block, so every thread reaches each scan.
template <typename Fold>
__device__ __forceinline__ void ordered_compact(int count, int t_total, int m,
                                                int32_t* ids_out, Fold fold) {
  int next = 0;
  unsigned changed = 0;
  int max_last = 0;
  for (int start = 0; start < count; start += blockDim.x) {
    const int j = start + threadIdx.x;
    int flag = 0;
    int id = 0;
    if (j < count) {
      const StripeFold f = fold(j);
      id = f.id;
      flag = (f.last == m) ? 1 : 0;
      changed += f.changed;
      max_last = max(max_last, f.last);
    }
    int chunk_total;
    const int pos = block_exclusive_scan(flag, &chunk_total);
    if (flag) ids_out[next + pos] = id;
    next += chunk_total;
  }
  changed = block_sum(changed);
  max_last = block_max(max_last);
  if (threadIdx.x == 0) {
    ids_out[t_total] = next;
    ids_out[t_total + 1] = (int32_t)changed;
    if (m > 1) ids_out[t_total + 2] = max_last;
  }
}

// One shard's extended column (frontier_shard.cu):
// s rows of top, b rows of mid, s rows of bot, every segment row-major with
// row stride n.
template <int NF>
struct ExtColumn {
  Fields<NF> top, mid, bot;
  int s, b;
  int64_t n, col;

  // r is uniform across a warp, so the segment branches never diverge
  __device__ __forceinline__ void load(int32_t (&v)[NF], int r) const {
    if (r < s) {
      load_entry(v, top, (int64_t)r * n + col);
    } else if (r < s + b) {
      load_entry(v, mid, (int64_t)(r - s) * n + col);
    } else {
      load_entry(v, bot, (int64_t)(r - s - b) * n + col);
    }
  }
  __device__ __forceinline__ void store(int r, const int32_t (&v)[NF]) const {
    if (r < s) {
      store_entry(top, (int64_t)r * n + col, v);
    } else if (r < s + b) {
      store_entry(mid, (int64_t)(r - s) * n + col, v);
    } else {
      store_entry(bot, (int64_t)(r - s - b) * n + col, v);
    }
  }
};

// One round on the extended column as a ring, in place (the pre-round rows
// r - 1 and r and the original row 0 stay in registers, as in
// sweep_column). After round k the rows [k, 2 s + b - k) are exact (the
// trapezoid of the reference's time tiling), so m <= s rounds leave the
// shard's rows exact; garbage from the internal wrap never reaches them.
// The boundary rows are stored only with store_halo (a round that a later
// round of the same call reads back). Calls on_row(r, wins) for every row
// r, wins being how many of its two neighbours beat it in turn (0, 1 or 2;
// nonzero iff the row changed).
template <typename E, typename OnRow>
__device__ __forceinline__ void sweep_ext(const ExtColumn<E::NF>& c, bool store_halo,
                                          OnRow on_row) {
  constexpr int NF = E::NF;
  const int len = 2 * c.s + c.b;
  int32_t row0[NF], up[NF], cur[NF], down[NF];
  c.load(row0, 0);
  c.load(up, len - 1);
  copy_entry(cur, row0);
  for (int r = 0; r < len; ++r) {
    if (r + 1 < len) {
      c.load(down, r + 1);
    } else {
      copy_entry(down, row0);
    }
    int32_t m[NF];
    unsigned wins = 0;
    copy_entry(m, cur);
    if (E::gt(up, m)) {
      copy_entry(m, up);
      ++wins;
    }
    if (E::gt(down, m)) {
      copy_entry(m, down);
      ++wins;
    }
    if (store_halo || (r >= c.s && r < c.s + c.b)) c.store(r, m);
    on_row(r, wins);
    copy_entry(up, cur);
    copy_entry(cur, down);
  }
}

// internal linkage: every source that includes this header gets its own
namespace {

__global__ void frontier_compact_kernel(const int32_t* ids, int32_t* ids_out,
                                        const unsigned* stripe_changed,
                                        const int32_t* stripe_last,
                                        int t_total, int m) {
  ordered_compact(ids[t_total], t_total, m, ids_out, [&](int j) {
    return StripeFold{ids[j], stripe_changed[j], stripe_last[j]};
  });
}

}  // namespace

// fields: host array of E::NF device pointers to [p, n] int32 (updated in
// place). ids: [t_total + 2] (m = 1) or [t_total + 3] (m > 1) int32 on the
// device; ids_out: a separate array of the same length. stripe_changed and
// stripe_last: [t_total] int32 scratch. tile_n divides n; tile_n is a
// multiple of 32 and at most kMaxTile.
template <typename E>
cudaError_t launch_frontier_round(void* const* fields, const void* ids, void* ids_out,
                                  void* stripe_changed, void* stripe_last, int p,
                                  long long n, int tile_n, int t_total, int m,
                                  int wrap, cudaStream_t s) {
  if (tile_n < 32 || tile_n > kMaxTile || tile_n % 32 || m < 1) {
    return cudaErrorInvalidValue;
  }
  auto* in = static_cast<const int32_t*>(ids);
  auto* sc = static_cast<unsigned*>(stripe_changed);
  auto* sl = static_cast<int32_t*>(stripe_last);
  if (t_total > 0 && m == kPipeDepth) {
    const cudaError_t err =
        launch_pipe<E>(fields, p, n, tile_n, t_total, wrap, StripeCounts{in, t_total, sc, sl}, s);
    if (err != cudaSuccess) return err;
  } else if (t_total > 0) {
    frontier_round_kernel<E><<<t_total, tile_n, 0, s>>>(
        fields_of<E::NF>(fields), in, p, n, tile_n, t_total, m, wrap, sc, sl);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  frontier_compact_kernel<<<1, 1024, 0, s>>>(
      in, static_cast<int32_t*>(ids_out), sc, sl, t_total, m);
  return cudaGetLastError();
}

}  // namespace bt
