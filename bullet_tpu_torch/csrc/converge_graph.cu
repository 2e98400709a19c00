// One launch that runs the reference's gossip rounds on the dirty columns
// of a packed-family table (packed (khi, klo, cv), rank (rank, cv) or rank1
// (rank)) over ANY neighbour matrix, in place, until a round changes
// nothing in a column or the cap: the table, the rounds and every round's
// changed count of the whole-table loop (ops/packed.py
// gossip_until_converged_packed over gossip_round_generic_packed).
//
// Replaces no TPU kernel: where the reference runs D whole-table gathers
// and merges a round (the neighbour matrix's D slots in turn), this keeps
// whole columns in shared memory and runs the same rounds there. A round
// takes slot k = 0 .. D-1 in turn; in slot k every row p with a slot-k
// neighbour merges that neighbour's value as slot k-1 left it (Jacobi within
// a slot), and the round's count is the sum of wins over its slots. Columns
// are independent, so each column runs its own rounds: once a round leaves
// a column as it was, every later round does too, and the whole-table loop
// ends at the first round no column changes in.
//
// The neighbour list (ops/packed.py GraphPlan, uploaded once a sim):
// positions are rows sorted by their extent (last slot + 1, stable), so
// slot k's active rows are a prefix of the positions; each position's
// neighbours are a row of a CSR in slot order, as positions, -1 where the
// matrix has a hole; a schedule groups the slots. A group of one slot runs
// Jacobi (every new value computed before any is stored); a run of slots
// whose written rows (a prefix) none of them reads is one group, each row
// merging its run in order, as the slots would one after the other. A group
// whose runs are long takes a warp a row: each lane folds a chunk of the
// run, a warp scan of the chunks' lexmax gives each lane the value before
// its chunk, and each lane counts its wins from there, so the row's wins
// are those of the sequential merges. Missing neighbours (the reference
// merges an all-zero entry there) are skipped: no entry a sim stores lies
// below the all-zero entry, so that merge never wins.
//
// Design: one block per 8-column group holding a dirty column (32 bytes a
// row a field: one sector). The group's rows are loaded into shared memory
// column-major (a column's P rows contiguous, the column stride P rounded
// to 32 plus 4 so that the load's and store's 16-byte quarters and the
// rounds' random reads spread over the banks), the dirty columns of the
// group run their rounds one after the other, and the rows that changed
// are stored back whole; the table's loads and stores skip the L1. At P =
// 1,024 packed a block takes 98 KB, so two blocks share an SM. The rounds
// are latency-bound: a slot group is a few shared-memory reads between two
// barriers. So each thread reads its positions' CSR offsets once a block,
// the schedule sits in shared memory, and a warp row keeps its chunk's
// neighbours in registers between its two passes and skips the second
// where its chunk holds no win. On the card (1024 x 2^20 packed, a scatter
// batch's 49,300 dirty columns on the 1,024-peer bridge: 4 rounds, 9 slot
// groups a round) a block spends most of its time in the thread groups'
// phases; one block of 1,024 threads an SM, with the first 8 slots'
// neighbours in registers, took 12% longer than two of 512.
#include "lexmax.cuh"

namespace {

constexpr int kCols = 8;                       // columns a block owns
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 3072;                 // the most positions a block takes
constexpr int kFewRows = 1024;                 // up to here, two positions a thread
constexpr int kSchedCache = 64;                // schedule entries kept in shared memory
constexpr int kRunCache = 8;                   // a lane's chunk held in registers

// words between two columns of a group in shared memory
__host__ __device__ inline int col_stride(int p) { return (p + 31) / 32 * 32 + 4; }

// Shared memory of a block: the group's columns [NF][8][stride] and a byte
// a row (the row changed).
inline long long smem_bytes(int p, int nf) {
  return 4LL * kCols * nf * col_stride(p) + p;
}

// A schedule entry: slots [k0, k1), the positions active at k0 (a prefix),
// and whether a warp takes each row (else a thread, Jacobi).
struct Group {
  int k0, k1, active, warp;
};

template <typename E>
__device__ __forceinline__ void read_entry(int32_t (&v)[E::NF], const int32_t* col, int stride,
                                           int i) {
#pragma unroll
  for (int f = 0; f < E::NF; ++f) v[f] = col[(int64_t)f * kCols * stride + i];
}

template <typename E>
__device__ __forceinline__ void write_entry(int32_t* col, int stride, int i,
                                            const int32_t (&v)[E::NF]) {
#pragma unroll
  for (int f = 0; f < E::NF; ++f) col[(int64_t)f * kCols * stride + i] = v[f];
}

template <int N>
__device__ __forceinline__ void shfl_entry(int32_t (&dst)[N], const int32_t (&src)[N],
                                           int lane) {
#pragma unroll
  for (int f = 0; f < N; ++f) dst[f] = __shfl_sync(0xffffffffu, src[f], lane);
}

// Sums of a and b over the block, in every thread. Every thread calls it.
__device__ __forceinline__ int2 block_total(int a, int b, int2* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) part[warp] = make_int2(a, b);
  __syncthreads();
  int2 t = lane < kWarps ? part[lane] : make_int2(0, 0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t.x += __shfl_xor_sync(0xffffffffu, t.x, off);
    t.y += __shfl_xor_sync(0xffffffffu, t.y, off);
  }
  __syncthreads();  // part is written again by the next call
  return t;
}

// How many of the thread's R positions hold an entry other than position
// 0's.
template <typename E, int R>
__device__ __forceinline__ int differing(const int32_t* col, int stride, int p) {
  int32_t first[E::NF], v[E::NF];
  read_entry<E>(first, col, stride, 0);
  int n = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < p) {
      read_entry<E>(v, col, stride, i);
      n += !E::eq(v, first);
    }
  }
  return n;
}

// A thread's R positions (threadIdx.x + j * kThreads): each one's CSR
// offset and extent, read once a block.
template <int R>
struct Rows {
  int base[R], ext[R];

  __device__ __forceinline__ void load(const int32_t* __restrict__ row_off, int p) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = threadIdx.x + j * kThreads;
      base[j] = i < p ? __ldg(row_off + i) : 0;
      ext[j] = i < p ? __ldg(row_off + i + 1) - base[j] : 0;
    }
  }
};

// A group of slots, one thread a position (R a thread): every new value is
// computed from the column as the previous group left it, then stored.
// Returns the thread's wins.
template <typename E, int R>
__device__ __forceinline__ int thread_group(int32_t* col, int stride, const Group& g,
                                            const Rows<R>& rows,
                                            const int16_t* __restrict__ nbr,
                                            uint8_t* changed) {
  constexpr int NF = E::NF;
  int32_t nv[R][NF];
  bool won[R];
  int wins = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = threadIdx.x + j * kThreads;
    won[j] = false;
    if (i < g.active) {
      read_entry<E>(nv[j], col, stride, i);
      const int end = min(rows.ext[j], g.k1);
      for (int k = g.k0; k < end; ++k) {
        const int q = __ldg(nbr + rows.base[j] + k);
        if (q < 0) continue;
        int32_t w[NF];
        read_entry<E>(w, col, stride, q);
        if (E::gt(w, nv[j])) {
          bt::copy_entry(nv[j], w);
          won[j] = true;
          ++wins;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (won[j]) {
      write_entry<E>(col, stride, i, nv[j]);
      changed[i] = 1;
    }
  }
  __syncthreads();
  return wins;
}

// A group of slots whose written rows none of them reads, one warp a
// position: the lanes split the row's run into chunks (see the head of the
// file). Returns the lane's wins.
template <typename E>
__device__ __forceinline__ int warp_group(int32_t* col, int stride, const Group& g,
                                          const int32_t* __restrict__ row_off,
                                          const int16_t* __restrict__ nbr, uint8_t* changed) {
  constexpr int NF = E::NF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int wins = 0;
  for (int i = warp; i < g.active; i += kWarps) {
    const int base = __ldg(row_off + i);
    const int beg = base + g.k0;
    const int len = min(__ldg(row_off + i + 1), base + g.k1) - beg;
    const int per = (len + 31) / 32;
    const int lo = beg + min(len, lane * per), hi = beg + min(len, lane * per + per);
    const bool cached = per <= kRunCache;
    int qs[kRunCache];
#pragma unroll
    for (int t = 0; t < kRunCache; ++t) qs[t] = cached && lo + t < hi ? __ldg(nbr + lo + t) : -1;
    int32_t cur[NF], m[NF], w[NF];
    read_entry<E>(cur, col, stride, i);
    bt::copy_entry(m, cur);
    if (cached) {
#pragma unroll
      for (int t = 0; t < kRunCache; ++t) {
        if (qs[t] < 0) continue;
        read_entry<E>(w, col, stride, qs[t]);
        if (E::gt(w, m)) bt::copy_entry(m, w);
      }
    } else {
      for (int e = lo; e < hi; ++e) {
        const int q = __ldg(nbr + e);
        if (q < 0) continue;
        read_entry<E>(w, col, stride, q);
        if (E::gt(w, m)) bt::copy_entry(m, w);
      }
    }
    // inclusive scan of the chunks' lexmax over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int32_t o[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) o[f] = __shfl_up_sync(0xffffffffu, m[f], off);
      if (lane >= off && E::gt(o, m)) bt::copy_entry(m, o);
    }
    int32_t run[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) run[f] = __shfl_up_sync(0xffffffffu, m[f], 1);
    if (lane == 0) bt::copy_entry(run, cur);
    // a chunk wins something iff its largest entry beats the value before
    // it, that is iff the scan through it (m) does
    if (E::gt(m, run)) {
      if (cached) {
#pragma unroll
        for (int t = 0; t < kRunCache; ++t) {
          if (qs[t] < 0) continue;
          read_entry<E>(w, col, stride, qs[t]);
          if (E::gt(w, run)) {
            bt::copy_entry(run, w);
            ++wins;
          }
        }
      } else {
        for (int e = lo; e < hi; ++e) {
          const int q = __ldg(nbr + e);
          if (q < 0) continue;
          read_entry<E>(w, col, stride, q);
          if (E::gt(w, run)) {
            bt::copy_entry(run, w);
            ++wins;
          }
        }
      }
    }
    int32_t fin[NF];
    shfl_entry(fin, m, 31);
    if (lane == 0 && E::gt(fin, cur)) {
      write_entry<E>(col, stride, i, fin);
      changed[i] = 1;
    }
  }
  __syncthreads();
  return wins;
}

template <typename E, int R>
__device__ __forceinline__ void converge_graph(bt::Fields<E::NF> t,
                                               const int32_t* __restrict__ work, int n_work,
                                               const int32_t* __restrict__ plan,
                                               const int16_t* __restrict__ nbr, int n_sched,
                                               int32_t* out, int n_counts, int p, int64_t n,
                                               int cap) {
  constexpr int NF = E::NF;
  extern __shared__ __align__(16) int32_t tile[];
  __shared__ int2 part[kWarps];
  __shared__ Group cached_sched[kSchedCache];
  const int stride = col_stride(p);
  uint8_t* changed = reinterpret_cast<uint8_t*>(tile + (int64_t)NF * kCols * stride);
  const Group* sched = reinterpret_cast<const Group*>(plan);
  const int32_t* order = plan + 4 * n_sched;
  const int32_t* row_off = order + p;
  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)work[blockIdx.x] * kCols;
  const unsigned dirty = (unsigned)work[n_work + blockIdx.x];
  auto at = [&](int f, int c, int i) -> int32_t& {
    return tile[((int64_t)f * kCols + c) * stride + i];
  };

  // 1. the group's rows, in position order: thread (position, quarter)
  for (int x = tid; x < 2 * p; x += kThreads) {
    const int i = x >> 1, h = x & 1;
    const int64_t src = (int64_t)__ldcg(order + i) * n + c0 + 4 * h;
    int4 v[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) v[f] = __ldcg(reinterpret_cast<const int4*>(t.f[f] + src));
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      at(f, 4 * h, i) = v[f].x;
      at(f, 4 * h + 1, i) = v[f].y;
      at(f, 4 * h + 2, i) = v[f].z;
      at(f, 4 * h + 3, i) = v[f].w;
    }
  }
  for (int i = tid; i < p; i += kThreads) changed[i] = 0;
  if (n_sched <= kSchedCache) {
    for (int s = tid; s < n_sched; s += kThreads) cached_sched[s] = sched[s];
    sched = cached_sched;
  }
  Rows<R> rows;
  rows.load(row_off, p);
  __syncthreads();

  // 2. each dirty column's rounds until one changes nothing, or the cap. A
  // column whose rows all hold one entry is at its fixed point (every merge
  // compares equal entries): the round that would find that is not run
  int depth = 0;
  for (int c = 0; c < kCols; ++c) {
    if (!((dirty >> c) & 1u)) continue;
    int32_t* col = &at(0, c, 0);
    if (block_total(0, differing<E, R>(col, stride, p), part).y == 0) continue;
    for (int r = 1; r <= cap; ++r) {
      int wins = 0;
      for (int s = 0; s < n_sched; ++s) {
        const Group g = sched[s];
        wins += g.warp ? warp_group<E>(col, stride, g, row_off, nbr, changed)
                       : thread_group<E, R>(col, stride, g, rows, nbr, changed);
      }
      const int2 total = block_total(wins, differing<E, R>(col, stride, p), part);
      if (total.x == 0) break;
      depth = max(depth, r);
      if (tid == 0 && r <= n_counts) atomicAdd(out + r, total.x);
      if (total.y == 0) break;
    }
  }
  if (tid == 0 && depth > 0) atomicMax(out, depth);

  // 3. the rows that changed, whole
  for (int x = tid; x < 2 * p; x += kThreads) {
    const int i = x >> 1, h = x & 1;
    if (!changed[i]) continue;
    const int64_t dst = (int64_t)__ldcg(order + i) * n + c0 + 4 * h;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      __stcg(reinterpret_cast<int4*>(t.f[f] + dst),
             make_int4(at(f, 4 * h, i), at(f, 4 * h + 1, i), at(f, 4 * h + 2, i),
                       at(f, 4 * h + 3, i)));
    }
  }
}

}  // namespace

// The kernels by field count, for P up to kFewRows rows (two positions a
// thread) or beyond (six), named without a namespace or template so that a
// device trace finds them by the prefix "bt_converge_graph".
#define BT_CONVERGE_GRAPH(NAME, ENTRY, R)                                                   \
  extern "C" __global__ void __launch_bounds__(kThreads, 2)                                \
      NAME(bt::Fields<ENTRY::NF> t, const int32_t* work, int n_work, const int32_t* plan,  \
           const int16_t* nbr, int n_sched, int32_t* out, int n_counts, int p, int64_t n,  \
           int cap) {                                                                      \
    converge_graph<ENTRY, R>(t, work, n_work, plan, nbr, n_sched, out, n_counts, p, n,    \
                             cap);                                                         \
  }
BT_CONVERGE_GRAPH(bt_converge_graph_packed, bt::PackedEntry, kFewRows / kThreads)
BT_CONVERGE_GRAPH(bt_converge_graph_rank, bt::RankEntry, kFewRows / kThreads)
BT_CONVERGE_GRAPH(bt_converge_graph_rank1, bt::Rank1Entry, kFewRows / kThreads)
BT_CONVERGE_GRAPH(bt_converge_graph_packed_tall, bt::PackedEntry, kMaxRows / kThreads)
BT_CONVERGE_GRAPH(bt_converge_graph_rank_tall, bt::RankEntry, kMaxRows / kThreads)
BT_CONVERGE_GRAPH(bt_converge_graph_rank1_tall, bt::Rank1Entry, kMaxRows / kThreads)
#undef BT_CONVERGE_GRAPH

namespace {

// the kernel of an entry type, for P up to kFewRows rows or beyond
template <typename E>
constexpr auto kernel_of(bool tall) {
  if constexpr (E::NF == 3) {
    return tall ? bt_converge_graph_packed_tall : bt_converge_graph_packed;
  } else if constexpr (E::NF == 2) {
    return tall ? bt_converge_graph_rank_tall : bt_converge_graph_rank;
  } else {
    return tall ? bt_converge_graph_rank1_tall : bt_converge_graph_rank1;
  }
}

template <typename E>
struct Launch {
  static cudaError_t run(void* const* fields, const void* work, int n_work, const void* plan,
                         const void* nbr, int n_sched, void* out, int n_counts, int p,
                         long long n, int cap, cudaStream_t s) {
    if (n % kCols != 0 || p < 1 || p > kMaxRows || cap < 1) return cudaErrorInvalidValue;
    if (n_work <= 0) return cudaSuccess;
    const long long bytes = smem_bytes(p, E::NF);
    const auto kernel = kernel_of<E>(p > kFewRows);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)n_work, kThreads, (size_t)bytes, s>>>(
        bt::fields_of<E::NF>(fields), static_cast<const int32_t*>(work), n_work,
        static_cast<const int32_t*>(plan), static_cast<const int16_t*>(nbr), n_sched,
        static_cast<int32_t*>(out), n_counts, p, n, cap);
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to [p, n] int32 (updated in
// place), n a multiple of 8, each 16-byte aligned. work: device int32
// [2 * n_work]: ids of 8-column groups (columns 8g .. 8g + 7), each at most
// once, then each group's dirty columns as a bit mask. plan: device int32,
// the schedule [n_sched][4] (k0, k1, active positions, warp), then each
// position's row [p], then the CSR offsets by position [p + 1]; nbr: device
// int16, the CSR's neighbours as positions (-1: a hole). out: device int32
// [1 + n_counts], zeroed by the caller: out[0] ends as the largest last
// round that changed a column, out[r] as round r's count. cap: the most
// rounds a column runs (>= 1). nf: 3 = packed, 2 = rank, 1 = rank1.
extern "C" cudaError_t bt_converge_graph(void* const* fields, const void* work, int n_work,
                                         const void* plan, const void* nbr, int n_sched,
                                         void* out, int n_counts, int p, long long n, int cap,
                                         int nf, void* stream) {
  return bt::dispatch_nf<Launch>(nf, fields, work, n_work, plan, nbr, n_sched, out, n_counts,
                                 p, n, cap, static_cast<cudaStream_t>(stream));
}

