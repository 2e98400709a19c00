// m ring or chain gossip rounds over a packed-family table (packed
// (khi, klo, cv), rank (rank, cv) or rank1 (rank)) as one window join, in
// place: every row becomes the lexmax of its radius-(m-1) window along the
// peer axis, then one classic round runs on that result. The count is that
// last round's winner-select count sum(gt1) + sum(gt2), as
// bt::sweep_column counts it, summed mod 2^32: the classic round-m
// residual, not an m-round total.
//
// Replaces: bullet_tpu/ops/packed.py::_fullp_window_kernel_packed (#12, the
// join on a whole column) and ::_halo_window_kernel_packed (#17, the join
// on an extended tile [m-row top slab | center rows | m-row bottom slab]
// that counts over its center rows only). One kernel takes both forms:
//   bt_window_packed        a whole column, wrapped (ring) or clipped to
//                           rows 0 and P-1 (chain);
//   bt_window_shard_packed  a shard's b center rows between its
//                           neighbours' slabs (the spmd fast_forward on a
//                           device mesh): rows past the extended column's
//                           ends are the all-zero entry, as in the
//                           reference's _window_block_packed; only the
//                           center rows are written and counted. A side
//                           without a slab may instead be a chain's edge
//                           (clip): the row tiles of a tall chain.
// Which shapes take which form: a column of L extended rows fits when two
// planes of it (2 x 4 nf L bytes) fit one block's shared memory, L up to
// bt_window_rows(nf) (9642 rows packed, 14464 rank, 28928 rank1 on an
// H100). The wrappers (ops/packed.py) run a taller table or shard as row
// tiles of the extended form, each with m-row slabs copied from the
// pre-call rows before the first launch, and cap a tiled pass's depth at
// rows / 4 rounds.
//
// Why a window: the merge is an idempotent lattice join and equal keys
// mean equal entries in every packed-family layout, so m Jacobi rounds
// equal the radius-m window join, and any way of computing that join gives
// the same bits. The radius grows by the reference's greedy schedule
// (_window_chain): from radius r a 3-way join with the rows r' = p - s and
// p + s (s <= 2r + 1) covers radius r + s, so radius m - 1 takes
// O(log m) steps (5 at m = 120, 7 at m = 480, 513 and 1024). A chain
// clamps the shifted rows to its edge rows, whose accumulated windows are
// the edge-clipped ones (zero-filling would lose coverage). The final step
// is the classic round, so its count is bit-identical to the classic
// loop's round-m residual.
//
// Bound on the H100: device memory. The floor is one read and one write of
// the table (2 x 4 nf bytes an entry; the shard form also reads its 2 m
// slab rows). Design: a block owns C columns (16 or 8, two blocks an SM
// where they fit, else one; 4, 2 or 1 for tall columns) and loads all L rows of them
// once into shared memory with cp.async, as [field][row][C] planes. A
// thread takes 4 adjacent columns of a row at a time when C >= 4 (16-byte
// shared-memory accesses, and 16-byte device-memory ones when n % 4 == 0),
// which spreads the index arithmetic of a join over 4 entries; a warp's
// accesses are contiguous either way. Where a thread has at most 4 units
// (V columns of a row; every whole column of the main paths), their values
// stay in registers between joins, so a join reads only the rows s up and
// s down, unless the registers would cost the SM a block (the spmd
// shards). The joins ping-pong between two
// planes on chip; packed keys are held in frontier.cuh's PipeKey encoding
// (a 3-word subtract with borrow a compare). The final round reads the
// last plane and writes each center row to device memory once, counting
// in registers, one block sum and one atomicAdd a block. Blocks own
// disjoint columns and read all their rows before writing any, so the call
// is in place and needs no scratch table.
#include <cuda_pipeline.h>

#include "frontier.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kLogMaxCols = 4;     // at most 16 columns a block
constexpr int kReserved = 1024;    // a block's static shared memory (block_sum)
constexpr int kSystem = 1024;      // the shared memory the system keeps per block
constexpr int kWrap = 1, kClipTop = 2, kClipBottom = 4;
constexpr int kHeld = 4;           // units a thread may hold in registers

// V adjacent columns of one row of a plane (V = 4: one 16-byte access a
// field), or one entry (V = 1)
template <int NF, int V>
struct Quad {
  int32_t v[NF][V];
};

template <int NF, int V>
__device__ __forceinline__ void quad_load(Quad<NF, V>& q, const int32_t* plane, int field,
                                          int idx) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (V == 4) {
      const int4 w = *reinterpret_cast<const int4*>(plane + f * field + idx);
      q.v[f][0] = w.x;
      q.v[f][V > 1 ? 1 : 0] = w.y;
      q.v[f][V > 2 ? 2 : 0] = w.z;
      q.v[f][V > 3 ? 3 : 0] = w.w;
    } else {
      q.v[f][0] = plane[f * field + idx];
    }
  }
}

template <int NF, int V>
__device__ __forceinline__ void quad_store(int32_t* plane, int field, int idx,
                                           const Quad<NF, V>& q) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (V == 4) {
      *reinterpret_cast<int4*>(plane + f * field + idx) =
          make_int4(q.v[f][0], q.v[f][V > 1 ? 1 : 0], q.v[f][V > 2 ? 2 : 0],
                    q.v[f][V > 3 ? 3 : 0]);
    } else {
      plane[f * field + idx] = q.v[f][0];
    }
  }
}

// the plane index of unit u: row u >> log_units, its first column
// (u mod 2^log_units) V, with V = 2^(log_cols - log_units)
__device__ __forceinline__ int unit_index(int u, int log_units, int log_cols) {
  return ((u >> log_units) << log_cols) + ((u & ((1 << log_units) - 1)) << (log_cols - log_units));
}

template <int NF, int V>
__device__ __forceinline__ void quad_fill(Quad<NF, V>& q, const int32_t (&e)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int j = 0; j < V; ++j) q.v[f][j] = e[f];
  }
}

template <typename E, int V>
__device__ __forceinline__ void entry_of(int32_t (&e)[E::NF], const Quad<E::NF, V>& q, int j) {
#pragma unroll
  for (int f = 0; f < E::NF; ++f) e[f] = q.v[f][j];
}

// best <- the join of best and cand, column by column; returns the wins
// of the columns whose bit is set in `live`
template <typename E, int V>
__device__ __forceinline__ unsigned quad_join(Quad<E::NF, V>& best, const Quad<E::NF, V>& cand,
                                              unsigned live = 0) {
  constexpr int NF = E::NF;
  unsigned wins = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    int32_t b[NF], c[NF];
    entry_of<E, V>(b, best, j);
    entry_of<E, V>(c, cand, j);
    const bool gt = bt::PipeKey<E>::gt(c, b);
    wins += gt && ((live >> j) & 1u);
#pragma unroll
    for (int f = 0; f < NF; ++f) best.v[f][j] = gt ? c[f] : b[f];
  }
  return wins;
}

// The join over an extended column of len = ht + h + hb rows: rows [0, ht)
// from `top`, [ht, ht + h) from `mid` (written back), [ht + h, len) from
// `bot`. flags: kWrap (ht = hb = 0: shifts wrap mod len), kClipTop /
// kClipBottom (that side has no slab: a shift past it takes the edge row,
// the final round's missing neighbour the all-zero entry), else a shift
// past an end takes the all-zero entry. A thread takes V adjacent columns
// of a row at a time (V = 4 when the block is at least 4 wide, so each
// shared-memory access moves 16 bytes a field; `vec_io`: n % 4 == 0, so
// device memory moves 16 bytes too). U > 0: the block has at most U units
// (V columns of a row) a thread, whose values stay in registers between
// joins.
template <typename E, int V, int U>
__global__ void __launch_bounds__(kThreads, 1)
    window_kernel(bt::Fields<E::NF> mid, bt::Fields<E::NF> top, bt::Fields<E::NF> bot,
                  int ht, int h, int hb, int64_t n, int radius, int flags, int log_cols,
                  int vec_io, unsigned* count) {
  constexpr int NF = E::NF;
  using K = bt::PipeKey<E>;
  extern __shared__ int4 smem4[];
  int32_t* const smem = reinterpret_cast<int32_t*>(smem4);
  const int cols = 1 << log_cols;
  const int log_units = log_cols - (V == 4 ? 2 : 0);  // units of V columns a row
  const int len = ht + h + hb;
  const int field = len * cols;  // words of one field's plane
  const int units = len << log_units;
  int32_t* const buf[2] = {smem, smem + NF * field};
  const int64_t col0 = (int64_t)blockIdx.x * cols;
  const bool wrap = flags & kWrap;
  const bool clip_top = flags & kClipTop, clip_bottom = flags & kClipBottom;

  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int x = u >> log_units;
    const int c = (u & ((1 << log_units) - 1)) * V;
    const int64_t col = col0 + c;
    const int seg = x < ht ? 0 : (x < ht + h ? 1 : 2);
    const int64_t idx = (int64_t)(seg == 0 ? x : (seg == 1 ? x - ht : x - ht - h)) * n + col;
    int32_t* dst = buf[0] + (x << log_cols) + c;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int32_t* src = (seg == 0 ? top.f[f] : (seg == 1 ? mid.f[f] : bot.f[f])) + idx;
      if (V == 4 && vec_io && col + V <= n) {
        __pipeline_memcpy_async(dst + f * field, src, 4 * sizeof(int32_t));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (col + j < n) {
            __pipeline_memcpy_async(dst + f * field + j, src + j, sizeof(int32_t));
          } else {
            dst[f * field + j] = 0;
          }
        }
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  int32_t zero_entry[NF];
  bt::zero_entry(zero_entry);
  K::encode(zero_entry);
  Quad<NF, V> zero;
  quad_fill(zero, zero_entry);
  if (NF == 3) {  // the packed keys into PipeKey words, each by its loader
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const int i = unit_index(u, log_units, log_cols);
      Quad<NF, V> q;
      quad_load(q, buf[0], field, i);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        int32_t e[NF];
        entry_of<E, V>(e, q, j);
        K::encode(e);
#pragma unroll
        for (int f = 0; f < NF; ++f) q.v[f][j] = e[f];
      }
      quad_store(buf[0], field, i, q);
    }
    __syncthreads();
  }

  // the thread's units u = threadIdx.x + k kThreads; with U > 0 their
  // current values stay in registers (own[k]), so a join reads only the
  // rows s up and s down from shared memory
  Quad<NF, V> own[U > 0 ? U : 1];
  if (U > 0) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = threadIdx.x + k * kThreads;
      if (u < units) quad_load(own[k], buf[0], field, unit_index(u, log_units, log_cols));
    }
  }
  int cur = 0;
  for (int r = 0; r < radius;) {  // the reference's _window_chain
    const int s = min(radius - r, 2 * r + 1);
    const int ring_s = s % len;
    const int32_t* src = buf[cur];
    int32_t* dst = buf[cur ^ 1];
    auto step = [&](Quad<NF, V>& best, int u) {
      const int x = u >> log_units;
      const int c = (u & ((1 << log_units) - 1)) * V;
      int up, down;
      if (wrap) {
        up = x - ring_s;
        up += up < 0 ? len : 0;
        down = x + ring_s;
        down -= down >= len ? len : 0;
      } else {
        up = x - s;
        down = x + s;
        if (clip_top) up = max(up, 0);
        if (clip_bottom) down = min(down, len - 1);
      }
      Quad<NF, V> cand;
      if (up >= 0) {
        quad_load(cand, src, field, (up << log_cols) + c);
      } else {
        cand = zero;
      }
      quad_join<E, V>(best, cand);
      if (down < len) {
        quad_load(cand, src, field, (down << log_cols) + c);
      } else {
        cand = zero;
      }
      quad_join<E, V>(best, cand);
      quad_store(dst, field, (x << log_cols) + c, best);
    };
    if (U > 0) {
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int u = threadIdx.x + k * kThreads;
        if (u < units) step(own[k], u);
      }
    } else {
      for (int u = threadIdx.x; u < units; u += kThreads) {
        Quad<NF, V> best;
        quad_load(best, src, field, unit_index(u, log_units, log_cols));
        step(best, u);
      }
    }
    __syncthreads();
    cur ^= 1;
    r += s;
  }

  // the classic last round on the center rows, each written once
  const int32_t* v = buf[cur];
  unsigned changed = 0;
  auto last = [&](Quad<NF, V>& out, int u) {
    const int x = u >> log_units;
    const int c = (u & ((1 << log_units) - 1)) * V;
    const int64_t col = col0 + c;
    if (col >= n) return;
    int up = x - 1, down = x + 1;
    if (wrap) {
      if (up < 0) up = len - 1;
      if (down == len) down = 0;
    }
    Quad<NF, V> cand;
    if (up >= 0) {
      quad_load(cand, v, field, (up << log_cols) + c);
    } else {
      cand = zero;
    }
    // count each column's wins only where it lies in the table
    const int in_table = col + V <= n ? V : (int)(n - col);
    const unsigned live = (1u << in_table) - 1u;
    changed += quad_join<E, V>(out, cand, live);
    if (down < len) {
      quad_load(cand, v, field, (down << log_cols) + c);
    } else {
      cand = zero;
    }
    changed += quad_join<E, V>(out, cand, live);
    const int64_t idx = (int64_t)(x - ht) * n + col;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      int32_t e[NF];
      entry_of<E, V>(e, out, j);
      K::decode(e);
#pragma unroll
      for (int f = 0; f < NF; ++f) out.v[f][j] = e[f];
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (V == 4 && vec_io && in_table == V) {
        *reinterpret_cast<int4*>(mid.f[f] + idx) =
            make_int4(out.v[f][0], out.v[f][V > 1 ? 1 : 0], out.v[f][V > 2 ? 2 : 0],
                      out.v[f][V > 3 ? 3 : 0]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (j < in_table) mid.f[f][idx + j] = out.v[f][j];
        }
      }
    }
  };
  const int first = ht << log_units, stop = (ht + h) << log_units;
  if (U > 0) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = threadIdx.x + k * kThreads;
      if (u >= first && u < stop) last(own[k], u);
    }
  } else {
    for (int u = first + threadIdx.x; u < stop; u += kThreads) {
      Quad<NF, V> out;
      quad_load(out, v, field, unit_index(u, log_units, log_cols));
      last(out, u);
    }
  }
  changed = bt::block_sum(changed);
  if (threadIdx.x == 0 && changed) atomicAdd(count, changed);
}

// bytes of a block's two planes of len rows x 2^log_cols columns
inline long long plane_bytes(int nf, int len, int log_cols) {
  return 2LL * nf * len * (int)sizeof(int32_t) << log_cols;
}

// The block width 2^log_cols: rows of 8 or 16 columns (32 or 64 bytes a
// field, whole sectors of device memory) first, two blocks an SM before
// one; narrower blocks only when a row of 8 does not fit. False when one
// column does not fit.
inline bool pick_cols(int nf, int len, int* log_cols, int* smem) {
  int dev = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  const int widest_first[2] = {kLogMaxCols, 2};
  for (const int widest : widest_first) {
    for (int pass = 0; pass < 2; ++pass) {
      for (int lc = widest; lc >= (widest == kLogMaxCols ? 3 : 0); --lc) {
        const long long bytes = plane_bytes(nf, len, lc);
        const bool fits = pass == 0 ? 2 * (bytes + kReserved + kSystem) <= per_sm
                                    : bytes + kReserved <= optin;
        if (fits) {
          *log_cols = lc;
          *smem = (int)bytes;
          return true;
        }
      }
    }
  }
  return false;
}

template <typename E>
struct WindowLaunch {
  static cudaError_t run(void* const* fields, void* const* tops, void* const* bottoms,
                         void* count, int ht, int h, int hb, long long n, long long m,
                         int flags, cudaStream_t st) {
    constexpr int NF = E::NF;
    if (m < 1 || h < 1 || ht < 0 || hb < 0 || n < 0) return cudaErrorInvalidValue;
    if ((flags & kWrap) && (ht || hb || (flags & (kClipTop | kClipBottom)))) {
      return cudaErrorInvalidValue;
    }
    if (((flags & kClipTop) && ht) || ((flags & kClipBottom) && hb)) {
      return cudaErrorInvalidValue;
    }
    if ((ht && !tops) || (hb && !bottoms)) return cudaErrorInvalidValue;
    const long long len = (long long)ht + h + hb;
    int log_cols = 0, smem = 0;
    if (len > INT32_MAX / 2 || !pick_cols(NF, (int)len, &log_cols, &smem)) {
      return cudaErrorInvalidValue;
    }
    if (n == 0) return cudaSuccess;
    // a radius of len rows already covers every row a window can reach
    const int radius = (int)(m - 1 < len ? m - 1 : len);
    const auto mid = bt::fields_of<NF>(fields);
    const auto top = tops ? bt::fields_of<NF>(tops) : mid;
    const auto bot = bottoms ? bt::fields_of<NF>(bottoms) : mid;
    // 16-byte device-memory accesses need 16-byte aligned rows
    bool vec_io = n % 4 == 0;
    for (int f = 0; f < NF; ++f) {
      vec_io = vec_io && reinterpret_cast<uintptr_t>(mid.f[f]) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(top.f[f]) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(bot.f[f]) % 16 == 0;
    }
    const long long blocks = (n + (1 << log_cols) - 1) >> log_cols;
    if (log_cols >= 2) return launch_units<4>(blocks, smem, st, mid, top, bot, ht, h, hb, n,
                                              radius, flags, log_cols, vec_io, count);
    return launch_units<1>(blocks, smem, st, mid, top, bot, ht, h, hb, n, radius, flags,
                           log_cols, vec_io, count);
  }

  // The kernel that holds each thread's units in registers (U = kHeld)
  // where the block has at most kHeld units a thread and that kernel keeps
  // as many blocks on an SM as the one that reads them from shared memory
  // (its extra registers can cost a block); else that one (U = 0).
  template <int V>
  static cudaError_t launch_units(long long blocks, int smem, cudaStream_t st,
                                  bt::Fields<E::NF> mid, bt::Fields<E::NF> top,
                                  bt::Fields<E::NF> bot, int ht, int h, int hb, long long n,
                                  int radius, int flags, int log_cols, bool vec_io,
                                  void* count) {
    auto kernel = window_kernel<E, V, 0>;
    int resident = 0, held_resident = 0;
    cudaError_t err = prepare(kernel, smem, &resident);
    if (err != cudaSuccess) return err;
    const int units = (ht + h + hb) << (log_cols - (V == 4 ? 2 : 0));
    if (units <= kHeld * kThreads) {
      err = prepare(window_kernel<E, V, kHeld>, smem, &held_resident);
      if (err != cudaSuccess) return err;
      if (held_resident >= resident) kernel = window_kernel<E, V, kHeld>;
    }
    kernel<<<(unsigned)blocks, kThreads, smem, st>>>(mid, top, bot, ht, h, hb, n, radius,
                                                     flags, log_cols, (int)vec_io,
                                                     static_cast<unsigned*>(count));
    return cudaGetLastError();
  }

  // Sets the kernel's shared memory; the blocks of it an SM holds.
  template <typename Kernel>
  static cudaError_t prepare(Kernel kernel, int smem, int* resident) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel, kThreads, smem);
  }
};

}  // namespace

// fields: host array of nf device pointers to [p, n] int32 (updated in
// place). count: one zeroed device int32 (the round-m residual is added).
// m >= 1 rounds; wrap: 1 ring, 0 chain. nf: 3 = packed, 2 = rank,
// 1 = rank1. p at most bt_window_rows(nf).
extern "C" cudaError_t bt_window_packed(void* const* fields, void* count, int p, long long n,
                                        long long m, int wrap, int nf, void* stream) {
  return bt::dispatch_nf<WindowLaunch>(nf, fields, (void* const*)nullptr,
                                       (void* const*)nullptr, count, 0, p, 0, n, m,
                                       wrap ? kWrap : (kClipTop | kClipBottom),
                                       static_cast<cudaStream_t>(stream));
}

// The extended form: fields: nf device pointers to the b center rows
// [b, n] (updated in place); tops / bottoms: nf device pointers each to
// [ht, n] / [hb, n] int32 rows above / below them (read only; null when
// that side has none). clip: 1 = the center's first row is a chain's top
// edge (ht = 0), 2 = its last row the bottom edge (hb = 0); a side without
// a slab or clip takes the all-zero entry. count: one zeroed device int32,
// the round-m residual of the center rows added. The spmd window passes
// ht = hb = m <= b and clip = 0. ht + b + hb at most bt_window_rows(nf).
extern "C" cudaError_t bt_window_shard_packed(void* const* fields, void* const* tops,
                                              void* const* bottoms, void* count, int b,
                                              long long n, long long m, int ht, int hb,
                                              int clip, int nf, void* stream) {
  if (clip & ~3) return cudaErrorInvalidValue;
  return bt::dispatch_nf<WindowLaunch>(nf, fields, tops, bottoms, count, ht, b, hb, n, m,
                                       clip << 1, static_cast<cudaStream_t>(stream));
}

// The most extended rows a launch of either form takes at nf fields (one
// column a block), 0 for a bad nf.
extern "C" int bt_window_rows(int nf) {
  if (nf < 1 || nf > 3) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (optin - kReserved) / (2 * nf * (int)sizeof(int32_t));
}
