// Per-shard frontier step on a device mesh: m ring rounds, in place, on the
// active slot stripes of one shard's [b, n] rows, given the neighbour
// shards' boundary rows taken before the step; emits the uncompacted
// per-round, per-stripe change counts of the shard's rows [m, t_total]. The
// caller sums the shards' counts and compacts them into the next ids array
// (compact_counts.cu).
//
// Replaces: bullet_tpu/ops/ring_kernel.py::_frontier_shard_kernel_dense
// (m = 1, one boundary row each way) and
// ::_frontier_shard_multiround_kernel_dense (8 fused rounds, 8 boundary
// rows each way), at nf = 7 (reference or lww order) and nf = 4 (lean)
// (bt_frontier_shard); bullet_tpu/ops/packed.py::_frontier_halo_kernel_counts
// (m = 1: the reference pads its boundary rows to 8 and reads row 7 above
// and row 0 below; here the one row is passed) and
// ::_frontier_shard_multiround_kernel_packed (m = 8), at nf = 3 (packed),
// 2 (rank) and 1 (rank1) (bt_frontier_shard_packed).
//
// Bound on the H100: device memory. A step must read each entry of an
// active stripe once, write it once, and read the boundary rows it depends
// on (nf x 4 bytes an entry); a settled stripe costs nothing. Only the
// shard's rows count and only they are stored: the boundary rows are read
// only at m = 1 and m = kPipeDepth. A chain's global ends arrive as zeroed
// boundary rows: an all-zero row is the bottom of every priority order, so
// it adds nothing the classic round's zero neighbour would not. Three
// modes, block j owning stripe ids[j]:
// - m = 1 (shard_sweep_kernel): the round depends on the b shard rows and
//   just two boundary rows, row s - 1 above and row 0 below, so it reads
//   those b + 2 rows and nothing else. A sweep of the whole extended
//   column with one row in flight a thread (190 registers at nf = 7, one
//   block an SM) held about 7 KB in flight an SM where the card's latency
//   needs some 16-20 KB, and ran at 2.2x its bound. Here each thread owns
//   a unit of V adjacent columns (V = 1 at nf = 7, 2 at nf = 4 and 3, 4 at
//   nf = 2 and 1: 4 V byte accesses, whole sectors a warp) and keeps a
//   ring of kSweepRing rows in registers, loading row r + kSweepRing - 1
//   while it joins row r, so kSweepRing - 2 rows are in flight a thread,
//   and several blocks share an SM (92 registers at nf = 7: two blocks of
//   256 on an H100, some 57 KB in flight an SM). The ring's slots are
//   compile-time (the loop is unrolled by its length), the field pointers
//   stay in parameter space.
// - m = kPipeDepth (HALO_FUSE, the loops' fused depth): one pipelined pass
//   (shard_pipe_kernel) over the extended rows [s - M, s + b + M), each
//   read once, the shard's rows each written once, per-round counts in
//   registers and M block sums at the end;
// - any other m <= s: m sweeps of the extended column [s top rows | b
//   shard rows | s bottom rows] as a ring (bt::sweep_ext), in place, the
//   boundary rows the caller's scratch for all but the last.
// Counts land at counts[k * t_total + stripe]; stripes not in ids keep the
// caller's zeros.
#include "frontier.cuh"

namespace {

// ------------------------------------------------------------ m = 1

// the rows of a thread's ring at m = 1: kSweepRing - 2 loads in flight
constexpr int kSweepRing = 6;

// the widest unit a thread takes at m = 1: NF x V int32 a row in registers
template <typename E>
constexpr int sweep_width() {
  return E::NF >= 7 ? 1 : E::NF >= 3 ? 2 : 4;
}

// V adjacent columns of one row: v[f][c] is field f of column c
template <int NF, int V>
struct Unit {
  int32_t v[NF][V];
};

template <int NF, int V>
__device__ __forceinline__ void unit_load(Unit<NF, V>& u, const bt::Fields<NF>& t,
                                          int64_t idx) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int32_t* p = t.f[f] + idx;
    if constexpr (V == 4) {
      const int4 w = *reinterpret_cast<const int4*>(p);
      u.v[f][0] = w.x;
      u.v[f][1] = w.y;
      u.v[f][2] = w.z;
      u.v[f][3] = w.w;
    } else if constexpr (V == 2) {
      const int2 w = *reinterpret_cast<const int2*>(p);
      u.v[f][0] = w.x;
      u.v[f][1] = w.y;
    } else {
      u.v[f][0] = *p;
    }
  }
}

template <int NF, int V>
__device__ __forceinline__ void unit_store(const bt::Fields<NF>& t, int64_t idx,
                                           const Unit<NF, V>& u) {
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    int32_t* p = t.f[f] + idx;
    if constexpr (V == 4) {
      *reinterpret_cast<int4*>(p) = make_int4(u.v[f][0], u.v[f][1], u.v[f][2], u.v[f][3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<int2*>(p) = make_int2(u.v[f][0], u.v[f][1]);
    } else {
      *p = u.v[f][0];
    }
  }
}

// out = the round of each column of cur between up and down, as
// bt::sweep_column joins it (cur, then up, then down); returns the wins
template <typename E, int V>
__device__ __forceinline__ unsigned unit_join(Unit<E::NF, V>& out, const Unit<E::NF, V>& up,
                                              const Unit<E::NF, V>& cur,
                                              const Unit<E::NF, V>& down) {
  constexpr int NF = E::NF;
  unsigned wins = 0;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    int32_t u[NF], m[NF], d[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      u[f] = up.v[f][c];
      m[f] = cur.v[f][c];
      d[f] = down.v[f][c];
    }
    if (E::gt(u, m)) {
      bt::copy_entry(m, u);
      ++wins;
    }
    if (E::gt(d, m)) {
      bt::copy_entry(m, d);
      ++wins;
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) out.v[f][c] = m[f];
  }
  return wins;
}

// What shard_sweep_kernel reads: the shard's rows, row s - 1 of the tops and
// row 0 of the bottoms (the only boundary rows one round depends on).
template <int NF>
struct SweepArgs {
  bt::Fields<NF> mid, top, bot;
  const int32_t* ids;
  int32_t* counts;
  int64_t n;
  int b, tile_n, t_total;
};

// One round of the shard's rows as x[r + 1] <- join(x[r], x[r + 1], x[r + 2])
// over its inputs x[0] = tops row s - 1, x[1 + i] = shard row i, x[b + 1] =
// bottoms row 0, each read once. Slot i mod R of the ring holds x[i]: row r
// takes slots r, r + 1, r + 2 (mod R), stores, then loads x[r + R] into
// slot r, whose x[r] it no longer needs. Every branch on a row is uniform
// across the block.
template <typename E, int V>
__global__ void __launch_bounds__(bt::kMaxTile)
    shard_sweep_kernel(const __grid_constant__ SweepArgs<E::NF> a) {
  constexpr int NF = E::NF, R = kSweepRing;
  const int j = blockIdx.x;
  if (j >= a.ids[a.t_total]) return;  // uniform across the block
  const int stripe = a.ids[j];
  const int64_t col = (int64_t)stripe * a.tile_n + threadIdx.x * V;
  Unit<NF, V> x[R];
  const auto input = [&](Unit<NF, V>& u, int i) {
    if (i == 0) {
      unit_load(u, a.top, col);
    } else if (i <= a.b) {
      unit_load(u, a.mid, (int64_t)(i - 1) * a.n + col);
    } else if (i == a.b + 1) {
      unit_load(u, a.bot, col);
    }
  };
#pragma unroll
  for (int i = 0; i < R; ++i) input(x[i], i);
  unsigned wins = 0;
  bt::rotated_steps<R>(0, a.b, [&](auto slot, int r) {
    constexpr int U = decltype(slot)::value;
    Unit<NF, V> out;
    wins += unit_join<E, V>(out, x[U], x[(U + 1) % R], x[(U + 2) % R]);
    unit_store(a.mid, (int64_t)r * a.n + col, out);
    input(x[U], r + R);
  });
  wins = bt::block_sum(wins);
  if (threadIdx.x == 0) a.counts[stripe] = (int32_t)wins;
}

// ---------------------------------------------- m sweeps (any other m)

template <typename E>
__global__ void __launch_bounds__(bt::kMaxTile)
    frontier_shard_kernel(bt::Fields<E::NF> mid, bt::Fields<E::NF> top,
                          bt::Fields<E::NF> bot, const int32_t* ids, int b, int s,
                          int64_t n, int tile_n, int t_total, int m, int32_t* counts) {
  const int j = blockIdx.x;
  if (j >= ids[t_total]) return;  // uniform across the block
  const int stripe = ids[j];
  const int64_t col = (int64_t)stripe * tile_n + threadIdx.x;
  const bool live = threadIdx.x < tile_n && col < n;
  const bt::ExtColumn<E::NF> c{top, mid, bot, s, b, n, col};
  for (int k = 0; k < m; ++k) {
    unsigned changed = 0;
    if (live) {
      bt::sweep_ext<E>(c, k + 1 < m, [&](int r, unsigned wins) {
        if (r >= s && r < s + b) changed += wins;
      });
    }
    changed = bt::block_sum(changed);
    if (threadIdx.x == 0) counts[(int64_t)k * t_total + stripe] = (int32_t)changed;
  }
}

// Input e of the shard's pipelined pass: extended row s - M + e, encoded.
template <typename E, int M>
__device__ __forceinline__ void shard_input(int32_t (&v)[E::NF], const bt::ExtColumn<E::NF>& c,
                                            int e) {
  c.load(v, c.s - M + e);
  bt::PipeKey<E>::encode(v);
}

// Step e of the shard's pass (bt::pipe_stages), R = e mod 3. The pass's
// row j is extended row s - M + j, so the shard's rows are j in [M, M + b).
// EDGE: test each stage's row against them, and whether input e + 1
// exists. STORE: stage M's row e - M is a shard row, stored at shard row
// e - 2 M.
template <typename E, int M, int R, bool EDGE, bool STORE>
__device__ __forceinline__ void shard_step(int32_t (&h)[M][3][E::NF], int32_t (&next)[E::NF],
                                           unsigned (&cnt)[M], const bt::ExtColumn<E::NF>& c,
                                           int e) {
  constexpr int NF = E::NF;
  bt::copy_entry(h[0][R], next);
  if (!EDGE || e + 1 < c.b + 2 * M) shard_input<E, M>(next, c, e + 1);
  int32_t out[NF];
  bt::pipe_stages<E, M, R>(h, cnt, out, e, [&](int row, int32_t(&)[NF]) {
    return !EDGE || (row >= M && row < M + c.b);
  });
  if (STORE) {
    bt::PipeKey<E>::decode(out);
    bt::store_entry(c.mid, (int64_t)(e - 2 * M) * c.n + c.col, out);
  }
}

template <typename E, int M, bool EDGE, bool STORE>
__device__ __forceinline__ void shard_steps(int32_t (&h)[M][3][E::NF], int32_t (&next)[E::NF],
                                            unsigned (&cnt)[M], const bt::ExtColumn<E::NF>& c,
                                            int e, int end) {
  bt::rotated_steps(e, end, [&](auto slot, int step) {
    shard_step<E, M, decltype(slot)::value, EDGE, STORE>(h, next, cnt, c, step);
  });
}

// M rounds of the shard in one pass per column: bt::frontier_pipe_kernel's
// stages over the chain of the b + 2 M extended rows [s - M, s + b + M),
// which are all that M rounds of the shard's rows depend on (all 2 s + b
// rows when s = M). Step e reads input e, stage k emits round k at pass
// row e - k, and stage M's row e - M is a shard row for every e >= 2 M,
// so the pass has exactly b + 2 M steps. Before the chain's first row the
// stages hold encoded zeros, and past its ends nothing is read: y_k[j] is
// exact for j in [k, b + 2 M - k) (the trapezoid), which holds the
// shard's rows [M, M + b) at every stage, so each stage counts exactly the
// classic round's wins there, and the rest never reaches them. Parts:
// - head, steps [0, 2 M): no store (stage M is still in the upper
//   boundary rows), the counted rows tested;
// - body, steps [2 M, b + M]: every stage's row e - k (k = 1..M) lies in
//   [M, M + b) and input e + 1 exists (e + 1 <= b + M + 1 < b + 2 M), so no
//   test at all; empty when b < M;
// - tail, the rest up to b + 2 M: rows and input e + 1 tested.
// The counts stay in registers, one per stage, and meet in M block sums.
template <typename E, int M>
__global__ void __launch_bounds__(bt::kMaxTile)
    shard_pipe_kernel(bt::Fields<E::NF> mid, bt::Fields<E::NF> top, bt::Fields<E::NF> bot,
                      const int32_t* ids, int b, int s, int64_t n, int tile_n, int t_total,
                      int32_t* counts) {
  constexpr int NF = E::NF;
  const int j = blockIdx.x;
  if (j >= ids[t_total]) return;  // uniform across the block
  const int stripe = ids[j];
  const int64_t col = (int64_t)stripe * tile_n + threadIdx.x;
  unsigned cnt[M];
#pragma unroll
  for (int k = 0; k < M; ++k) cnt[k] = 0;
  if (threadIdx.x < tile_n && col < n) {
    const bt::ExtColumn<NF> c{top, mid, bot, s, b, n, col};
    int32_t h[M][3][NF];
    int32_t zero[NF];
    bt::zero_entry(zero);
    bt::PipeKey<E>::encode(zero);
#pragma unroll
    for (int k = 0; k < M; ++k) {
#pragma unroll
      for (int r = 0; r < 3; ++r) bt::copy_entry(h[k][r], zero);
    }
    int32_t next[NF];
    shard_input<E, M>(next, c, 0);
    const int body = max(2 * M, b + M + 1);
    shard_steps<E, M, true, false>(h, next, cnt, c, 0, 2 * M);
    shard_steps<E, M, false, true>(h, next, cnt, c, 2 * M, body);
    shard_steps<E, M, true, true>(h, next, cnt, c, body, b + 2 * M);
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const unsigned total = bt::block_sum(cnt[k]);
    if (threadIdx.x == 0) counts[(int64_t)k * t_total + stripe] = (int32_t)total;
  }
}

// go(bt::Slot<V>()) for the widest unit V <= sweep_width<E>() that fits(V)
template <typename E, typename Fits, typename Go>
cudaError_t widest_unit(Fits fits, Go go) {
  constexpr int W = sweep_width<E>();
  if constexpr (W >= 4) {
    if (fits(4)) return go(bt::Slot<4>());
  }
  if constexpr (W >= 2) {
    if (fits(2)) return go(bt::Slot<2>());
  }
  return go(bt::Slot<1>());
}

template <typename E>
struct FrontierShard {
  static cudaError_t run(void* const* fields, void* const* tops, void* const* bottoms,
                         const void* ids, void* counts, int b, int s, long long n,
                         int tile_n, int t_total, int m, cudaStream_t st) {
    constexpr int NF = E::NF;
    if (tile_n < 32 || tile_n > bt::kMaxTile || tile_n % 32 || m < 1 || m > s || b < 1) {
      return cudaErrorInvalidValue;
    }
    if (t_total == 0) return cudaSuccess;
    const auto mid = bt::fields_of<NF>(fields), top = bt::fields_of<NF>(tops),
               bot = bt::fields_of<NF>(bottoms);
    const auto* in = static_cast<const int32_t*>(ids);
    auto* out = static_cast<int32_t*>(counts);
    if (m == 1) {
      const SweepArgs<NF> a{mid, row_of(top, s - 1, n), bot, in, out, n, b, tile_n, t_total};
      return widest_unit<E>([&](int v) { return sweep_fits(a, v); }, [&](auto unit) {
        constexpr int V = decltype(unit)::value;
        shard_sweep_kernel<E, V><<<t_total, tile_n / V, 0, st>>>(a);
        return cudaGetLastError();
      });
    }
    if (m == bt::kPipeDepth) {
      shard_pipe_kernel<E, bt::kPipeDepth>
          <<<t_total, tile_n, 0, st>>>(mid, top, bot, in, b, s, n, tile_n, t_total, out);
    } else {
      frontier_shard_kernel<E>
          <<<t_total, tile_n, 0, st>>>(mid, top, bot, in, b, s, n, tile_n, t_total, m, out);
    }
    return cudaGetLastError();
  }

  // Whether units of V columns fit the stripe in whole warps and every row
  // the sweep reads or writes is aligned for 4 V byte accesses.
  static bool sweep_fits(const SweepArgs<E::NF>& a, int v) {
    bool fits = a.tile_n % (32 * v) == 0 && a.n % v == 0;
    for (int f = 0; f < E::NF; ++f) {
      fits = fits && reinterpret_cast<uintptr_t>(a.mid.f[f]) % (4 * v) == 0 &&
             reinterpret_cast<uintptr_t>(a.top.f[f]) % (4 * v) == 0 &&
             reinterpret_cast<uintptr_t>(a.bot.f[f]) % (4 * v) == 0;
    }
    return fits;
  }

  // The fields' row r of a [rows, n] boundary.
  static bt::Fields<E::NF> row_of(bt::Fields<E::NF> t, int r, long long n) {
    for (int f = 0; f < E::NF; ++f) t.f[f] += (int64_t)r * n;
    return t;
  }
};

// The blocks of the m = 1 kernel an SM holds for stripes of tile_n
// columns on aligned rows (the occupancy API).
template <typename E>
struct SweepBlocks {
  static cudaError_t run(int tile_n, int* blocks) {
    return widest_unit<E>([&](int v) { return tile_n % (32 * v) == 0; }, [&](auto unit) {
      constexpr int V = decltype(unit)::value;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, shard_sweep_kernel<E, V>,
                                                           tile_n / V, 0);
    });
  }
};

}  // namespace

// fields: host array of nf device pointers to the shard's [b, n] int32
// rows (updated in place): the 7 fields of a dense table, or its 4 value
// keys when nf = 4 (lww ignored). tops / bottoms: nf device pointers each
// to [s, n] int32 holding the rows above / below the shard (zeros at a
// chain's ends): read only at m = 1 and m = bt::kPipeDepth, scratch at
// any other m. ids: [t_total + 2] or [t_total + 3] int32 (the active
// stripes and their count at [t_total]). counts: [m, t_total] zeroed
// int32. 1 <= m <= s; tile_n is a multiple of 32, at most bt::kMaxTile,
// and divides n.
extern "C" cudaError_t bt_frontier_shard(void* const* fields, void* const* tops,
                                         void* const* bottoms, const void* ids,
                                         void* counts, int b, int s, long long n,
                                         int tile_n, int t_total, int m, int lww, int nf,
                                         void* stream) {
  return bt::dispatch_dense<FrontierShard>(nf, lww, fields, tops, bottoms, ids, counts, b,
                                           s, n, tile_n, t_total, m,
                                           static_cast<cudaStream_t>(stream));
}

// The same for a packed-family shard of nf = 3, 2 or 1 fields (lexmax.cuh's
// PackedEntry, RankEntry, Rank1Entry).
extern "C" cudaError_t bt_frontier_shard_packed(void* const* fields, void* const* tops,
                                                void* const* bottoms, const void* ids,
                                                void* counts, int b, int s, long long n,
                                                int tile_n, int t_total, int m, int nf,
                                                void* stream) {
  return bt::dispatch_nf<FrontierShard>(nf, fields, tops, bottoms, ids, counts, b, s, n,
                                        tile_n, t_total, m,
                                        static_cast<cudaStream_t>(stream));
}

// blocks: the blocks an SM holds of the m = 1 kernel of nf fields (7 or 4
// dense, with lww; 3, 2 or 1 packed family) for stripes of tile_n columns.
extern "C" cudaError_t bt_frontier_shard_blocks(int nf, int lww, int tile_n, int* blocks) {
  if (tile_n < 32 || tile_n > bt::kMaxTile || tile_n % 32) return cudaErrorInvalidValue;
  if (nf >= 4) return bt::dispatch_dense<SweepBlocks>(nf, lww, tile_n, blocks);
  return bt::dispatch_nf<SweepBlocks>(nf, tile_n, blocks);
}
