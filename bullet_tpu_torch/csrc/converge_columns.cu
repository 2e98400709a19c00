// One pass that settles the dirty columns of a packed-family table (packed
// (khi, klo, cv), rank (rank, cv) or rank1 (rank)) on a ring or a chain, in
// place, and the classic round count of the converge it replaces.
//
// Replaces no TPU kernel: it takes the place, where a converge is not
// capped, of the compacting frontier loop (frontier_packed.cu, #19/#20),
// which runs L + 1 Jacobi rounds over whole 256-column stripes. A round
// takes both neighbours from the pre-round table, so after r rounds row q
// holds the join of its column over the ring (chain) ball of radius r. The
// fixed point of a column is therefore its join J in every row; row q
// changes for the last time at round d(q), its distance to the nearest row
// that already holds J; and every round from 1 to L_c = max_q d(q) changes
// some row. The classic round count is L + 1 for L the largest L_c over the
// dirty columns (0 with no dirty column). L_c is read from the holders:
//   ring:  ceil(k / 2) for the longest cyclic run of k non-holders;
//   chain: the larger of the runs before the first and after the last
//          holder, and ceil(k / 2) for each run between two holders.
// A chain's ends compare against the all-zero entry. Where it is not below
// the join (a column of entries below it, which no sim writes), the fixed
// point is that entry, and the ends act as holders one row beyond the
// chain: every run then counts ceil(k / 2). In all three layouts equal keys
// mean equal entries (lexmax.cuh), so the join does not depend on the order
// of the compares and "holds J" is a compare of the fields.
//
// Bound on the H100: device memory. Each entry of a group is read once and
// each changed row's 16-byte half written once; the rounds' mathematics is
// the same joins, evaluated once a column instead of once a round.
// Design: one block per 16-column group that holds a dirty column (64 bytes
// a row a field: two whole sectors). cp.async brings the group's P x 16 x
// NF words into shared memory (192 KB packed, 64 KB rank1 at P = 1024); the
// join, the holders' flags and, one warp a column, the runs of non-holders
// (a ballot a 32-row word, then an ordered shuffle reduction of run
// summaries) are computed there; the block folds its largest L_c into one
// device int with an atomic max; the group's rows that hold a changed entry
// are stored back whole. On the card (1024 x 2^20, a scatter batch's
// 49,300 dirty columns) 16-byte stores of the changed quarters alone took
// 1.7x the time of whole rows (partial sectors are read back), and 8-column
// groups 1.2x that of 16. P is bounded by shared memory (ops/packed.py's
// column_pass_smem mirrors smem_bytes); the caller keeps larger P on the
// stripe loop.
#include "lexmax.cuh"

namespace {

constexpr int kGroup = 16;                // columns a block owns
constexpr int kQuads = kGroup / 4;        // 16-byte quarters of a group's row
constexpr int kThreads = 32 * kGroup;     // warp w reads column w's runs
constexpr int kWarps = kThreads / 32;
constexpr int kRowLanes = kThreads / kGroup;  // threads a column in the join
static_assert(kWarps == kGroup && kRowLanes == 32, "one warp a column of the group");
static_assert(kGroup == 16, "a row's holder flags are read as one uint4");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A stretch of rows summarised by its runs of non-holders: its length, the
// run at its start, the run at its end and its longest run. pre == len means
// the stretch holds no holder.
struct Runs {
  int len, pre, suf, best;
};

// The runs of the first `valid` rows of a 32-row word; bit i set = row i
// holds the join.
__device__ __forceinline__ Runs runs_of_word(unsigned holders, int valid) {
  const unsigned rows = valid >= 32 ? 0xffffffffu : (1u << valid) - 1u;
  holders &= rows;
  if (holders == 0u) return {valid, valid, valid, valid};
  Runs r;
  r.len = valid;
  r.pre = __ffs(holders) - 1;
  r.suf = valid - 32 + __clz(holders);
  unsigned gaps = ~holders & rows;
  int best = 0;
  while (gaps) {  // each step shortens every run of set bits by one
    gaps &= gaps >> 1;
    ++best;
  }
  r.best = best;
  return r;
}

// The runs of stretch a followed by stretch b.
__device__ __forceinline__ Runs join_runs(const Runs& a, const Runs& b) {
  Runs r;
  r.len = a.len + b.len;
  r.pre = a.pre == a.len ? a.len + b.pre : a.pre;
  r.suf = b.suf == b.len ? b.len + a.suf : b.suf;
  r.best = max(max(a.best, b.best), a.suf + b.pre);
  return r;
}

// Shared memory of a block: the group's table [NF][p][16], the holders'
// flags [p][16] as bytes (1 = holds the join), and the holder bitmaps
// [16][words] of 32 rows each.
inline long long smem_bytes(int p, int nf) {
  const long long words = (p + 31) / 32;
  return 4LL * kGroup * p * nf + (long long)kGroup * p + 4LL * kGroup * words;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    converge_columns_kernel(bt::Fields<E::NF> t, const int32_t* __restrict__ groups,
                            int32_t* depth, int p, int64_t n, int wrap) {
  constexpr int NF = E::NF;
  extern __shared__ __align__(16) int32_t tile[];
  uint8_t* flags = reinterpret_cast<uint8_t*>(tile + (int64_t)NF * p * kGroup);
  unsigned* masks = reinterpret_cast<unsigned*>(flags + (int64_t)p * kGroup);
  __shared__ int32_t part[kWarps][kGroup][NF];
  __shared__ int32_t join[kGroup][NF];
  __shared__ bool ends[kGroup];  // a chain's ends hold the join
  __shared__ int dist[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = (int64_t)groups[blockIdx.x] * kGroup;
  auto at = [&](int f, int r, int c) -> int32_t& {
    return tile[((int64_t)f * p + r) * kGroup + c];
  };

  // 1. the group's rows into shared memory, 16 bytes a copy
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    for (int i = tid; i < kQuads * p; i += kThreads) {
      const int r = i / kQuads, h = i % kQuads;
      cp_async16(&at(f, r, h * 4), t.f[f] + (int64_t)r * n + c0 + h * 4);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. each column's join: thread (c, r0) folds rows r0, r0 + 32, ...; a
  // warp's lanes read 32 consecutive words (no bank conflict)
  const int c = tid % kGroup, r0 = tid / kGroup;
  {
    int32_t best[NF], cur[NF];
    const int first = r0 < p ? r0 : 0;  // a row of the column leaves the join as it is
#pragma unroll
    for (int f = 0; f < NF; ++f) best[f] = at(f, first, c);
    for (int r = r0 + 32; r < p; r += 32) {
#pragma unroll
      for (int f = 0; f < NF; ++f) cur[f] = at(f, r, c);
      if (E::gt(cur, best)) bt::copy_entry(best, cur);
    }
#pragma unroll
    for (int off = kGroup; off < 32; off <<= 1) {
#pragma unroll
      for (int f = 0; f < NF; ++f) cur[f] = __shfl_xor_sync(0xffffffffu, best[f], off);
      if (E::gt(cur, best)) bt::copy_entry(best, cur);
    }
    if (lane < kGroup) {
#pragma unroll
      for (int f = 0; f < NF; ++f) part[warp][lane][f] = best[f];
    }
    __syncthreads();
    if (tid < kGroup) {
#pragma unroll
      for (int f = 0; f < NF; ++f) best[f] = part[0][tid][f];
      for (int w = 1; w < kWarps; ++w) {
#pragma unroll
        for (int f = 0; f < NF; ++f) cur[f] = part[w][tid][f];
        if (E::gt(cur, best)) bt::copy_entry(best, cur);
      }
      bt::zero_entry(cur);
      ends[tid] = !wrap && !E::gt(best, cur);
      if (ends[tid]) bt::zero_entry(best);
#pragma unroll
      for (int f = 0; f < NF; ++f) join[tid][f] = best[f];
    }
    __syncthreads();
  }

  // 3. the holders' flags; every other entry becomes the join
  {
    int32_t j[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) j[f] = join[c][f];
    for (int r = r0; r < p; r += 32) {
      bool holds = true;
#pragma unroll
      for (int f = 0; f < NF; ++f) holds &= at(f, r, c) == j[f];
      flags[r * kGroup + c] = holds;
      if (!holds) {
#pragma unroll
        for (int f = 0; f < NF; ++f) at(f, r, c) = j[f];
      }
    }
  }
  __syncthreads();

  // 4. warp w: column w's runs of non-holders, and its L_c
  {
    const int words = (p + 31) / 32;
    unsigned* mine = masks + warp * words;
    for (int k = 0; k < words; ++k) {
      const int r = k * 32 + lane;
      const unsigned m = __ballot_sync(0xffffffffu, r < p && flags[r * kGroup + warp]);
      if (lane == 0) mine[k] = m;
    }
    __syncwarp();
    const int per = (words + 31) / 32;
    Runs acc = {0, 0, 0, 0};
    for (int k = lane * per; k < min(words, lane * per + per); ++k) {
      acc = join_runs(acc, runs_of_word(mine[k], min(32, p - k * 32)));
    }
    // ordered reduction: lane 0 ends with the runs of the whole column
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      Runs o;
      o.len = __shfl_down_sync(0xffffffffu, acc.len, off);
      o.pre = __shfl_down_sync(0xffffffffu, acc.pre, off);
      o.suf = __shfl_down_sync(0xffffffffu, acc.suf, off);
      o.best = __shfl_down_sync(0xffffffffu, acc.best, off);
      if ((lane & (2 * off - 1)) == 0) acc = join_runs(acc, o);
    }
    if (lane == 0) {
      // unless a chain's ends hold it, the join is some row's entry
      if (wrap) {
        dist[warp] = max((acc.best + 1) / 2, (acc.pre + acc.suf + 1) / 2);
      } else if (ends[warp]) {
        dist[warp] = (acc.best + 1) / 2;
      } else {
        dist[warp] = max(max(acc.pre, acc.suf), (acc.best + 1) / 2);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int d = dist[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) d = max(d, dist[w]);
    if (d > *reinterpret_cast<volatile int32_t*>(depth)) atomicMax(depth, d);
  }

  // 5. the group's rows that hold a changed entry back to device memory,
  // whole: a partial sector write costs the card a read of it
  const uint4* row_flags = reinterpret_cast<const uint4*>(flags);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    for (int i = tid; i < kQuads * p; i += kThreads) {
      const int r = i / kQuads, h = i % kQuads;
      const uint4 held = row_flags[r];
      if ((held.x & held.y & held.z & held.w) == 0x01010101u) continue;  // 16 holders
      *reinterpret_cast<int4*>(t.f[f] + (int64_t)r * n + c0 + h * 4) =
          *reinterpret_cast<const int4*>(&at(f, r, h * 4));
    }
  }
}

template <typename E>
struct Launch {
  static cudaError_t run(void* const* fields, const void* groups, int n_groups, void* depth,
                         int p, long long n, int wrap, cudaStream_t s) {
    if (n % kGroup != 0 || p < 1) return cudaErrorInvalidValue;
    if (n_groups <= 0) return cudaSuccess;
    const long long bytes = smem_bytes(p, E::NF);
    cudaError_t err = cudaFuncSetAttribute(converge_columns_kernel<E>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    converge_columns_kernel<E><<<(unsigned)n_groups, kThreads, (size_t)bytes, s>>>(
        bt::fields_of<E::NF>(fields), static_cast<const int32_t*>(groups),
        static_cast<int32_t*>(depth), p, n, wrap);
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to [p, n] int32 (updated in
// place), n a multiple of 16. groups: device int32 [n_groups] ids of
// 16-column groups (columns 16g .. 16g + 15), each at most once. depth: a
// device int32 that ends as the largest of its value and every L_c of the
// groups' columns (the caller zeroes it). nf: 3 = packed, 2 = rank, 1 =
// rank1.
extern "C" cudaError_t bt_converge_columns(void* const* fields, const void* groups,
                                           int n_groups, void* depth, int p, long long n,
                                           int wrap, int nf, void* stream) {
  return bt::dispatch_nf<Launch>(nf, fields, groups, n_groups, depth, p, n, wrap,
                                 static_cast<cudaStream_t>(stream));
}
