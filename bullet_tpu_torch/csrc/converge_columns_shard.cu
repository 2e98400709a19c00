// The column pass of a ring or chain whose rows are sharded over a mesh (a
// shard a card): the dirty columns settled to their fixed point in two
// launches a shard about one exchange, and the classic round count of the
// converge they replace.
//
// Replaces no TPU kernel: it takes the place, where a mesh converge is not
// capped, of the per-shard window frontier (frontier_shard_window.cu, #25,
// folded by compact_counts.cu's window fold, #26), which runs m = 63 rounds
// per exchange of m-row slabs until the frontier empties. As in
// converge_columns.cu, the fixed point of a column is its join J in every
// row, and the rounds' depth L_c is read from the runs of rows that do not
// hold J. Those runs compose across shard boundaries: a shard is summarised
// by the runs before its first and after its last holder and its longest
// run, and a shard whose own join is not J holds no holder of it (every
// entry there lies below J; in all three layouts equal keys mean equal
// entries, lexmax.cuh). So:
//   1. column_summaries_kernel: one block a dirty 16-column group, per
//      shard: the shard's rows of the group into shared memory by cp.async
//      (48 KB packed at 256 rows), each column's join over the shard and,
//      one warp a column, the runs of rows that do not hold it; written as
//      NF + 2 words a column (the join, pre | suf << 16, best) in group
//      order. The caller gathers every shard's summaries to every process
//      (one collective), so all of them hold the same [S][G][16][NF + 2].
//   2. settle_columns_kernel: one block a group, per shard: from the S
//      summaries in shard order (brought into shared memory by the whole
//      block in one coalesced read) each column's J (on a chain the all-zero
//      entry where J is not above it, converge_columns.cu's rule), the runs
//      of the whole column (cyclic on a ring) and L_c, folded into one
//      device int by an atomic max; then J into every row of the shard's
//      group, but for a 32-byte half of the group's rows that every row of
//      the shard already holds (rewriting an entry with its value leaves it
//      bit for bit). Every process computes the same depth.
// Bound on the H100: device memory. Each entry of a group is read once by
// the first kernel and each 32-byte half of a row that needs it written
// once by the second; at a 256-row shard of 2^20 slots and a scatter
// batch's 35,200 dirty groups, 1.73 GB read and at most 1.73 GB written a
// shard. The gathered summaries are 20 B a column packed, 12 B rank1.
// The shard's rows are bounded by shared memory as in converge_columns.cu
// (ops/packed.py's column_pass_smem); the caller keeps larger shards on
// the window frontier.
#include "column_runs.cuh"
#include "lexmax.cuh"

namespace {

constexpr int kGroup = 16;               // columns a block owns
constexpr int kQuads = kGroup / 4;       // 16-byte quarters of a group's row
constexpr int kThreads = 32 * kGroup;    // summaries: warp w reads column w's runs
constexpr int kWarps = kThreads / 32;
constexpr int kStoreThreads = 256;       // settle: threads a block
constexpr int kMaxRows = 0xffff;         // a summary's runs take 16 bits
static_assert(kWarps == kGroup, "one warp a column of the group");

using bt::cp_async16;
using bt::cp_async_wait_all;
using bt::join_runs;
using bt::Runs;
using bt::runs_of_word;

// Shared memory of a summaries block: the group's rows [NF][b][16], the
// holders' flags [b][16] as bytes and their 32-row bitmaps [16][words]
// (converge_columns.cu's smem_bytes).
inline long long smem_bytes(int b, int nf) {
  const long long words = (b + 31) / 32;
  return 4LL * kGroup * b * nf + (long long)kGroup * b + 4LL * kGroup * words;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    column_summaries_kernel(bt::CFields<E::NF> t, const int32_t* __restrict__ groups,
                            int32_t* __restrict__ out, int b, int64_t n) {
  constexpr int NF = E::NF, W = NF + 2;
  extern __shared__ __align__(16) int32_t tile[];
  uint8_t* flags = reinterpret_cast<uint8_t*>(tile + (int64_t)NF * b * kGroup);
  unsigned* masks = reinterpret_cast<unsigned*>(flags + (int64_t)b * kGroup);
  __shared__ int32_t part[kWarps][kGroup][NF];
  __shared__ int32_t join[kGroup][NF];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = (int64_t)groups[blockIdx.x] * kGroup;
  auto at = [&](int f, int r, int c) -> int32_t& {
    return tile[((int64_t)f * b + r) * kGroup + c];
  };

  // 1. the shard's rows of the group into shared memory, 16 bytes a copy
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    for (int i = tid; i < kQuads * b; i += kThreads) {
      const int r = i / kQuads, h = i % kQuads;
      cp_async16(&at(f, r, h * 4), t.f[f] + (int64_t)r * n + c0 + h * 4);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. each column's join over the shard: thread (c, r0) folds rows r0,
  // r0 + 32, ..., then the warps' partial joins
  const int c = tid % kGroup, r0 = tid / kGroup;
  {
    int32_t best[NF], cur[NF];
    const int first = r0 < b ? r0 : 0;  // a row of the column leaves the join as it is
#pragma unroll
    for (int f = 0; f < NF; ++f) best[f] = at(f, first, c);
    for (int r = r0 + 32; r < b; r += 32) {
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
#pragma unroll
      for (int f = 0; f < NF; ++f) join[tid][f] = best[f];
    }
    __syncthreads();
  }

  // 3. the flags of the rows that hold the shard's join
  {
    int32_t j[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) j[f] = join[c][f];
    for (int r = r0; r < b; r += 32) {
      bool holds = true;
#pragma unroll
      for (int f = 0; f < NF; ++f) holds &= at(f, r, c) == j[f];
      flags[r * kGroup + c] = holds;
    }
  }
  __syncthreads();

  // 4. warp w: column w's runs over the shard, into its summary
  {
    const int words = (b + 31) / 32;
    unsigned* mine = masks + warp * words;
    for (int k = 0; k < words; ++k) {
      const int r = k * 32 + lane;
      const unsigned m = __ballot_sync(0xffffffffu, r < b && flags[r * kGroup + warp]);
      if (lane == 0) mine[k] = m;
    }
    __syncwarp();
    const int per = (words + 31) / 32;
    Runs acc = {0, 0, 0, 0};
    for (int k = lane * per; k < min(words, lane * per + per); ++k) {
      acc = join_runs(acc, runs_of_word(mine[k], min(32, b - k * 32)));
    }
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
      int32_t* s = out + ((int64_t)blockIdx.x * kGroup + warp) * W;
#pragma unroll
      for (int f = 0; f < NF; ++f) s[f] = join[warp][f];
      s[NF] = acc.pre | (acc.suf << 16);
      s[NF + 1] = acc.best;
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(kStoreThreads)
    settle_columns_kernel(bt::Fields<E::NF> t, const int32_t* __restrict__ groups,
                          const int32_t* __restrict__ sums, int32_t* depth, int shards,
                          int shard, int n_groups, int b, int64_t n, int wrap) {
  constexpr int NF = E::NF, W = NF + 2;
  extern __shared__ int32_t mine[];  // the group's summaries [shards][16][W]
  __shared__ __align__(16) int32_t join[NF][kGroup];
  __shared__ bool held[kGroup];  // every row of this shard holds the column's join

  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)groups[blockIdx.x] * kGroup;
  for (int i = tid; i < shards * kGroup * W; i += kStoreThreads) {
    const int s = i / (kGroup * W), k = i % (kGroup * W);
    mine[i] = sums[((int64_t)s * n_groups + blockIdx.x) * kGroup * W + k];
  }
  __syncthreads();

  // thread c < 16: column c's join over the shards, its runs and L_c
  if (tid < kGroup) {
    auto summary = [&](int s) { return mine + (s * kGroup + tid) * W; };
    int32_t j[NF], cur[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) j[f] = summary(0)[f];
    for (int s = 1; s < shards; ++s) {
#pragma unroll
      for (int f = 0; f < NF; ++f) cur[f] = summary(s)[f];
      if (E::gt(cur, j)) bt::copy_entry(j, cur);
    }
    bool ends = false;  // a chain's ends hold the join
    if (!wrap) {
      bt::zero_entry(cur);
      ends = !E::gt(j, cur);
      if (ends) bt::zero_entry(j);
    }
    Runs acc = {0, 0, 0, 0};
    bool full = false;
    for (int s = 0; s < shards; ++s) {
      const int32_t* e = summary(s);
      bool holds = true;
#pragma unroll
      for (int f = 0; f < NF; ++f) holds &= e[f] == j[f];
      const Runs r = holds ? Runs{b, e[NF] & 0xffff, (e[NF] >> 16) & 0xffff, e[NF + 1]}
                           : Runs{b, b, b, b};
      acc = join_runs(acc, r);
      if (s == shard) full = holds && r.best == 0;
    }
    int d;
    if (wrap) {
      d = max((acc.best + 1) / 2, (acc.pre + acc.suf + 1) / 2);
    } else if (ends) {
      d = (acc.best + 1) / 2;
    } else {
      d = max(max(acc.pre, acc.suf), (acc.best + 1) / 2);
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      d = max(d, __shfl_xor_sync(0x0000ffffu, d, off));
    }
    if (tid == 0 && d > *reinterpret_cast<volatile int32_t*>(depth)) atomicMax(depth, d);
#pragma unroll
    for (int f = 0; f < NF; ++f) join[f][tid] = j[f];
    held[tid] = full;
  }
  __syncthreads();

  // the join into every row of the shard's group, a 32-byte half at a time
  // (two 16-byte quarters), but for a half that every row already holds
  bool need[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    need[h] = false;
#pragma unroll
    for (int c = 0; c < kGroup / 2; ++c) need[h] |= !held[h * kGroup / 2 + c];
  }
  if (!need[0] && !need[1]) return;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    for (int i = tid; i < kQuads * b; i += kStoreThreads) {
      const int r = i / kQuads, q = i % kQuads;
      if (!need[q / 2]) continue;
      *reinterpret_cast<int4*>(t.f[f] + (int64_t)r * n + c0 + q * 4) =
          *reinterpret_cast<const int4*>(&join[f][q * 4]);
    }
  }
}

template <typename E>
struct Summaries {
  static cudaError_t run(void* const* fields, const void* groups, int n_groups, void* out,
                         int b, long long n, cudaStream_t s) {
    if (n % kGroup != 0 || b < 1 || b > kMaxRows) return cudaErrorInvalidValue;
    if (n_groups <= 0) return cudaSuccess;
    const long long bytes = smem_bytes(b, E::NF);
    cudaError_t err = cudaFuncSetAttribute(column_summaries_kernel<E>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
    bt::CFields<E::NF> t;
    for (int f = 0; f < E::NF; ++f) t.f[f] = static_cast<const int32_t*>(fields[f]);
    column_summaries_kernel<E><<<(unsigned)n_groups, kThreads, (size_t)bytes, s>>>(
        t, static_cast<const int32_t*>(groups), static_cast<int32_t*>(out), b, n);
    return cudaGetLastError();
  }
};

template <typename E>
struct Settle {
  static cudaError_t run(void* const* fields, const void* groups, int n_groups,
                         const void* sums, void* depth, int shards, int shard, int b,
                         long long n, int wrap, cudaStream_t s) {
    if (n % kGroup != 0 || b < 1 || b > kMaxRows || shards < 1 || shard < 0 ||
        shard >= shards) {
      return cudaErrorInvalidValue;
    }
    if (n_groups <= 0) return cudaSuccess;
    const long long bytes = 4LL * shards * kGroup * (E::NF + 2);
    if (bytes > 48 * 1024) return cudaErrorInvalidValue;
    settle_columns_kernel<E><<<(unsigned)n_groups, kStoreThreads, (size_t)bytes, s>>>(
        bt::fields_of<E::NF>(fields), static_cast<const int32_t*>(groups),
        static_cast<const int32_t*>(sums), static_cast<int32_t*>(depth), shards, shard,
        n_groups, b, n, wrap);
    return cudaGetLastError();
  }
};

}  // namespace

// fields: host array of nf device pointers to a shard's [b, n] int32 rows,
// n a multiple of 16. groups: device int32 [n_groups] ids of 16-column
// groups. out: device int32 [n_groups][16][nf + 2], each column's join over
// the shard's rows (nf words), then pre | suf << 16 and best, the runs of
// rows that do not hold it. nf: 3 = packed, 2 = rank, 1 = rank1.
extern "C" cudaError_t bt_column_summaries(void* const* fields, const void* groups,
                                           int n_groups, void* out, int b, long long n,
                                           int nf, void* stream) {
  return bt::dispatch_nf<Summaries>(nf, fields, groups, n_groups, out, b, n,
                                    static_cast<cudaStream_t>(stream));
}

// fields, groups, b, n as bt_column_summaries (the shard's own rows,
// updated in place). sums: device int32 [shards][n_groups][16][nf + 2],
// every shard's summaries in shard order; shard: this shard's index there.
// depth: a device int32 that ends as the largest of its value and every
// L_c of the groups' columns over the whole ring (wrap) or chain (the
// caller zeroes it).
extern "C" cudaError_t bt_settle_columns(void* const* fields, const void* groups,
                                         int n_groups, const void* sums, void* depth,
                                         int shards, int shard, int b, long long n, int wrap,
                                         int nf, void* stream) {
  return bt::dispatch_nf<Settle>(nf, fields, groups, n_groups, sums, depth, shards, shard, b,
                                 n, wrap, static_cast<cudaStream_t>(stream));
}
