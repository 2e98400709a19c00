// The re-key of a rank1 table after a RankIndex respread, in place: every
// rank of the old epoch becomes the new rank of the vid it stood for.
//
// The rule is ops/rank.py's plain rekey_rank1 (decode_vids_rank1, then the
// vid -> rank gather), entry by entry. For an entry r > 0:
//   i = lower_bound(old_sranks, r), clamped to count - 1;
//   a hit is old_sranks[i] == r;
//   on a hit the entry becomes rank_map[clamp(old_svids[i], 0, map_len - 1)],
//   elsewhere 0, so a rank the old inverse does not hold reads as absent.
// An entry r <= 0 becomes 0, and an empty inverse gives 0 everywhere.
//
// Replaces no TPU kernel: the reference re-keys with XLA's searchsorted and
// gathers (bullet_tpu/ops/rank.py::rekey_rank1). In PyTorch those are about
// a dozen launches a column block over the table, with int64 temporaries
// (the plain version); a respread re-keys the whole table, so the pass is
// written to read each entry once and write each changed entry once.
//
// Bound on the H100: device memory. The table is read once and its live
// entries written once: at 1,024 x 2^20 and about 91% live, about 8.2 GB,
// 2.5 ms at 3.35 TB/s.
// Design: a thread owns 4 neighbouring columns (16-byte loads and stores, a
// warp a 512-byte segment of a row) and walks down all the rows, kRows rows
// loaded ahead of their use so that enough bytes are in flight. It keeps
// each column's entry of the row above and that entry's new rank in
// registers: an entry equal to the row above reuses the result, so only the
// start of a run of equal ranks pays the binary search and its two
// dependent loads (the old inverse and the vid -> rank map, a few MB, stay
// in L2). A respread re-keys the table that the last converge left, with
// one rank down each column, so it searches about once a live column
// instead of once an entry; any other table is still exact and only
// searches more. At the cells' widths the columns alone give 1,024 blocks
// of 256 threads (2^20 / 4 / 256), more than the 132 SMs hold at once, so
// the rows are not split and each column searches once a run.
// An unchanged 4-entry vector (absent slots among them) is not stored.
// Where the row length is not a multiple of 4 a thread owns one column. A
// block sums its searches and adds them to the caller's counter with one
// atomic; the kernel allocates nothing and does not synchronise.
#include "lexmax.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows a thread loads before it uses them

__device__ __forceinline__ int32_t& lane(int32_t& v, int) { return v; }
__device__ __forceinline__ int32_t& lane(int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

struct Inverse {
  const int32_t* sranks;    // the old epoch's sorted live ranks
  const int32_t* svids;     // their vids
  int count;                // 0 where the inverse is empty
  const int32_t* rank_map;  // vid -> new rank
  int map_len;              // >= 1 where count >= 1
};

// The new rank of a stale rank r > 0.
__device__ __forceinline__ int32_t new_rank(int32_t r, const Inverse& inv) {
  int lo = 0, len = inv.count;
  while (len > 0) {
    const int half = len >> 1;
    if (__ldg(inv.sranks + lo + half) < r) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  const int i = min(lo, inv.count - 1);
  if (__ldg(inv.sranks + i) != r) return 0;
  const int vid = min(max(__ldg(inv.svids + i), 0), inv.map_len - 1);
  return __ldg(inv.rank_map + vid);
}

// V columns a thread (int4: 4, int32_t: 1); `groups` such vectors a row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rekey_rank1_kernel(T* table, int p, int64_t groups, Inverse inv,
                       unsigned long long* searches) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  unsigned found = 0;
  if (g < groups) {
    T* col = table + g;
    // each column's entry in the row above and its new rank (0 -> 0)
    int32_t above[V], out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) above[j] = out[j] = 0;
    for (int r0 = 0; r0 < p; r0 += kRows) {
      const int rows = min(kRows, p - r0);
      T v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (k < rows) v[k] = col[(int64_t)(r0 + k) * groups];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k >= rows) break;
        bool changed = false;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          int32_t& e = lane(v[k], j);
          if (e != above[j]) {
            above[j] = e;
            if (e > 0 && inv.count > 0) {
              out[j] = new_rank(e, inv);
              ++found;
            } else {
              out[j] = 0;
            }
          }
          changed |= out[j] != e;
          e = out[j];
        }
        if (changed) col[(int64_t)(r0 + k) * groups] = v[k];
      }
    }
  }
  found = bt::block_sum(found);
  if (threadIdx.x == 0 && found) atomicAdd(searches, (unsigned long long)found);
}

}  // namespace

// table: [p, n] int32 on the device, updated in place. sranks, svids:
// [count] int32 (the old epoch's inverse; count may be 0); rank_map:
// [map_len] int32, map_len >= 1 where count >= 1. searches: one int64 on the
// device that the launch adds its binary searches to.
extern "C" cudaError_t bt_rekey_rank1(void* table, int p, long long n, const void* sranks,
                                      const void* svids, int count, const void* rank_map,
                                      int map_len, void* searches, void* stream) {
  if (p <= 0 || n <= 0 || count < 0 || (count > 0 && map_len <= 0))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const Inverse inv{static_cast<const int32_t*>(sranks), static_cast<const int32_t*>(svids),
                    count, static_cast<const int32_t*>(rank_map), map_len};
  auto* found = static_cast<unsigned long long*>(searches);
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0) {
    const int64_t groups = n / 4;
    const auto blocks = (unsigned)((groups + kThreads - 1) / kThreads);
    rekey_rank1_kernel<int4, 4><<<blocks, kThreads, 0, st>>>(
        static_cast<int4*>(table), p, groups, inv, found);
  } else {
    const auto blocks = (unsigned)((n + kThreads - 1) / kThreads);
    rekey_rank1_kernel<int32_t, 1><<<blocks, kThreads, 0, st>>>(
        static_cast<int32_t*>(table), p, n, inv, found);
  }
  return cudaGetLastError();
}
