// Shared device helpers for every table layout: the entry types with their
// lexicographic priority compares, the Jacobi column sweep that one
// ring/chain round runs, and block reductions.
//
// An entry type E gives the field count E::NF and E::gt(b, a), "b beats a
// strictly", comparing SIGNED int32 keys (the packed family also E::eq(b,
// a), "equal keys", and E::gt_at(b, at), gt against the entry whose field
// f is at(f), reading each field only when the compare reaches it):
//   DenseEntry<false>: fields (cls, khi, klo, vid, writer, ctr, tick), the
//     TableState order, keyed (cls, khi, klo, vid, writer, ctr) (reference);
//   DenseEntry<true>:  the same fields keyed (ctr, cls, khi, klo, vid,
//     writer) (lww); tick is carried, never compared;
//   LeanEntry:         the value keys (cls, khi, klo, vid) of a dense table,
//     keyed in that order: lean gossip merges these four and leaves writer,
//     ctr and tick alone (reference mode only);
//   PackedEntry:       fields (khi, klo, cv) with cv = cls << 28 | vid, keyed
//     (cv >> 28, khi, klo, cv) == (cls, khi, klo, vid);
//   RankEntry:         fields (rank, cv), keyed by rank alone (distinct vids
//     have distinct ranks, so the cv tiebreak never fires);
//   Rank1Entry:        the field (rank), keyed by rank; 0 is absent.
// In all three packed-family layouts equal keys mean equal entries, so the
// lexmax of a set of entries does not depend on the order of the compares.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bt {

template <int N>
struct Fields {
  int32_t* f[N];
};

template <int N>
struct CFields {
  const int32_t* f[N];
};

constexpr int kCvShift = 28;

template <bool LWW>
struct DenseEntry {
  static constexpr int NF = 7;
  __device__ __forceinline__ static bool gt(const int32_t (&b)[NF],
                                            const int32_t (&a)[NF]) {
    if (LWW && b[5] != a[5]) return b[5] > a[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (b[i] != a[i]) return b[i] > a[i];
    }
    if (!LWW && b[5] != a[5]) return b[5] > a[5];
    return false;
  }
};

struct LeanEntry {
  static constexpr int NF = 4;
  __device__ __forceinline__ static bool gt(const int32_t (&b)[NF],
                                            const int32_t (&a)[NF]) {
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      if (b[i] != a[i]) return b[i] > a[i];
    }
    return false;
  }
};

struct PackedEntry {
  static constexpr int NF = 3;
  template <typename At>
  __device__ __forceinline__ static bool gt_at(const int32_t (&b)[NF], At at) {
    const int32_t acv = at(2);
    const int32_t bc = b[2] >> kCvShift, ac = acv >> kCvShift;
    if (bc != ac) return bc > ac;
    const int32_t akhi = at(0);
    if (b[0] != akhi) return b[0] > akhi;
    const int32_t aklo = at(1);
    if (b[1] != aklo) return b[1] > aklo;
    return b[2] > acv;
  }
  __device__ __forceinline__ static bool gt(const int32_t (&b)[NF],
                                            const int32_t (&a)[NF]) {
    return gt_at(b, [&](int f) { return a[f]; });
  }
  // equal keys (cls, khi, klo, vid): the three fields equal
  __device__ __forceinline__ static bool eq(const int32_t (&b)[NF],
                                            const int32_t (&a)[NF]) {
    return b[0] == a[0] && b[1] == a[1] && b[2] == a[2];
  }
  // a live op: cls (the top bits of cv) > 0
  __device__ __forceinline__ static bool present(const int32_t (&v)[NF]) {
    return (v[2] >> kCvShift) > 0;
  }
};

struct RankEntry {
  static constexpr int NF = 2;
  template <typename At>
  __device__ __forceinline__ static bool gt_at(const int32_t (&b)[NF], At at) {
    return b[0] > at(0);
  }
  __device__ __forceinline__ static bool gt(const int32_t (&b)[NF],
                                            const int32_t (&a)[NF]) {
    return gt_at(b, [&](int f) { return a[f]; });
  }
  // equal keys: the rank alone
  __device__ __forceinline__ static bool eq(const int32_t (&b)[NF],
                                            const int32_t (&a)[NF]) {
    return b[0] == a[0];
  }
  __device__ __forceinline__ static bool present(const int32_t (&v)[NF]) {
    return (v[1] >> kCvShift) > 0;
  }
};

struct Rank1Entry {
  static constexpr int NF = 1;
  template <typename At>
  __device__ __forceinline__ static bool gt_at(const int32_t (&b)[NF], At at) {
    return b[0] > at(0);
  }
  __device__ __forceinline__ static bool gt(const int32_t (&b)[NF],
                                            const int32_t (&a)[NF]) {
    return gt_at(b, [&](int f) { return a[f]; });
  }
  __device__ __forceinline__ static bool eq(const int32_t (&b)[NF],
                                            const int32_t (&a)[NF]) {
    return b[0] == a[0];
  }
  __device__ __forceinline__ static bool present(const int32_t (&v)[NF]) {
    return v[0] > 0;
  }
};

// Runs Launch<E>::run(args...) for the entry type of a packed-family table
// of nf fields: 1 = rank1, 2 = rank, 3 = packed.
template <template <typename> class Launch, typename... Args>
cudaError_t dispatch_nf(int nf, Args... args) {
  switch (nf) {
    case 1:
      return Launch<Rank1Entry>::run(args...);
    case 2:
      return Launch<RankEntry>::run(args...);
    case 3:
      return Launch<PackedEntry>::run(args...);
    default:
      return cudaErrorInvalidValue;
  }
}

// Runs Launch<E>::run(args...) for the entry type of a dense-family table
// of nf fields: 4 = lean (the value keys only), 7 = full metadata under the
// reference (lww = 0) or lww (lww = 1) priority order.
template <template <typename> class Launch, typename... Args>
cudaError_t dispatch_dense(int nf, int lww, Args... args) {
  if (nf == 4) return Launch<LeanEntry>::run(args...);
  if (nf != 7) return cudaErrorInvalidValue;
  return lww ? Launch<DenseEntry<true>>::run(args...)
             : Launch<DenseEntry<false>>::run(args...);
}

template <int N>
__device__ __forceinline__ void copy_entry(int32_t (&dst)[N], const int32_t (&src)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = src[i];
}

template <int N>
__device__ __forceinline__ void zero_entry(int32_t (&dst)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = 0;
}

template <int N>
__device__ __forceinline__ void load_entry(int32_t (&dst)[N], const Fields<N>& t,
                                           int64_t idx) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = t.f[i][idx];
}

template <int N>
__device__ __forceinline__ void store_entry(const Fields<N>& t, int64_t idx,
                                            const int32_t (&src)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) t.f[i][idx] = src[i];
}

// One ring (wrap) or chain round on column `col` of a [p, n] table: row
// r <- lexmax(lexmax(row r, row r-1), row r+1), every neighbour taken from
// the PRE-round table `src`, the result written to `dst`. src and dst may
// be one table: the thread keeps the pre-round rows r-1 and r, and the
// original row 0 (the ring's wrap-around for row p-1), in registers, so
// overwriting row r never corrupts a later read. Without STORE nothing is
// written (the count-only probe). A chain's missing neighbour is an
// all-zero entry that is still compared. Returns the changed count
// sum(gt1) + sum(gt2) (an entry can count twice).
template <typename E, bool STORE = true>
__device__ __forceinline__ unsigned sweep_column(const Fields<E::NF>& src,
                                                 const Fields<E::NF>& dst, int64_t col,
                                                 int p, int64_t n, bool wrap) {
  constexpr int NF = E::NF;
  int32_t row0[NF], up[NF], cur[NF], down[NF];
  load_entry(row0, src, col);
  if (wrap) {
    load_entry(up, src, (int64_t)(p - 1) * n + col);
  } else {
    zero_entry(up);
  }
  copy_entry(cur, row0);
  unsigned changed = 0;
  for (int r = 0; r < p; ++r) {
    if (r + 1 < p) {
      load_entry(down, src, (int64_t)(r + 1) * n + col);
    } else if (wrap) {
      copy_entry(down, row0);
    } else {
      zero_entry(down);
    }
    int32_t m[NF];
    copy_entry(m, cur);
    if (E::gt(up, m)) {
      copy_entry(m, up);
      ++changed;
    }
    if (E::gt(down, m)) {
      copy_entry(m, down);
      ++changed;
    }
    if (STORE) store_entry(dst, (int64_t)r * n + col, m);
    copy_entry(up, cur);
    copy_entry(cur, down);
  }
  return changed;
}

// The round in place on one table.
template <typename E, bool STORE = true>
__device__ __forceinline__ unsigned sweep_column(const Fields<E::NF>& t, int64_t col,
                                                 int p, int64_t n, bool wrap) {
  return sweep_column<E, STORE>(t, t, col, p, n, wrap);
}

// Block-wide sum; the result is valid in thread 0. Every thread of the
// block must call it (it synchronises). blockDim.x is a multiple of 32.
__device__ __forceinline__ unsigned block_sum(unsigned v) {
  __shared__ unsigned warp_part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // warp_part may still be read by an earlier call
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  const int warps = blockDim.x >> 5;
  v = (threadIdx.x < warps) ? warp_part[threadIdx.x] : 0u;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Block-wide max of non-negative ints; the result is valid in thread 0.
__device__ __forceinline__ int block_max(int v) {
  __shared__ int warp_part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  __syncthreads();
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  const int warps = blockDim.x >> 5;
  v = (threadIdx.x < warps) ? warp_part[threadIdx.x] : 0;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

template <int N>
inline Fields<N> fields_of(void* const* ptrs) {
  Fields<N> t;
  for (int f = 0; f < N; ++f) t.f[f] = static_cast<int32_t*>(ptrs[f]);
  return t;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace bt
