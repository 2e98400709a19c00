// Helpers of the column passes (converge_columns.cu on one card,
// converge_columns_shard.cu on a mesh): 16-byte copies into shared memory,
// and the summary of a stretch of a column's rows by its runs of rows that
// do not hold the column's join.
#pragma once
#include <cuda_runtime.h>

namespace bt {

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

}  // namespace bt
