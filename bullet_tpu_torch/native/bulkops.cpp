// Native bulk-ingest helpers: single-pass replacements for the numpy
// stages that dominate put_bulk's host time at 1M-op batches (profiled:
// argsort-based grouping ~0.37 s, float64 key transform ~0.53 s).
//
// Both must be BIT-IDENTICAL to their Python twins (tested):
//  * bk_group_positions  <-> models/netsim.py::_group_positions
//  * bk_number_keys      <-> utils/encode.py::number_keys_np +
//                            bulk_encode_numbers' canonical intern bits

//  * bk_reduce_flat_ops   <-> ops/packed.py::reduce_flat_ops (numpy path)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct OpRow {
  uint64_t pslot;
  int64_t k1, k2;
};

// LSD radix sort by pslot, 16-bit digits, low passes only up to the key's
// actual bit width (pslot is block-major < 2^31 in block mode, < 2^42
// generic). Stable and ascending — the same order np.argsort(pslot) gives,
// and group identity is all the downstream scan needs.
void radix_by_pslot(std::vector<OpRow>& rows, uint64_t max_key) {
  std::vector<OpRow> tmp(rows.size());
  uint64_t count[1 << 16];
  for (int shift = 0; shift < 64 && (max_key >> shift); shift += 16) {
    std::memset(count, 0, sizeof(count));
    for (const OpRow& r : rows) ++count[(r.pslot >> shift) & 0xFFFF];
    uint64_t pos = 0;
    for (int d = 0; d < (1 << 16); ++d) {
      uint64_t c = count[d];
      count[d] = pos;
      pos += c;
    }
    for (const OpRow& r : rows) tmp[count[(r.pslot >> shift) & 0xFFFF]++] = r;
    rows.swap(tmp);
  }
}

}  // namespace

extern "C" {

// O(n) counting pass: seq[i] = position of op i among its peer's ops in
// batch order (stable); counts[p] = number of ops for peer p. The numpy
// twin gets the same answer via a stable argsort + segment arithmetic.
void bk_group_positions(const int32_t* peers, int64_t k, int32_t num_peers,
                        int64_t* seq, int64_t* counts) {
  for (int32_t p = 0; p < num_peers; ++p) counts[p] = 0;
  for (int64_t i = 0; i < k; ++i) {
    seq[i] = counts[peers[i]]++;
  }
}

// Order-preserving (khi, klo) int32 key pair per float64 (the standard
// flip-negatives / set-sign-bit trick, utils/encode.py::number_key), plus
// the canonical intern bits: -0.0 collapses to 0.0, every NaN keys to
// 0xFFF8... (above +inf) and interns as the canonical qNaN.
void bk_number_keys(const double* vals, int64_t k, int32_t* khi,
                    int32_t* klo, uint64_t* raw) {
  const uint64_t kCanonicalNan = 0xFFF8000000000000ull;
  const uint64_t kRawNan = 0x7FF8000000000000ull;
  for (int64_t i = 0; i < k; ++i) {
    double f = vals[i];
    uint64_t b;
    if (f != f) {
      b = kCanonicalNan;
      raw[i] = kRawNan;
    } else {
      if (f == 0.0) f = 0.0;  // collapse -0.0 (JS === identifies them)
      std::memcpy(&b, &f, 8);
      raw[i] = b;
      if (b >> 63) {
        b = ~b;
      } else {
        b |= (1ull << 63);
      }
    }
    // (u32 - 2^31) as int32 == u32 ^ 0x80000000 reinterpreted
    khi[i] = (int32_t)((uint32_t)(b >> 32) ^ 0x80000000u);
    klo[i] = (int32_t)((uint32_t)b ^ 0x80000000u);
  }
}

// Lattice pre-reduction: (cls,khi,klo,vid)-max op per (peer,slot), winners
// emitted ascending by the fused pslot key — bit-identical to the numpy
// argsort+reduceat path in ops/packed.py::reduce_flat_ops (same fused-key
// construction: k1 = cls<<32 | khi+2^31 compared first, k2 =
// (klo+2^31)<<cv_shift | vid among k1-maximal rows; same block-major key
// when block mode is on). Returns the winner count; outputs may alias the
// op count in capacity (n_out <= k always).
int64_t bk_reduce_flat_ops(const int32_t* peer, const int32_t* slot,
                           const int32_t* cls, const int32_t* khi,
                           const int32_t* klo, const int32_t* vid, int64_t k,
                           int32_t block_mode, int64_t bn, int64_t nb,
                           int32_t cv_shift, int64_t vid_mask,
                           int32_t* peer_w, int32_t* slot_w, int32_t* khi_w,
                           int32_t* klo_w, int32_t* cv_w) {
  const int64_t bias = int64_t(1) << 31;
  // Generic mode sorts by peer*stride + slot instead of peer<<32 | slot:
  // identical lexicographic (peer, slot) order, but the tighter key usually
  // drops one 16-bit radix pass (e.g. 30 bits at P=1024 x N=1M vs 42).
  uint64_t stride = 1;
  if (!block_mode) {
    int32_t max_slot = 0;
    for (int64_t i = 0; i < k; ++i)
      if (slot[i] > max_slot) max_slot = slot[i];
    stride = static_cast<uint64_t>(max_slot) + 1;
  }
  std::vector<OpRow> rows;
  rows.reserve(static_cast<size_t>(k));
  uint64_t max_key = 0;
  for (int64_t i = 0; i < k; ++i) {
    if (cls[i] <= 0) continue;  // cls>0 keep-filter (padding never wins)
    uint64_t ps;
    if (block_mode) {
      int64_t p = peer[i], s = slot[i];
      uint64_t block = static_cast<uint64_t>((p >> 3) * nb + s / bn);
      ps = (block << 14) | (static_cast<uint64_t>(p & 7) << 11) |
           static_cast<uint64_t>(s % bn);
    } else {
      ps = static_cast<uint64_t>(static_cast<uint32_t>(peer[i])) * stride +
           static_cast<uint32_t>(slot[i]);
    }
    if (ps > max_key) max_key = ps;
    int64_t k1 = (static_cast<int64_t>(cls[i]) << 32) | (khi[i] + bias);
    int64_t k2 = ((klo[i] + bias) << cv_shift) | static_cast<int64_t>(vid[i]);
    rows.push_back({ps, k1, k2});
  }
  if (rows.empty()) return 0;
  radix_by_pslot(rows, max_key);
  int64_t n_out = -1;
  uint64_t cur = ~0ull;
  int64_t m1 = 0, m2 = 0;
  auto emit = [&](int64_t at, uint64_t key) {
    int64_t cls_w = m1 >> 32;
    khi_w[at] = static_cast<int32_t>((m1 & 0xFFFFFFFFll) - bias);
    klo_w[at] = static_cast<int32_t>((m2 >> cv_shift) - bias);
    cv_w[at] = static_cast<int32_t>((cls_w << cv_shift) | (m2 & vid_mask));
    if (block_mode) {
      uint64_t blk = key >> 14;
      peer_w[at] = static_cast<int32_t>((blk / nb) * 8 + ((key >> 11) & 7));
      slot_w[at] = static_cast<int32_t>((blk % nb) * bn + (key & 0x7FF));
    } else {
      peer_w[at] = static_cast<int32_t>(key / stride);
      slot_w[at] = static_cast<int32_t>(key % stride);
    }
  };
  for (const OpRow& r : rows) {
    if (r.pslot != cur) {
      if (n_out >= 0) emit(n_out, cur);
      ++n_out;
      cur = r.pslot;
      m1 = r.k1;
      m2 = r.k2;
    } else if (r.k1 > m1) {
      m1 = r.k1;
      m2 = r.k2;
    } else if (r.k1 == m1 && r.k2 > m2) {
      m2 = r.k2;
    }
  }
  emit(n_out, cur);
  return n_out + 1;
}

// Rank-layout twin of bk_reduce_flat_ops: the winner key fuses into ONE
// int64 (rank<<32 | cv, both fields non-negative int32), so the grouped
// scan keeps a single max — bit-identical to
// ops/rank.py::reduce_flat_ops_rank's numpy path. Keep-filter is the cv
// class bits (cv>>cv_shift > 0; rank 0 rows are absent padding).
int64_t bk_reduce_flat_ops_rank(const int32_t* peer, const int32_t* slot,
                                const int32_t* rank, const int32_t* cv,
                                int64_t k, int32_t block_mode, int64_t bn,
                                int64_t nb, int32_t cv_shift,
                                int32_t* peer_w, int32_t* slot_w,
                                int32_t* rank_w, int32_t* cv_w) {
  uint64_t stride = 1;
  if (!block_mode) {
    int32_t max_slot = 0;
    for (int64_t i = 0; i < k; ++i)
      if (slot[i] > max_slot) max_slot = slot[i];
    stride = static_cast<uint64_t>(max_slot) + 1;
  }
  std::vector<OpRow> rows;
  rows.reserve(static_cast<size_t>(k));
  uint64_t max_key = 0;
  for (int64_t i = 0; i < k; ++i) {
    if ((cv[i] >> cv_shift) <= 0) continue;
    uint64_t ps;
    if (block_mode) {
      int64_t p = peer[i], s = slot[i];
      uint64_t block = static_cast<uint64_t>((p >> 3) * nb + s / bn);
      ps = (block << 14) | (static_cast<uint64_t>(p & 7) << 11) |
           static_cast<uint64_t>(s % bn);
    } else {
      ps = static_cast<uint64_t>(static_cast<uint32_t>(peer[i])) * stride +
           static_cast<uint32_t>(slot[i]);
    }
    if (ps > max_key) max_key = ps;
    int64_t w = (static_cast<int64_t>(rank[i]) << 32) |
                static_cast<uint32_t>(cv[i]);
    rows.push_back({ps, w, 0});
  }
  if (rows.empty()) return 0;
  radix_by_pslot(rows, max_key);
  int64_t n_out = -1;
  uint64_t cur = ~0ull;
  int64_t m1 = 0;
  auto emit = [&](int64_t at, uint64_t key) {
    rank_w[at] = static_cast<int32_t>(m1 >> 32);
    cv_w[at] = static_cast<int32_t>(m1 & 0xFFFFFFFFll);
    if (block_mode) {
      uint64_t blk = key >> 14;
      peer_w[at] = static_cast<int32_t>((blk / nb) * 8 + ((key >> 11) & 7));
      slot_w[at] = static_cast<int32_t>((blk % nb) * bn + (key & 0x7FF));
    } else {
      peer_w[at] = static_cast<int32_t>(key / stride);
      slot_w[at] = static_cast<int32_t>(key % stride);
    }
  };
  for (const OpRow& r : rows) {
    if (r.pslot != cur) {
      if (n_out >= 0) emit(n_out, cur);
      ++n_out;
      cur = r.pslot;
      m1 = r.k1;
    } else if (r.k1 > m1) {
      m1 = r.k1;
    }
  }
  emit(n_out, cur);
  return n_out + 1;
}

// ABI version of this library's bk_* surface. Bump whenever an exported
// function's SIGNATURE changes (not just when symbols appear): the loader
// rejects mismatches and rebuilds — a name-only probe let a stale .so with
// the old 16-arg bk_rank_insert_batch receive the new 17-arg call, writing
// new_ranks into the sranks pool and leaving the caller's array garbage.
extern "C" int32_t bk_abi_version() { return 2; }

// Single-pass sort-merge twin of ops/rank.py::RankIndex.insert_batch's
// numpy chain (searchsorted x3 + lexsort + np.insert x3 + gap spread +
// monotonicity check — ~4.4 s per 1M-value insert at the north-star
// shape; this pass is ~10x). BIT-IDENTICAL contract:
//  * batch sorted by (k1, k2, vid) — vid order preserved for equal keys;
//  * equal (k1, k2) ties with STORED elements land after the stored run
//    (numpy side='right');
//  * the t-th of g items in gap (lo, hi) gets lo + (hi-lo)*(t+1)/(g+1)
//    (non-negative int64 floor division, same as numpy's //);
//  * returns 1 when the merged rank sequence is not strictly increasing
//    from >= 1 (the caller respreads), else 0.
// out_new_ranks is aligned with the INPUT batch order (the caller does
// rank_of[vids] = out_new_ranks on the unsorted vids array);
// out_sranks is the merged-order rank sequence (the monotonicity check
// already walks it — emitting it lets the caller keep ranks in sorted
// order WITHOUT an O(index) random gather through rank_of, which on a
// 1-CPU host cost more than this whole merge at multi-million indexes).
// The batch keys arrive as raw int32 (cls, khi, klo) triples and fuse
// inline (k1 = cls·2^32 | (khi + bias), k2 = klo + bias —
// RankIndex._fuse exactly), saving the Python-side int64 conversion
// passes.
int32_t bk_rank_insert_batch(
    const int64_t* sk1, const int64_t* sk2, const int64_t* svids,
    const int64_t* sranks, int64_t m,
    const int32_t* cls, const int32_t* khi, const int32_t* klo,
    const int64_t* bvids, int64_t k,
    int64_t bias, int64_t rank_span,
    int64_t* out_k1, int64_t* out_k2, int64_t* out_svids,
    int64_t* out_sranks, int64_t* out_new_ranks) {
  // stable LSD radix by (k1, k2): k2-low passes first, then k1. The fused
  // keys are non-negative (k2 = klo + 2^31 bias < 2^32, k1 = cls·2^32 +
  // biased khi < ~2^35), and vids ascend in input order, so stability
  // alone yields the (k1, k2, vid) order. ~5 counting passes beat a
  // comparator sort ~5x at 1M rows.
  struct RankRow {
    uint64_t k1, k2;
    int64_t idx;
  };
  std::vector<int64_t> fk1(k), fk2(k);
  std::vector<RankRow> rows(k);
  uint64_t max_k1 = 0, max_k2 = 0;
  for (int64_t i = 0; i < k; ++i) {
    fk1[i] = (static_cast<int64_t>(cls[i]) << 32) |
             (static_cast<int64_t>(khi[i]) + bias);
    fk2[i] = static_cast<int64_t>(klo[i]) + bias;
    rows[i] = {static_cast<uint64_t>(fk1[i]), static_cast<uint64_t>(fk2[i]),
               i};
    if (rows[i].k1 > max_k1) max_k1 = rows[i].k1;
    if (rows[i].k2 > max_k2) max_k2 = rows[i].k2;
  }
  const int64_t* bk1 = fk1.data();
  const int64_t* bk2 = fk2.data();
  {
    std::vector<RankRow> tmp(k);
    uint64_t count[1 << 16];
    auto pass = [&](auto key_of) {
      std::memset(count, 0, sizeof(count));
      for (const RankRow& r : rows) ++count[key_of(r)];
      uint64_t pos = 0;
      for (int d = 0; d < (1 << 16); ++d) {
        uint64_t c = count[d];
        count[d] = pos;
        pos += c;
      }
      for (const RankRow& r : rows) tmp[count[key_of(r)]++] = r;
      rows.swap(tmp);
    };
    bool vids_ascending = true;
    for (int64_t i = 1; i < k && vids_ascending; ++i)
      vids_ascending = bvids[i - 1] <= bvids[i];
    if (!vids_ascending) {
      // callers outside _sync_rank_index may pass unordered vids; the
      // equal-key tiebreak is vid, so seed stability with vid passes
      uint64_t max_vid = 0;
      for (int64_t i = 0; i < k; ++i)
        if (static_cast<uint64_t>(bvids[i]) > max_vid)
          max_vid = static_cast<uint64_t>(bvids[i]);
      for (int shift = 0; shift < 64 && (max_vid >> shift); shift += 16)
        pass([shift, bvids](const RankRow& r) {
          return (static_cast<uint64_t>(bvids[r.idx]) >> shift) & 0xFFFF;
        });
    }
    for (int shift = 0; shift < 64 && (max_k2 >> shift); shift += 16)
      pass([shift](const RankRow& r) { return (r.k2 >> shift) & 0xFFFF; });
    for (int shift = 0; shift < 64 && (max_k1 >> shift); shift += 16)
      pass([shift](const RankRow& r) { return (r.k1 >> shift) & 0xFFFF; });
  }
  std::vector<int64_t> idx(k);
  for (int64_t i = 0; i < k; ++i) idx[i] = rows[i].idx;
  int64_t i = 0, o = 0, j = 0;
  int64_t prev_rank = 0;  // first emitted rank must be >= 1
  int32_t respread = 0;
  while (j < k) {
    const int64_t q = idx[j];
    // stored elements <= the next batch key (stored wins ties)
    while (i < m &&
           (sk1[i] < bk1[q] || (sk1[i] == bk1[q] && sk2[i] <= bk2[q]))) {
      out_k1[o] = sk1[i];
      out_k2[o] = sk2[i];
      out_svids[o] = svids[i];
      out_sranks[o] = sranks[i];
      if (sranks[i] <= prev_rank) respread = 1;
      prev_rank = sranks[i];
      ++i;
      ++o;
    }
    // the run of batch items landing in this gap (all strictly below
    // stored[i]; the run is non-empty — the advance above stopped on q)
    const int64_t lo = i > 0 ? sranks[i - 1] : 0;
    const int64_t hi = i < m ? sranks[i] : rank_span;
    int64_t g = 0;
    while (j + g < k) {
      const int64_t q2 = idx[j + g];
      if (i < m && !(bk1[q2] < sk1[i] ||
                     (bk1[q2] == sk1[i] && bk2[q2] < sk2[i])))
        break;
      ++g;
    }
    for (int64_t t = 0; t < g; ++t) {
      const int64_t q2 = idx[j + t];
      const int64_t r = lo + (hi - lo) * (t + 1) / (g + 1);
      out_new_ranks[q2] = r;
      out_k1[o] = bk1[q2];
      out_k2[o] = bk2[q2];
      out_svids[o] = bvids[q2];
      out_sranks[o] = r;
      if (r <= prev_rank) respread = 1;
      prev_rank = r;
      ++o;
    }
    j += g;
  }
  while (i < m) {
    out_k1[o] = sk1[i];
    out_k2[o] = sk2[i];
    out_svids[o] = svids[i];
    out_sranks[o] = sranks[i];
    if (sranks[i] <= prev_rank) respread = 1;
    prev_rank = sranks[i];
    ++i;
    ++o;
  }
  return respread;
}

}  // extern "C"
