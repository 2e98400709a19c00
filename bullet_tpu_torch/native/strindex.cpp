// Native lexicographic gap-rank index.
//
// Backs utils/encode.py::StringOrderIndex: every interned string gets
// a rank in [0, 2^62) preserving lexicographic order, new strings take the
// midpoint of their neighbors' ranks, and exhausted gaps trigger an even
// respread. The pure-Python implementation pays O(n) per insert for its
// sorted-list bookkeeping; this std::map-based version is O(log n) and is
// the framework's host-side native runtime component (the reference has no
// native code — SURVEY.md §2 — so this is additive, with the Python
// implementation as a always-available fallback).
//
// The gap/respread arithmetic deliberately mirrors the Python implementation
// exactly (tests assert bit-identical ranks), because ranks feed the device
// order keys.

#include <cstdint>
#include <map>
#include <string>

namespace {

constexpr uint64_t kRankSpace = 1ULL << 62;

struct Index {
  std::map<std::string, uint64_t> ranks;
  uint64_t rebalances = 0;

  void respread() {
    const uint64_t n = ranks.size();
    const uint64_t gap = kRankSpace / (n + 1);
    uint64_t r = gap;
    for (auto& kv : ranks) {
      kv.second = r;
      r += gap;
    }
    rebalances++;
  }
};

}  // namespace

extern "C" {

void* six_new() { return new Index(); }

void six_free(void* h) { delete static_cast<Index*>(h); }

uint64_t six_size(void* h) { return static_cast<Index*>(h)->ranks.size(); }

uint64_t six_rebalances(void* h) {
  return static_cast<Index*>(h)->rebalances;
}

// Look up an existing rank. Keys are length-delimited byte strings (the
// Python side passes UTF-16-BE encodings, whose byte order matches JS's
// UTF-16 code-unit comparison; they contain NUL bytes, hence the explicit
// length). Returns 0 on success, -1 if absent.
int six_rank(void* h, const char* s, int64_t len, uint64_t* rank_out) {
  Index& idx = *static_cast<Index*>(h);
  auto it = idx.ranks.find(std::string(s, static_cast<size_t>(len)));
  if (it == idx.ranks.end()) return -1;
  *rank_out = it->second;
  return 0;
}

// Insert (idempotent). Returns 1 if a respread happened, 0 otherwise.
// The assigned rank is written to *rank_out.
int six_insert(void* h, const char* s, int64_t len, uint64_t* rank_out) {
  Index& idx = *static_cast<Index*>(h);
  std::string key(s, static_cast<size_t>(len));
  auto it = idx.ranks.find(key);
  if (it != idx.ranks.end()) {
    *rank_out = it->second;
    return 0;
  }
  auto hi_it = idx.ranks.lower_bound(key);
  const int64_t hi = (hi_it != idx.ranks.end())
                         ? static_cast<int64_t>(hi_it->second)
                         : static_cast<int64_t>(kRankSpace);
  const int64_t lo = (hi_it != idx.ranks.begin())
                         ? static_cast<int64_t>(std::prev(hi_it)->second)
                         : -1;
  if (hi - lo < 2) {
    idx.ranks.emplace(key, 0);
    idx.respread();
    *rank_out = idx.ranks[key];
    return 1;
  }
  // lo >= -1 and hi >= lo + 2 ⇒ lo + hi >= 1, so truncating division
  // equals Python's floor division here.
  const uint64_t rank = static_cast<uint64_t>((lo + hi) / 2);
  idx.ranks.emplace(std::move(key), rank);
  *rank_out = rank;
  return 0;
}

// Batch insert of length-delimited keys, in order (rank/respread sequence
// is bit-identical to n scalar six_insert calls). ranks_out[i] holds key
// i's rank AFTER the whole batch — a mid-batch respread re-resolves every
// rank at the end, so callers never see stale values. Returns the number
// of respreads triggered.
int64_t six_insert_batch(void* h, const char* blob, const int64_t* starts,
                         const int64_t* lens, int64_t n, uint64_t* ranks_out) {
  Index& idx = *static_cast<Index*>(h);
  const uint64_t reb0 = idx.rebalances;
  for (int64_t i = 0; i < n; ++i) {
    six_insert(h, blob + starts[i], lens[i], &ranks_out[i]);
  }
  const uint64_t d = idx.rebalances - reb0;
  if (d) {
    for (int64_t i = 0; i < n; ++i) {
      auto it = idx.ranks.find(
          std::string(blob + starts[i], static_cast<size_t>(lens[i])));
      ranks_out[i] = it->second;
    }
  }
  return static_cast<int64_t>(d);
}

// Batch rank lookup. Returns 0 on success, -1 if any key is absent.
int six_rank_batch(void* h, const char* blob, const int64_t* starts,
                   const int64_t* lens, int64_t n, uint64_t* ranks_out) {
  Index& idx = *static_cast<Index*>(h);
  for (int64_t i = 0; i < n; ++i) {
    auto it = idx.ranks.find(
        std::string(blob + starts[i], static_cast<size_t>(lens[i])));
    if (it == idx.ranks.end()) return -1;
    ranks_out[i] = it->second;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Numeric value interner: canonical float64 bit pattern -> dense vid.
//
// The bulk-ingestion data loader (models/netsim.py put_bulk) interns every
// distinct numeric value; doing that per value in Python costs ~8 µs each.
// This map batch-assigns contiguous vids at C++ speed; the Python side
// extends its vid-indexed tables with single vectorized appends.
//
// Open-addressing flat map (same idiom as pathintern.cpp's FlatMap):
// ~4x faster than std::unordered_map for the 1M-novel-values batch because
// inserts are node-allocation-free and the batch reserves up front. The
// all-ones key doubles as the empty-slot sentinel; it cannot collide with a
// real key (callers canonicalize NaN bit patterns before lookup), but a
// dedicated side slot keeps the map correct even if one ever arrives.

#include <vector>

namespace {

constexpr uint64_t kNviEmpty = ~0ULL;

inline uint64_t nvi_mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct NumInterner {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  size_t mask, count = 0;
  bool has_empty_key = false;  // side slot for the sentinel bit pattern
  int32_t empty_vid = 0;

  NumInterner() : keys(1 << 12, kNviEmpty), vals(1 << 12, 0), mask((1 << 12) - 1) {}

  void grow(size_t cap) {
    std::vector<uint64_t> old_keys = std::move(keys);
    std::vector<int32_t> old_vals = std::move(vals);
    keys.assign(cap, kNviEmpty);
    vals.assign(cap, 0);
    mask = cap - 1;
    for (size_t i = 0; i < old_keys.size(); ++i) {
      if (old_keys[i] != kNviEmpty) {
        size_t j = static_cast<size_t>(nvi_mix64(old_keys[i])) & mask;
        while (keys[j] != kNviEmpty) j = (j + 1) & mask;
        keys[j] = old_keys[i];
        vals[j] = old_vals[i];
      }
    }
  }

  void reserve(size_t n) {
    size_t need = (n * 4) / 3 + 1;
    size_t cap = mask + 1;
    while (cap < need) cap <<= 1;
    if (cap != mask + 1) grow(cap);
  }

  inline size_t find_slot(uint64_t key, bool* found) const {
    size_t i = static_cast<size_t>(nvi_mix64(key)) & mask;
    while (keys[i] != kNviEmpty) {
      if (keys[i] == key) {
        *found = true;
        return i;
      }
      i = (i + 1) & mask;
    }
    *found = false;
    return i;
  }

  inline void insert_at(size_t slot, uint64_t key, int32_t v) {
    keys[slot] = key;
    vals[slot] = v;
    if (++count * 4 > (mask + 1) * 3) grow((mask + 1) * 2);
  }

  size_t size() const { return count + (has_empty_key ? 1 : 0); }
};

}  // namespace

extern "C" {

void* nvi_new() { return new NumInterner(); }

void nvi_free(void* h) { delete static_cast<NumInterner*>(h); }

uint64_t nvi_size(void* h) { return static_cast<NumInterner*>(h)->size(); }

// Single lookup: returns vid or -1.
int32_t nvi_lookup(void* h, uint64_t bits) {
  auto& m = *static_cast<NumInterner*>(h);
  if (bits == kNviEmpty) return m.has_empty_key ? m.empty_vid : -1;
  bool found;
  size_t slot = m.find_slot(bits, &found);
  return found ? m.vals[slot] : -1;
}

void nvi_insert(void* h, uint64_t bits, int32_t vid) {
  auto& m = *static_cast<NumInterner*>(h);
  if (bits == kNviEmpty) {
    if (!m.has_empty_key) {
      m.has_empty_key = true;
      m.empty_vid = vid;
    }
    return;
  }
  bool found;
  size_t slot = m.find_slot(bits, &found);
  if (!found) m.insert_at(slot, bits, vid);
}

// Batch intern: for each bits[i], write its vid to vids[i]; unseen values
// get sequential vids starting at next_vid (first-occurrence order) and
// their indices are recorded in new_idx (caller-allocated, size n).
// Returns the number of new values.
int64_t nvi_intern_batch(void* h, const uint64_t* bits, int64_t n,
                         int32_t next_vid, int32_t* vids, int64_t* new_idx) {
  auto& m = *static_cast<NumInterner*>(h);
  m.reserve(m.count + static_cast<size_t>(n));
  int64_t n_new = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t key = bits[i];
    if (key == kNviEmpty) {
      if (!m.has_empty_key) {
        m.has_empty_key = true;
        m.empty_vid = next_vid + static_cast<int32_t>(n_new);
        new_idx[n_new++] = i;
      }
      vids[i] = m.empty_vid;
      continue;
    }
    bool found;
    size_t slot = m.find_slot(key, &found);
    if (found) {
      vids[i] = m.vals[slot];
    } else {
      const int32_t vid = next_vid + static_cast<int32_t>(n_new);
      m.insert_at(slot, key, vid);
      vids[i] = vid;
      new_idx[n_new++] = i;
    }
  }
  return n_new;
}

}  // extern "C"
