// Native bulk path interner — the host ingestion hot path.
//
// Python's PathInterner (utils/paths.py) assigns dense ids to slash paths in
// first-intern order, auto-creating ancestor prefixes, and tracks the tree
// (parent id, last-segment id, children). The pure-Python loop tops out
// around 0.4M novel paths/s; bulk ingestion of graph-sized workloads (the
// reference's store walk emits one leaf path per entry,
// bullet-network-sync.js:592-664) needs millions/s.
//
// Design for allocation-free steady state:
//   * paths resolve by walking (parent_id, segment_id) EDGES through an
//     open-addressing flat map (splitmix64-mixed keys, linear probing) — no
//     per-prefix string hashing, no node allocations;
//   * segment strings intern once into an arena-backed flat map (FNV-1a);
//   * the tree is intrusive (first_child/last_child/next_sibling vectors);
//   * full path strings are reconstructed on demand, never stored.
//
// Id assignment, normalization (split on '/', drop empty segments),
// segment-id assignment, and children order are bit-identical to the Python
// implementation (enforced by tests/test_native.py fuzz equivalence).
//
// C ABI only (loaded via ctypes; pybind11 is not available in this image).

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

inline uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<uint8_t>(s[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

constexpr uint64_t kEmpty = ~0ULL;  // unreachable edge key (ids are int32)

// Open-addressing uint64 -> int32 map (linear probing, 0.75 load factor).
struct FlatMap {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  size_t mask = 0, count = 0;

  FlatMap() { grow(1 << 12); }

  void grow(size_t cap) {
    std::vector<uint64_t> old_keys = std::move(keys);
    std::vector<int32_t> old_vals = std::move(vals);
    keys.assign(cap, kEmpty);
    vals.assign(cap, 0);
    mask = cap - 1;
    for (size_t i = 0; i < old_keys.size(); ++i) {
      if (old_keys[i] != kEmpty) {
        size_t j = static_cast<size_t>(mix64(old_keys[i])) & mask;
        while (keys[j] != kEmpty) j = (j + 1) & mask;
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

  // Returns the slot for key; vals[slot] is valid iff found (else the slot
  // is the insertion point).
  inline size_t find_slot(uint64_t key, bool* found) const {
    size_t i = static_cast<size_t>(mix64(key)) & mask;
    while (keys[i] != kEmpty) {
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
};

// Arena-backed string -> dense id map (segments).
struct SegMap {
  std::vector<int64_t> slot_sid;  // -1 = empty
  std::vector<uint64_t> slot_hash;
  std::vector<uint32_t> off, len;  // per sid, into arena
  std::string arena;
  size_t mask = 0, count = 0;

  SegMap() {
    slot_sid.assign(1 << 12, -1);
    slot_hash.assign(1 << 12, 0);
    mask = (1 << 12) - 1;
  }

  inline std::string_view name(int32_t sid) const {
    return {arena.data() + off[sid], len[sid]};
  }

  void grow() {
    size_t cap = (mask + 1) << 1;
    std::vector<int64_t> old_sid = std::move(slot_sid);
    std::vector<uint64_t> old_hash = std::move(slot_hash);
    slot_sid.assign(cap, -1);
    slot_hash.assign(cap, 0);
    mask = cap - 1;
    for (size_t i = 0; i < old_sid.size(); ++i) {
      if (old_sid[i] >= 0) {
        size_t j = static_cast<size_t>(old_hash[i]) & mask;
        while (slot_sid[j] >= 0) j = (j + 1) & mask;
        slot_sid[j] = old_sid[i];
        slot_hash[j] = old_hash[i];
      }
    }
  }

  int32_t find(std::string_view seg) const {
    uint64_t h = fnv1a(seg.data(), seg.size());
    size_t i = static_cast<size_t>(h) & mask;
    while (slot_sid[i] >= 0) {
      if (slot_hash[i] == h &&
          name(static_cast<int32_t>(slot_sid[i])) == seg)
        return static_cast<int32_t>(slot_sid[i]);
      i = (i + 1) & mask;
    }
    return -1;
  }

  int32_t intern(std::string_view seg) {
    uint64_t h = fnv1a(seg.data(), seg.size());
    size_t i = static_cast<size_t>(h) & mask;
    while (slot_sid[i] >= 0) {
      if (slot_hash[i] == h &&
          name(static_cast<int32_t>(slot_sid[i])) == seg)
        return static_cast<int32_t>(slot_sid[i]);
      i = (i + 1) & mask;
    }
    int32_t sid = static_cast<int32_t>(off.size());
    off.push_back(static_cast<uint32_t>(arena.size()));
    len.push_back(static_cast<uint32_t>(seg.size()));
    arena.append(seg.data(), seg.size());
    slot_sid[i] = sid;
    slot_hash[i] = h;
    if (++count * 4 > (mask + 1) * 3) grow();
    return sid;
  }
};

struct PathInterner {
  FlatMap edges;  // (parent_id + 1) << 32 | seg_id  ->  path id
  SegMap segs;
  std::vector<int32_t> parent;
  std::vector<int32_t> seg_id;
  std::vector<int32_t> first_child, last_child, next_sibling;

  // full path reconstruction on demand (paths are NOT stored per id);
  // depth is unbounded — a fixed chain would silently truncate deep paths,
  // breaking the bit-identity contract with the Python PathInterner
  void build_path(int32_t pid, std::string& out) const {
    out.clear();
    if (pid < 0) return;
    thread_local std::vector<int32_t> chain;
    chain.clear();
    for (int32_t cur = pid; cur >= 0; cur = parent[cur]) chain.push_back(cur);
    for (auto it = chain.rbegin(); it != chain.rend(); ++it) {
      if (!out.empty()) out.push_back('/');
      std::string_view seg = segs.name(seg_id[*it]);
      out.append(seg.data(), seg.size());
    }
  }
};

inline uint64_t edge_key(int32_t parent_id, int32_t sid) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(parent_id + 1)) << 32) |
         static_cast<uint32_t>(sid);
}

// Walk one path's segments, interning missing edges. Operates directly on
// the raw bytes (split on '/', skip empty) — no normalized copy needed.
inline int32_t intern_one(PathInterner* pi, const char* s, int64_t len) {
  int32_t parent_id = -1;
  int64_t i = 0;
  while (i < len) {
    while (i < len && s[i] == '/') ++i;
    int64_t j = i;
    while (j < len && s[j] != '/') ++j;
    if (j > i) {
      std::string_view seg(s + i, static_cast<size_t>(j - i));
      int32_t sid = pi->segs.intern(seg);
      uint64_t key = edge_key(parent_id, sid);
      bool found;
      size_t slot = pi->edges.find_slot(key, &found);
      int32_t pid;
      if (found) {
        pid = pi->edges.vals[slot];
      } else {
        pid = static_cast<int32_t>(pi->parent.size());
        pi->edges.insert_at(slot, key, pid);
        pi->parent.push_back(parent_id);
        pi->seg_id.push_back(sid);
        pi->first_child.push_back(-1);
        pi->last_child.push_back(-1);
        pi->next_sibling.push_back(-1);
        if (parent_id >= 0) {
          if (pi->last_child[parent_id] < 0)
            pi->first_child[parent_id] = pid;
          else
            pi->next_sibling[pi->last_child[parent_id]] = pid;
          pi->last_child[parent_id] = pid;
        }
      }
      parent_id = pid;
    }
    i = j;
  }
  return parent_id;  // -1 for the empty path (matches Python)
}

inline int32_t lookup_one(const PathInterner* pi, const char* s, int64_t len) {
  int32_t parent_id = -1;
  bool any = false;
  int64_t i = 0;
  while (i < len) {
    while (i < len && s[i] == '/') ++i;
    int64_t j = i;
    while (j < len && s[j] != '/') ++j;
    if (j > i) {
      any = true;
      int32_t sid =
          pi->segs.find({s + i, static_cast<size_t>(j - i)});
      if (sid < 0) return -1;
      bool found;
      size_t slot = pi->edges.find_slot(edge_key(parent_id, sid), &found);
      if (!found) return -1;
      parent_id = pi->edges.vals[slot];
    }
    i = j;
  }
  return any ? parent_id : -1;
}

}  // namespace

extern "C" {

void* pin_new() { return new PathInterner(); }

void pin_free(void* h) { delete static_cast<PathInterner*>(h); }

uint64_t pin_size(void* h) {
  return static_cast<PathInterner*>(h)->parent.size();
}

uint64_t pin_seg_count(void* h) {
  return static_cast<PathInterner*>(h)->segs.off.size();
}

int32_t pin_intern_one(void* h, const char* s, int64_t len) {
  return intern_one(static_cast<PathInterner*>(h), s, len);
}

// Bulk intern: `buf` holds k concatenated UTF-8 paths addressed by
// (starts[i], lens[i]). Writes the k leaf ids to slots_out.
void pin_intern_batch(void* h, const char* buf, const int64_t* starts,
                      const int64_t* lens, int64_t k, int32_t* slots_out) {
  auto* pi = static_cast<PathInterner*>(h);
  // No up-front reserve(count + k): insert_at's doubling already amortizes
  // growth, and big batches are mostly re-hits — sizing the table for k
  // assumed-novel paths inflated a 60k-unique map to 2M slots (24 MB),
  // turning every probe into a cache miss (~6x slower at 1M-op batches).
  for (int64_t i = 0; i < k; ++i)
    slots_out[i] = intern_one(pi, buf + starts[i], lens[i]);
}

int32_t pin_lookup(void* h, const char* s, int64_t len) {
  return lookup_one(static_cast<PathInterner*>(h), s, len);
}

// Bulk lookup: same addressing as pin_intern_batch; -1 per unknown path.
void pin_lookup_batch(void* h, const char* buf, const int64_t* starts,
                      const int64_t* lens, int64_t k, int32_t* pids_out) {
  const auto* pi = static_cast<const PathInterner*>(h);
  for (int64_t i = 0; i < k; ++i)
    pids_out[i] = lookup_one(pi, buf + starts[i], lens[i]);
}

int32_t pin_parent(void* h, int32_t pid) {
  return static_cast<PathInterner*>(h)->parent[pid];
}

// Structure export for ids [start, end): parent and segment-id arrays.
void pin_export(void* h, int64_t start, int64_t end, int32_t* parent_out,
                int32_t* seg_out) {
  auto* pi = static_cast<PathInterner*>(h);
  std::memcpy(parent_out, pi->parent.data() + start,
              (end - start) * sizeof(int32_t));
  std::memcpy(seg_out, pi->seg_id.data() + start,
              (end - start) * sizeof(int32_t));
}

// Path / segment string access: total blob length for [start, end), then a
// fill call writing concatenated bytes + per-id int64 lengths.
int64_t pin_paths_blob_len(void* h, int64_t start, int64_t end) {
  auto* pi = static_cast<PathInterner*>(h);
  // climb ancestors per id in the requested range — O(range x depth), not
  // O(total) per call (incremental string-cache fills would otherwise be
  // quadratic in interleaved intern/read workloads)
  int64_t total = 0;
  for (int64_t i = start; i < end; ++i) {
    for (int32_t cur = static_cast<int32_t>(i); cur >= 0;
         cur = pi->parent[cur]) {
      total += static_cast<int64_t>(pi->segs.len[pi->seg_id[cur]]) + 1;
    }
    total -= 1;  // no leading slash
  }
  return total;
}

void pin_paths_blob(void* h, int64_t start, int64_t end, char* buf,
                    int64_t* lens) {
  auto* pi = static_cast<PathInterner*>(h);
  std::string path;
  for (int64_t i = start; i < end; ++i) {
    pi->build_path(static_cast<int32_t>(i), path);
    std::memcpy(buf, path.data(), path.size());
    buf += path.size();
    lens[i - start] = static_cast<int64_t>(path.size());
  }
}

int64_t pin_segs_blob_len(void* h, int64_t start, int64_t end) {
  auto* pi = static_cast<PathInterner*>(h);
  int64_t total = 0;
  for (int64_t i = start; i < end; ++i)
    total += pi->segs.len[pi->seg_id[i]];
  return total;
}

void pin_segs_blob(void* h, int64_t start, int64_t end, char* buf,
                   int64_t* lens) {
  auto* pi = static_cast<PathInterner*>(h);
  for (int64_t i = start; i < end; ++i) {
    std::string_view p = pi->segs.name(pi->seg_id[i]);
    std::memcpy(buf, p.data(), p.size());
    buf += p.size();
    lens[i - start] = static_cast<int64_t>(p.size());
  }
}

// Children of one id: count then fill (creation order via sibling chain).
int64_t pin_children_count(void* h, int32_t pid) {
  auto* pi = static_cast<PathInterner*>(h);
  int64_t n = 0;
  for (int32_t c = pi->first_child[pid]; c >= 0; c = pi->next_sibling[c]) ++n;
  return n;
}

void pin_children_get(void* h, int32_t pid, int32_t* out) {
  auto* pi = static_cast<PathInterner*>(h);
  for (int32_t c = pi->first_child[pid]; c >= 0; c = pi->next_sibling[c])
    *out++ = c;
}

// Bulk subtree export: all strict descendants of pid in the exact order
// Python's PathInterner.descendants yields (LIFO stack: pop last, extend
// with children in creation order) — one call instead of one children()
// call per node.
int64_t pin_subtree(void* h, int32_t pid, int32_t* out, int64_t cap) {
  auto* pi = static_cast<PathInterner*>(h);
  std::vector<int32_t> stack;
  for (int32_t c = pi->first_child[pid]; c >= 0; c = pi->next_sibling[c])
    stack.push_back(c);
  int64_t n = 0;
  while (!stack.empty()) {
    int32_t cur = stack.back();
    stack.pop_back();
    if (n < cap) out[n] = cur;
    ++n;
    for (int32_t c = pi->first_child[cur]; c >= 0; c = pi->next_sibling[c])
      stack.push_back(c);
  }
  return n;  // > cap signals the caller to retry with a bigger buffer
}

// Segment-id registry: create-or-get (matches GraphHost._seg_id) and
// lookup-only (seg_lookup returns -1 when absent).
int32_t pin_seg_id(void* h, const char* s, int64_t len) {
  return static_cast<PathInterner*>(h)->segs.intern(
      {s, static_cast<size_t>(len)});
}

int32_t pin_seg_lookup(void* h, const char* s, int64_t len) {
  return static_cast<PathInterner*>(h)->segs.find(
      {s, static_cast<size_t>(len)});
}

}  // extern "C"
