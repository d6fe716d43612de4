// Copy of uigc_tpu/native/crgc_shadow.cpp, built by the port's native/
// loader into native/build/.
//
// Native CRGC shadow graph: the C++ twin of the reference's hot Java tier.
//
// The reference keeps its performance-critical collector structures in
// allocation-conscious plain Java (reference: crgc/Shadow.java,
// crgc/ShadowGraph.java, crgc/DeltaGraph.java, crgc/UndoLog.java).  This
// library is the host-native equivalent for the TPU framework: dense
// integer slots, flat arrays, batch-oriented C ABI consumed from Python
// via ctypes.  Liveness semantics are identical to the Python oracle
// (uigc_tpu/engines/crgc/shadow.py) and the array/device graphs; the
// differential tests drive all of them over the same entry streams.
//
// Actor identity: 64-bit ids assigned by the caller.  The top 24 bits are
// a node id (location), so halting a dead node's actors and
// count_reachable_from are pure integer comparisons.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC crgc_shadow.cpp -o libuigc_crgc.so

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint8_t FLAG_ROOT = 1;      // same bit layout as ops/trace.py
constexpr uint8_t FLAG_BUSY = 2;
constexpr uint8_t FLAG_INTERNED = 4;
constexpr uint8_t FLAG_LOCAL = 8;
constexpr uint8_t FLAG_HALTED = 16;
constexpr uint8_t FLAG_IN_USE = 32;

constexpr int NODE_SHIFT = 40;  // id >> NODE_SHIFT == node id (location)

// Entry-batch flag bits (per flattened entry, distinct from node flags).
constexpr uint8_t EFLAG_BUSY = 1;
constexpr uint8_t EFLAG_ROOT = 2;

// Delta-shadow flag bits.
constexpr uint8_t DFLAG_INTERNED = 1;
constexpr uint8_t DFLAG_BUSY = 2;
constexpr uint8_t DFLAG_ROOT = 4;

struct Graph {
  // Node state, indexed by dense slot (reference: Shadow.java:10-54).
  std::vector<uint8_t> flags;
  std::vector<int64_t> recv;
  std::vector<int32_t> sup;          // supervisor slot, or -1
  std::vector<int64_t> id_of_slot;   // actor id, valid iff IN_USE
  // Net created-minus-deactivated refs per (owner, target); may be
  // negative; zero entries are erased (reference: ShadowGraph.java:64-73).
  std::vector<std::unordered_map<int32_t, int64_t>> outgoing;
  // Reverse index for O(degree) cleanup when a slot is freed.
  std::vector<std::unordered_set<int32_t>> incoming;

  std::unordered_map<int64_t, int32_t> slot_of_id;
  std::vector<int32_t> free_slots;

  // Epoch-based mark bits: marked iff mark_epoch[slot] == epoch.
  std::vector<uint32_t> mark_epoch;
  uint32_t epoch = 0;

  int64_t total_seen = 0;

  int32_t intern(int64_t id) {
    auto it = slot_of_id.find(id);
    if (it != slot_of_id.end()) return it->second;
    int32_t slot;
    if (!free_slots.empty()) {
      slot = free_slots.back();
      free_slots.pop_back();
    } else {
      slot = static_cast<int32_t>(flags.size());
      flags.push_back(0);
      recv.push_back(0);
      sup.push_back(-1);
      id_of_slot.push_back(0);
      outgoing.emplace_back();
      incoming.emplace_back();
      mark_epoch.push_back(0);
    }
    flags[slot] = FLAG_IN_USE;  // not interned, not local
    recv[slot] = 0;
    sup[slot] = -1;
    id_of_slot[slot] = id;
    mark_epoch[slot] = 0;
    slot_of_id.emplace(id, slot);
    ++total_seen;
    return slot;
  }

  void update_edge(int32_t owner, int32_t target, int64_t delta) {
    if (delta == 0) return;
    auto& out = outgoing[owner];
    auto it = out.find(target);
    if (it == out.end()) {
      out.emplace(target, delta);
      incoming[target].insert(owner);
    } else if ((it->second += delta) == 0) {
      out.erase(it);
      incoming[target].erase(owner);
    }
  }

  void free_slot(int32_t slot) {
    slot_of_id.erase(id_of_slot[slot]);
    for (const auto& kv : outgoing[slot]) incoming[kv.first].erase(slot);
    for (int32_t src : incoming[slot]) outgoing[src].erase(slot);
    outgoing[slot].clear();
    incoming[slot].clear();
    flags[slot] = 0;
    recv[slot] = 0;
    sup[slot] = -1;
    free_slots.push_back(slot);
  }

  bool is_pseudo_root(int32_t s) const {
    // (reference: ShadowGraph.java:201-203)
    uint8_t f = flags[s];
    if (f & FLAG_HALTED) return false;
    return (f & (FLAG_ROOT | FLAG_BUSY)) != 0 || recv[s] != 0 ||
           (f & FLAG_INTERNED) == 0;
  }
};

}  // namespace

extern "C" {

void* uigc_graph_new() { return new Graph(); }

void uigc_graph_free(void* g) { delete static_cast<Graph*>(g); }

int64_t uigc_num_in_use(void* g) {
  return static_cast<int64_t>(static_cast<Graph*>(g)->slot_of_id.size());
}

int64_t uigc_total_seen(void* g) { return static_cast<Graph*>(g)->total_seen; }

// Fold a batch of flattened entries (reference: ShadowGraph.java:75-125).
// Entry i owns the half-open ranges [off[i], off[i+1]) of the pair arrays.
void uigc_merge_entries(
    void* gp, int64_t n, const int64_t* self_ids, const int64_t* recv_counts,
    const uint8_t* eflags, const int64_t* created_off,
    const int64_t* created_owners, const int64_t* created_targets,
    const int64_t* spawned_off, const int64_t* spawned_ids,
    const int64_t* updated_off, const int64_t* updated_ids,
    const int64_t* send_counts, const uint8_t* deactivated) {
  Graph& g = *static_cast<Graph*>(gp);
  for (int64_t i = 0; i < n; ++i) {
    int32_t self_slot = g.intern(self_ids[i]);
    g.flags[self_slot] |= FLAG_INTERNED | FLAG_LOCAL;
    g.recv[self_slot] += recv_counts[i];
    if (eflags[i] & EFLAG_BUSY)
      g.flags[self_slot] |= FLAG_BUSY;
    else
      g.flags[self_slot] &= ~FLAG_BUSY;
    if (eflags[i] & EFLAG_ROOT)
      g.flags[self_slot] |= FLAG_ROOT;
    else
      g.flags[self_slot] &= ~FLAG_ROOT;

    for (int64_t j = created_off[i]; j < created_off[i + 1]; ++j) {
      int32_t target = g.intern(created_targets[j]);
      int32_t owner = g.intern(created_owners[j]);
      g.update_edge(owner, target, 1);
    }
    for (int64_t j = spawned_off[i]; j < spawned_off[i + 1]; ++j) {
      int32_t child = g.intern(spawned_ids[j]);
      g.sup[child] = self_slot;
    }
    for (int64_t j = updated_off[i]; j < updated_off[i + 1]; ++j) {
      int32_t target = g.intern(updated_ids[j]);
      if (send_counts[j] > 0) g.recv[target] -= send_counts[j];
      if (deactivated[j]) g.update_edge(self_slot, target, -1);
    }
  }
}

// Fold one peer delta graph (reference: ShadowGraph.java:127-156).
// Shadow i is identified by ids[i]; supervisor_idx and out_target_idx are
// indices into the same ids array (the wire compression table).
void uigc_merge_delta(void* gp, int64_t n, const int64_t* ids,
                      const int64_t* recv, const int32_t* supervisor_idx,
                      const uint8_t* dflags, const int64_t* out_off,
                      const int32_t* out_target_idx, const int64_t* out_count) {
  Graph& g = *static_cast<Graph*>(gp);
  std::vector<int32_t> slots(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) slots[i] = g.intern(ids[i]);
  for (int64_t i = 0; i < n; ++i) {
    int32_t slot = slots[i];
    if (dflags[i] & DFLAG_INTERNED) {
      g.flags[slot] |= FLAG_INTERNED;
      // busy/root are only meaningful when the actor produced an entry
      // this period (reference: ShadowGraph.java:139-146).
      if (dflags[i] & DFLAG_BUSY)
        g.flags[slot] |= FLAG_BUSY;
      else
        g.flags[slot] &= ~FLAG_BUSY;
      if (dflags[i] & DFLAG_ROOT)
        g.flags[slot] |= FLAG_ROOT;
      else
        g.flags[slot] &= ~FLAG_ROOT;
    }
    g.recv[slot] += recv[i];
    if (supervisor_idx[i] >= 0) g.sup[slot] = slots[supervisor_idx[i]];
    for (int64_t j = out_off[i]; j < out_off[i + 1]; ++j)
      g.update_edge(slot, slots[out_target_idx[j]], out_count[j]);
  }
}

// Fold a dead node's undo log: halt its actors, revert its unadmitted
// effects (reference: ShadowGraph.java:158-174).  Targets interned while
// folding are visited too (they may live on the dead node) — mirrors the
// oracle's live from_set iteration.
void uigc_merge_undo(void* gp, int64_t node_id, int64_t n_admitted,
                     const int64_t* admitted_ids, const int64_t* msg_counts,
                     const int64_t* created_off, const int64_t* created_targets,
                     const int64_t* created_counts) {
  Graph& g = *static_cast<Graph*>(gp);
  std::unordered_map<int64_t, int64_t> admitted;
  admitted.reserve(static_cast<size_t>(n_admitted));
  for (int64_t i = 0; i < n_admitted; ++i) admitted.emplace(admitted_ids[i], i);

  std::vector<int32_t> worklist;
  worklist.reserve(g.slot_of_id.size());
  for (const auto& kv : g.slot_of_id) worklist.push_back(kv.second);
  std::unordered_set<int32_t> seen(worklist.begin(), worklist.end());

  for (size_t w = 0; w < worklist.size(); ++w) {
    int32_t slot = worklist[w];
    int64_t id = g.id_of_slot[slot];
    if ((id >> NODE_SHIFT) == node_id) g.flags[slot] |= FLAG_HALTED;
    auto it = admitted.find(id);
    if (it == admitted.end()) continue;
    int64_t i = it->second;
    g.recv[slot] += msg_counts[i];
    for (int64_t j = created_off[i]; j < created_off[i + 1]; ++j) {
      int32_t target = g.intern(created_targets[j]);
      if (seen.insert(target).second) worklist.push_back(target);
      g.update_edge(slot, target, created_counts[j]);
    }
  }
}

// One mark-trace + sweep (reference: ShadowGraph.java:205-289).  Fills
// out_garbage_ids with every collected actor id and out_kill_ids with the
// subset to send StopMsg (local, not halted, supervisor marked).  Both
// buffers must hold at least uigc_num_in_use() entries.  Returns the
// garbage count; *out_n_kill gets the kill count; *out_n_live the number
// of marked actors.
int64_t uigc_trace(void* gp, int64_t* out_garbage_ids, int64_t* out_kill_ids,
                   int64_t* out_n_kill, int64_t* out_n_live) {
  Graph& g = *static_cast<Graph*>(gp);
  ++g.epoch;
  const uint32_t epoch = g.epoch;

  std::vector<int32_t> stack;
  stack.reserve(g.slot_of_id.size());
  for (const auto& kv : g.slot_of_id) {
    int32_t slot = kv.second;
    if (g.is_pseudo_root(slot)) {
      g.mark_epoch[slot] = epoch;
      stack.push_back(slot);
    }
  }
  int64_t n_live = 0;
  while (!stack.empty()) {
    int32_t owner = stack.back();
    stack.pop_back();
    ++n_live;
    // Halted actors may be marked but never propagate
    // (reference: ShadowGraph.java:226-229).
    if (g.flags[owner] & FLAG_HALTED) continue;
    for (const auto& kv : g.outgoing[owner]) {
      if (kv.second > 0 && g.mark_epoch[kv.first] != epoch) {
        g.mark_epoch[kv.first] = epoch;
        stack.push_back(kv.first);
      }
    }
    // Supervisor marking: parents outlive descendants — deliberately
    // incomplete (reference: ShadowGraph.java:242-267).
    int32_t s = g.sup[owner];
    if (s >= 0 && g.mark_epoch[s] != epoch) {
      g.mark_epoch[s] = epoch;
      stack.push_back(s);
    }
  }

  int64_t n_garbage = 0, n_kill = 0;
  std::vector<int32_t> garbage_slots;
  for (const auto& kv : g.slot_of_id) {
    int32_t slot = kv.second;
    if (g.mark_epoch[slot] == epoch) continue;
    out_garbage_ids[n_garbage++] = g.id_of_slot[slot];
    garbage_slots.push_back(slot);
    uint8_t f = g.flags[slot];
    int32_t s = g.sup[slot];
    if ((f & FLAG_LOCAL) && !(f & FLAG_HALTED) && s >= 0 &&
        g.mark_epoch[s] == epoch)
      out_kill_ids[n_kill++] = g.id_of_slot[slot];
  }
  for (int32_t slot : garbage_slots) g.free_slot(slot);
  *out_n_kill = n_kill;
  *out_n_live = n_live;
  return n_garbage;
}

// Ids of local roots, for wave collection (reference:
// ShadowGraph.java:291-299).  Buffer must hold uigc_num_in_use() entries.
int64_t uigc_local_roots(void* gp, int64_t* out_ids) {
  Graph& g = *static_cast<Graph*>(gp);
  int64_t n = 0;
  for (const auto& kv : g.slot_of_id) {
    uint8_t f = g.flags[kv.second];
    if ((f & FLAG_ROOT) && (f & FLAG_LOCAL)) out_ids[n++] = kv.first;
  }
  return n;
}

// Every interned actor id.  Buffer must hold uigc_num_in_use() entries.
// Lets the Python wrapper reconcile its id<->cell maps after folds that
// mention actors the graph never interns (undo logs).
int64_t uigc_live_ids(void* gp, int64_t* out_ids) {
  Graph& g = *static_cast<Graph*>(gp);
  int64_t n = 0;
  for (const auto& kv : g.slot_of_id) out_ids[n++] = kv.first;
  return n;
}

// Actors reachable from any actor located at node_id
// (reference: ShadowGraph.java:302-330).
int64_t uigc_count_reachable_from(void* gp, int64_t node_id) {
  Graph& g = *static_cast<Graph*>(gp);
  ++g.epoch;
  const uint32_t epoch = g.epoch;
  std::vector<int32_t> stack;
  for (const auto& kv : g.slot_of_id) {
    if ((kv.first >> NODE_SHIFT) == node_id) {
      g.mark_epoch[kv.second] = epoch;
      stack.push_back(kv.second);
    }
  }
  int64_t count = 0;
  while (!stack.empty()) {
    int32_t owner = stack.back();
    stack.pop_back();
    ++count;
    if (g.flags[owner] & FLAG_HALTED) continue;
    for (const auto& kv : g.outgoing[owner]) {
      if (kv.second > 0 && g.mark_epoch[kv.first] != epoch) {
        g.mark_epoch[kv.first] = epoch;
        stack.push_back(kv.first);
      }
    }
  }
  return count;
}

}  // extern "C"

// --------------------------------------------------------------------- //
// Batch probes for the vectorized int64 hash map (ops/i64map.py).
//
// The table storage stays Python-owned (two flat int64 numpy arrays);
// these functions only run the probe loops, which dominate the packed
// fold's remaining cost when batches carry 10^5-10^6 keys.  The hash
// and probe order are BIT-IDENTICAL to the Python implementation —
// both sides read and write the same table, so they must agree on
// every slot choice.  EMPTY = -1, TOMBSTONE = -2, keys >= 0.
// --------------------------------------------------------------------- //

extern "C" {

static inline int64_t uigc_map_hash(int64_t k, int64_t mask) {
  return (int64_t)(((uint64_t)k * 0x9E3779B97F4A7C15ull) >> 29) & mask;
}

// Values for karr[n] (-1 where absent); keys need not be unique.
void uigc_map_get_batch(const int64_t* keys_tab, const int64_t* vals_tab,
                        int64_t mask, const int64_t* karr, int64_t n,
                        int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t k = karr[i];
    int64_t j = uigc_map_hash(k, mask);
    int64_t v = -1;
    for (;;) {
      int64_t tk = keys_tab[j];
      if (tk == k) { v = vals_tab[j]; break; }
      if (tk == -1) break;
      j = (j + 1) & mask;
    }
    out[i] = v;
  }
}

// Insert keys known to be UNIQUE and ABSENT.  Returns the number of
// tombstones reclaimed (callers adjust size by n and tombs by this).
int64_t uigc_map_put_batch_new(int64_t* keys_tab, int64_t* vals_tab,
                               int64_t mask, const int64_t* karr,
                               const int64_t* varr, int64_t n) {
  int64_t freed_tombs = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t k = karr[i];
    int64_t j = uigc_map_hash(k, mask);
    while (keys_tab[j] >= 0) j = (j + 1) & mask;
    if (keys_tab[j] == -2) ++freed_tombs;
    keys_tab[j] = k;
    vals_tab[j] = varr[i];
  }
  return freed_tombs;
}

// Remove karr[n] (unique); out[i] = removed value or -1.  Returns the
// number removed.
int64_t uigc_map_pop_batch(int64_t* keys_tab, const int64_t* vals_tab,
                           int64_t mask, const int64_t* karr, int64_t n,
                           int64_t* out) {
  int64_t removed = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t k = karr[i];
    int64_t j = uigc_map_hash(k, mask);
    int64_t v = -1;
    for (;;) {
      int64_t tk = keys_tab[j];
      if (tk == k) {
        v = vals_tab[j];
        keys_tab[j] = -2;
        ++removed;
        break;
      }
      if (tk == -1) break;
      j = (j + 1) & mask;
    }
    out[i] = v;
  }
  return removed;
}

}  // extern "C"
