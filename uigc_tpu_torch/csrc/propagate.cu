// One propagation sweep of the CRGC liveness trace, for Hopper (sm_90a),
// writing packed hit words.
//
// Replaces the TPU kernel uigc_tpu/ops/pallas_trace.py:build_propagate
// (the pl.pallas_call at :1181), in both of its forms: one template,
// instantiated without (GATED = false) and with (GATED = true) the
// per-supertile gate operand.  The Pallas kernel emits an f32
// contribution plane per layout; every caller thresholds it (> 0) and
// packs it to words right away.  This kernel emits the words.
//
// Contract (the same operands the Pallas kernel reads, from the same host
// packer):
//   row_pos, emeta  int32[n_slots]   one packed (src, dst) pair per slot;
//                                    slot i sits in row i / 128, and rows
//                                    group into layout blocks of
//                                    block_rows (a multiple of 8)
//   bmeta1          int32[n_blocks]  (output tile << 1) | first-visit bit
//   bmeta2          int32[n_blocks]  (c_lo << 12) | span: the block's walk
//                                    groups [c_lo, c_lo + span)
//   super_ids       int32[tiles]     compact layouts only (else null): the
//                                    global supertile of each output tile
//   d               int32[n_chunks+1] dirty prefix: group c is dirty iff
//                                    d[c + 1] != d[c]
//   gate            int32[n_super]   GATED only, indexed by GLOBAL
//                                    supertile: 0 PUSH, 1 FULL, 2 SKIP
//   table           int32[r_rows*128] source bits, node k = bit k%32 of
//                                    word k/32
//   out             uint32 words     the sweep's word plane, hits ORed in
// A slot is live when its row_pos is a table row (the packer's pad
// sentinel is 1 << 28), its row class matches (row_pos % 8 == slot row
// % 8, the packer's placement rule), and its walk group
// c = row_pos / group_rows lies in its block's span and is walked: dirty,
// or the tile's gate is FULL.  A SKIP gate kills every slot of the tile
// (SKIP wins over FULL).  A live slot whose source bit is set ORs bit
// node & 31 of word node >> 5, where
//   node = (gtile * s_rows + dst_sub) * 128 + dst_lane,
//   gtile = super_ids[tile] for a compact layout, tile for a dense one.
// OR is order-free, so blocks may run in any order, several layouts of
// one sweep may OR into one plane, and a compact pad tile (mapped to
// supertile 0 with span 0) adds nothing.  The caller zeroes the plane
// once per sweep; the first-visit bit of bmeta1 is not read.
//
// Bound: bytes.  There is no arithmetic to speak of.  A sweep must read
// row_pos of the slots of every walked block (4 B), emeta of each live
// walked slot (4 B), the block metadata, the dirty prefix, the gate and
// the table rows of the walked groups, and write the word plane (1 bit
// per node).  What this design does about it:
//   - One warp per layout block (8 per CTA); the warp reads the block's
//     metadata once and leaves before touching a slot when the gate is
//     SKIP, the span is 0 (padding blocks), or, with no FULL gate, no
//     group of the span is dirty (d[c_lo + span] == d[c_lo]; the prefix
//     is exact).  That is the Pallas kernel's block skip
//     (pallas_trace.py:999-1002), per block, and it is what makes a late,
//     sparse sweep cheap.
//   - row_pos moves as 16-byte loads, neighbouring lanes on neighbouring
//     addresses (all 8 of a lane's loads issued before any is used);
//     emeta is loaded, also 16 bytes at a time, only where one of the
//     four slots passed the row_pos tests.
//   - Hits atomicOr into a per-warp shared bitmap of the tile's words
//     (128 at s_rows = 32), after a plain read that skips a bit already
//     set (hub destinations); the warp then flushes each nonzero word
//     with one global atomicOr: at most 128 global atomics per walked
//     block, where the f32 kernel this replaces made one atomicAdd per
//     hit.
// Staging the slot stream through cp.async or TMA, and pre-reducing hits
// across a warp with match/ballot, are left for later.
//
// The second kernel of this file, jump_sweep_kernel, is the jump step of
// a sweep.  It replaces no Pallas kernel: the JAX package's jump step,
// uigc_tpu/ops/pallas_trace.py:341-362 jump_sweep (with bits_at and the
// pack that follows it), is a jnp expression that XLA fuses into a few
// passes and eager PyTorch cannot fuse (some 58 int64 ops a sweep).
// Contract:
//   table, trans_w, iu_w  int32[n_words]  word planes, node k = bit k%32
//                                         of word k/32; n <= 32 * n_words
//   jump_j                int32[n + 1]    parents J, each in [0, n]; n is
//                                         the "no parent" sentinel
//   hit_words             int32[n_words]  out: bit v set iff v < n, J[v] < n
//                                         and table bit J[v] is set, ANDed
//                                         with iu_w (bits >= n are 0)
//   new_j                 int32[n + 1]    out: J after two doublings,
//                                         J_{k+1}[v] = J_k[J_k[v]] where
//                                         J_k[v] < n is trans_w-transparent
//                                         and J_k[J_k[v]] < n, else J_k[v]
// Exactly the two-step result: the second doubling reads the first's
// parents, never a half-updated J, so the per-sweep parents (and the
// sweep count of the fixpoint) are those of the torch ops it replaces.
// J is read only; the outputs are fresh.
//
// Bound: bytes.  Per node it reads J[v] and writes new_j[v] (8 B), with
// the three word tables (1.25 MB each at 10M) and the hit words: about
// 85 MB a sweep at 10M, or 0.025 ms at 3.35 TB/s, if the dependent
// gathers below hit L2.  Design:
//   - One thread per node, int32 throughout, one launch a sweep.  The
//     first doubling's parent at the gathered node is recomputed from J
//     (four dependent gathers of J in all: J[v], J[J[v]], J[a], J[J[a]]),
//     so no scratch copy of J goes out to memory and back between the
//     doublings, and no grid-wide barrier is needed.
//   - Word tables are read with read-only loads; at 1.25 MB each they
//     stay in the 50 MB L2, as do the hub parents that most gathers hit.
//   - A warp owns one hit word: __ballot_sync packs its 32 nodes' hits
//     and lane 0 stores the word ANDed with iu_w.  No atomics, no
//     zeroing pass: every word of the plane is written once.
//
// The third kernel, propagate_pairs_kernel, propagates a raw pair tier:
// the layout's newest, unpacked insertions (ops/cuda_trace.py
// xla_tier), launched once a sweep beside the packed tiers' launches.
// It replaces no Pallas kernel: the JAX package propagates that tier
// with a jnp scatter (uigc_tpu/ops/pallas_trace.py build_sweep_contribs),
// which eager PyTorch ran as some 21 ops over the whole node plane a
// sweep, one of them a host-to-device copy and a stream sync.  Contract:
//   table         int32[n_words]   the sweep's source bits, node k = bit
//                                  k%32 of word k/32; n <= 32 * n_words
//   src, dst      int32[capacity]  one pair a slot; unused slots are sink
//                                  pads, src = dst = n
//   out           uint32[n_words]  the sweep's word plane, hits ORed in
// For every slot i: if src[i] < n, dst[i] < n and table bit src[i] is
// set, then out word dst[i] >> 5 |= 1 << (dst[i] & 31).  Unsigned
// compares keep any id outside [0, n) from being read through: a sink
// pad's word can lie one row past the table (n a multiple of 32,768).
// OR is order-free, so the launch may come before or after the packed
// tiers' launches of the same sweep.
//
// Bound: bytes.  8 B a slot of src and dst, and a 32-B sector each for
// the table word it reads and the out word it ORs: at 16,384 slots about
// 1.2 MB, 0.35 us at 3.35 TB/s, so one launch costs its launch.  Design:
// one thread a slot, coalesced int32 loads of src and dst, a read-only
// load of the table word, one atomicOr a hit straight into the plane (at
// most capacity of them; the packed tiers' hub words are not in the way).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
constexpr int kWordBits = 32;
constexpr int kSpanBits = 12;
constexpr int kGateFull = 1;
constexpr int kGateSkip = 2;
constexpr int kWarp = 32;
constexpr int kWarps = 8;  // layout blocks per CTA, one per warp
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxSRows = 32;  // dst_sub is packed in 5 bits
constexpr int kMaxTileWords = kMaxSRows * kLane / kWordBits;
constexpr int kRowVec = kLane / 4;  // int4 loads per layout row
constexpr int kBatch = 8;           // rows whose loads a lane issues at once

template <bool GATED>
__global__ void __launch_bounds__(kThreads) propagate_words_kernel(
    const int32_t* __restrict__ d,
    const int32_t* __restrict__ gate,
    const int32_t* __restrict__ bmeta1,
    const int32_t* __restrict__ bmeta2,
    const int32_t* __restrict__ super_ids,
    const int32_t* __restrict__ table,
    const int32_t* __restrict__ row_pos,
    const int32_t* __restrict__ emeta,
    unsigned int* __restrict__ out,
    int64_t n_blocks, int32_t r_rows, int32_t block_rows,
    int32_t group_rows, int32_t s_rows) {
  __shared__ unsigned int bitmap[kWarps][kMaxTileWords];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (blk >= n_blocks) return;

  // --- the block's metadata, once (every lane reads the same words) ---
  const uint32_t m2 = static_cast<uint32_t>(__ldg(bmeta2 + blk));
  const int32_t m1 = __ldg(bmeta1 + blk);
  const int32_t span = static_cast<int32_t>(m2 & ((1u << kSpanBits) - 1));
  const int32_t c_lo = static_cast<int32_t>(m2 >> kSpanBits);
  if (span == 0) return;  // padding or an empty tile: nothing to walk
  const int32_t tile = m1 >> 1;
  const int32_t gtile = super_ids != nullptr ? __ldg(super_ids + tile) : tile;
  bool full = false;
  if (GATED) {
    const int32_t g = __ldg(gate + gtile);
    if (g == kGateSkip) return;
    full = (g == kGateFull);
  }
  if (!full && __ldg(d + c_lo + span) == __ldg(d + c_lo)) return;
  const int32_t c_hi = c_lo + span;

  const int tile_words = s_rows * (kLane / kWordBits);
  unsigned int* bits = bitmap[warp];
  for (int w = lane; w < tile_words; w += kWarp) bits[w] = 0u;
  __syncwarp();

  // --- the slots: lane l takes int4 l of every row of the block ---
  const int64_t slot0 = blk * block_rows * kLane;
  const int4* rp4 = reinterpret_cast<const int4*>(row_pos + slot0) + lane;
  const int4* em4 = reinterpret_cast<const int4*>(emeta + slot0) + lane;
  for (int r0 = 0; r0 < block_rows; r0 += kBatch) {
    int4 rp[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) rp[i] = __ldcs(rp4 + (r0 + i) * kRowVec);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      // block_rows is a multiple of 8, so the slot row's class is i
      const int32_t v[4] = {rp[i].x, rp[i].y, rp[i].z, rp[i].w};
      unsigned live = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int32_t r = v[j];
        // unsigned compare: the pad sentinel and negatives are dead
        if (static_cast<uint32_t>(r) >= static_cast<uint32_t>(r_rows)) continue;
        if ((r & 7) != i) continue;
        const int32_t c = r / group_rows;
        if (c < c_lo || c >= c_hi) continue;
        if (!full && __ldg(d + c + 1) == __ldg(d + c)) continue;
        live |= 1u << j;
      }
      if (live == 0) continue;
      const int4 em = __ldcs(em4 + (r0 + i) * kRowVec);
      const uint32_t e[4] = {static_cast<uint32_t>(em.x),
                             static_cast<uint32_t>(em.y),
                             static_cast<uint32_t>(em.z),
                             static_cast<uint32_t>(em.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!((live >> j) & 1u)) continue;
        const uint32_t word = static_cast<uint32_t>(__ldg(
            table + static_cast<int64_t>(v[j]) * kLane + (e[j] & 127u)));
        if (((word >> ((e[j] >> 7) & 31u)) & 1u) == 0u) continue;
        const uint32_t local = ((e[j] >> 19) & 31u) * kLane + ((e[j] >> 12) & 127u);
        unsigned int* p = bits + (local >> 5);
        const unsigned int b = 1u << (local & 31u);
        if ((*p & b) == 0u) atomicOr(p, b);
      }
    }
  }
  __syncwarp();

  // --- flush: one global atomicOr per nonzero word of the tile ---
  unsigned int* dst = out + static_cast<int64_t>(gtile) * tile_words;
  for (int w = lane; w < tile_words; w += kWarp) {
    const unsigned int v = bits[w];
    if (v != 0u) atomicOr(dst + w, v);
  }
}

constexpr int kJumpThreads = 256;  // 8 hit words a CTA

__device__ __forceinline__ bool bit_at(const int32_t* __restrict__ words,
                                       uint32_t id) {
  return (static_cast<uint32_t>(__ldg(words + (id >> 5))) >> (id & 31u)) & 1u;
}

// One doubling at a node whose parent is j: J[j] where j is a node
// (j < n), transparent, and its own parent is a node; else j.  Unsigned
// compares keep any id outside [0, n) from being read through.
__device__ __forceinline__ uint32_t hop(const int32_t* __restrict__ jump_j,
                                        const int32_t* __restrict__ trans_w,
                                        uint32_t j, uint32_t n) {
  if (j < n && bit_at(trans_w, j)) {
    const uint32_t j2 = static_cast<uint32_t>(__ldg(jump_j + j));
    if (j2 < n) return j2;
  }
  return j;
}

__global__ void __launch_bounds__(kJumpThreads) jump_sweep_kernel(
    const int32_t* __restrict__ table,
    const int32_t* __restrict__ jump_j,
    const int32_t* __restrict__ trans_w,
    const int32_t* __restrict__ iu_w,
    int32_t* __restrict__ hit_words,
    int32_t* __restrict__ new_j,
    uint32_t n, int64_t n_words) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kJumpThreads + threadIdx.x;
  const int64_t w = v >> 5;  // a warp is one hit word: uniform per warp
  const bool owns_word = w < n_words;
  if (!owns_word && v > n) return;

  bool hit = false;
  if (v <= n) {
    const uint32_t j = static_cast<uint32_t>(__ldg(jump_j + v));
    hit = v < n && j < n && bit_at(table, j);
    const uint32_t a = hop(jump_j, trans_w, j, n);  // J1[v]
    uint32_t out = a;
    if (a < n && bit_at(trans_w, a)) {
      // J1[a], recomputed from J
      const uint32_t b = hop(jump_j, trans_w,
                             static_cast<uint32_t>(__ldg(jump_j + a)), n);
      if (b < n) out = b;
    }
    new_j[v] = static_cast<int32_t>(out);
  }
  if (owns_word) {
    const unsigned word = __ballot_sync(0xffffffffu, hit);
    if ((threadIdx.x & 31) == 0) {
      hit_words[w] = static_cast<int32_t>(word) & __ldg(iu_w + w);
    }
  }
}

constexpr int kPairThreads = 256;

__global__ void __launch_bounds__(kPairThreads) propagate_pairs_kernel(
    const int32_t* __restrict__ table,
    const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst,
    unsigned int* __restrict__ out,
    uint32_t n, int64_t capacity) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kPairThreads + threadIdx.x;
  if (i >= capacity) return;
  const uint32_t s = static_cast<uint32_t>(__ldg(src + i));
  const uint32_t d = static_cast<uint32_t>(__ldg(dst + i));
  if (s >= n || d >= n || !bit_at(table, s)) return;
  atomicOr(out + (d >> 5), 1u << (d & 31u));
}

}  // namespace

// Plain C interface (bound with ctypes).  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() so a refused
// launch is reported to the caller.  `super_ids` is null for a dense
// layout; `gate` is null for the ungated form.
extern "C" int uigc_propagate_words(
    int gated, const int32_t* d, const int32_t* gate, const int32_t* bmeta1,
    const int32_t* bmeta2, const int32_t* super_ids, const int32_t* table,
    const int32_t* row_pos, const int32_t* emeta, unsigned int* out,
    int64_t n_blocks, int32_t r_rows, int32_t block_rows, int32_t group_rows,
    int32_t s_rows, void* stream) {
  if (n_blocks <= 0) return 0;
  if (block_rows % kBatch != 0 || s_rows < 1 || s_rows > kMaxSRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (n_blocks + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gated) {
    propagate_words_kernel<true><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        d, gate, bmeta1, bmeta2, super_ids, table, row_pos, emeta, out,
        n_blocks, r_rows, block_rows, group_rows, s_rows);
  } else {
    propagate_words_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        d, gate, bmeta1, bmeta2, super_ids, table, row_pos, emeta, out,
        n_blocks, r_rows, block_rows, group_rows, s_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The jump step of a sweep: hit words and parents after two doublings
// (contract above).  Same conventions as uigc_propagate_words: launches
// on `stream`, does not synchronise, allocates nothing, returns
// cudaGetLastError().
extern "C" int uigc_jump_sweep_words(
    const int32_t* table, const int32_t* jump_j, const int32_t* trans_w,
    const int32_t* iu_w, int32_t* hit_words, int32_t* new_j, int32_t n,
    int64_t n_words, void* stream) {
  if (n < 0 || n_words < 0 || static_cast<int64_t>(n) > n_words * kWordBits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t threads = n_words * kWordBits > static_cast<int64_t>(n) + 1
                              ? n_words * kWordBits
                              : static_cast<int64_t>(n) + 1;
  const int64_t grid = (threads + kJumpThreads - 1) / kJumpThreads;
  jump_sweep_kernel<<<static_cast<unsigned>(grid), kJumpThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      table, jump_j, trans_w, iu_w, hit_words, new_j,
      static_cast<uint32_t>(n), n_words);
  return static_cast<int>(cudaGetLastError());
}

// A raw pair tier's share of a sweep, ORed into `out` (contract above).
// Same conventions as uigc_propagate_words: launches on `stream`, does
// not synchronise, allocates nothing, returns cudaGetLastError().
extern "C" int uigc_propagate_pairs(
    const int32_t* table, const int32_t* src, const int32_t* dst,
    unsigned int* out, int32_t n, int64_t capacity, void* stream) {
  if (n < 0 || capacity < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (capacity == 0) return 0;
  const int64_t grid = (capacity + kPairThreads - 1) / kPairThreads;
  propagate_pairs_kernel<<<static_cast<unsigned>(grid), kPairThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      table, src, dst, out, static_cast<uint32_t>(n), capacity);
  return static_cast<int>(cudaGetLastError());
}
