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
