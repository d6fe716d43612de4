"""The CRGC liveness trace on the CUDA card: the word-packed propagation
fixpoint over packed pair layouts.

Port of ``uigc_tpu/ops/pallas_trace.py``, held against it by
``tests/test_torch_propagate.py`` and ``tests/test_torch_cuda_trace.py``.
What it keeps, and how:

- **The host packer, copied** (``prepare_chunks``/``prepare_pairs``,
  ``pad_layout_blocks``, ``xla_tier``, ``layout_spec``, ``device_args``
  and the jump-parent helpers).  The port's kernel reads the very
  operands the Pallas kernel reads, so one layout feeds both and their
  per-sweep hits compare bit for bit.  The layout's geometry (slot row
  = source row mod 8, 128-slot rows, 12-bit spans) was shaped by the
  TPU; a layout native to Hopper is later work.
- **The sweep glue, as torch ops** (``bits_at``, ``jump_sweep``,
  ``saturated_tiles``, the dirty lists, the word pack/unpack and
  ``build_sweep_contribs`` with its dense, compact and xla tiers), but
  for the jump step on the card: :func:`jump_sweep_words` launches a
  hand-written kernel there, and keeps ``jump_sweep`` and ``pack_bools``
  as its plain twin.
- **The fixpoint** (``_build_trace_fn_multi``) in all four modes (push,
  pull, jump, auto).  The reference's loop is one device program
  (``jax.lax.while_loop``); here the loop (:class:`SweepLoop`, which
  also runs both phases of the decremental wake) runs on the host and
  reads the dirty count once per sweep.  Those reads are counted in the
  stats as ``host_syncs``.  The full trace's stretches are
  ``uigc.fixpoint.*`` spans (``utils/events.py`` ``span``): the seed,
  each sweep with its gates, propagation, jump and dirty lists, each
  changed-flag wait, the unpack.
- **The layout conversion.**  :func:`layout_to_device` turns a packed
  layout of numpy arrays, from either package's packer, into the port's
  tensors; :func:`graph_to_device` does the same for a graph dict.

One sweep is one :func:`ops.propagate.propagate_words` per packed
layout, all ORing into one word plane: the hand-written Hopper kernel on
CUDA tensors, its plain PyTorch twin on CPU tensors.  The reference's
sweep sums f32 contribution planes, thresholds and packs them; the
port's kernel writes the packed words itself, so no contribution plane,
no pack and no compact-tile scatter is left on the sweep.  The
reference's ``UIGC_KERNEL_INT8`` switch chose the precision of the TPU
matrix unit's one-hot contraction; the port's kernel is not a matrix
product, so the switch is gone.

Semantics are identical to ``trace_marks_np`` (the oracle for the
reference's ShadowGraph.java:205-289): supervisor pointers are folded in
as ordinary propagation pairs, sources gate on ``mark & ~halted``, and
only positive-weight edges propagate.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import trace as trace_ops
from .propagate import (  # the kernel ABI, named as the reference names it
    GATE_FULL,
    GATE_PUSH,
    GATE_SKIP,
    LANE,
    PAD_ROW,
    ROWS,
    SPAN_BITS,
    WORD_BITS,
    check_jump_operands,
    jump_sweep_words_cuda,
    pack_hits_words,
    propagate_words,
)
from .slotmap import log_columns
from ..utils import events
from ..utils.platform import resolve_device
from ..utils.validation import require

#: slot sub-blocks per kernel block (block_rows = ROWS * SUB) and table
#: row groups per walk group (group_rows = ROWS * GROUP) of new layouts.
#: The port's kernel gives each layout block one warp and skips a block
#: whose span holds no walked group, so the smallest block (1,024 slots)
#: skips at the finest grain and pads least, and the finest walk group
#: gives the finest dirty skip.  (1, 1) is also the reference's
#: interpret-mode geometry, so the two packers give the same layout by
#: default.
SUB = 1
GROUP = 1
#: default output sublane rows per supertile (s_rows * 128 destination
#: nodes per output tile); 32 is the packing limit (dst_sub is 5 bits)
S_ROWS = 32
_PAD_ROW = np.int32(PAD_ROW)
_SPAN_BITS = SPAN_BITS
#: quantum for large-layout block padding (see _pad_blocks_target)
_BLOCK_QUANTUM = 8192

# --------------------------------------------------------------------- #
# Trace propagation modes (uigc.crgc.trace-mode)
# --------------------------------------------------------------------- #
#: plain source-push sweeps over the dirty-chunk frontier
MODE_PUSH = "push"
#: push walks + destination-pull saturation gates every sweep: blocks
#: whose output supertile has no unmarked in-use node left are skipped
MODE_PULL = "pull"
#: push walks + pointer-jumping through a min-source parent array that is
#: squared each sweep: O(log diameter) sweeps instead of O(diameter)
MODE_JUMP = "jump"
#: jump always on, pull gates switched per sweep when the dirty-chunk
#: density crosses ``pull_density`` — the default
MODE_AUTO = "auto"
TRACE_MODES = (MODE_AUTO, MODE_PUSH, MODE_PULL, MODE_JUMP)
#: dirty-chunk density above which AUTO turns the pull gates on
DEFAULT_PULL_DENSITY = 0.25
#: pointer doublings applied per sweep
JUMP_STEPS = 2
#: per-sweep stat ring length for with_stats traces (sweeps beyond this
#: fold into the last slot)
MAX_SWEEP_STATS = 32


def jump_parents(psrc, pdst, n: int) -> np.ndarray:
    """Min-source jump-parent array: J[d] = the smallest source with a
    live propagation pair into ``d``, sentinel ``n`` when none.

    Minimum (not first/last) is the load-bearing choice: low slots are
    the oldest, shallowest actors (roots intern first; preferential
    attachment biases hub targets low), so the parent forest points
    toward the seed-rich end of the graph — the min-label hooking of the
    GPU connected-components literature.  Shaped (n + 1,) with J[n] = n
    so pointer doubling can gather through the sentinel."""
    j = np.full(n + 1, n, dtype=np.int32)
    pdst = np.asarray(pdst, dtype=np.int64)
    psrc = np.asarray(psrc, dtype=np.int64)
    ok = (pdst < n) & (psrc < n)
    np.minimum.at(j, pdst[ok], psrc[ok].astype(np.int32))
    j[n] = n
    return j


def fold_jump_cols(jump_parent, cols: np.ndarray, n: int) -> np.ndarray:
    """Vectorized jump-parent maintenance for one pair-transition batch in
    ``slotmap.log_columns`` form — the batched form of the
    min-fold-on-insert / invalidate-on-remove rules (``jump_parents``),
    shared by the single-device and mesh layout planes.

    Order-insensitive and conservative: pointers built from any pair
    removed in the batch are invalidated (even when an insert earlier
    in the same batch created them), and inserts whose (src, dst) pair
    is ALSO removed anywhere in the batch are not folded (their order
    against the remove is lost once the batch is vectorized).  A
    spurious invalidation or a skipped fold costs acceleration only;
    a pointer surviving its pair's removal would let the jump sweep
    cross a dead edge, which this can never produce.  Ids >= ``n``
    (node spaces that grew past the layout) are ignored.

    Mutates ``jump_parent`` in place and returns the destinations whose
    entry changed (repeats possible): the device mirror's writes, whose
    values are the host array's."""
    ins = cols[0] != 0
    src, dst = cols[1], cols[2]
    ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    rs, rd = src[~ins & ok], dst[~ins & ok]
    changed = [np.zeros(0, dtype=np.int64)]
    if rd.size:
        hrd = rd[jump_parent[rd] == rs]
        jump_parent[hrd] = n
        changed.append(hrd)
    isrc, idst = src[ins & ok], dst[ins & ok]
    if isrc.size and rd.size:
        keep = ~np.isin((isrc << 32) | idst, (rs << 32) | rd, kind="sort")
        isrc, idst = isrc[keep], idst[keep]
    if isrc.size:
        before = jump_parent[idst]
        np.minimum.at(jump_parent, idst, isrc.astype(jump_parent.dtype))
        changed.append(idst[jump_parent[idst] < before])
    return np.concatenate(changed)


def fold_jump_log(jump_parent, log, n: int, writes=None) -> None:
    """:func:`fold_jump_cols` over a log [(insert?, src, dst, kind),
    ...]; when ``writes`` is a dict the changed entries are recorded
    there too (dst -> final host value, the device-mirror scatter
    queue)."""
    changed = fold_jump_cols(jump_parent, log_columns(log), n)
    if writes is not None and changed.size:
        changed = np.unique(changed)
        writes.update(zip(changed.tolist(), jump_parent[changed].tolist()))


def jump_parents_from_graph(
    edge_src, edge_dst, edge_weight, supervisor, n: int
) -> np.ndarray:
    """jump_parents over a graph's live propagation pairs (edges with
    positive weight + supervisor pointers)."""
    live = edge_weight > 0
    psrc = edge_src[live].astype(np.int64)
    pdst = edge_dst[live].astype(np.int64)
    sup_src = np.nonzero(supervisor >= 0)[0].astype(np.int64)
    if sup_src.size:
        psrc = np.concatenate([psrc, sup_src])
        pdst = np.concatenate([pdst, supervisor[sup_src].astype(np.int64)])
    return jump_parents(psrc, pdst, n)


# --------------------------------------------------------------------- #
# Sweep glue (torch ops; the reference's are jnp expressions)
# --------------------------------------------------------------------- #


def bits_at(table, ids, n):
    """Gather per-node bits from a packed word table for an integer id
    vector; ids >= n (the sentinel and any padding) read as 0."""
    flat = table.reshape(-1)
    ids = ids.long()
    word = torch.clamp(ids >> 5, max=flat.numel() - 1)
    return (((flat[word] >> (ids & 31)) & 1) > 0) & (ids < n)


def jump_sweep(table, jump_j, trans_w, n, steps: int = JUMP_STEPS):
    """One pointer-jump propagation step + ``steps`` pointer doublings
    (reference: pallas_trace.jump_sweep, whose docstring argues the
    soundness).  Returns (hits, new_jump_j): the (n,) bool plane of nodes
    whose jump parent is active in ``table``, and the parent array
    advanced by squaring through ``trans_w``-transparent nodes only."""
    hits = bits_at(table, jump_j[:n], n)
    for _ in range(steps):
        j2 = jump_j[jump_j.long()]
        can = bits_at(trans_w, jump_j, n) & (j2 < n)
        jump_j = torch.where(can, j2, jump_j)
    return hits, jump_j


def saturated_tiles(mark_w, iu_w, n_super, sup_words):
    """Per-supertile saturation bits (int32, 1 = no unmarked in-use node
    left): the destination-pull summary."""
    un = (iu_w & ~mark_w).reshape(-1)[: n_super * sup_words]
    return (~(un.reshape(n_super, sup_words) != 0).any(dim=1)).to(torch.int32)


def hier_dirty_lists(table, table_prev, n_chunks, group_rows, n_super,
                     sup_words):
    """The hierarchical frontier: per-supertile changed bits above the
    walk-group dirty prefix.  Returns (d, changed, super_changed) with
    d/changed exactly as :func:`dirty_group_lists` produces them."""
    d, changed = dirty_group_lists(table, table_prev, n_chunks, group_rows)
    flat = (table != table_prev).reshape(-1)[: n_super * sup_words]
    super_changed = flat.reshape(n_super, sup_words).any(dim=1).to(
        torch.int32
    )
    return d, changed, super_changed


def pack_bools(active, n, r_rows):
    """Pack an (n,) bool vector into the (r_rows, LANE) word table (bits
    >= n stay 0)."""
    a = torch.zeros(r_rows * LANE * WORD_BITS, dtype=torch.bool,
                    device=active.device)
    a[:n] = active
    return pack_hits_words(a.reshape(-1, LANE)).reshape(r_rows, LANE)


def jump_sweep_words(table, jump_j, trans_w, iu_w, n):
    """The jump step of a sweep as the fixpoint ORs it into the marks:
    (hit_words, new_jump_j), with ``hit_words`` an int32 plane shaped
    like ``table`` holding ``pack_bools(hits) & iu_w`` and (hits,
    new_jump_j) what :func:`jump_sweep` returns (``JUMP_STEPS`` = 2
    doublings, the kernel's fixed depth).  ``jump_j`` is only read.
    CPU tensors take :func:`jump_sweep` and :func:`pack_bools`, its plain
    twin; CUDA tensors take the kernel (``ops/propagate.py``
    ``jump_sweep_words_cuda``), with no fallback."""
    kind = table.device.type
    if kind == "cuda":
        return jump_sweep_words_cuda(table, jump_j, trans_w, iu_w, n)
    if kind != "cpu":
        raise ValueError(f"no jump kernel for device type {kind!r}")
    check_jump_operands(table, jump_j, trans_w, iu_w, n)
    hits, new_j = jump_sweep(table, jump_j, trans_w, n)
    return pack_bools(hits, n, table.shape[0]) & iu_w, new_j


def dirty_group_lists(table, table_prev, n_chunks, group_rows):
    """Prefix D (n_chunks+1) of the walk groups whose words changed — the
    kernel ABI: group c is dirty iff D[c+1] != D[c] — plus the
    any-changed flag (a bool tensor).  The reference also builds the
    compacted index list L its TPU kernel walks; the Hopper kernel reads
    D alone, so L is not built."""
    diff = (table != table_prev).reshape(n_chunks, group_rows * LANE).any(
        dim=1
    )
    d = torch.zeros(n_chunks + 1, dtype=torch.int32, device=table.device)
    d[1:] = torch.cumsum(diff.to(torch.int32), dim=0)
    return d, d[n_chunks] > 0


def unpack_table(words, n):
    """Unpack the (r_rows, LANE) word table back to an (n,) bool vector
    (inverse of pack_bools/pack_hits_words for bits < n)."""
    flat = words.reshape(-1)[: -(-n // WORD_BITS)]
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (flat[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:n] > 0


def build_sweep_contribs(specs, n, n_super, s_rows):
    """The per-layout propagation sweep shared by the full trace and the
    decremental wake: returns fn(table, d, layout_args, gate) -> the
    sweep's hit words, an int32 plane shaped like ``table``.

    ``layout_args`` holds each layout's operands in ``device_args`` order;
    ``gate`` is the per-global-supertile gate vector for the gated kernel
    form, or None for the plain form.  Every layout ORs its hits into one
    zeroed plane, so the union of the layouts' pairs propagates: the
    packed layouts through the kernel (a compact one maps its tiles to
    global supertiles itself), the xla tier through a scatter-max whose
    hits are packed and ORed in.  Keeping this loop in one place is what
    makes the two fixpoints propagate identically per sweep."""
    t_rows = n_super * s_rows
    n_pad_nodes = t_rows * LANE

    def sweep(table, d, layout_args, gate=None):
        dev = table.device
        words = torch.zeros_like(table)
        pos = 0
        for spec in specs:
            if spec[0] == "xla":
                psrc, pdst = layout_args[pos:pos + 2]
                pos += 2
                with events.span("uigc.fixpoint.propagate", form="xla"):
                    # Source-active bits straight from the packed table;
                    # sink pads (src = n) read as 0 (bits_at clamps the
                    # word index, which can be one row past the table for
                    # them).
                    src_active = bits_at(table, psrc, n).to(torch.int32)
                    prop = torch.zeros(n_pad_nodes + 1, dtype=torch.int32,
                                       device=dev)
                    prop.scatter_reduce_(0, pdst.long(), src_active, "amax",
                                         include_self=True)
                    hits = pack_hits_words(
                        prop[:n_pad_nodes].reshape(t_rows, LANE) > 0
                    )
                    flat = words.view(-1)
                    flat[: hits.numel()] |= hits
                continue
            if spec[0] == "compact":
                bmeta1, bmeta2, row_pos, emeta, super_ids = layout_args[
                    pos:pos + 5
                ]
                pos += 5
            else:
                bmeta1, bmeta2, row_pos, emeta = layout_args[pos:pos + 4]
                pos += 4
                super_ids = None
            sub, group = spec[-2:]
            with events.span("uigc.fixpoint.propagate", form=spec[0]):
                propagate_words(
                    d, bmeta1, bmeta2, table, row_pos, emeta, words,
                    n_super=n_super, s_rows=s_rows, sub=sub, group=group,
                    gate=gate, super_ids=super_ids,
                )
        return words

    return sweep


def default_geometry() -> tuple:
    """(sub, group) for new layouts (module SUB/GROUP notes)."""
    return SUB, GROUP


def _parallel_argsort(keys: np.ndarray) -> np.ndarray:
    """argsort through torch's multi-threaded CPU sort from 2^20 keys up
    (numpy's is single-threaded and dominates the 50M-pair pack), numpy's
    below, as the reference chooses: the two packers then break ties
    alike and give equal layouts.  Equal keys may land in either order;
    the packer's placement is valid under any tie-break (the composite
    key carries every field the placement reads)."""
    if keys.size < (1 << 20):
        return np.argsort(keys)
    return torch.from_numpy(np.ascontiguousarray(keys)).argsort().numpy()


def _pad_blocks_target(n_blocks: int) -> int:
    """Padded block count for a mutable layout: power of two while small,
    then multiples of ``_BLOCK_QUANTUM`` (the reference's rule, kept so
    the packers agree; it bounded the TPU's scalar-prefetch memory)."""
    if n_blocks <= _BLOCK_QUANTUM:
        return 1 << max(0, int(n_blocks - 1).bit_length())
    return ((n_blocks + _BLOCK_QUANTUM - 1) // _BLOCK_QUANTUM) * _BLOCK_QUANTUM


def prepare_chunks(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_weight: np.ndarray,
    supervisor: np.ndarray,
    n: int,
    s_rows: int = S_ROWS,
    pad_blocks_pow2: bool = False,
    sub: int = None,
    group: int = None,
) -> Dict[str, np.ndarray]:
    """Host-side packer: place propagation pairs into kernel blocks.

    Rebuild whenever the edge set or supervisor pointers change (one
    lexsort of the live pairs, amortized across the trace's fixpoint
    iterations and across traces between graph mutations; a live,
    churning graph should use ops/cuda_incremental.py instead, which
    keeps this full pack off the per-wake path).

    ``pad_blocks_pow2`` rounds the block count up to a power of two with
    inert padding blocks (they re-accumulate zeros into the last
    supertile), so a live, mutating graph sees log-many distinct layout
    shapes instead of one per edge-set change.
    """
    live = edge_weight > 0
    psrc = edge_src[live].astype(np.int64)
    pdst = edge_dst[live].astype(np.int64)
    sup_src = np.nonzero(supervisor >= 0)[0].astype(np.int64)
    if sup_src.size:
        psrc = np.concatenate([psrc, sup_src])
        pdst = np.concatenate([pdst, supervisor[sup_src].astype(np.int64)])
    return prepare_pairs(
        psrc, pdst, n, s_rows=s_rows, pad_blocks_pow2=pad_blocks_pow2,
        sub=sub, group=group,
    )


def prepare_pairs(
    psrc: np.ndarray,
    pdst: np.ndarray,
    n: int,
    s_rows: int = S_ROWS,
    pad_blocks_pow2: bool = False,
    want_slots: bool = False,
    compact_supers: bool = False,
    n_src: int = None,
    sub: int = None,
    group: int = None,
) -> Dict[str, np.ndarray]:
    """Pack explicit propagation pairs (already filtered to live ones)
    into kernel blocks.

    With ``want_slots`` the result also carries ``slot_ri``/``slot_col``
    — each input pair's (row, column) in ``row_pos``/``emeta``, aligned
    with the *input* pair order — so a caller can later mask individual
    pairs in place (the deletion path of the incremental layout).

    With ``compact_supers`` the layout covers only the destination
    supertiles this pair set actually touches: the kernel's output is
    (k_touched * s_rows, LANE) and ``super_ids`` maps each compact tile
    back to its global supertile.  Without it, a tiny delta layout over
    a 10M-node space would still pay one (mostly dummy) grid step per
    global supertile; with it the cost scales with the delta.

    ``n_src`` decouples the source space from the destination space: the
    bit-table geometry (r_rows) covers ``n_src`` nodes while supertiles
    cover ``n`` destinations.  The mesh path uses this — sources are
    global ids gathered from the all-gathered table, destinations are
    shard-local (parallel/sharded_trace)."""
    assert 1 <= s_rows <= 32, "dst_sub is packed in 5 bits"
    if sub is None or group is None:
        d_sub, d_group = default_geometry()
        sub = d_sub if sub is None else sub
        group = d_group if group is None else group
    block_rows = ROWS * sub
    group_rows = ROWS * group
    super_sz = s_rows * LANE
    psrc = np.asarray(psrc, dtype=np.int64)
    pdst = np.asarray(pdst, dtype=np.int64)

    n_super = max(1, -(-n // super_sz))
    n_pad = n_super * super_sz
    # Bit table geometry: R rows of 128 lanes of 32-bit words, padded to
    # whole walk groups.
    n_words = -(-(n_src if n_src is not None else n_pad) // WORD_BITS)
    r_rows = -(-n_words // LANE)
    r_rows = ((r_rows + group_rows - 1) // group_rows) * group_rows
    assert r_rows // group_rows < (1 << _SPAN_BITS), (
        "graph too large for span packing"
    )

    m = psrc.size
    word = psrc >> 5
    w_row = word >> 7
    if super_sz & (super_sz - 1) == 0:
        # pow2 supertile (any pow2 s_rows): shifts instead of int64
        # division, which costs whole seconds at 50M pairs
        ss = super_sz.bit_length() - 1
        d_super = pdst >> ss
        d_local = pdst & (super_sz - 1)
    else:
        d_super = pdst // super_sz
        d_local = pdst % super_sz
    # per-pair emeta value, computed pre-sort so the sort permutation
    # needs only two gathers (composite + this) instead of six
    eval32 = (
        (word & 127)
        | ((psrc & 31) << 7)
        | ((d_local & 127) << 12)
        | ((d_local >> 7) << 19)
    ).astype(np.int32)

    if compact_supers:
        touched = np.unique(d_super)
        if touched.size == 0:
            touched = np.zeros(1, dtype=np.int64)
        d_super = np.searchsorted(touched, d_super)
        n_tiles = int(touched.size)
    else:
        touched = None
        n_tiles = n_super

    # --- placement -----------------------------------------------------
    # Sort by (dst supertile, row%8 class, source row); rank within each
    # class gives (block-in-supertile, column) such that each column holds
    # at most one edge per class — the slot row can then be the class
    # itself — and each block's 128-edge runs are source-sorted, keeping
    # its table-chunk span narrow.  One composite-key argsort instead of
    # a 3-key lexsort: a third of the sorting passes on the 50M-pair
    # packs, and equal keys are interchangeable so stability is not
    # needed (w_row fits 31 bits for any graph the span packing admits).
    # The key also CARRIES d_super/r8/w_row, so the sorted values are
    # recovered by bit ops on one gathered array instead of per-field
    # gathers.
    composite = (d_super << 34) | ((w_row & 7) << 31) | w_row
    order = _parallel_argsort(composite)
    comp_s = composite[order]
    eval32 = eval32[order]
    w_row = (comp_s & ((1 << 31) - 1)).astype(np.int32)
    r8 = (comp_s >> 31) & 7
    d_super = comp_s >> 34

    # rank of each edge within its (d_super, r8) class
    if m:
        key_change = np.ones(m, dtype=bool)
        cls = comp_s >> 31  # (d_super, r8) in one compare
        key_change[1:] = cls[1:] != cls[:-1]
        start_idx = np.nonzero(key_change)[0]
        starts = np.repeat(start_idx, np.diff(np.append(start_idx, m)))
        rank = np.arange(m, dtype=np.int64) - starts
    else:
        rank = np.zeros(0, dtype=np.int64)

    # blocks needed per (compact) supertile = max over classes of
    # ceil(ceil(class/128)/sub)
    sub_shift = sub.bit_length() - 1 if sub & (sub - 1) == 0 else None
    blocks_needed = np.zeros(n_tiles, dtype=np.int64)
    if m:
        sub_seq = (
            (rank >> 7) >> sub_shift if sub_shift is not None
            else (rank >> 7) // sub
        )
        np.maximum.at(blocks_needed, d_super, sub_seq + 1)
    blocks_needed = np.maximum(blocks_needed, 1)  # dummy for empty supertiles

    n_blocks = int(blocks_needed.sum())
    block_base = np.zeros(n_tiles, dtype=np.int64)
    block_base[1:] = np.cumsum(blocks_needed)[:-1]

    # --- fill kernel arrays -------------------------------------------
    shape = (n_blocks * block_rows, LANE)
    row_pos = np.full(shape, _PAD_ROW, dtype=np.int32)
    emeta = np.zeros(shape, dtype=np.int32)

    slot_ri = slot_col = None
    if m:
        sub_idx = rank >> 7  # sub-block sequence within the class
        g_block = block_base[d_super] + (
            sub_idx >> sub_shift if sub_shift is not None else sub_idx // sub
        )
        col = rank & 127
        # slot row = (sub-block within grid block, source row mod 8)
        sub_in = (
            sub_idx & (sub - 1) if sub_shift is not None else sub_idx % sub
        )
        ri = g_block * block_rows + sub_in * ROWS + r8
        if want_slots:
            # Undo the placement sort: slot of the i-th *input* pair.
            slot_ri = np.empty(m, dtype=np.int64)
            slot_col = np.empty(m, dtype=np.int64)
            slot_ri[order] = ri
            slot_col[order] = col
        row_pos[ri, col] = w_row
        emeta[ri, col] = eval32
        # per-block table walk-group range
        if group_rows & (group_rows - 1) == 0:
            chunk = (w_row >> (group_rows.bit_length() - 1)).astype(np.int64)
        else:
            chunk = (w_row // group_rows).astype(np.int64)
        c_lo = np.full(n_blocks, 1 << 30, dtype=np.int64)
        c_hi = np.zeros(n_blocks, dtype=np.int64)
        np.minimum.at(c_lo, g_block, chunk)
        np.maximum.at(c_hi, g_block, chunk + 1)
        empty = c_lo > c_hi
        c_lo[empty] = 0
        c_hi[empty] = 0
    else:
        c_lo = np.zeros(n_blocks, dtype=np.int64)
        c_hi = np.zeros(n_blocks, dtype=np.int64)

    span = c_hi - c_lo
    assert span.max(initial=0) < (1 << _SPAN_BITS)

    block_super = np.repeat(np.arange(n_tiles, dtype=np.int64), blocks_needed)
    block_first = np.zeros(n_blocks, dtype=np.int64)
    block_first[block_base] = 1

    if compact_supers and pad_blocks_pow2:
        # Pad the compact tile count to a power of two so repeated delta
        # packs reuse cached kernels.  Each pad tile gets one inert
        # first-visit block with span 0, mapped by super_ids to global
        # supertile 0; the kernel walks no span-0 block, so a pad tile
        # ORs nothing.
        k_pad = 1 << max(0, int(n_tiles - 1).bit_length())
        if k_pad > n_tiles:
            extra_t = k_pad - n_tiles
            block_super = np.concatenate(
                [block_super, np.arange(n_tiles, k_pad, dtype=np.int64)]
            )
            block_first = np.concatenate(
                [block_first, np.ones(extra_t, dtype=np.int64)]
            )
            c_lo = np.concatenate([c_lo, np.zeros(extra_t, dtype=np.int64)])
            span = np.concatenate([span, np.zeros(extra_t, dtype=np.int64)])
            row_pos = np.concatenate(
                [row_pos, np.full((extra_t * block_rows, LANE), _PAD_ROW, np.int32)]
            )
            emeta = np.concatenate(
                [emeta, np.zeros((extra_t * block_rows, LANE), np.int32)]
            )
            n_blocks += extra_t
            n_tiles = k_pad

    if pad_blocks_pow2:
        padded = _pad_blocks_target(n_blocks)
        if padded > n_blocks:
            extra = padded - n_blocks
            # Inert blocks: span 0 (no gather), accumulate zeros into the
            # last (compact) supertile (keeps output revisits consecutive).
            block_super = np.concatenate(
                [block_super, np.full(extra, n_tiles - 1, dtype=np.int64)]
            )
            block_first = np.concatenate(
                [block_first, np.zeros(extra, dtype=np.int64)]
            )
            c_lo = np.concatenate([c_lo, np.zeros(extra, dtype=np.int64)])
            span = np.concatenate([span, np.zeros(extra, dtype=np.int64)])
            row_pos = np.concatenate(
                [row_pos, np.full((extra * block_rows, LANE), _PAD_ROW, np.int32)]
            )
            emeta = np.concatenate(
                [emeta, np.zeros((extra * block_rows, LANE), np.int32)]
            )
            n_blocks = padded

    # meta1 = supertile id | first-visit bit; meta2 = chunk range
    bmeta1 = (block_super << 1 | block_first).astype(np.int32)
    bmeta2 = (c_lo << _SPAN_BITS | span).astype(np.int32)

    prep = {
        "row_pos": row_pos,
        "emeta": emeta,
        "bmeta1": bmeta1,
        "bmeta2": bmeta2,
        "n_super": n_super,
        "n_blocks": n_blocks,
        "r_rows": r_rows,
        "n_pad": n_pad,
        "n": n,
        "s_rows": s_rows,
        "sub": sub,
        "group": group,
        "n_pairs": int(m),
    }
    if compact_supers:
        k = int(touched.size)
        super_ids = np.zeros(n_tiles, dtype=np.int32)
        super_ids[:k] = touched.astype(np.int32)
        prep["super_ids"] = super_ids
        prep["out_supers"] = n_tiles
    if want_slots:
        prep["slot_ri"] = (
            slot_ri if slot_ri is not None else np.zeros(0, dtype=np.int64)
        )
        prep["slot_col"] = (
            slot_col if slot_col is not None else np.zeros(0, dtype=np.int64)
        )
    return prep


def pad_layout_blocks(prep: Dict[str, np.ndarray], target: int) -> None:
    """Pad a packed layout with inert blocks (span 0, not first-visit,
    accumulating nothing into the last supertile) up to ``target`` blocks,
    in place.  The mesh path uses this to equalize per-shard block counts
    so one SPMD program covers every shard."""
    extra = target - prep["n_blocks"]
    if extra <= 0:
        return
    block_rows = ROWS * prep["sub"]
    n_tiles = prep.get("out_supers", prep["n_super"])
    bmeta1_pad = np.full(extra, (n_tiles - 1) << 1, dtype=np.int32)
    prep["bmeta1"] = np.concatenate([prep["bmeta1"], bmeta1_pad])
    prep["bmeta2"] = np.concatenate(
        [prep["bmeta2"], np.zeros(extra, dtype=np.int32)]
    )
    prep["row_pos"] = np.concatenate(
        [prep["row_pos"], np.full((extra * block_rows, LANE), _PAD_ROW, np.int32)]
    )
    prep["emeta"] = np.concatenate(
        [prep["emeta"], np.zeros((extra * block_rows, LANE), np.int32)]
    )
    prep["n_blocks"] = target


def device_args(prep: Dict[str, np.ndarray]) -> tuple:
    """The kernel operands (after flags/recv) in call order."""
    if "xla_src" in prep:
        return (prep["xla_src"], prep["xla_dst"])
    args = (prep["bmeta1"], prep["bmeta2"], prep["row_pos"], prep["emeta"])
    if "out_supers" in prep:
        args = args + (prep["super_ids"],)
    return args


def xla_tier(psrc, pdst, n: int, capacity: int) -> Dict[str, np.ndarray]:
    """A propagation tier held as raw pair arrays, padded to a static
    ``capacity`` with inert sink pairs (src=dst=n).  Propagated by an
    torch scatter-max instead of the propagate kernel: O(capacity) per
    fixpoint iteration, but zero pack cost while the capacity is
    stable — the landing pad for the newest churn."""
    m = len(psrc)
    assert m <= capacity
    src = np.full(capacity, n, dtype=np.int32)
    dst = np.full(capacity, n, dtype=np.int32)
    src[:m] = psrc
    dst[:m] = pdst
    return {"xla_src": src, "xla_dst": dst, "capacity": capacity, "n": n}


def layout_spec(prep: Dict[str, np.ndarray]) -> tuple:
    """The static shape signature of a packed layout (kernel cache key
    component)."""
    if "xla_src" in prep:
        return ("xla", prep["capacity"])
    if "out_supers" in prep:
        return (
            "compact",
            prep["n_blocks"],
            prep["out_supers"],
            prep["sub"],
            prep["group"],
        )
    return ("dense", prep["n_blocks"], prep["sub"], prep["group"])


#: layout keys that are kernel operands (int32 arrays); the rest of a
#: packed layout is static geometry or host bookkeeping
_OPERANDS = ("row_pos", "emeta", "bmeta1", "bmeta2", "super_ids", "xla_src",
             "xla_dst")


def layout_to_device(prep: Dict, device=None) -> Dict:
    """A packed layout (numpy arrays from either package's packer, or
    tensors) with its kernel operands as int32 tensors on ``device``
    (default: the CUDA card).  Static geometry entries are kept; host
    bookkeeping (slot maps, ``_``-prefixed keys) is dropped.  The arrays
    are copied, so later in-place edits of the host layout do not reach
    the device copy."""
    dev = resolve_device(device)
    out = {}
    for k, v in prep.items():
        if k in _OPERANDS:
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v)
            )
            require(t.dtype == torch.int32, "layout.dtype",
                    "layout operands are int32", key=k, dtype=str(t.dtype))
            out[k] = t.to(dev, copy=True)
        elif not k.startswith("_") and k not in ("slot_ri", "slot_col"):
            out[k] = v
    if "bmeta1" in out and out["n_blocks"]:
        tiles = out.get("out_supers", out["n_super"])
        top = int(out["bmeta1"].max()) >> 1  # readback: one-time layout check
        require(top < tiles, "layout.tiles", "block maps past the output",
                top=top, tiles=tiles)
    if "super_ids" in out and out["super_ids"].numel():
        top = int(out["super_ids"].max())  # readback: one-time layout check
        require(top < out["n_super"], "layout.tiles",
                "compact tile maps past the supertiles", top=top,
                n_super=out["n_super"])
    return out


def graph_to_device(graph: Dict, device=None) -> Dict:
    """A graph dict (``models.graphgen``) with its arrays as tensors on
    ``device`` (default: the CUDA card), dtypes kept."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        if isinstance(v, np.ndarray) else v
        for k, v in graph.items()
    }


_fn_cache: Dict[tuple, object] = {}


def pull_cut(pull_density: float, n_chunks: int) -> int:
    """AUTO's per-sweep pull threshold, in dirty walk groups."""
    return max(1, int(round(pull_density * n_chunks)))


def pull_switch(mode: str, n_dirty: int, cut: int) -> bool:
    """Whether a sweep skips saturated supertiles: every sweep in pull
    mode, in auto mode once ``n_dirty`` walk groups reach ``cut``."""
    return mode == MODE_PULL or (mode == MODE_AUTO and n_dirty >= cut)


def pull_gate(base, mark_w, keep, n_super, sup_words):
    """``base`` with GATE_SKIP on every saturated supertile.  Marks only
    grow within one fixpoint, so a tile with no unmarked ``keep`` node
    left gains nothing from a walk: skipping it loses no hit."""
    sat = saturated_tiles(mark_w, keep, n_super, sup_words)
    return base.masked_fill(sat > 0, GATE_SKIP)


def supertile_any(words, n_super, sup_words):
    """1 for each supertile whose words hold a set bit (int32)."""
    return ((words.reshape(-1)[: n_super * sup_words] != 0)
            .reshape(n_super, sup_words).any(dim=1).to(torch.int32))


class LoopSpans(NamedTuple):
    """The span a :class:`SweepLoop` opens over each stretch of a call;
    a role left None opens nothing."""

    sweep: str
    wait: str
    gate: Optional[str] = None
    jump: Optional[str] = None
    dirty: Optional[str] = None


FIXPOINT_SPANS = LoopSpans("uigc.fixpoint.sweep", "uigc.fixpoint.wait",
                           "uigc.fixpoint.gate", "uigc.fixpoint.jump",
                           "uigc.fixpoint.dirty")


def _span(name, **args):
    return events._NO_SPAN if name is None else events.span(name, **args)


class SweepLoop:
    """The single-device mark fixpoint of one geometry: the full trace's
    loop, and the decremental wake's closure and repair.

    One call of :meth:`run` grows ``mark_w`` by each sweep's hits (the
    propagate kernel over every layout, and the jump step where the mode
    has one) masked by ``keep``, until the table (``mark_w & active``,
    or the marks themselves where ``active`` is None) stops changing.
    The host reads the dirty count once per sweep, plus once before the
    first; those reads are the call's ``waits``.  Built once per
    geometry, it holds no state between calls."""

    def __init__(self, n, specs, n_super, r_rows, s_rows, mode, pull_density):
        require(mode in TRACE_MODES, "config.trace_mode", "bad trace mode",
                mode=mode, valid=TRACE_MODES)
        geoms = {spec[-2:] for spec in specs if spec[0] != "xla"}
        require(len(geoms) == 1, "trace.geometry",
                "packed layouts must share (sub, group)", geoms=sorted(geoms))
        ((_, group),) = geoms
        self.n = n
        self.r_rows = r_rows
        self.n_super = n_super
        self.mode = mode
        self.use_jump = mode in (MODE_JUMP, MODE_AUTO)
        self.group_rows = ROWS * group
        self.n_chunks = r_rows // self.group_rows  # one walk group each
        self.sup_words = s_rows * (LANE // WORD_BITS)  # words per supertile
        self.pull_cut = pull_cut(pull_density, self.n_chunks)
        self.sweep = build_sweep_contribs(specs, n, n_super, s_rows)

    def pack(self, active):
        return pack_bools(active, self.n, self.r_rows)

    def supertile_any(self, words):
        return supertile_any(words, self.n_super, self.sup_words)

    def split_jump(self, rest):
        """(jump parents or None, layout operands) of a fn's trailing
        operands: jump and auto modes take the parents first."""
        if not self.use_jump:
            return None, rest
        jump_j, *layout_args = rest
        return jump_j.to(torch.int32), layout_args

    def frontier(self, table, table_prev, summary):
        """(dirty prefix, per-supertile changed bits or None): the bits
        only under ``summary``, for the ``changed_supers`` stats row."""
        if summary:
            d, _, super_changed = hier_dirty_lists(
                table, table_prev, self.n_chunks, self.group_rows,
                self.n_super, self.sup_words)
            return d, super_changed
        return dirty_group_lists(table, table_prev, self.n_chunks,
                                 self.group_rows)[0], None

    def start(self, mark_w, table_prev, active=None, stats=False):
        """The state :meth:`run` starts from: the marks, their table and
        its frontier against ``table_prev``; with ``stats`` the run
        records the per-sweep stats rows."""
        table = mark_w if active is None else mark_w & active
        return (mark_w, table) + self.frontier(table, table_prev, stats)

    def run(self, state, keep, active, layout_args, *, mode=None,
            jump_j=None, gate=None, gated=False, spans=FIXPOINT_SPANS):
        """The loop from :meth:`start`'s ``state``: returns (mark_w,
        table, sweeps, waits, stats rows or None).

        ``mode`` defaults to the loop's own.  ``gate`` forces the first
        sweep (GATE_FULL on the supertiles that must re-derive from all
        their in-edges), and the loop then sweeps at least once when any
        tile is forced.  The propagate kernel takes its gated form where
        ``gate`` is given, ``gated`` is set or the mode pulls, and a zero
        gate on the sweeps nothing forces or skips; its plain form
        otherwise."""
        mark_w, table, d, super_changed = state
        stats = super_changed is not None
        mode = self.mode if mode is None else mode
        use_jump = mode in (MODE_JUMP, MODE_AUTO)
        use_pull = mode in (MODE_PULL, MODE_AUTO)
        dev = table.device
        zero = None
        if gate is not None or gated or use_pull:
            zero = torch.zeros(self.n_super, dtype=torch.int32, device=dev)
        base = zero if gate is None else gate
        trans_w = keep & active if use_jump else None  # jump-transparent
        jump_form = "cuda" if dev.type == "cuda" else "torch"
        st = None
        if stats:
            st = {k: torch.zeros(MAX_SWEEP_STATS, dtype=torch.int32,
                                 device=dev)
                  for k in ("dirty_chunks", "changed_supers",
                            "tiles_skipped", "pull_on")}
            st["full_tiles"] = torch.zeros((), dtype=torch.int64, device=dev)
        with _span(spans.wait):
            n_dirty = int(d[self.n_chunks])  # readback: the loop's changed flag
        waits = 1
        go = n_dirty > 0
        if not go and gate is not None:
            with _span(spans.wait):
                go = bool(gate.any())  # readback: a forced tile sweeps once
            waits += 1
        sweeps = 0
        while go:
            pull_on = use_pull and pull_switch(mode, n_dirty, self.pull_cut)
            with _span(spans.sweep, dirty_groups=n_dirty, pull=pull_on):
                g = base
                if use_pull:
                    with _span(spans.gate):
                        if pull_on:
                            g = pull_gate(base, mark_w, keep, self.n_super,
                                          self.sup_words)
                hit_w = self.sweep(table, d, layout_args, gate=g)
                new_mark_w = mark_w | (hit_w & keep)
                if use_jump:
                    with _span(spans.jump, form=jump_form):
                        jump_w, jump_j = jump_sweep_words(table, jump_j,
                                                          trans_w, keep, self.n)
                        new_mark_w |= jump_w
                new_table = new_mark_w if active is None else new_mark_w & active
                if st is not None:
                    i = min(sweeps, MAX_SWEEP_STATS - 1)
                    st["dirty_chunks"][i] = n_dirty
                    st["changed_supers"][i] = super_changed.sum()
                    if pull_on:
                        st["tiles_skipped"][i] = (g == GATE_SKIP).sum()
                    if use_pull:
                        st["pull_on"][i] = int(pull_on)
                    if sweeps == 0 and gate is not None:
                        st["full_tiles"] = (g == GATE_FULL).sum()
                with _span(spans.dirty):
                    d, super_changed = self.frontier(new_table, table, stats)
                mark_w, table, base = new_mark_w, new_table, zero
                sweeps += 1
                with _span(spans.wait):
                    n_dirty = int(d[self.n_chunks])  # readback: the changed flag
                waits += 1
                go = n_dirty > 0
        return mark_w, table, sweeps, waits, st


def _build_trace_fn_multi(
    n: int,
    specs: tuple,
    n_super: int,
    r_rows: int,
    s_rows: int,
    mode: str = MODE_PUSH,
    pull_density: float = DEFAULT_PULL_DENSITY,
    with_stats: bool = False,
):
    """Trace fn over one or more pair layouts sharing a node space:
    fn(flags, recv_count, [jump_parent,] *layout_args) -> marks, on the
    device of its arguments.

    ``specs`` holds one static shape signature per layout (``layout_spec``):
      ("dense", n_blocks, sub, group)   — full layout, every supertile
      ("compact", n_blocks, out_tiles, sub, group) — only touched
        supertiles, mapped to global supertiles by the layout's
        ``super_ids`` operand
      ("xla", capacity)                 — raw pair arrays propagated by a
        scatter-max; the landing tier for the newest churn
    Packed layouts sharing a trace must share (sub, group): the walk
    geometry fixes the dirty-list granularity.

    ``mode`` selects the propagation strategy (module MODE_* docs); jump
    and auto modes take a jump-parent operand right after flags/recv.
    ``with_stats`` returns (marks, stats): the sweep count, the host
    syncs the loop made, and the per-sweep frontier decomposition (dirty
    chunks, changed supertiles, tiles skipped, pull-gate decision)."""
    F = trace_ops
    loop = SweepLoop(n, specs, n_super, r_rows, s_rows, mode, pull_density)

    def trace_fn(flags, recv_count, *rest):
        jump_j, layout_args = loop.split_jump(rest)
        with events.span("uigc.fixpoint", layouts=len(specs),
                         mode=mode) as fixpoint:
            with events.span("uigc.fixpoint.seed"):
                in_use = F.flag_set(flags, F.FLAG_IN_USE)
                halted = F.flag_set(flags, F.FLAG_HALTED)
                # Gate tables: in_use bits (mark gating) and ~halted bits
                # (propagation gating); bits >= n stay 0 in both.
                iu_w = loop.pack(in_use)
                nh_w = loop.pack(~halted)
                mark_w = loop.pack(
                    in_use & ~halted & F.seeds_torch(flags, recv_count))
                state = loop.start(mark_w, torch.zeros_like(mark_w), nh_w,
                                   stats=with_stats)
            mark_w, _, sweeps, waits, st = loop.run(
                state, iu_w, nh_w, layout_args, jump_j=jump_j)
            with events.span("uigc.fixpoint.unpack"):
                marks = unpack_table(mark_w, n)
            fixpoint.set(sweeps=sweeps, waits=waits)
        if not with_stats:
            return marks
        return marks, dict(st, n_sweeps=sweeps, host_syncs=waits)

    return trace_fn


def get_trace_fn(
    prep: Dict,
    mode: str = MODE_PUSH,
    pull_density: float = DEFAULT_PULL_DENSITY,
    with_stats: bool = False,
):
    """Cached trace fn for a packed layout (host or device form)."""
    return get_trace_fn_multi(
        prep["n"],
        (layout_spec(prep),),
        prep["n_super"],
        prep["r_rows"],
        prep["s_rows"],
        mode=mode,
        pull_density=pull_density,
        with_stats=with_stats,
    )


def cached_fn(cache: Dict, tag: str, build, key: tuple):
    """``build(*key)``, memoised in ``cache`` by ``key``, a layout
    geometry: every lookup commits a ``tpu.compile`` hit or miss under
    ``tag``.  A miss is a new geometry, the churn the
    ``recompile_storm`` alert reads (the rule in telemetry/device.py).
    Building a fn compiles nothing; the kernel library is built once, on
    first launch."""
    # No lock: collectors of several systems on one card can miss here
    # together and build the same fn twice; both are equal, the last
    # store wins, and each miss commits its own compile event.
    fn = cache.get(key)
    if fn is None:
        t0 = time.perf_counter()
        fn = cache[key] = build(*key)
        if events.recorder.enabled:
            events.recorder.commit(
                events.COMPILE, duration_s=time.perf_counter() - t0,
                tag=tag, geom=events.compile_geom(key), hit=False,
            )
    elif events.recorder.enabled:
        events.recorder.commit(
            events.COMPILE, tag=tag, geom=events.compile_geom(key), hit=True,
        )
    return fn


def get_trace_fn_multi(
    n: int,
    specs: tuple,
    n_super: int,
    r_rows: int,
    s_rows: int,
    mode: str = MODE_PUSH,
    pull_density: float = DEFAULT_PULL_DENSITY,
    with_stats: bool = False,
):
    """Cached trace fn over one or more pair layouts (operands per layout
    in ``device_args`` order, after flags/recv — and, for jump/auto
    modes, after the jump-parent operand); tag ``trace_fn`` in
    :func:`cached_fn`."""
    key = (n, tuple(specs), n_super, r_rows, s_rows, mode, pull_density,
           with_stats)
    return cached_fn(_fn_cache, "trace_fn", _build_trace_fn_multi, key)


def _host(x):
    """A stats value as the reference returns it: numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()  # readback: host boundary: stats -> np
    return np.asarray(x)  # readback: not a tensor: a host value already


def trace_marks_prepared(flags, recv_count, prep: Dict, device=None) -> np.ndarray:
    """Run the trace against one packed layout."""
    return trace_marks_layouts(flags, recv_count, [prep], device=device)


def trace_marks_layouts(
    flags,
    recv_count,
    preps,
    device=None,
    mode: str = MODE_PUSH,
    pull_density: float = DEFAULT_PULL_DENSITY,
    jump_parent=None,
    with_stats: bool = False,
):
    """Run the trace against one or more pair layouts that share a node
    space (their hits are ORed into one word plane per sweep, so the
    union of the layouts' pairs propagates).  The
    first layout must be a packed (non-xla) one; it pins the geometry.
    Inputs may be numpy arrays or tensors; the trace runs on ``device``
    (default: the CUDA card) and returns numpy, as the reference does.

    ``mode`` jump/auto requires ``jump_parent`` — the (n + 1,) min-source
    parent array over the SAME live pair set the layouts hold; a stale
    parent crossing a deleted pair would propagate marks along a dead
    edge."""
    dev = resolve_device(device)
    first = preps[0]
    n = first["n"]
    require("xla_src" not in first, "trace.layouts",
            "first layout pins the packed geometry")
    for p in preps[1:]:
        require(p["n"] == n, "trace.layouts",
                "layouts must share the node space")
        if "xla_src" not in p:
            require(
                all(p[k] == first[k]
                    for k in ("n_super", "r_rows", "s_rows", "sub", "group")),
                "trace.layouts", "layouts must share node-space geometry",
            )
    fn = get_trace_fn_multi(
        n,
        tuple(layout_spec(p) for p in preps),
        first["n_super"],
        first["r_rows"],
        first["s_rows"],
        mode=mode,
        pull_density=pull_density,
        with_stats=with_stats,
    )
    args = []
    if mode in (MODE_JUMP, MODE_AUTO):
        require(
            jump_parent is not None, "trace.jump_parent",
            "jump modes need the parent array", mode=mode,
        )
        args.append(torch.as_tensor(jump_parent).to(dev, torch.int32))
    for p in preps:
        args.extend(device_args(layout_to_device(p, dev)))
    out = fn(
        torch.as_tensor(flags[:n]).to(dev, torch.uint8),
        torch.as_tensor(recv_count[:n]).to(dev, torch.int64),
        *args,
    )
    if with_stats:
        marks, stats = out
        return _host(marks), {k: _host(v) for k, v in stats.items()}
    return _host(out)


def trace_marks_cuda(
    flags, recv_count, supervisor, edge_src, edge_dst, edge_weight,
    mode: str = MODE_PUSH, device=None,
) -> np.ndarray:
    """Same contract as trace_marks_np/_torch, the propagate kernel
    inside; runs on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    n = flags.shape[0]
    edge_src, edge_dst, edge_weight, supervisor = (
        np.asarray(a)  # readback: host inputs, as trace_marks_np takes them
        for a in (edge_src, edge_dst, edge_weight, supervisor))
    prep = prepare_chunks(edge_src, edge_dst, edge_weight, supervisor, n)
    jp = None
    if mode in (MODE_JUMP, MODE_AUTO):
        jp = jump_parents_from_graph(edge_src, edge_dst, edge_weight,
                                     supervisor, n)
    return trace_marks_layouts(
        np.asarray(flags), np.asarray(recv_count),  # readback: host inputs
        [prep], device=dev,
        mode=mode, jump_parent=jp,
    )


# --------------------------------------------------------------------- #
# Marking parents (why-live provenance)
# --------------------------------------------------------------------- #


def marking_parents_torch(flags, recv_count, supervisor, edge_src, edge_dst,
                          edge_weight, device=None):
    """Mark fixpoint with marking-parent capture, on ``device`` (default:
    the CUDA card).  Port of ``marking_parents_jax`` (the XLA fixpoint of
    ``uigc_tpu/ops/pallas_trace.py:_build_parents_fn``), a loop of torch
    ``scatter_reduce_("amin")`` sweeps rather than a kernel: the reference
    is XLA, not Pallas.

    Same mark contract as ``trace_marks_np``; ``parent`` (int32[n]) is -1
    for pseudoroot seeds and unmarked slots, else the minimum source whose
    propagation first marked the slot, exactly as
    ``trace_marks_np_parents`` gives it.  Dead edges and absent
    supervisors scatter into a sink slot ``n``.  The loop reads its
    ``newly`` flag on the host once per sweep.  Returns numpy, as the
    reference does."""
    F = trace_ops
    dev = resolve_device(device)

    def put(a, dtype):
        host = np.asarray(a)  # readback: host inputs, numpy or a list
        return torch.as_tensor(host, device=dev).to(dtype)

    flags = put(flags, torch.uint8)
    recv_count = put(recv_count, torch.int64)
    supervisor = put(supervisor, torch.int64)
    edge_src = put(edge_src, torch.int64)
    edge_dst = put(edge_dst, torch.int64)
    edge_weight = put(edge_weight, torch.int64)
    n = flags.shape[0]
    in_use = F.flag_set(flags, F.FLAG_IN_USE)
    halted = F.flag_set(flags, F.FLAG_HALTED)
    mark = in_use & ~halted & F.seeds_torch(flags, recv_count)
    parent = torch.full((n,), -1, dtype=torch.int64, device=dev)

    live_edge = edge_weight > 0
    sink = torch.full_like(edge_dst, n)
    edst = torch.where(live_edge, edge_dst, sink)
    esrc = torch.where(live_edge, edge_src, sink)
    sup_dst = torch.where(supervisor >= 0, supervisor,
                          torch.full_like(supervisor, n))
    sup_src = torch.arange(n, dtype=torch.int64, device=dev)
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    while True:
        active = mark & ~halted
        active_pad = torch.cat([active, false1])
        cand = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
        cand.scatter_reduce_(0, edst, torch.where(active_pad[esrc], esrc, sink),
                             "amin", include_self=True)
        cand.scatter_reduce_(
            0, sup_dst,
            torch.where(active, sup_src, torch.full_like(sup_src, n)),
            "amin", include_self=True,
        )
        cand = cand[:n]
        newly = (cand < n) & ~mark & in_use
        if not bool(newly.any()):  # host sync: the loop's changed flag
            break
        parent = torch.where(newly, cand, parent)
        mark = mark | newly
    return (mark.cpu().numpy(),  # readback: host boundary: np result contract
            parent.to(torch.int32).cpu().numpy())  # readback: the same
