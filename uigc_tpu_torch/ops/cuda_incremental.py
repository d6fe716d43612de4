"""Incremental pair layout for the CUDA trace: base + frozen + live.

Port of ``uigc_tpu/ops/pallas_incremental.py`` (``IncrementalPallasLayout``
becomes :class:`IncrementalCudaLayout`), held against it mutation for
mutation by ``tests/test_torch_incremental.py``.  The host side is the
reference's; the device-resident operand mirrors are CUDA tensors
updated by O(churn) ``index_put_`` in place of the reference's donated
``jax.jit`` scatters.

The full packer (cuda_trace.prepare_chunks) sorts every live
propagation pair — O(E log E) host work, which at 10M actors / 30M edges
dwarfs the kernel it feeds.  This module keeps the full pack off the
per-wake path with three tiers:

- **Base.**  A dense packed layout built from the whole graph, rebuilt
  only when accumulated churn crosses ``repack_fraction`` of its size.
  Deletions mask the pair's slot in place with the inert ``_PAD_ROW``
  sentinel (the packer's ``want_slots`` map locates it in O(1)); the
  layout, spans and block count never change.
- **Frozen deltas.**  When the live tier overflows, its pairs are packed
  into a *compact* layout (only the supertiles they touch) and appended
  to a chain.  Frozen pairs are slot-mapped (:class:`FrozenSlots`: each
  tier's keys sorted, its slots and live flags beside them), so later
  deletions mask them the same way.  When the chain exceeds
  ``max_frozen`` it is consolidated into one compact layout — O(d log d)
  in the total delta.
- **Live tier.**  The newest insertions sit in a sorted key array and
  ride along as raw pair arrays propagated by a torch scatter-max
  (cuda_trace.xla_tier): zero pack cost, O(capacity) device work per
  fixpoint iteration — cheap while the tier is small, which freezing
  guarantees.

The pair -> slot bookkeeping is array work a batch at a time: a log is
converted once (slotmap.log_columns), folded to its net effect per key
(slotmap.net_log), resolved against the live tier, the frozen tiers and
the base in that order by batch lookups, and applied by fancy indexing;
a tier pack fills its slot map from the packer's slot arrays in one
step.  ``stats`` counts where each fold's keys resolved (``fold_keys``,
``fold_pending``, ``fold_frozen``, ``fold_base``, ``fold_missing``).

The trace launches the propagate kernel once per packed tier, each
ORing its hits into the sweep's one word plane
(cuda_trace.build_sweep_contribs), which is equivalent to one layout
holding the union of the pairs.

Spans (``utils/events.py`` ``span``): ``uigc.layout.fold`` over
:meth:`IncrementalCudaLayout.apply_log`, with the fold's five counts as
args at its end, ``uigc.layout.freeze`` and
``uigc.layout.consolidate`` over the two tier packs, and
``uigc.layout.tiers`` over :meth:`IncrementalCudaLayout.prepare_device_wake`.

Pairs are keyed (src, dst, kind) where kind distinguishes refob edges
from supervisor pointers — the same (src, dst) node pair can legally
carry both (reference: ShadowGraph.java:224-268 treats them as separate
propagation reasons).
"""

from __future__ import annotations

from time import perf_counter
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from . import cuda_trace as pt
from ..utils import events
from ..utils.platform import resolve_device
from ..utils.validation import require
from .slotmap import (
    PackedSlotMap, log_columns, net_log, pack_keys, unpack_keys,
)

#: pair kinds
EDGE = 0
SUP = 1

Key = Tuple[int, int, int]

#: where a fold resolves a key (the order ``_fold`` looks in)
_MISSING, _PENDING, _FROZEN, _BASE = range(4)
_EMPTY = np.zeros(0, dtype=np.int64)


def _in_sorted(sorted_keys: np.ndarray, karr: np.ndarray) -> np.ndarray:
    """Which of ``karr`` are in the sorted array ``sorted_keys``, and
    their positions there (valid where found)."""
    pos = np.searchsorted(sorted_keys, karr)
    if sorted_keys.size == 0:
        return np.zeros(karr.size, dtype=bool), pos
    pos = np.minimum(pos, sorted_keys.size - 1)
    return sorted_keys[pos] == karr, pos


class FrozenSlots:
    """Packed key -> (tier, row, col) over the frozen tiers, in arrays:
    per tier its keys sorted, their slots (``row << 8 | col``) and live
    flags aligned.  A tier is added whole from the packer's slot arrays;
    a removal clears live flags.  A key is live in at most one tier (the
    layout inserts only keys live nowhere)."""

    def __init__(self):
        self.keys: List[np.ndarray] = []
        self.slots: List[np.ndarray] = []
        self.live: List[np.ndarray] = []
        self.size = 0

    def __len__(self) -> int:
        return self.size

    def add_tier(self, keys: np.ndarray, slots: np.ndarray) -> None:
        """A new tier of sorted unique ``keys`` at ``slots``."""
        self.keys.append(keys)
        self.slots.append(slots)
        self.live.append(np.ones(keys.size, dtype=bool))
        self.size += keys.size

    def find(self, karr: np.ndarray):
        """(tier, position in the tier) of each live key of ``karr``;
        tier -1 where none holds it."""
        tier = np.full(karr.size, -1, dtype=np.int64)
        pos = np.zeros(karr.size, dtype=np.int64)
        for t, (keys, live) in enumerate(zip(self.keys, self.live)):
            if keys.size == 0:
                continue
            hit, p = _in_sorted(keys, karr)
            hit &= live[p]
            tier[hit] = t
            pos[hit] = p[hit]
        return tier, pos

    def kill(self, t: int, pos: np.ndarray) -> np.ndarray:
        """Drop tier ``t``'s keys at ``pos``; returns their slots."""
        self.live[t][pos] = False
        self.size -= pos.size
        return self.slots[t][pos]

    def items(self):
        """(keys, tier, row, col) of every live key."""
        parts = [(k[v], np.full(int(v.sum()), t, np.int64), s[v])
                 for t, (k, s, v) in enumerate(
                     zip(self.keys, self.slots, self.live))]
        if not parts:
            return _EMPTY, _EMPTY, _EMPTY, _EMPTY
        keys, tier, slots = (np.concatenate(x) for x in zip(*parts))
        return keys, tier, slots >> 8, slots & 0xFF


class IncrementalCudaLayout:
    """Mutable pair layout with O(changes) per-wake maintenance."""

    def __init__(
        self,
        n: int,
        s_rows: int = pt.S_ROWS,
        repack_fraction: float = 0.25,
        min_repack: int = 1 << 18,
        freeze_threshold: int = 1 << 14,
        max_frozen: int = 4,
        device=None,
        sub: Optional[int] = None,
        group: Optional[int] = None,
        mode: str = pt.MODE_AUTO,
        pull_density: float = pt.DEFAULT_PULL_DENSITY,
    ):
        self.n = n
        self.s_rows = s_rows
        #: where the trace and the operand mirrors live (default: the
        #: CUDA card; "cpu" runs the kernel's plain version)
        self.device = resolve_device(device)
        #: propagation strategy (cuda_trace MODE_*, uigc.crgc.trace-mode)
        require(
            mode in pt.TRACE_MODES, "config.trace_mode",
            "bad trace mode", mode=mode, valid=pt.TRACE_MODES,
        )
        self.mode = mode
        self.pull_density = pull_density
        self.use_jump = mode in (pt.MODE_JUMP, pt.MODE_AUTO)
        # Pin the kernel walk geometry once: base and delta tiers must
        # agree (they share one trace).  Explicit sub/group override the
        # default (the tests cover the reference's wide TPU geometry).
        d_sub, d_group = pt.default_geometry()
        self.sub = d_sub if sub is None else sub
        self.group = d_group if group is None else group
        self.repack_fraction = repack_fraction
        self.min_repack = min_repack
        self.freeze_threshold = freeze_threshold
        self.max_frozen = max_frozen
        self.base: Optional[Dict[str, np.ndarray]] = None
        #: packed (src, dst, kind) key -> packed (row << 8 | col) into the
        #: base row_pos/emeta.  Sorted numpy bulk + churn overlays, so a
        #: rebuild stays vectorized and O(E) ints, not O(E) Python objects.
        self.base_slot = PackedSlotMap()
        #: frozen compact delta layouts
        self.frozen: List[Dict[str, np.ndarray]] = []
        #: packed key -> (frozen index, row, col); churn-bounded
        self.frozen_slots = FrozenSlots()
        #: newest insertions, not yet packed (sorted packed keys)
        self.pending = _EMPTY
        #: masked (deleted-in-place) slots, tracked per home so frozen
        #: masks can be forgiven when consolidation rebuilds the chain
        self.masked_base = 0
        self.masked_frozen = 0
        self._xla_cap = 1 << 10
        #: min-source jump-parent array (n + 1,) for the jump/auto trace
        #: modes.  Invariant: jump_parent[d] is always a CURRENT live
        #: pair's source (or the sentinel n) — a stale pointer would let
        #: the jump sweep propagate marks across a deleted edge.
        #: Maintained per batch (cuda_trace.fold_jump_cols): inserts fold
        #: in by minimum, removing the pair a pointer was built from
        #: invalidates it (best-effort: the next insert or rebuild
        #: re-derives).
        self.jump_parent = np.full(n + 1, n, dtype=np.int32)
        #: queued jump-parent device writes: arrays of changed dsts, the
        #: values read from the host array when the mirror syncs (so the
        #: device scatter is order-independent)
        self._jump_writes: List[np.ndarray] = []
        self._jump_dev = None
        self.stats = {
            "rebuilds": 0,
            "freezes": 0,
            "consolidations": 0,
            "pack_s": 0.0,
            "anomalies": 0,
            # where the folds' distinct keys resolved
            "fold_keys": 0,
            "fold_pending": 0,
            "fold_frozen": 0,
            "fold_base": 0,
            "fold_missing": 0,
        }
        #: device-resident mirrors (trace_device): mirror token -> dict of
        #: device tensors; plus per-prep masked-slot write queues (arrays
        #: of packed row << 8 | col) so the mirror syncs in O(churn)
        #: instead of re-uploading the layout.
        #: Tokens are monotonically assigned and stamped into the prep
        #: dict — keying by id(prep) would serve a stale mirror when the
        #: allocator recycles a freed dict's address.
        self._dev_mirror: Dict[int, dict] = {}
        self._dev_writes: Dict[int, List[np.ndarray]] = {}
        self._mirror_next = 0

    # ----------------------------------------------------------------- #
    # Building
    # ----------------------------------------------------------------- #

    @staticmethod
    def pairs_from_graph(edge_src, edge_dst, edge_weight, supervisor):
        """(psrc, pdst, kinds) for all live propagation pairs."""
        live = edge_weight > 0
        psrc = edge_src[live].astype(np.int64)
        pdst = edge_dst[live].astype(np.int64)
        kinds = np.zeros(psrc.size, dtype=np.int64)
        sup_src = np.nonzero(supervisor >= 0)[0].astype(np.int64)
        if sup_src.size:
            psrc = np.concatenate([psrc, sup_src])
            pdst = np.concatenate([pdst, supervisor[sup_src].astype(np.int64)])
            kinds = np.concatenate([kinds, np.ones(sup_src.size, np.int64)])
        return psrc, pdst, kinds

    def rebuild(self, edge_src, edge_dst, edge_weight, supervisor) -> None:
        """Full repack from the graph arrays (the only O(E log E) step)."""
        t0 = perf_counter()
        psrc, pdst, kinds = self.pairs_from_graph(
            edge_src, edge_dst, edge_weight, supervisor
        )
        self.base = pt.prepare_pairs(
            psrc,
            pdst,
            self.n,
            s_rows=self.s_rows,
            pad_blocks_pow2=True,
            want_slots=True,
            sub=self.sub,
            group=self.group,
        )
        if self.use_jump:
            self.jump_parent = pt.jump_parents(psrc, pdst, self.n)
        self._jump_writes.clear()
        self._jump_dev = None
        slot_ri = self.base.pop("slot_ri")
        slot_col = self.base.pop("slot_col")
        self.base_slot = PackedSlotMap(
            pack_keys(psrc, pdst, kinds), (slot_ri << 8) | slot_col
        )
        self.frozen = []
        self.frozen_slots = FrozenSlots()
        self.pending = _EMPTY
        self.masked_base = 0
        self.masked_frozen = 0
        self.stats["rebuilds"] += 1
        self.stats["pack_s"] += perf_counter() - t0

    def _pack_tier(self, keys: np.ndarray) -> None:
        """Pack sorted ``keys`` into a compact frozen layout, appended to
        the chain with its slot map."""
        psrc, pdst = unpack_keys(keys)
        prep = pt.prepare_pairs(
            psrc,
            pdst,
            self.n,
            s_rows=self.s_rows,
            pad_blocks_pow2=True,
            want_slots=True,
            compact_supers=True,
            sub=self.sub,
            group=self.group,
        )
        slots = (prep.pop("slot_ri") << 8) | prep.pop("slot_col")
        self.frozen.append(prep)
        self.frozen_slots.add_tier(keys, slots)

    def _freeze_pending(self) -> None:
        """Pack the live tier into a compact frozen layout."""
        with events.span("uigc.layout.freeze"):
            t0 = perf_counter()
            self._pack_tier(self.pending)
            self.pending = _EMPTY
            self.stats["freezes"] += 1
            self.stats["pack_s"] += perf_counter() - t0

    def _consolidate_frozen(self) -> None:
        """Merge the frozen chain into one compact layout."""
        with events.span("uigc.layout.consolidate"):
            t0 = perf_counter()
            # each tier's keys are sorted: a merge of sorted runs
            keys = np.sort(self.frozen_slots.items()[0], kind="stable")
            self.frozen = []
            self.frozen_slots = FrozenSlots()
            # consolidation dropped every masked frozen slot
            self.masked_frozen = 0
            self.stats["consolidations"] += 1
            if keys.size:
                self._pack_tier(keys)
                self.stats["pack_s"] += perf_counter() - t0

    # ----------------------------------------------------------------- #
    # Mutation (array work per batch)
    # ----------------------------------------------------------------- #

    def insert(self, src: int, dst: int, kind: int) -> None:
        self._fold(log_columns([(True, src, dst, kind)]))

    def remove(self, src: int, dst: int, kind: int) -> None:
        self._fold(log_columns([(False, src, dst, kind)]))

    def _mask(self, prep, slots: np.ndarray) -> None:
        """Mask ``prep``'s slots (packed row << 8 | col) in place and
        queue them for its device mirror."""
        ri, col = slots >> 8, slots & 0xFF
        prep["row_pos"][ri, col] = pt._PAD_ROW
        prep["emeta"][ri, col] = 0
        tok = prep.get("_mirror_token")
        writes = self._dev_writes.get(tok) if tok is not None else None
        if writes is not None:
            writes.append(slots)

    def apply_log(self, log) -> None:
        """Batched replay of a pair-transition log [(insert?, src, dst,
        kind), ...].  Equivalent to calling insert/remove in order
        (including anomaly accounting for caller-side drift), but as
        array work for the whole batch (slotmap.net_log documents the
        net-effect argument)."""
        with events.span("uigc.layout.fold") as span:
            span.set(**self._fold(log_columns(log)))

    def _fold(self, cols: np.ndarray) -> Dict[str, int]:
        """:meth:`apply_log` on a log in slotmap.log_columns form, without
        its span, for a caller that opens the fold's span around work of
        its own too (the decremental tracer's suspect sets).  Returns the
        fold's counts of where its keys resolved."""
        if self.use_jump:
            # Batched jump-parent maintenance (pt.fold_jump_cols):
            # conservative about insert-and-remove-in-one-batch pairs,
            # so an insert-then-remove of the pair a pointer came from
            # always leaves it invalidated, exactly as sequential
            # insert()/remove() calls would.
            changed = pt.fold_jump_cols(self.jump_parent, cols, self.n)
            if self._jump_dev is not None and changed.size:
                self._jump_writes.append(changed)
        keys, first, last = net_log(cols)
        first_ins, last_ins = cols[0][first] != 0, cols[0][last] != 0

        # First op a remove: remove from the home (absent: drift).
        # Insert first, remove last: a no-op for a fresh key, but a key
        # already live had an anomalous insert and a real remove.  Last
        # op an insert: a duplicate of a key still live is drift, and the
        # key leaves its home for the live tier only if a remove came
        # between; else the key goes to the live tier, after the removals.
        removes = ~first_ins
        leaves = removes | ~last_ins | (first != last)  # if it has a home

        # Each key's home before the fold, looked up in the order the
        # scalar replay looks: the live tier, the frozen tiers, the base
        # (popped there at once where the key leaves it).
        home = np.full(keys.size, _MISSING, dtype=np.int8)
        in_p, p_pos = _in_sorted(self.pending, keys)
        home[in_p] = _PENDING
        rest = np.nonzero(~in_p)[0]
        ftier, fpos = self.frozen_slots.find(keys[rest])
        in_f = ftier >= 0
        home[rest[in_f]] = _FROZEN
        f_out = leaves[rest[in_f]]
        ftier, fpos = ftier[in_f][f_out], fpos[in_f][f_out]
        rest = rest[~in_f]
        b_out = leaves[rest]
        b_vals = np.empty(rest.size, dtype=np.int64)
        b_vals[b_out] = self.base_slot.pop_batch(keys[rest[b_out]])
        b_vals[~b_out] = self.base_slot.get_batch(keys[rest[~b_out]])
        in_b = b_vals >= 0
        home[rest[in_b]] = _BASE
        found = home != _MISSING
        self.stats["anomalies"] += int(
            (removes & ~found).sum()
            + (first_ins & ~last_ins & found).sum()
            + (first_ins & last_ins & found).sum()
        )

        for t in np.unique(ftier).tolist():
            pos = fpos[ftier == t]
            self._mask(self.frozen[t], self.frozen_slots.kill(t, pos))
            self.masked_frozen += pos.size
        b_slots = b_vals[b_out & in_b]
        if b_slots.size:
            self._mask(self.base, b_slots)
            self.masked_base += b_slots.size
        pending = np.delete(self.pending, p_pos[leaves & in_p])
        new = keys[last_ins & (leaves | ~found)]  # sorted, as keys are
        self.pending = np.insert(pending, np.searchsorted(pending, new), new)

        counts = {
            "fold_keys": int(keys.size),
            "fold_pending": int(in_p.sum()),
            "fold_frozen": int(in_f.sum()),
            "fold_base": int((home == _BASE).sum()),
            "fold_missing": int((~found).sum()),
        }
        for k, v in counts.items():
            self.stats[k] += v
        return counts

    @property
    def churn(self) -> int:
        return (
            len(self.frozen_slots)
            + len(self.pending)
            + self.masked_base
            + self.masked_frozen
        )

    @property
    def needs_repack(self) -> bool:
        base_pairs = self.base["n_pairs"] if self.base is not None else 0
        return self.churn > max(
            self.min_repack, int(self.repack_fraction * base_pairs)
        )

    # ----------------------------------------------------------------- #
    # Trace
    # ----------------------------------------------------------------- #

    def prepare_wake(self) -> list:
        """The per-wake layout maintenance: freeze an overflowing live
        tier, consolidate an overlong frozen chain, and materialize the
        tier list for this trace.  Split out from :meth:`trace` so its
        host cost can be measured without launching the kernel."""
        assert self.base is not None, "rebuild() before trace()"
        if len(self.pending) > self.freeze_threshold:
            self._freeze_pending()
        if len(self.frozen) > self.max_frozen:
            self._consolidate_frozen()
        preps = [self.base] + self.frozen
        if self.pending.size:
            m = self.pending.size
            while self._xla_cap < m:
                self._xla_cap *= 2
            psrc, pdst = unpack_keys(self.pending)
            preps.append(pt.xla_tier(psrc, pdst, self.n, self._xla_cap))
        return preps

    def trace(self, flags, recv_count, with_stats: bool = False):
        preps = self.prepare_wake()
        return pt.trace_marks_layouts(
            flags, recv_count, preps, device=self.device,
            mode=self.mode, pull_density=self.pull_density,
            jump_parent=self.jump_parent if self.use_jump else None,
            with_stats=with_stats,
        )

    # ----------------------------------------------------------------- #
    # Device-resident trace (steady-state wake path)
    # ----------------------------------------------------------------- #

    def _device_args(self, prep) -> list:
        """Device operands for one layout, from a mirror that lives on
        the device across wakes and syncs only the slots masked since the
        last sync (an O(churn) ``index_put_``, not an O(layout)
        re-upload)."""
        if "xla_src" in prep:
            # the live tier is small and fully rebuilt per wake
            return list(pt.device_args(pt.layout_to_device(prep, self.device)))
        pid = prep.get("_mirror_token")
        if pid is None:
            pid = prep["_mirror_token"] = self._mirror_next
            self._mirror_next += 1
        mirror = self._dev_mirror.get(pid)
        if mirror is None:
            mirror = self._dev_mirror[pid] = pt.layout_to_device(
                prep, self.device
            )
            self._dev_writes[pid] = []
        else:
            writes = self._dev_writes[pid]
            if writes:
                packed = torch.from_numpy(np.concatenate(writes)).to(
                    self.device
                )
                rows, cols = packed >> 8, packed & 0xFF
                mirror["row_pos"][rows, cols] = int(pt._PAD_ROW)
                mirror["emeta"][rows, cols] = 0
                writes.clear()
        return list(pt.device_args(mirror))

    def jump_device(self):
        """The device-resident jump-parent mirror, synced with the
        queued host writes (an O(churn) ``index_put_``, like the
        masked-slot mirrors — the parent array never re-uploads per
        wake)."""
        if self._jump_dev is None:
            self._jump_dev = torch.from_numpy(self.jump_parent).to(
                self.device, copy=True
            )
            self._jump_writes.clear()
        elif self._jump_writes:
            idx = np.unique(np.concatenate(self._jump_writes))
            self._jump_dev[torch.from_numpy(idx).to(self.device)] = (
                torch.from_numpy(self.jump_parent[idx]).to(self.device)
            )
            self._jump_writes.clear()
        return self._jump_dev

    def prepare_device_wake(self):
        """prepare_wake + device-operand assembly + mirror GC: the
        device-resident wake entry shared by :meth:`trace_device` and the
        decremental tracer (ops/cuda_decremental.py).  Returns
        (preps, args) with the jump-parent mirror leading ``args`` for
        jump/auto-mode layouts."""
        with events.span("uigc.layout.tiers"):
            preps = self.prepare_wake()
            args = []
            if self.use_jump:
                args.append(self.jump_device())
            for p in preps:
                args.extend(self._device_args(p))
            live_tokens = {
                p["_mirror_token"] for p in preps if "_mirror_token" in p
            }
            for pid in list(self._dev_mirror):
                if pid not in live_tokens:
                    del self._dev_mirror[pid]
                    self._dev_writes.pop(pid, None)
            return preps, args

    def trace_device(self, flags_dev, recv_dev, with_stats: bool = False):
        """Like :meth:`trace`, but every packed layout's operands stay
        device-resident between wakes (the reference's steady state:
        LocalGC.scala:144-186 never re-ships its graph per wake) and the
        mark vector is returned as a device tensor, so callers can reduce
        garbage counts/ids on device instead of pulling 10M bools.
        ``with_stats`` returns (marks, stats) with the stats left as
        the fixpoint made them (device tensors and host ints)."""
        preps, args = self.prepare_device_wake()
        fn = pt.get_trace_fn_multi(
            self.n,
            tuple(pt.layout_spec(p) for p in preps),
            preps[0]["n_super"],
            preps[0]["r_rows"],
            preps[0]["s_rows"],
            mode=self.mode,
            pull_density=self.pull_density,
            with_stats=with_stats,
        )
        return fn(flags_dev, recv_dev, *args)
