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
  to a chain.  Frozen pairs are slot-mapped, so later deletions mask
  them the same way.  When the chain exceeds ``max_frozen`` it is
  consolidated into one compact layout — O(d log d) in the total delta.
- **Live tier.**  The newest insertions sit in an ordered dict and ride
  along as raw pair arrays propagated by a torch scatter-max
  (cuda_trace.xla_tier): zero pack cost, O(capacity) device work per
  fixpoint iteration — cheap while the tier is small, which freezing
  guarantees.

The trace launches the propagate kernel once per packed tier, each
ORing its hits into the sweep's one word plane
(cuda_trace.build_sweep_contribs), which is equivalent to one layout
holding the union of the pairs.

Spans (``utils/events.py`` ``span``): ``uigc.layout.fold`` over
:meth:`IncrementalCudaLayout.apply_log`, ``uigc.layout.freeze`` and
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
from .slotmap import PackedSlotMap, fold_log, pack_key, pack_keys, unpack_keys

#: pair kinds
EDGE = 0
SUP = 1

Key = Tuple[int, int, int]


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
        #: packed key -> (frozen index, row, col); churn-bounded, plain dict
        self.frozen_slot: Dict[int, Tuple[int, int, int]] = {}
        #: newest insertions, not yet packed (ordered set of packed keys)
        self.pending: Dict[int, None] = {}
        #: masked (deleted-in-place) slots, tracked per home so frozen
        #: masks can be forgiven when consolidation rebuilds the chain
        self.masked_base = 0
        self.masked_frozen = 0
        self._xla_cap = 1 << 10
        #: min-source jump-parent array (n + 1,) for the jump/auto trace
        #: modes.  Invariant: jump_parent[d] is always a CURRENT live
        #: pair's source (or the sentinel n) — a stale pointer would let
        #: the jump sweep propagate marks across a deleted edge.
        #: Maintained O(1) per mutation: inserts fold in by minimum,
        #: removing the pair a pointer was built from invalidates it
        #: (best-effort: the next insert or rebuild re-derives).
        self.jump_parent = np.full(n + 1, n, dtype=np.int32)
        #: queued jump-parent device writes (dst -> final host value;
        #: last-wins dedup keeps the device scatter order-independent)
        self._jump_writes: Dict[int, int] = {}
        self._jump_dev = None
        self.stats = {
            "rebuilds": 0,
            "freezes": 0,
            "consolidations": 0,
            "pack_s": 0.0,
            "anomalies": 0,
        }
        #: device-resident mirrors (trace_device): mirror token -> dict of
        #: device tensors; plus per-prep masked-slot write queues so the
        #: mirror syncs in O(churn) instead of re-uploading the layout.
        #: Tokens are monotonically assigned and stamped into the prep
        #: dict — keying by id(prep) would serve a stale mirror when the
        #: allocator recycles a freed dict's address.
        self._dev_mirror: Dict[int, dict] = {}
        self._dev_writes: Dict[int, List[int]] = {}
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
        self.frozen_slot = {}
        self.pending.clear()
        self.masked_base = 0
        self.masked_frozen = 0
        self.stats["rebuilds"] += 1
        self.stats["pack_s"] += perf_counter() - t0

    def _freeze_pending(self) -> None:
        """Pack the live tier into a compact frozen layout."""
        with events.span("uigc.layout.freeze"):
            t0 = perf_counter()
            keys = list(self.pending)
            m = len(keys)
            psrc, pdst = unpack_keys(np.fromiter(keys, np.int64, m))
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
            slot_ri = prep.pop("slot_ri")
            slot_col = prep.pop("slot_col")
            fidx = len(self.frozen)
            self.frozen.append(prep)
            for key, ri, co in zip(keys, slot_ri, slot_col):
                self.frozen_slot[key] = (fidx, int(ri), int(co))
            self.pending.clear()
            self.stats["freezes"] += 1
            self.stats["pack_s"] += perf_counter() - t0

    def _consolidate_frozen(self) -> None:
        """Merge the frozen chain into one compact layout."""
        with events.span("uigc.layout.consolidate"):
            t0 = perf_counter()
            keys = list(self.frozen_slot)
            m = len(keys)
            if m == 0:
                self.frozen = []
                self.masked_frozen = 0
                self.stats["consolidations"] += 1
                return
            psrc, pdst = unpack_keys(np.fromiter(keys, np.int64, m))
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
            slot_ri = prep.pop("slot_ri")
            slot_col = prep.pop("slot_col")
            self.frozen = [prep]
            self.frozen_slot = {
                key: (0, int(ri), int(co))
                for key, ri, co in zip(keys, slot_ri, slot_col)
            }
            # consolidation dropped every masked frozen slot
            self.masked_frozen = 0
            self.stats["consolidations"] += 1
            self.stats["pack_s"] += perf_counter() - t0

    # ----------------------------------------------------------------- #
    # Mutation (O(1) per changed pair)
    # ----------------------------------------------------------------- #

    def _jump_insert(self, src: int, dst: int) -> None:
        """Fold a new live pair into the jump-parent array (minimum
        wins, see jump_parents); O(1), queued for the device mirror."""
        if not self.use_jump or dst >= self.n or src >= self.n:
            return
        if src < self.jump_parent[dst]:
            self.jump_parent[dst] = src
            if self._jump_dev is not None:
                self._jump_writes[dst] = src

    def _jump_remove(self, src: int, dst: int) -> None:
        """Invalidate the jump parent if it was built from this pair.
        Conservative: another live pair with the same (src, dst) node
        ids (the other kind) may remain, but a spurious invalidation
        only costs acceleration, never soundness."""
        if not self.use_jump or dst >= self.n:
            return
        if self.jump_parent[dst] == src:
            self.jump_parent[dst] = self.n
            if self._jump_dev is not None:
                self._jump_writes[dst] = self.n

    def insert(self, src: int, dst: int, kind: int) -> None:
        key = pack_key(src, dst, kind)
        self._jump_insert(src, dst)
        if key in self.pending or key in self.frozen_slot or key in self.base_slot:
            # The graph layer only reports dead->live transitions, so a
            # duplicate means caller-side accounting drift; the pair is
            # already live here, which keeps the trace correct.
            self.stats["anomalies"] += 1
            return
        self.pending[key] = None

    def _queue_dev_write(self, prep, ri, col) -> None:
        """Record a masked slot for the device mirror (packed ri<<8|col)."""
        tok = prep.get("_mirror_token")
        if tok is None:
            return
        writes = self._dev_writes.get(tok)
        if writes is not None:
            writes.append((int(ri) << 8) | int(col))

    def remove(self, src: int, dst: int, kind: int) -> None:
        key = pack_key(src, dst, kind)
        self._jump_remove(src, dst)
        if key in self.pending:
            del self.pending[key]
            return
        slot = self.frozen_slot.pop(key, None)
        if slot is not None:
            fidx, ri, col = slot
            prep = self.frozen[fidx]
            prep["row_pos"][ri, col] = pt._PAD_ROW
            prep["emeta"][ri, col] = 0
            self._queue_dev_write(prep, ri, col)
            self.masked_frozen += 1
            return
        packed = self.base_slot.pop(key)
        if packed is None:
            self.stats["anomalies"] += 1
            return
        ri, col = packed >> 8, packed & 0xFF
        self.base["row_pos"][ri, col] = pt._PAD_ROW
        self.base["emeta"][ri, col] = 0
        self._queue_dev_write(self.base, ri, col)
        self.masked_base += 1

    def _mask_base_slots(self, vals: np.ndarray) -> int:
        """Mask base slots from packed (row << 8 | col) values (-1 =
        absent); returns how many were found."""
        found = vals >= 0
        ri = vals[found] >> 8
        col = vals[found] & 0xFF
        self.base["row_pos"][ri, col] = pt._PAD_ROW
        self.base["emeta"][ri, col] = 0
        tok = self.base.get("_mirror_token")
        writes = self._dev_writes.get(tok) if tok is not None else None
        if writes is not None:
            writes.extend(vals[found].tolist())
        n = int(found.sum())
        self.masked_base += n
        return n

    def _remove_key(self, k: int, base_rem: List[int]) -> bool:
        """Remove ``k`` from pending/frozen, or defer it to the batched
        base lookup; returns False only when deferred."""
        if k in self.pending:
            del self.pending[k]
            return True
        slot = self.frozen_slot.pop(k, None)
        if slot is not None:
            fidx, ri, col = slot
            prep = self.frozen[fidx]
            prep["row_pos"][ri, col] = pt._PAD_ROW
            prep["emeta"][ri, col] = 0
            self._queue_dev_write(prep, ri, col)
            self.masked_frozen += 1
            return True
        base_rem.append(k)
        return False

    def apply_log(self, log) -> None:
        """Batched replay of a pair-transition log [(insert?, src, dst,
        kind), ...].  Equivalent to calling insert/remove in order
        (including anomaly accounting for caller-side drift), but
        base-slot lookups are one vectorized binary search for the whole
        batch instead of a scalar search per pair (slotmap.fold_log
        documents the net-effect argument)."""
        with events.span("uigc.layout.fold"):
            self._fold_log(log)

    def _fold_log(self, log) -> None:
        """:meth:`apply_log` without its span, for a caller that opens
        the fold's span around work of its own too (the decremental
        tracer's suspect sets)."""
        if self.use_jump:
            # Batched jump-parent maintenance (pt.fold_jump_log):
            # conservative about insert-and-remove-in-one-batch pairs,
            # so an insert-then-remove of the pair a pointer came from
            # always leaves it invalidated, exactly as sequential
            # insert()/remove() calls would.
            pt.fold_jump_log(
                self.jump_parent, log, self.n,
                self._jump_writes if self._jump_dev is not None else None,
            )
        removes, cond_removes, inserts = fold_log(log)

        base_rem: List[int] = []
        for k in removes:
            self._remove_key(k, base_rem)
        if base_rem:
            vals = self.base_slot.pop_batch(
                np.fromiter(base_rem, np.int64, len(base_rem))
            )
            n_found = self._mask_base_slots(vals)
            self.stats["anomalies"] += len(base_rem) - n_found

        # Insert-first/remove-last keys: net no-op unless the key was
        # already live (anomalous duplicate insert followed by a real
        # remove) — then remove it, like the sequential replay would.
        cond_base: List[int] = []
        for k in cond_removes:
            if k in self.pending or k in self.frozen_slot:
                self.stats["anomalies"] += 1
                self._remove_key(k, cond_base)
            else:
                cond_base.append(k)
        if cond_base:
            vals = self.base_slot.pop_batch(
                np.fromiter(cond_base, np.int64, len(cond_base))
            )
            self.stats["anomalies"] += self._mask_base_slots(vals)

        if inserts:
            fresh: List[int] = []
            for k in inserts:
                if k in self.pending or k in self.frozen_slot:
                    self.stats["anomalies"] += 1
                    continue
                self.pending[k] = None
                fresh.append(k)
            if fresh:
                # Anomalous duplicate-with-base inserts are harmless for
                # liveness (contributions are OR'd) but tracked for
                # diagnostics, batched.
                karr = np.fromiter(fresh, np.int64, len(fresh))
                present = self.base_slot.get_batch(karr) >= 0
                n_dup = int(present.sum())
                if n_dup:
                    self.stats["anomalies"] += n_dup
                    for k in karr[present].tolist():
                        del self.pending[k]

    @property
    def churn(self) -> int:
        return (
            len(self.frozen_slot)
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
        if self.pending:
            m = len(self.pending)
            while self._xla_cap < m:
                self._xla_cap *= 2
            psrc, pdst = unpack_keys(np.fromiter(self.pending, np.int64, m))
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
                packed = torch.from_numpy(
                    np.fromiter(writes, np.int64, len(writes))
                ).to(self.device)
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
            k = len(self._jump_writes)
            idx = np.fromiter(self._jump_writes.keys(), np.int64, k)
            vals = np.fromiter(self._jump_writes.values(), np.int64, k)
            self._jump_dev[torch.from_numpy(idx).to(self.device)] = (
                torch.from_numpy(vals.astype(np.int32)).to(self.device)
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
