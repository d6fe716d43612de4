"""Decremental per-wake garbage detection: suspect closure + region repair.

Port of ``uigc_tpu/ops/pallas_decremental.py`` (``_build_wake_fn`` and
``DecrementalTracer``), held against the reference tracer and the numpy
oracle wake for wake by ``tests/test_torch_decremental.py``.  The
reference's wake is one jitted device program with two
``jax.lax.while_loop``s; here both are calls of the full trace's host
loop (``cuda_trace.SweepLoop``), which reads its ``changed`` flag once
per sweep (counted as ``host_syncs`` in the stats).

Marks do not shrink monotonically under churn — releasing a ref can turn
live actors into garbage — so a sound incremental wake must re-derive
exactly the region whose old derivation might have depended on what
changed.  Per wake, relative to the previous fixpoint:

1. **Suspect seeds** ``S``: nodes whose mark derivation inputs may have
   shrunk — destinations of deleted propagation pairs, previously-seed
   nodes that stopped seeding, newly-halted nodes and freed slots — all
   intersected with the previous marks.
2. **Closure**: the forward closure of ``S`` through the current layout,
   restricted to previously-marked nodes — every mark that transitively
   depended on a suspect.  A monotone fixpoint, so the source-side
   dirty-group machinery bounds its cost by the region size.
3. **Repair**: clear the closure's marks, reseed from the current seed
   vector, and run the propagation fixpoint where the FIRST sweep forces
   blocks whose output supertile intersects the closure to walk their
   full chunk span (the gated propagate kernel with ``GATE_FULL``) —
   those supertiles must re-derive contributions from ALL in-edges,
   including sources whose table groups never changed.  Later sweeps are
   monotone growth and fall back to the ordinary dirty-group walk.

Soundness: a previously-marked node outside the closure retains a support
path untouched by any deletion, de-seeding, or halt (otherwise some node
on the path would have entered ``S`` and pushed the rest into the
closure), so its mark stays valid; closure members are re-derived from
scratch against that stable boundary.  A cold start degenerates
gracefully: with zero previous state the suspect set is empty and the
repair fixpoint IS the full trace from seeds.

Spans (``utils/events.py`` ``span``; host values only): ``uigc.wake``
over one :meth:`DecrementalTracer.wake_device` (args ``closure_sweeps``,
``repair_sweeps`` and ``waits`` at its end), ``uigc.wake.ids`` over each
id-set scatter, ``uigc.wake.closure.sweep`` and ``uigc.wake.repair.sweep``
over one sweep of either loop, and ``uigc.wake.wait`` over each
changed-flag read, ``host_syncs`` of them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import cuda_trace as pt
from . import trace as trace_ops
from ..utils import events
from ..utils.validation import require
from .cuda_incremental import IncrementalCudaLayout
from .slotmap import log_columns

_fn_cache: Dict[tuple, object] = {}

CLOSURE_SPANS = pt.LoopSpans("uigc.wake.closure.sweep", "uigc.wake.wait")
REPAIR_SPANS = pt.LoopSpans("uigc.wake.repair.sweep", "uigc.wake.wait")


def _build_wake_fn(
    n: int,
    specs: tuple,
    n_super: int,
    r_rows: int,
    s_rows: int,
    mode: str = pt.MODE_PUSH,
    pull_density: float = pt.DEFAULT_PULL_DENSITY,
    with_stats: bool = False,
):
    """The wake: (flags, recv, del_words, fresh_words, prev state,
    [jump parents,] *layout args) -> (mark_w, seed_w, halted_w, iu_w,
    table, counts) with all word tables (r_rows, LANE) int32 tensors and
    ``counts`` the host ints ``closure_sweeps``, ``n_sweeps`` (the
    repair's) and ``host_syncs`` (every changed-flag read).

    Both phases are calls of one ``cuda_trace.SweepLoop``.  ``mode``
    applies to the REPAIR fixpoint only: on a cold start the repair IS
    the full derivation, which is where the O(diameter) sweep wall lives.
    The closure phase stays a plain push fixpoint: it is bounded by the
    churn's region, and jump hits there would only over-approximate the
    closure.  ``with_stats`` adds to ``counts`` the repair's per-sweep
    frontier decomposition and the FULL-gated tiles of its forced sweep
    (device tensors)."""
    F = trace_ops
    loop = pt.SweepLoop(n, specs, n_super, r_rows, s_rows, mode, pull_density)

    def wake_fn(flags, recv_count, del_w, fresh_w, prev_mark_w,
                prev_seed_w, prev_halted_w, prev_iu_w, prev_table, *rest):
        jump_j, layout_args = loop.split_jump(rest)
        in_use = F.flag_set(flags, F.FLAG_IN_USE)
        halted = F.flag_set(flags, F.FLAG_HALTED)
        seed = F.seeds_torch(flags, recv_count)

        iu_w = loop.pack(in_use)
        nh_w = loop.pack(~halted)
        halted_w = loop.pack(halted)
        seed_w = loop.pack(in_use & ~halted & seed)

        # --- 1. suspect seeds --------------------------------------- #
        # A previously-marked node is suspect when any input of its old
        # derivation may have shrunk: it was freed, it newly halted, it
        # stopped seeding, or an in-edge was deleted.
        s_w = (
            ~iu_w
            | (halted_w & ~prev_halted_w)
            | (prev_seed_w & ~seed_w)
            | del_w
        ) & prev_mark_w

        # --- 2. closure: marks that depended on a suspect ----------- #
        # A push fixpoint grown within the previous marks; one gated
        # sweep form serves both phases (a zero gate makes the gated
        # kernel behave exactly like the plain one).
        closure_w, _, closure_sweeps, closure_waits, _ = loop.run(
            loop.start(s_w, torch.zeros_like(s_w)), prev_mark_w, None,
            layout_args, mode=pt.MODE_PUSH, gated=True, spans=CLOSURE_SPANS)

        # Per-supertile gate: closure members must re-derive; fresh
        # insert destinations must see their new pairs' contributions at
        # least once (a new edge changes no node word, so the dirty
        # machinery alone would never walk it); newly-in-use nodes (slot
        # reuse) likewise.  Gating only ADDS contributions, so it is
        # monotone-safe.  The first repair sweep forces these tiles to
        # walk their whole span (GATE_FULL); later sweeps are monotone
        # growth on the ordinary dirty walk.
        suspect_g = (
            loop.supertile_any(closure_w)
            | loop.supertile_any(fresh_w)
            | loop.supertile_any(iu_w & ~prev_iu_w)
        )

        # --- 3. repair fixpoint ------------------------------------- #
        mark_w, table, sweeps, repair_waits, st = loop.run(
            loop.start((prev_mark_w & ~closure_w) | seed_w, prev_table, nh_w,
                       stats=with_stats),
            iu_w, nh_w, layout_args, jump_j=jump_j, gate=suspect_g,
            spans=REPAIR_SPANS)
        counts = dict(closure_sweeps=closure_sweeps, n_sweeps=sweeps,
                      host_syncs=closure_waits + repair_waits)
        if with_stats:
            counts.update(st)
        return mark_w, seed_w, halted_w, iu_w, table, counts

    return wake_fn


def get_wake_fn(n, specs, n_super, r_rows, s_rows, mode=pt.MODE_PUSH,
                pull_density=pt.DEFAULT_PULL_DENSITY, with_stats=False):
    """Cached wake fn, tag ``dec_wake`` in ``cuda_trace.cached_fn``."""
    key = (n, tuple(specs), n_super, r_rows, s_rows, mode, pull_density,
           with_stats)
    return pt.cached_fn(_fn_cache, "dec_wake", _build_wake_fn, key)


class DecrementalTracer:
    """Per-wake detection state on top of IncrementalCudaLayout.

    Owns the device-resident previous-fixpoint words (marks, seeds,
    halted/in-use bits, active table) and the deleted-destination set
    gathered from the mutation log, and runs the closure+repair wake.
    The first wake (or any wake after the previous state was
    invalidated) runs the full derivation through the same code path.
    Runs on ``device`` (default: the CUDA card).
    """

    def __init__(self, n: int, device=None, **kwargs):
        self.layout = IncrementalCudaLayout(n, device=device, **kwargs)
        self.n = n
        self.device = self.layout.device
        #: when set, each wake runs the with_stats variant of the wake fn
        #: and leaves its stats (device tensors and host ints) in
        #: ``last_stats``
        self.collect_stats = False
        self.last_stats: Optional[dict] = None
        self._mark_w = None
        self._seed_w = None
        self._halted_w = None
        self._iu_w = None
        self._table = None
        #: suspect destinations since the last wake, as id arrays: of
        #: released pairs and of created ones
        self._pending_del_dst: List[np.ndarray] = []
        self._pending_fresh_dst: List[np.ndarray] = []

    # -- building / mutation (layout pass-throughs that watch removals) --

    def rebuild(self, edge_src, edge_dst, edge_weight, supervisor) -> None:
        """Full repack from graph arrays.  The previous fixpoint is
        invalidated: a rebuild may drop pairs that never went through
        remove()/apply_log(), so the next wake re-derives everything."""
        self.layout.rebuild(edge_src, edge_dst, edge_weight, supervisor)
        self.invalidate()

    def insert(self, src: int, dst: int, kind: int) -> None:
        self._fold(log_columns([(True, src, dst, kind)]))

    def remove(self, src: int, dst: int, kind: int) -> None:
        self._fold(log_columns([(False, src, dst, kind)]))

    def apply_log(self, log: List[tuple]) -> None:
        with events.span("uigc.layout.fold") as span:
            span.set(**self._fold(log_columns(log)))

    def _fold(self, cols: np.ndarray) -> Dict[str, int]:
        # Over-approximation is sound: a removal that nets out adds a
        # suspect whose repair is a no-op; an insert dst only forces one
        # full re-derivation of its supertile.
        ins = cols[0] != 0
        dst = cols[2]
        ok = (dst >= 0) & (dst < self.n)
        self._pending_fresh_dst.append(dst[ok & ins])
        self._pending_del_dst.append(dst[ok & ~ins])
        return self.layout._fold(cols)

    # -- the wake ------------------------------------------------------ #

    def _id_words(self, id_arrays: List[np.ndarray],
                  r_rows: int) -> torch.Tensor:
        """Scatter id arrays (repeats allowed) into a packed word table on
        the device.  The arrays are not drained here: wake_device clears
        them only after the wake ran, so a wake that raises keeps its
        suspects."""
        with events.span("uigc.wake.ids"):
            words = np.zeros(r_rows * pt.LANE, dtype=np.uint32)
            if id_arrays:
                ids = np.concatenate(id_arrays)
                np.bitwise_or.at(
                    words, ids >> 5,
                    np.uint32(1) << (ids & 31).astype(np.uint32),
                )
            return torch.from_numpy(
                words.view(np.int32).reshape(r_rows, pt.LANE)
            ).to(self.device)

    def wake_device(self, flags_dev, recv_dev):
        """Run one wake; returns the packed mark words (device).  Use
        :meth:`marks` for the boolean vector."""
        with events.span("uigc.wake") as span:
            mark_w, counts = self._wake(flags_dev, recv_dev)
            span.set(closure_sweeps=counts["closure_sweeps"],
                     repair_sweeps=counts["n_sweeps"],
                     waits=counts["host_syncs"])
        return mark_w

    def _wake(self, flags_dev, recv_dev):
        preps, args = self.layout.prepare_device_wake()
        first = preps[0]
        r_rows = first["r_rows"]
        fn = get_wake_fn(
            self.n,
            tuple(pt.layout_spec(p) for p in preps),
            first["n_super"],
            r_rows,
            first["s_rows"],
            mode=self.layout.mode,
            pull_density=self.layout.pull_density,
            with_stats=self.collect_stats,
        )
        if self._mark_w is None or self._mark_w.shape[0] != r_rows:
            # every previous mark is gone: the zero previous state makes
            # everything re-derive (empty suspects, full seed-diff dirty
            # set)
            z = torch.zeros((r_rows, pt.LANE), dtype=torch.int32,
                            device=self.device)
            self._mark_w = self._seed_w = self._halted_w = z
            self._iu_w = self._table = z
        out = fn(
            flags_dev,
            recv_dev,
            self._id_words(self._pending_del_dst, r_rows),
            self._id_words(self._pending_fresh_dst, r_rows),
            self._mark_w,
            self._seed_w,
            self._halted_w,
            self._iu_w,
            self._table,
            *args,
        )
        *out, counts = out
        if self.collect_stats:
            self.last_stats = counts
        self._mark_w, self._seed_w, self._halted_w, self._iu_w, self._table = out
        self._pending_del_dst.clear()
        self._pending_fresh_dst.clear()
        return self._mark_w, counts

    def invalidate(self) -> None:
        """Drop the previous-fixpoint state: the next wake re-derives
        everything from the current seeds."""
        self._mark_w = self._seed_w = self._halted_w = None
        self._iu_w = self._table = None
        self._pending_del_dst.clear()
        self._pending_fresh_dst.clear()

    def unpack_marks(self, mark_w) -> np.ndarray:
        """Packed mark words -> the oracle's (n,) bool mark vector."""
        return pt.unpack_table(mark_w, self.n).cpu().numpy()  # readback: host boundary: wake marks -> np for the caller

    def marks(self, flags, recv_count) -> np.ndarray:
        """Wake + unpack to the oracle's (n,) bool mark vector."""
        return self.unpack_marks(self.wake_device(
            torch.as_tensor(flags).to(self.device, torch.uint8),
            torch.as_tensor(recv_count).to(self.device, torch.int64),
        ))
