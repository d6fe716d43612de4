"""Decremental per-wake garbage detection: suspect closure + region repair.

Port of ``uigc_tpu/ops/pallas_decremental.py`` (``_build_wake_fn`` and
``DecrementalTracer``), held against the reference tracer and the numpy
oracle wake for wake by ``tests/test_torch_decremental.py``.  The
reference's wake is one jitted device program with two
``jax.lax.while_loop``s; here both loops run on the host and read their
``changed`` flag once per sweep (counted as ``host_syncs`` in the stats).

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

import time
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from . import cuda_trace as pt
from . import trace as trace_ops
from ..utils import events
from ..utils.validation import require
from .cuda_incremental import IncrementalCudaLayout

_fn_cache: Dict[tuple, object] = {}


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

    ``mode`` applies to the REPAIR fixpoint only: on a cold start the
    repair IS the full derivation, which is where the O(diameter) sweep
    wall lives.  The closure phase stays a plain push fixpoint: it is
    bounded by the churn's region, and jump hits there would only
    over-approximate the closure.  ``with_stats`` adds to ``counts``
    the FULL-gated tiles of the forced sweep and the per-sweep frontier
    decomposition (device tensors)."""
    F = trace_ops
    require(
        mode in pt.TRACE_MODES, "config.trace_mode",
        "bad trace mode", mode=mode, valid=pt.TRACE_MODES,
    )
    use_jump = mode in (pt.MODE_JUMP, pt.MODE_AUTO)
    use_pull = mode in (pt.MODE_PULL, pt.MODE_AUTO)

    geoms = {spec[-2:] for spec in specs if spec[0] != "xla"}
    require(len(geoms) == 1, "trace.geometry",
            "packed layouts must share (sub, group)", geoms=sorted(geoms))
    ((_, group),) = geoms
    group_rows = pt.ROWS * group
    n_chunks = r_rows // group_rows
    sup_words = s_rows * (pt.LANE // pt.WORD_BITS)  # words per supertile
    pull_cut = max(1, int(round(pull_density * n_chunks)))

    # One gated sweep serves both phases: a zero gate vector makes the
    # gated kernel behave exactly like the plain one.
    sweep = pt.build_sweep_contribs(specs, n, n_super, s_rows)

    def pack(active):
        return pt.pack_bools(active, n, r_rows)

    def dirty_chunks(table, table_prev):
        return pt.dirty_group_lists(table, table_prev, n_chunks, group_rows)

    def per_super(words):
        return (
            (words.reshape(-1)[: n_super * sup_words] != 0)
            .reshape(n_super, sup_words)
            .any(dim=1)
            .to(torch.int32)
        )

    def wake_fn(flags, recv_count, del_w, fresh_w, prev_mark_w,
                prev_seed_w, prev_halted_w, prev_iu_w, prev_table, *rest):
        if use_jump:
            jump_j, *layout_args = rest
            jump_j = jump_j.to(torch.int32)
        else:
            jump_j, layout_args = None, rest
        dev = flags.device
        in_use = F.flag_set(flags, F.FLAG_IN_USE)
        halted = F.flag_set(flags, F.FLAG_HALTED)
        seed = F.seeds_torch(flags, recv_count)

        iu_w = pack(in_use)
        nh_w = pack(~halted)
        halted_w = pack(halted)
        seed_w = pack(in_use & ~halted & seed)
        host_syncs = 0

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
        zero_gate = torch.zeros(n_super, dtype=torch.int32, device=dev)
        closure_w = s_w
        d, changed = dirty_chunks(s_w, torch.zeros_like(s_w))
        with events.span("uigc.wake.wait"):
            grow = bool(changed)  # host sync
        host_syncs += 1
        closure_sweeps = 0
        while grow:
            with events.span("uigc.wake.closure.sweep"):
                hit_w = sweep(closure_w, d, layout_args, gate=zero_gate)
                new_closure = closure_w | (hit_w & prev_mark_w)
                d, changed = dirty_chunks(new_closure, closure_w)
                closure_w = new_closure
                closure_sweeps += 1
                with events.span("uigc.wake.wait"):
                    grow = bool(changed)  # host sync
                host_syncs += 1

        # Per-supertile gate: closure members must re-derive; fresh
        # insert destinations must see their new pairs' contributions at
        # least once (a new edge changes no node word, so the dirty
        # machinery alone would never walk it); newly-in-use nodes (slot
        # reuse) likewise.  Gating only ADDS contributions, so it is
        # monotone-safe.
        suspect_g = (
            per_super(closure_w)
            | per_super(fresh_w)
            | per_super(iu_w & ~prev_iu_w)
        )

        # --- 3. repair fixpoint ------------------------------------- #
        mark_w = (prev_mark_w & ~closure_w) | seed_w
        table = mark_w & nh_w
        d, _ = dirty_chunks(table, prev_table)
        trans_w = iu_w & nh_w  # jump-transparent intermediates
        with events.span("uigc.wake.wait"):
            n_dirty = int(d[n_chunks])  # readback: the loop's changed flag
        host_syncs += 1
        run = n_dirty > 0
        if not run:
            # Run at least one gated sweep whenever anything is suspect,
            # even if the table diff alone is empty.
            with events.span("uigc.wake.wait"):
                run = bool(suspect_g.any())  # host sync
            host_syncs += 1
        use_gate = True
        sweeps = 0
        full_tiles = torch.zeros((), dtype=torch.int64, device=dev)
        if with_stats:
            st = {k: torch.zeros(pt.MAX_SWEEP_STATS, dtype=torch.int32,
                                 device=dev)
                  for k in ("dirty_chunks", "tiles_skipped", "pull_on")}
        while run:
            with events.span("uigc.wake.repair.sweep"):
                # Gate composition: the repair forcing (GATE_FULL on
                # suspect tiles, first sweep only) under the pull skip
                # (GATE_SKIP on saturated tiles — a saturated tile has
                # nothing left to re-derive, contributions are not
                # carried across sweeps).
                base_gate = suspect_g if use_gate else zero_gate
                pull_on = False
                if use_pull:
                    sat = pt.saturated_tiles(mark_w, iu_w, n_super,
                                             sup_words)
                    pull_on = mode != pt.MODE_AUTO or n_dirty >= pull_cut
                    gate = (
                        torch.where(sat > 0,
                                    torch.full_like(sat, pt.GATE_SKIP),
                                    base_gate)
                        if pull_on else base_gate
                    )
                else:
                    gate = base_gate
                if use_gate:
                    full_tiles = (gate == pt.GATE_FULL).sum()
                hit_w = sweep(table, d, layout_args, gate=gate)
                new_mark_w = mark_w | (hit_w & iu_w)
                if use_jump:
                    jump_w, jump_j = pt.jump_sweep_words(table, jump_j,
                                                         trans_w, iu_w, n)
                    new_mark_w |= jump_w
                new_table = new_mark_w & nh_w
                if with_stats:
                    i = min(sweeps, pt.MAX_SWEEP_STATS - 1)
                    st["dirty_chunks"][i] = n_dirty
                    if use_pull:
                        st["tiles_skipped"][i] = (sat.sum() if pull_on
                                                  else 0)
                        st["pull_on"][i] = int(pull_on)
                d, _ = dirty_chunks(new_table, table)
                mark_w, table = new_mark_w, new_table
                # The gated sweep fully re-derives suspect supertiles;
                # the monotone dirty machinery is sufficient (and
                # cheaper) after.
                use_gate = False
                sweeps += 1
                with events.span("uigc.wake.wait"):
                    n_dirty = int(d[n_chunks])  # readback: the changed flag
                host_syncs += 1
                run = n_dirty > 0
        counts = dict(closure_sweeps=closure_sweeps, n_sweeps=sweeps,
                      host_syncs=host_syncs)
        if with_stats:
            counts.update(st, full_tiles=full_tiles)
        return mark_w, seed_w, halted_w, iu_w, table, counts

    return wake_fn


def get_wake_fn(n, specs, n_super, r_rows, s_rows, mode=pt.MODE_PUSH,
                pull_density=pt.DEFAULT_PULL_DENSITY, with_stats=False):
    """Cached wake fn.  Keyed by layout geometry, so every lookup commits
    a ``tpu.compile`` hit or miss (tag ``dec_wake``), by the rule in
    telemetry/device.py."""
    key = (n, tuple(specs), n_super, r_rows, s_rows, mode, pull_density,
           with_stats)
    # No lock: collectors of several systems on one card can miss here
    # together and build the same fn twice; both are equal, the last
    # store wins, and each miss commits its own compile event.
    fn = _fn_cache.get(key)
    if fn is None:
        t0 = time.perf_counter()
        fn = _fn_cache[key] = _build_wake_fn(
            n, tuple(specs), n_super, r_rows, s_rows, mode=mode,
            pull_density=pull_density, with_stats=with_stats,
        )
        if events.recorder.enabled:
            events.recorder.commit(
                events.COMPILE, duration_s=time.perf_counter() - t0,
                tag="dec_wake", geom=events.compile_geom(key), hit=False,
            )
    elif events.recorder.enabled:
        events.recorder.commit(
            events.COMPILE, tag="dec_wake",
            geom=events.compile_geom(key), hit=True,
        )
    return fn


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
        self._pending_del_dst: Set[int] = set()
        self._pending_fresh_dst: Set[int] = set()

    # -- building / mutation (layout pass-throughs that watch removals) --

    def rebuild(self, edge_src, edge_dst, edge_weight, supervisor) -> None:
        """Full repack from graph arrays.  The previous fixpoint is
        invalidated: a rebuild may drop pairs that never went through
        remove()/apply_log(), so the next wake re-derives everything."""
        self.layout.rebuild(edge_src, edge_dst, edge_weight, supervisor)
        self.invalidate()

    def insert(self, src: int, dst: int, kind: int) -> None:
        if dst < self.n:
            self._pending_fresh_dst.add(int(dst))
        self.layout.insert(src, dst, kind)

    def remove(self, src: int, dst: int, kind: int) -> None:
        if dst < self.n:
            self._pending_del_dst.add(int(dst))
        self.layout.remove(src, dst, kind)

    def apply_log(self, log: List[tuple]) -> None:
        with events.span("uigc.layout.fold"):
            for ins, _src, dst, _kind in log:
                # Over-approximation is sound: a removal that nets out
                # adds a suspect whose repair is a no-op; an insert dst
                # only forces one full re-derivation of its supertile.
                if dst < self.n:
                    (self._pending_fresh_dst if ins
                     else self._pending_del_dst).add(int(dst))
            self.layout._fold_log(log)

    # -- the wake ------------------------------------------------------ #

    def _id_words(self, id_set: Set[int], r_rows: int) -> torch.Tensor:
        """Scatter an id set into a packed word table on the device.  The
        set is not drained here: wake_device clears it only after the
        wake ran, so a wake that raises keeps its suspects."""
        with events.span("uigc.wake.ids"):
            words = np.zeros(r_rows * pt.LANE, dtype=np.uint32)
            if id_set:
                ids = np.fromiter(id_set, np.int64, len(id_set))
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
