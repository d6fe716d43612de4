"""Copy of ``uigc_tpu/engines/crgc/collector.py`` (pure Python); ``wakes``
counts the collector's wakes.  What differs: a pipelined wake launches a
device wake only when something folded since the last launch, the rule
the reference applies to its synchronous trace alone
(``uigc_tpu/engines/crgc/collector.py:504-519``).  The reference
launches on every timer tick, and on a multi-node fabric those idle
launches take the interpreter lock from the transport and the quorum's
messages: ``run_cluster_recovery(10_000)`` on pipelined "decremental"
with the plain wake on the CPU collected in 37.8 and 50.0 s that way,
and in 9.6 and 14.7 s with the gate.

The per-node collector actor ("Bookkeeper").

Mirrors the reference's ``LocalGC`` (reference: crgc/LocalGC.scala:48-282):
a system actor on a pinned thread that periodically drains the mutator
entry queue, folds entries into its shadow graph, and runs the liveness
trace.  Multi-node (num-nodes > 1, attached to a Fabric):

- GC is gated until all ``num-nodes`` members join
  (reference: LocalGC.scala:69-75,206-208);
- drained entries are additionally folded into a DeltaGraph that is
  broadcast to every peer collector when full
  (reference: LocalGC.scala:159-165,191-196);
- per-link ingress entries are merged into undo logs and re-broadcast to
  the other peers (reference: LocalGC.scala:100-122,245-268);
- on member removal, the matching ingress finalizes, and once every
  surviving peer's final entry arrives (the quorum), the undo log is
  folded: the dead node's actors halt and its unadmitted effects revert
  (reference: LocalGC.scala:228-243,251-266).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import TYPE_CHECKING, Any, Dict, Optional, Set

from ...runtime.behaviors import RawBehavior
from ...runtime.fabric import MemberRemoved, MemberUp
from ...utils import events
from .delta import DeltaGraph
from .gateways import IngressEntry
from .undo import UndoLog

if TYPE_CHECKING:  # pragma: no cover
    from .engine import CRGC


class _Wakeup:
    __slots__ = ()

    def __repr__(self) -> str:
        return "Wakeup"


class _StartWave:
    __slots__ = ()

    def __repr__(self) -> str:
        return "StartWave"


class _FinalizeEgresses:
    __slots__ = ()


WAKEUP = _Wakeup()
START_WAVE = _StartWave()
FINALIZE_EGRESSES = _FinalizeEgresses()


def _phase(wake: Any, name: str):
    """Profiler phase bracket, or a no-op when no wake is active."""
    return wake.phase(name) if wake is not None else nullcontext()


class DeltaMsg:
    """(reference: LocalGC.scala:26-28)"""

    __slots__ = ("seqnum", "graph", "_wire_buf")

    def __init__(self, seqnum: int, graph: DeltaGraph):
        self.seqnum = seqnum
        self.graph = graph
        self._wire_buf: Optional[bytes] = None

    def reencode(self, fabric, dst_system) -> "DeltaMsg":
        """Cross a serialized fabric as the DeltaGraph wire format
        (reference: DeltaGraph.java:189-232).  The encode side is
        destination-independent, so a broadcast serializes once and
        decodes per peer."""
        from ...runtime import wire

        if self._wire_buf is None:
            self._wire_buf = self.graph.serialize(wire.encode_cell)
        graph = DeltaGraph.deserialize(
            self._wire_buf,
            dst_system.engine.crgc_context,
            wire.make_decode_cell(fabric),
        )
        return DeltaMsg(self.seqnum, graph)


class LocalIngressEntry:
    """(reference: LocalGC.scala:16)"""

    __slots__ = ("entry",)

    def __init__(self, entry: IngressEntry):
        self.entry = entry


class RemoteIngressEntry:
    """(reference: LocalGC.scala:35-37)"""

    __slots__ = ("entry", "_wire_buf")

    def __init__(self, entry: IngressEntry):
        self.entry = entry
        self._wire_buf: Optional[bytes] = None

    def reencode(self, fabric, dst_system) -> "RemoteIngressEntry":
        """Cross a serialized fabric as the IngressEntry wire format
        (reference: IngressEntry.java:103-144), encoded once per
        broadcast."""
        from ...runtime import wire

        if self._wire_buf is None:
            self._wire_buf = self.entry.serialize(wire.encode_cell)
        return RemoteIngressEntry(
            IngressEntry.deserialize(self._wire_buf, wire.make_decode_cell(fabric))
        )


class Bookkeeper(RawBehavior):
    """Collector loop (reference: LocalGC.scala:48-282)."""

    def __init__(self, engine: "CRGC"):
        self.engine = engine
        self.cell: Any = None
        self.total_entries = 0
        #: collector wakes so far (``collect`` calls)
        self.wakes = 0
        self.started = False
        self._timer_keys: list = []
        self.shadow_graph = engine.make_shadow_graph()
        #: does the shadow graph hold mutations the last trace has not
        #: seen?  Set by every fold path (entries, packed rows, deltas,
        #: undo folds, wave starts); cleared when a trace runs.  A wake
        #: that folded nothing skips the trace outright — the verdict
        #: is a pure function of graph state, so re-deriving it idle is
        #: pure cost (at mesh scale a no-op wake otherwise pays a full
        #: collective program dispatch, saturating the collector and
        #: convoying every other system on the process-wide collective
        #: lock, which is what stretched crash-recovery quorums from
        #: ms to tens of seconds).
        self._graph_dirty = True
        # Multi-node state (reference: LocalGC.scala:59-67).
        self.remote_gcs: Dict[str, Any] = {}  # address -> peer Bookkeeper cell
        self.undo_logs: Dict[str, UndoLog] = {}
        self.downed_gcs: Set[str] = set()
        #: dead nodes whose undo log has already been folded (folding is
        #: not idempotent, so exactly-once matters)
        self.undone_gcs: Set[str] = set()
        self.delta_graph_id = 0
        self.delta_graph = DeltaGraph(engine.system.address, engine.crgc_context)

    @property
    def multi_node(self) -> bool:
        return self.engine.num_nodes > 1

    # Bound by spawn_system_raw before the first batch runs.
    def bind(self, cell: Any) -> None:
        self.cell = cell
        if not self.multi_node:
            self.start()
        else:
            fabric = self.engine.system.fabric
            if fabric is None:
                raise RuntimeError(
                    "uigc.crgc.num-nodes > 1 requires the system to be "
                    "attached to a Fabric"
                )
            fabric.subscribe(cell)

    def start(self) -> None:
        """Begin periodic collection (reference: LocalGC.scala:211-226)."""
        self.started = True
        timers = self.engine.system.timers
        wakeup_s = self.engine.wakeup_interval_ms / 1000.0
        key = ("crgc-wakeup", id(self))
        self._timer_keys.append(key)
        timers.schedule_fixed_delay(wakeup_s, lambda: self.cell.tell(WAKEUP), key=key)
        if self.engine.collection_style == "wave":
            wave_s = self.engine.wave_frequency_ms / 1000.0
            key = ("crgc-wave", id(self))
            self._timer_keys.append(key)
            timers.schedule_fixed_delay(
                wave_s, lambda: self.cell.tell(START_WAVE), key=key
            )
        if self.multi_node:
            fin_s = self.engine.egress_finalize_interval_ms / 1000.0
            key = ("crgc-egress-finalize", id(self))
            self._timer_keys.append(key)
            timers.schedule_fixed_delay(
                fin_s, lambda: self.cell.tell(FINALIZE_EGRESSES), key=key
            )

    def on_message(self, msg: Any) -> Any:
        if isinstance(msg, _Wakeup):
            if self.started:
                self.collect()
        elif isinstance(msg, _StartWave):
            self.shadow_graph.start_wave()
            self._graph_dirty = True
        elif isinstance(msg, _FinalizeEgresses):
            # (reference: LocalGC.scala:219-224, via ForwardToEgress)
            fabric = self.engine.system.fabric
            for addr in list(self.remote_gcs):
                fabric.finalize_egress(self.engine.system, addr)
        elif isinstance(msg, MemberUp):
            self.add_member(msg.address)
        elif isinstance(msg, MemberRemoved):
            self.remove_member(msg.address)
        elif isinstance(msg, DeltaMsg):
            self.handle_delta(msg.graph)
        elif isinstance(msg, LocalIngressEntry):
            self.handle_local_ingress_entry(msg.entry)
        elif isinstance(msg, RemoteIngressEntry):
            with events.recorder.timed(events.MERGING_INGRESS_ENTRIES):
                self.merge_ingress_entry(msg.entry)
        return None

    # ------------------------------------------------------------- #
    # Membership (reference: LocalGC.scala:198-243)
    # ------------------------------------------------------------- #

    def add_member(self, address: str) -> None:
        if address == self.engine.system.address or not self.multi_node:
            return
        fabric = self.engine.system.fabric
        peer_system = fabric.systems.get(address)
        if peer_system is None:
            return
        self.remote_gcs[address] = peer_system.engine.bookkeeper_cell
        if address in self.downed_gcs:
            # Rejoin of a downed address: a FRESH incarnation after a
            # rolling restart, or the SAME incarnation healing after a
            # partition verdict (``uigc.node.heal-rejoin``).  Either
            # way its re-admitted stream must not fold into the dead
            # era's undo state: reset the log, and clear the one-shot
            # undone latch so a LATER death of the rejoined peer folds
            # again.  If the old log was still awaiting its fold
            # quorum, the skipped fold can only LEAK the dead era's
            # refs (marks stay), never collect a live actor: safe
            # direction — the same argument covers the healed peer's
            # pre-partition contributions, which the death-time fold
            # already reverted (re-sent refs re-register as they
            # arrive).
            self.downed_gcs.discard(address)
            self.undone_gcs.discard(address)
            # Rejoin opens a new incarnation era for the address: the
            # ingress gateways key their windows by (peer, fence) from
            # here on, and the fresh log's fence floor drops pre-death
            # stragglers still in flight (gateways.py fence discipline).
            fence = self.engine.bump_link_fence(address)
            log = UndoLog(
                address, fence=fence, own_address=self.engine.system.address,
                expected_nonce=self._peer_nonce(address),
            )
            prior = self.undo_logs.get(address)
            if prior is not None:
                log.seed_floors(prior)
            self.undo_logs[address] = log
        elif address not in self.undo_logs:
            self.undo_logs[address] = UndoLog(
                address,
                fence=self.engine.link_fence(address),
                own_address=self.engine.system.address,
                expected_nonce=self._peer_nonce(address),
            )
        # Establish both link directions eagerly (the Artery-handshake
        # analogue) so crash-time finalization always has an ingress,
        # even for pairs that never exchanged app messages.
        fabric.link(self.engine.system, peer_system)
        fabric.link(peer_system, self.engine.system)
        if not self.started and len(self.remote_gcs) + 1 == self.engine.num_nodes:
            self.start()

    def _peer_nonce(self, address: str) -> int:
        """The process-incarnation nonce of ``address`` as the fabric
        currently knows it (0 = none): captured into each UndoLog at
        creation so the log is pinned to the incarnation it covers."""
        return self.engine.system.fabric.peer_nonce(address) or 0

    def remove_member(self, address: str) -> None:
        """(reference: LocalGC.scala:228-243)"""
        if address == self.engine.system.address:
            return
        self.downed_gcs.add(address)
        self.remote_gcs.pop(address, None)
        # Finalize the ingress for the dead link (the NewIngressActor hook
        # in the reference, Gateways.scala:129).  In async-link mode the
        # final entry rides the link queue behind any in-flight traffic.
        fabric = self.engine.system.fabric
        fabric.finalize_dead_link(address, self.engine.system)
        # Membership shrank, so quorums that were waiting on the removed
        # node may now be satisfiable — re-check every pending undo log.
        # (The reference only checks on is_final arrival,
        # LocalGC.scala:251-266, which stalls under a second crash.)
        for downed in list(self.downed_gcs):
            self._maybe_fold_undo_log(downed)

    # ------------------------------------------------------------- #
    # Peer traffic (reference: LocalGC.scala:100-142)
    # ------------------------------------------------------------- #

    def handle_delta(self, graph: DeltaGraph) -> None:
        if graph.address in self.remote_gcs:
            with events.recorder.timed(events.MERGING_DELTA_GRAPHS):
                # Only merge from nodes that have not been removed.
                self.shadow_graph.merge_delta(graph)
                self._graph_dirty = True
                self.undo_logs[graph.address].merge_delta_graph(graph)

    def handle_local_ingress_entry(self, entry: IngressEntry) -> None:
        # Tell every remote GC except the one adjacent to this entry
        # (one message object, so serialize mode encodes once).
        fabric = self.engine.system.fabric
        msg = RemoteIngressEntry(entry)
        for addr, gc in self.remote_gcs.items():
            if addr != entry.egress_address:
                fabric.control_send(self.engine.system, gc, msg)
        with events.recorder.timed(events.MERGING_INGRESS_ENTRIES):
            self.merge_ingress_entry(entry)

    def merge_ingress_entry(self, entry: IngressEntry) -> None:
        """(reference: LocalGC.scala:245-268)"""
        addr = entry.egress_address
        log = self.undo_logs.get(addr)
        if log is None:
            log = UndoLog(
                addr,
                fence=self.engine.link_fence(addr),
                own_address=self.engine.system.address,
                expected_nonce=self._peer_nonce(addr),
            )
            self.undo_logs[addr] = log
        if log.stale_fence(entry):
            # A pre-death straggler of a rejoined incarnation: merging
            # it would mix the dead era's windows into the live stream's
            # accounting (the latent (peer, fence) bug).
            events.recorder.commit(
                events.STALE_WINDOW,
                peer=addr,
                ingress=entry.ingress_address,
                window=entry.id,
                fence=entry.fence,
                log_fence=log.fence,
            )
            return
        log.merge_ingress_entry(entry)
        if entry.is_final:
            self._maybe_fold_undo_log(addr)

    def _maybe_fold_undo_log(self, addr: str) -> None:
        """Fold the dead node's undo log exactly once, when our own final
        entry and every surviving peer's are in (the finalization quorum,
        reference: LocalGC.scala:251-266)."""
        if addr in self.undone_gcs:
            return
        log = self.undo_logs.get(addr)
        if log is None:
            return
        my_addr = self.engine.system.address
        if my_addr in log.finalized_by and all(
            peer in log.finalized_by for peer in self.remote_gcs
        ):
            self.undone_gcs.add(addr)
            events.recorder.commit(
                events.UNDO_FOLD,
                address=addr,
                node=my_addr,
                **log.summary(),
            )
            self.shadow_graph.merge_undo_log(log)
            self.shadow_graph.trace(should_kill=True)
            # The fold's own trace consumed the merge, but its kills
            # cascade; leave the next timer wake a fresh derivation.
            self._graph_dirty = True

    # ------------------------------------------------------------- #
    # Collection (reference: LocalGC.scala:144-196)
    # ------------------------------------------------------------- #

    def collect(self) -> int:
        """One collector wake.  Observability wrapping (both optional,
        both attached by ``telemetry.Telemetry``): the whole wake runs
        inside a ``gc_wave`` span whose context becomes the causal
        parent of the terminations it triggers, and the wake profiler
        brackets the pipeline phases (ingest/fold/trace/broadcast here;
        the sweep share is attributed from the ``crgc.sweep`` event the
        backends emit inside their trace)."""
        engine = self.engine
        self.wakes += 1
        tel = engine.system.telemetry
        tracer = tel.tracer if tel is not None and tel.tracer.enabled else None
        prof = engine.wake_profiler
        insp = engine.liveness_inspector
        wake = prof.begin_wake() if prof is not None else None
        if hasattr(self.shadow_graph, "sweep_stats"):
            # Device backends collect the per-sweep frontier stats only
            # when a profiler is attached to carry them (arrays.py
            # _stamp_sweep_stats -> WakeProfiler per-wake records).
            self.shadow_graph.sweep_stats = wake is not None
        if hasattr(self.shadow_graph, "capture_parents"):
            # Why-live parent capture follows the same gating discipline:
            # only a liveness inspector that asked for verdict-exact
            # provenance flips the graph onto the parents kernels — a
            # plain wake never pays the capture fixpoint
            # (telemetry/inspect.py).
            self.shadow_graph.capture_parents = (
                insp is not None and insp.parent_capture
            )
        count = n_garbage = 0
        try:
            if tracer is not None:
                with tracer.span("gc_wave", node=engine.system.address) as span:
                    tracer.note_wave(span.ctx)
                    count, n_garbage = self._collect_inner(wake)
                    span.args["entries"] = count
                    span.args["garbage"] = n_garbage
            else:
                count, n_garbage = self._collect_inner(wake)
        finally:
            # A raising wake must still close its profiler accounting,
            # or _active dangles and later sweep/device events are
            # credited to a dead wake.
            if wake is not None:
                wake.end(entries=count, garbage=n_garbage)
        if insp is not None:
            # Flight recorder + leak watchdog ride the collector thread
            # (the one thread that owns the graph, so the read is
            # fold-consistent).  Isolated like any listener: a broken
            # inspector must not stall collection.
            try:
                insp.on_wake(self.shadow_graph, count, n_garbage)
            except Exception:
                events.recorder.commit(
                    events.LISTENER_ERROR, listener="liveness_inspector"
                )
        obs = engine.device_observatory
        if obs is not None:
            # Device observatory: one read-only memory-ledger sample per
            # wake, on the collector thread (fold-consistent, like the
            # inspector's hook) and under the same isolation discipline.
            try:
                obs.on_wake(self.shadow_graph)
            except Exception:
                events.recorder.commit(
                    events.LISTENER_ERROR, listener="device_observatory"
                )
        self._after_wake(n_garbage)
        return count

    def _collect_inner(self, wake: Any) -> tuple:
        """Drain, fold, trace.  Returns ``(num_entries, n_garbage)``."""
        engine = self.engine
        queue = engine.queue
        pool = engine.entry_pool
        count = 0
        multi = self.multi_node
        with events.recorder.timed(events.PROCESSING_ENTRIES) as ev:
            plane = engine.packed_plane
            rows = None
            with _phase(wake, "ingest"):
                if plane is not None:
                    rows = plane.drain()
                batch = []
                while True:
                    try:
                        entry = queue.popleft()
                    except IndexError:
                        break
                    count += 1
                    batch.append(entry)
                    if multi:
                        self.delta_graph.merge_entry(entry)
                        if self.delta_graph.is_full():
                            self.finalize_delta_graph(wake)
            with _phase(wake, "fold"):
                # Packed rows fold first: they happened-before any object
                # entries drained for the same actors (the only object
                # entries in packed mode are dead-letter accounting, which
                # follows the dead actor's packed final flush).
                if rows is not None:
                    count += rows.shape[0]
                    self.shadow_graph.merge_packed(rows)
                if batch:
                    merge_entries = getattr(self.shadow_graph, "merge_entries", None)
                    if merge_entries is not None:
                        # Batched fold: flatten the whole drained queue, then
                        # vectorized scatter-applies (ArrayShadowGraph).
                        merge_entries(batch)
                    else:
                        for entry in batch:
                            self.shadow_graph.merge_entry(entry)
                    for entry in batch:
                        entry.clean()
                        pool.append(entry)
            if multi and self.delta_graph.non_empty():
                self.finalize_delta_graph(wake)
            ev.fields["num_entries"] = count
        self.total_entries += count
        if count:
            self._graph_dirty = True
        graph = self.shadow_graph
        with _phase(wake, "trace"):
            if self.engine.pipelined and getattr(graph, "can_pipeline", False):
                # Pipelined: sweep the previous wake's verdicts (if its
                # device result landed), then dispatch the next wake and
                # return — the device traces while the mutators keep
                # folding (SURVEY §7; sound because CRGC garbage is
                # monotone, see ArrayShadowGraph.launch_trace).  A wake
                # whose result never lands is expired so a transport outage
                # cannot deadlock collection forever.
                n_garbage = 0
                if graph.harvest_ready():
                    n_garbage = graph.harvest_trace(should_kill=True)
                else:
                    graph.expire_stalled_wake(
                        max(30.0, self.engine.wakeup_interval_ms / 1000.0 * 20)
                    )
                if self._graph_dirty and not graph.has_pending_wake:
                    # The idle-wake rule of the synchronous branch: with
                    # nothing folded since the last launch, a new wake
                    # would derive the verdict already harvested.
                    self._graph_dirty = False
                    graph.launch_trace()
            elif self._graph_dirty:
                # Cleared before the trace: kills the sweep triggers
                # re-dirty through their death-flush entries (and
                # _after_wake re-wakes on progress), so cascades still
                # converge wake by wake.
                self._graph_dirty = False
                n_garbage = graph.trace(should_kill=True)
            else:
                # Nothing folded since the last trace — the verdict
                # cannot have changed; skip the device round-trip.
                n_garbage = 0
        return count, n_garbage

    def _after_wake(self, n_garbage: int) -> None:
        # Cascade acceleration: a wake that killed actors triggers more
        # facts (death flushes, released refs) that usually make MORE
        # actors collectable — a released tree dies level by level.  A
        # fixed cadence pays one full interval per level (the dominant
        # cost of end-to-end collection latency, BENCH_LIVE r4); instead
        # re-wake immediately and let the mailbox round-trip provide the
        # yield that lets the death flushes land first.  Terminates: a
        # re-wake fires only on progress (n_garbage > 0), and garbage is
        # finite.  The reference has no analogue (fixed 50ms delay,
        # LocalGC.scala:213) — at its scale the cascade fits one wake.
        if n_garbage > 0 and self.started:
            self.cell.tell(WAKEUP)

    def diagnostic_dump(self) -> Dict[str, Any]:
        """Structured collector diagnostics (the reference's println
        inspectors, ShadowGraph.java:331-394, as data): per-address
        shadow counts and the live-set breakdown.  Backends without the
        inspectors (e.g. native) report what they have."""
        g = self.shadow_graph
        out: Dict[str, Any] = {
            "total_entries": self.total_entries,
            "members": sorted(self.remote_gcs),
            "downed": sorted(self.downed_gcs),
        }
        if hasattr(g, "addresses_in_graph"):
            out["addresses_in_graph"] = g.addresses_in_graph()
        if hasattr(g, "investigate_live_set"):
            out["live_set"] = g.investigate_live_set()
        return out

    def finalize_delta_graph(self, wake: Any = None) -> None:
        """(reference: LocalGC.scala:191-196).  Profiled as the wake's
        ``broadcast`` phase — the nested-phase accounting keeps it out
        of the enclosing ingest bracket."""
        with _phase(wake, "broadcast"):
            fabric = self.engine.system.fabric
            msg = DeltaMsg(self.delta_graph_id, self.delta_graph)
            for gc in self.remote_gcs.values():
                fabric.control_send(self.engine.system, gc, msg)
            self.delta_graph_id += 1
            self.delta_graph = DeltaGraph(
                self.engine.system.address, self.engine.crgc_context
            )

    def stop_timers(self) -> None:
        for key in self._timer_keys:
            self.engine.system.timers.cancel(key)
        self._timer_keys.clear()

    def on_signal(self, signal: Any) -> Any:
        from ...runtime.signals import _PostStop

        if isinstance(signal, _PostStop):
            self.stop_timers()
        return None
