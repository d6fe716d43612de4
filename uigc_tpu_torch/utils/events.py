"""Copy of ``uigc_tpu/utils/events.py`` (pure Python; event names are kept
as the reference spells them, so one telemetry vocabulary covers both
packages).

Structured observability events — the JFR analogue.

The reference instruments every pipeline stage with Java Flight Recorder
events under category "UIGC" (reference: src/main/java/.../crgc/jfr/*,
.../mac/jfr/*, PROFILING.md:1-10).  This module provides the same event
vocabulary as cheap in-process counters plus optional listeners, so a
profiler (or a test) can observe the pipeline without touching engine code.

Events are disabled by default, like the reference's ``@Enabled(false)``
flush events; enable with :func:`enable` or per-category.

Ours besides: :func:`span`, a named stretch of the port's own host code
(the mark fixpoint's seed, sweeps, waits and glue), recorded into
torch.profiler's host events while a profiler runs and into a
``telemetry.tracing.Tracer``'s ring while one of its spans is open on the
thread.  With neither, a span costs two flag reads.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from bisect import bisect_left
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# Event names, mirroring the reference's JFR classes:
#   crgc/jfr/EntrySendEvent, ProcessingEntries,
#   TracingEvent, MergingDeltaGraphs, MergingIngressEntries,
#   DeltaGraphSerialization, IngressEntrySerialization
#   mac/jfr/ProcessingMessages
ENTRY_SEND = "crgc.entry_send"
PROCESSING_ENTRIES = "crgc.processing_entries"
TRACING = "crgc.tracing"
MERGING_DELTA_GRAPHS = "crgc.merging_delta_graphs"
MERGING_INGRESS_ENTRIES = "crgc.merging_ingress_entries"
DELTA_GRAPH_SERIALIZATION = "crgc.delta_graph_serialization"
INGRESS_ENTRY_SERIALIZATION = "crgc.ingress_entry_serialization"
PROCESSING_MESSAGES = "mac.processing_messages"
DEVICE_TRACE = "tpu.device_trace"  # ours: one device kernel dispatch
#: The sweep half of one collection (kill decisions + slot/shadow frees),
#: nested inside ``crgc.tracing``.  Emitted by every shadow-graph backend
#: so the wake profiler (uigc_tpu/telemetry/profile.py) can attribute
#: trace-vs-sweep time without backend-specific hooks.
SWEEP = "crgc.sweep"
# Device-plane observatory events (ours; uigc_tpu/telemetry/device.py
# folds them into the HBM ledger / compile-cache / transfer planes):
#   tpu.host_transfer   a device->host value crossing on a collector
#                       path (fields: site, bytes) — committed by the
#                       annotated readback sites in engines/crgc and
#                       attributed to the active wake's profiler phase
#   tpu.donation_copy   a buffer handed to a donating jitted call
#                       SURVIVED the call (is_deleted() false): XLA
#                       silently copied instead of aliasing (fields:
#                       site, bytes) — the donation-audit signal
#   tpu.compile         a compile-cache consultation (fields: tag,
#                       geom, hit; duration_s on a miss when the build
#                       was timed) — recompile storms are a rate spike
#                       of hit=False commits for one (tag, geom) stream
HOST_TRANSFER = "tpu.host_transfer"
DONATION_COPY = "tpu.donation_copy"
COMPILE = "tpu.compile"


def compile_geom(key: Any) -> str:
    """Short stable label of a compile-cache geometry key (crc32 of its
    repr) for ``tpu.compile`` events: process-stable, bounded label
    cardinality, and two sites caching on the same key tuple agree on
    the label — which is what lets a recompile storm show up as ONE
    (tag, geom) stream missing repeatedly rather than scattered noise."""
    import zlib

    return format(zlib.crc32(repr(key).encode()) & 0xFFFFFFFF, "08x")

# Transport/failure events (ours; the reference has no failure-injection
# instrumentation).  Emitted by runtime/node.py, runtime/fabric.py,
# runtime/heartbeat.py and the CRGC crash-accounting paths, so a test or
# chaos bench can observe detection and recovery without touching
# internals:
#   fabric.node_suspect     phi crossed half the threshold (early warning)
#   fabric.node_down        failure verdict; fields: address, reason
#                           ("heartbeat" | "eof" | "injected")
#   fabric.node_crashed     this node crash-injected itself (FaultPlan)
#   fabric.link_reconnect   a broken link was re-dialed successfully
#   fabric.dead_link_finalized  finalize_dead_link flushed the ingress
#   fabric.dead_letter      undeliverable frame routed through the
#                           dead-letter accounting (recipient gone)
#   fabric.frame_dropped    fault injection dropped an outbound frame
#   fabric.frame_duplicate  receiver seq layer discarded a duplicate
#   fabric.frame_gap        receiver seq layer observed missing frames
#   fabric.frame_corrupt    frame body failed to decode (truncation)
#   crgc.undo_fold          a dead node's undo log folded into the graph
# Correctness-tooling events (ours; uigc_tpu/analysis):
#   analysis.violation      the sanitizer recorded a violated invariant;
#                           fields: rule, detail, plus rule-specific
#                           evidence (see analysis/sanitizer.py catalog)
#   analysis.check          one sanitizer cross-check cycle completed;
#                           fields: node, n_garbage, oracle_garbage
#   sched.*                 scheduling taps consumed by the vector-clock
#                           race detector (analysis/race.py); emitted by
#                           runtime/cell.py and runtime/system.py only
#                           when ``uigc.analysis.sched-events`` is on:
#   sched.enqueue           a message was appended to a mailbox
#                           (fields: cell, kind="sys"|"app")
#   sched.batch_start       a dispatcher thread began a cell batch
#   sched.batch_end         the batch released ownership of the cell
#   sched.invoke            one message is about to be invoked
#   sched.spawn             a cell was registered under a parent
#   sched.poststop          PostStop is about to run for a cell
#   sched.terminated        the cell reached its terminal state
ANALYSIS_VIOLATION = "analysis.violation"
ANALYSIS_CHECK = "analysis.check"
SCHED_ENQUEUE = "sched.enqueue"
SCHED_BATCH_START = "sched.batch_start"
SCHED_BATCH_END = "sched.batch_end"
SCHED_INVOKE = "sched.invoke"
SCHED_SPAWN = "sched.spawn"
SCHED_POSTSTOP = "sched.poststop"
SCHED_TERMINATED = "sched.terminated"

NODE_SUSPECT = "fabric.node_suspect"
NODE_DOWN = "fabric.node_down"
NODE_CRASHED = "fabric.node_crashed"
LINK_RECONNECT = "fabric.link_reconnect"
DEAD_LINK_FINALIZED = "fabric.dead_link_finalized"
DEAD_LETTER = "fabric.dead_letter"
FRAME_DROPPED = "fabric.frame_dropped"
FRAME_DUPLICATE = "fabric.frame_duplicate"
FRAME_GAP = "fabric.frame_gap"
FRAME_CORRUPT = "fabric.frame_corrupt"
#: a well-known name lookup could not be resolved by the peer's hello
#: (fields: address, lookup) — see NodeFabric.lookup (runtime/node.py).
LOOKUP_MISS = "fabric.lookup_miss"
#: one per-peer writer flush coalesced into a multi-frame batch unit
#: (fields: dst, size=frames in the batch, bytes=wire bytes) — feeds the
#: ``uigc_frame_batch_frames_total`` histogram.
FRAME_BATCH = "fabric.frame_batch"
#: a frame that had already claimed its sequence number could not reach
#: the peer (link broke mid-flush, or died while frames were queued);
#: fields: dst, kind.  The receiver accounts the loss as a gap; this
#: event is the sender-side record that replaces the old silent
#: bool-only ``send_frame`` failure path.
SEND_FAILED = "fabric.send_failed"
#: per-writer-drain codec mix (fields: dst, schema=N, pickle=N app
#: frames) — feeds ``uigc_codec_frames_total{codec=...}`` so the
#: schema-vs-pickle ratio on each link is observable (runtime/node.py).
CODEC_FRAMES = "fabric.codec_frames"
#: a co-located shm ring pair went live for a peer direction (fields:
#: dst, role="producer"|"consumer") — runtime/shm_ring.py negotiation.
SHM_ESTABLISHED = "fabric.shm_established"
#: the producer found its shm ring full and stalled (fields: dst) —
#: the ring-backpressure signal (``uigc_shm_ring_full_total``).
SHM_RING_FULL = "fabric.shm_ring_full"
#: a live shm ring was renounced and the link fell back to the socket
#: path (fields: dst, reason="peer-dead"|"poisoned"|"write-failed").
SHM_FALLBACK = "fabric.shm_fallback"
UNDO_FOLD = "crgc.undo_fold"
#: an ingress-entry window from a pre-rejoin fence era was refused by
#: the undo log (gateways.py (peer, fence) keying; fields: peer,
#: ingress, window, fence, log_fence)
STALE_WINDOW = "crgc.stale_window"

# Distributed-collector events (engines/crgc/distributed.py): the
# partitioned trace-wave protocol, observable end to end:
#   crgc.dist_wave      one wave completed on this node (fields: wave,
#                       node, garbage, live, rounds, marks_sent,
#                       marks_recv, boundary_edges)
#   crgc.dist_marks     one dmark frame left for a peer (fields: count,
#                       dst, node) — cumulative sets, so retransmits
#                       count too; feeds
#                       uigc_dist_marks_exchanged_total
#   crgc.dist_round     the root judged one Safra-style termination
#                       round (fields: wave, round, settled, changed,
#                       sent, recv, nodes) — feeds
#                       uigc_dist_wave_rounds_total
#   crgc.dist_refold    a partition's retained delta journal was
#                       re-folded after an ownership transfer (fields:
#                       partition, shadows, node, fence)
#   crgc.dist_locality_violation
#                       the per-sweep fold-locality audit found
#                       authoritative state folded outside the owned
#                       slice (fields: node, keys, count) — the runtime
#                       twin of lint rule UL014; always a bug
DIST_WAVE = "crgc.dist_wave"
DIST_MARKS = "crgc.dist_marks"
DIST_ROUND = "crgc.dist_round"
DIST_REFOLD = "crgc.dist_refold"
DIST_LOCALITY = "crgc.dist_locality_violation"
#: mirror decay (fields: count, resident, node) — foreign-owned
#: shadows left the traversal working set after the configured number
#: of untouched waves (uigc.crgc.mirror-decay-waves)
DIST_MIRROR_EVICT = "crgc.dist_mirror_evict"

# Cluster-sharding events (ours; uigc_tpu/cluster).  Emitted by the
# shard regions and the migration machinery so rebalances are observable
# end to end:
#   shard.table_update       a new shard table version was adopted
#                            (fields: version, shards, origin)
#   shard.migration          one entity handoff completed, measured from
#                            capture to ack (duration_s; fields: key,
#                            src, dst, type)
#   shard.entity_activated   an entity cell was (re)constructed
#                            (fields: key, type, resumed)
#   shard.entity_passivated  an idle entity spilled its state and stopped
#   shard.handoff_buffered   a message was buffered while its entity was
#                            mid-handoff/passivation (fields: depth)
#   shard.forwarded          an entity message was re-routed because this
#                            node no longer owns the key
#   shard.state_conflict     a migrated snapshot met a resident entity
#                            that had already processed messages; the
#                            resident won and the snapshot was dropped
#                            (the coordinator-free divergence residue —
#                            counted, never silent)
SHARD_TABLE = "shard.table_update"
SHARD_MIGRATION = "shard.migration"
SHARD_ENTITY_ACTIVATED = "shard.entity_activated"
SHARD_ENTITY_PASSIVATED = "shard.entity_passivated"
SHARD_HANDOFF_BUFFERED = "shard.handoff_buffered"
SHARD_FORWARDED = "shard.forwarded"
SHARD_STATE_CONFLICT = "shard.state_conflict"

# Durability-plane events (uigc_tpu/cluster/journal.py + the bounded
# queue admission paths, PR 12):
#   journal.torn_record     a recovery scan hit a frame whose CRC (or
#                           framing) failed — the crash tore the tail
#                           of an append; replay stops cleanly at the
#                           last valid frame of that segment (fields:
#                           path, offset)
#   journal.recovered       one journaled entity was reconstructed
#                           (snapshot + command replay) after a crash
#                           or on first touch of a rehomed shard
#                           (duration_s; fields: key, type, cmds,
#                           skipped)
#   fabric.backpressure     a bounded queue refused to grow silently:
#                           a full mailbox (site="mailbox"), a full
#                           per-peer writer queue (site="writer-queue")
#                           or a capped cluster buffer made a sender
#                           wait, shed the oldest entry, or error
#                           (fields: site, action="wait"|"shed"|
#                           "error", depth, path/dst, count)
#   shard.buffer_dropped    a capped EntityRef buffer (handoff/hold/
#                           deferred) shed its oldest message (fields:
#                           site, key, type) — feeds
#                           uigc_entity_buffer_dropped_total
#   fabric.node_draining    NodeFabric.drain() began: placements
#                           stopped, handoffs in flight
#   fabric.node_drained     the drain finished (fields: complete,
#                           duration_s) — complete=False means the
#                           timeout expired with residue
JOURNAL_TORN = "journal.torn_record"
JOURNAL_RECOVERED = "journal.recovered"
BACKPRESSURE = "fabric.backpressure"
SHARD_BUFFER_DROPPED = "shard.buffer_dropped"
NODE_DRAINING = "fabric.node_draining"
NODE_DRAINED = "fabric.node_drained"

# Ingress-gateway events (uigc_tpu/gateway, the client edge):
#   gateway.connection      one client connection changed state (fields:
#                           action="open"|"close"|"reject", tenant) —
#                           feeds the uigc_gateway_connections gauge's
#                           churn context
#   gateway.msg             admitted client commands routed into the
#                           entity plane (fields: tenant, count) —
#                           uigc_gateway_tenant_msgs_total{tenant}
#   gateway.shed            client work refused with a clean ERROR
#                           frame or a slammed socket (fields:
#                           reason="overload"|"auth"|"conn-limit"|
#                           "msg-rate"|"draining"|"proto"|"slow-consumer"|
#                           "flood"|"gone"|"encode", count) —
#                           uigc_gateway_shed_total{reason}; read
#                           throttling itself rides fabric.backpressure
#                           with site="gateway"
GATEWAY_CONNECTION = "gateway.connection"
GATEWAY_MSG = "gateway.msg"
GATEWAY_SHED = "gateway.shed"

# Partition-tolerance events (uigc_tpu/cluster/membership.py + the
# epoch-fencing sites, PR 13):
#   cluster.sbr_decision      the split-brain resolver reached a verdict
#                             after the settle window (fields: strategy,
#                             survived, downed, live, seen, fence) —
#                             counts into uigc_cluster_partitions_total
#   cluster.sbr_downed        this node LOST the verdict and is downing
#                             itself (fields: strategy, downed_with) —
#                             uigc_sbr_downed_total{strategy}
#   cluster.sbr_quarantine    the losing side finished draining its
#                             entities to the journal and stopped
#                             serving (fields: entities, checkpointed)
#   cluster.sbr_rejoin        a quarantined node adopted a survivor's
#                             fence and re-entered the cluster (fields:
#                             fence, via)
#   cluster.fence_rejected    an epoch-fencing site refused stale work
#                             (fields: site="journal"|"recovery"|"mig"|
#                             "sgrant"|"route"|"ent", plus evidence) —
#                             uigc_fence_rejected_total{site}
#   cluster.membership_disagreement  two live peers' membership views
#                             conflict (one lists as live a node the
#                             other declared dead) — the
#                             split_brain_suspected alert's input
#   fabric.link_healed        a same-incarnation peer reconnected after
#                             MemberRemoved and was re-admitted with a
#                             fresh stream (fields: address)
SBR_DECISION = "cluster.sbr_decision"
SBR_DOWNED = "cluster.sbr_downed"
SBR_QUARANTINE = "cluster.sbr_quarantine"
SBR_REJOIN = "cluster.sbr_rejoin"
FENCE_REJECTED = "cluster.fence_rejected"
MEMBERSHIP_DISAGREEMENT = "cluster.membership_disagreement"
LINK_HEALED = "fabric.link_healed"

# Telemetry self-observation (uigc_tpu/telemetry):
#   telemetry.listener_error  a recorder listener raised during dispatch;
#                             fields: listener, event, error.  Counted so
#                             broken listeners are a metric, not just a
#                             traceback scrolling past on stderr.
#   telemetry.leak_suspect    the liveness inspector's watchdog flagged an
#                             actor that survived N collection waves with
#                             zero traffic (fields: actor, node, waves,
#                             recv_count, retained_by); advisory — a
#                             pointer to run `graph_inspect why-live`.
#   telemetry.snapshot        the flight recorder captured a shadow-graph
#                             snapshot (fields: node, wave, reason,
#                             actors, edges).
#   telemetry.alert           an anomaly/SLO rule changed state (fields:
#                             rule, severity, series, labels, value,
#                             threshold, node, state="firing"|"resolved");
#                             firing transitions count into
#                             uigc_alerts_total{rule,severity}.
#   telemetry.labelset_overflow  a metric crossed the per-metric labelset
#                             bound (uigc.telemetry.max-labelsets) and
#                             new labelsets folded into the
#                             overflow="true" labelset; emitted once per
#                             metric (fields: scope, metric, limit).
LISTENER_ERROR = "telemetry.listener_error"
LEAK_SUSPECT = "telemetry.leak_suspect"
SNAPSHOT = "telemetry.snapshot"
ALERT = "telemetry.alert"
LABELSET_OVERFLOW = "telemetry.labelset_overflow"

#: Per-thread event origin (a node address).  The recorder is a process
#: singleton; when several ActorSystems share one process (the
#: in-process multi-node topologies), a per-node consumer — the
#: telemetry metrics bridge, an offline log splitter — needs to know
#: WHICH system produced an event.  Each system tags the threads it
#: owns (dispatcher workers, pinned collector threads, the timer
#: service, node-transport loops) with its address; ``commit`` stamps
#: the tag into every listener payload as ``origin``.  Threads nobody
#: tagged (user/test threads) stay origin-less, which consumers treat
#: as "unscoped: accept".
_ORIGIN_TLS = threading.local()


def set_thread_origin(origin: Optional[str]) -> None:
    """Tag the calling thread's committed events with ``origin``."""
    _ORIGIN_TLS.origin = origin


def thread_origin() -> Optional[str]:
    return getattr(_ORIGIN_TLS, "origin", None)

#: Fixed duration-histogram bucket upper bounds (seconds): powers of two
#: from 1µs to ~134s, plus an implicit overflow bucket.  Shared with the
#: telemetry metrics registry so recorder snapshots and Prometheus
#: exposition agree on bucket geometry.
DURATION_BUCKET_BOUNDS_S: Tuple[float, ...] = tuple(
    1e-6 * (2.0**i) for i in range(28)
)


class DurationStat:
    """Streaming summary of one observed quantity: count/total/min/max
    plus a fixed-size histogram over ``bounds`` (default: the duration
    bucket geometry above).  The one bounded-bucket implementation —
    the telemetry metrics registry reuses it per labelset.

    Replaces the old unbounded per-event duration list: memory is
    O(buckets) no matter how many events are observed (a 1M-event loop
    holds the same ~30 counters as a 10-event one)."""

    __slots__ = ("n", "total_s", "max_s", "min_s", "bounds", "buckets")

    def __init__(self, bounds: Tuple[float, ...] = DURATION_BUCKET_BOUNDS_S) -> None:
        self.n = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.min_s = float("inf")
        self.bounds = bounds
        #: non-cumulative counts; index i counts observations x with
        #: bounds[i-1] < x <= bounds[i]; the last slot is the overflow.
        self.buckets = [0] * (len(bounds) + 1)

    def observe(self, duration_s: float) -> None:
        self.n += 1
        self.total_s += duration_s
        if duration_s > self.max_s:
            self.max_s = duration_s
        if duration_s < self.min_s:
            self.min_s = duration_s
        self.buckets[bisect_left(self.bounds, duration_s)] += 1

    def summary(self) -> Dict[str, Any]:
        """Snapshot dict; keeps the historical ``n``/``total_s``/``max_s``
        shape and adds the streaming extras."""
        return {
            "n": self.n,
            "total_s": self.total_s,
            "max_s": self.max_s,
            "min_s": self.min_s if self.n else 0.0,
            "mean_s": (self.total_s / self.n) if self.n else 0.0,
            "buckets": list(self.buckets),
        }


class EventRecorder:
    """Thread-safe counter/duration sink with optional listeners.

    Listener dispatch is exception-isolated: one throwing listener must
    not break ``commit`` for the others (or for the caller), and
    ``add_listener``/``remove_listener`` are safe against concurrent
    commits.  Every committed event carries a ``seq`` field stamped
    under the recorder lock — a process-wide total order consistent
    with real time, which the race detector (analysis/race.py) relies
    on to order events across dispatcher threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.enabled = False
        self._seq = 0
        self._counts: Dict[str, int] = defaultdict(int)
        self._sums: Dict[str, float] = defaultdict(float)
        self._durations: Dict[str, DurationStat] = defaultdict(DurationStat)
        self._listeners: List[Callable[[str, Dict[str, Any]], None]] = []
        self._tls = threading.local()  # listener-error reentrancy guard

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def add_listener(self, fn: Callable[[str, Dict[str, Any]], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[str, Dict[str, Any]], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def suppressed(self) -> "_Suppressed":
        """Context manager muting this thread's commits.  For tooling
        that re-runs instrumented pipeline code as a shadow computation
        (the sanitizer's oracle trace): without it, the mirror emits the
        same ``crgc.tracing``/``crgc.sweep`` events as the real backend
        and every metrics consumer double-counts the wave."""
        return _Suppressed(self)

    def commit(self, name: str, duration_s: Optional[float] = None, **fields: Any) -> None:
        """Record one event occurrence (the JFR ``commit()`` analogue)."""
        if not self.enabled or getattr(self._tls, "suppress", False):
            return
        with self._lock:
            self._counts[name] += 1
            for key, value in fields.items():
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    self._sums[f"{name}.{key}"] += value
            if duration_s is not None:
                self._durations[name].observe(duration_s)
            seq = self._seq
            self._seq = seq + 1
            listeners = list(self._listeners)
        if not listeners:
            return
        payload = dict(fields, duration_s=duration_s, seq=seq)
        origin = getattr(_ORIGIN_TLS, "origin", None)
        if origin is not None:
            payload.setdefault("origin", origin)
        for fn in listeners:
            try:
                fn(name, dict(payload))
            except Exception as exc:  # one bad listener must not break the rest
                self._on_listener_error(fn, name, exc)

    def _on_listener_error(self, fn: Any, name: str, exc: Exception) -> None:
        """A listener raised: log the traceback to stderr AND commit a
        structured ``telemetry.listener_error`` event, so broken listeners
        are countable (snapshot counts, metrics, JSONL) rather than only
        printed.  Reentrancy-guarded: a listener that also throws on the
        error event is counted silently instead of recursing."""
        traceback.print_exc(file=sys.stderr)
        if getattr(self._tls, "in_error", False):
            with self._lock:
                self._counts[LISTENER_ERROR] += 1
            return
        self._tls.in_error = True
        try:
            self.commit(
                LISTENER_ERROR,
                listener=repr(fn),
                event=name,
                error=f"{type(exc).__name__}: {exc}",
            )
        finally:
            self._tls.in_error = False

    def timed(self, name: str) -> "_Timed":
        return _Timed(self, name)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {"counts": dict(self._counts), "sums": dict(self._sums)}
            out["durations"] = {
                k: stat.summary() for k, stat in self._durations.items()
            }
            return out

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._durations.clear()


class _Suppressed:
    """Per-thread commit mute (see :meth:`EventRecorder.suppressed`).
    Nestable: restores the previous state on exit."""

    __slots__ = ("_recorder", "_prev")

    def __init__(self, recorder: EventRecorder):
        self._recorder = recorder
        self._prev = False

    def __enter__(self) -> "_Suppressed":
        tls = self._recorder._tls
        self._prev = getattr(tls, "suppress", False)
        tls.suppress = True
        return self

    def __exit__(self, *exc: Any) -> None:
        self._recorder._tls.suppress = self._prev


class _Timed:
    """Context manager for timed events (the begin()/commit() pair)."""

    __slots__ = ("_recorder", "_name", "_start", "fields")

    def __init__(self, recorder: EventRecorder, name: str):
        self._recorder = recorder
        self._name = name
        self._start = 0.0
        self.fields: Dict[str, Any] = {}

    def __enter__(self) -> "_Timed":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._recorder.commit(
            self._name, duration_s=time.perf_counter() - self._start, **self.fields
        )


#: Process-wide recorder, like the JVM-global JFR stream.
recorder = EventRecorder()


# ------------------------------------------------------------------ #
# Spans
# ------------------------------------------------------------------ #

class _SpanState(threading.local):
    """The ``Tracer`` whose span is open on this thread: set and restored
    by ``telemetry/tracing.py`` ``_ActiveSpan``; every :func:`span`
    opened under it records a child span in its ring.  The class default
    makes the read on a thread that never set it a plain lookup (a
    ``getattr`` default would raise and catch an AttributeError)."""

    tracer: Any = None


_SPAN_TLS = _SpanState()


def swap_span_tracer(tracer: Any) -> Any:
    """Make ``tracer`` (or None) the thread's open tracer; returns the
    one it replaces."""
    prev = _SPAN_TLS.tracer
    _SPAN_TLS.tracer = tracer
    return prev


class _NoSpan:
    """The one span handed out while no sink listens."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **args: Any) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Span:
    """A span with at least one sink.  Under a running torch profiler it
    is a ``_RecordFunctionFast``: a host event at function scope on the
    profiler's clock, which makes no device-side annotation (a
    ``record_function`` would, and the device time of a profile would
    count it).  Under an open ``Tracer`` span it is a child span in that
    tracer's ring, whose args are this span's, ``set`` included."""

    __slots__ = ("name", "args", "_tracer", "_record", "_ring")

    def __init__(self, name: str, args: Dict[str, Any], tracer: Any):
        self.name = name
        self.args = args
        self._tracer = tracer
        self._record = None
        self._ring = None

    def __enter__(self) -> "_Span":
        if _profiler._is_profiler_enabled:
            self._record = _RecordFunctionFast(self.name)
            self._record.__enter__()
        if self._tracer is not None:
            self._ring = self._tracer.span(self.name)
            self._ring.args = self.args
            self._ring.__enter__()
        return self

    def set(self, **args: Any) -> None:
        """Args known only at the span's end (host values, never a
        tensor read)."""
        self.args.update(args)

    def __exit__(self, *exc: Any) -> None:
        if self._ring is not None:
            self._ring.__exit__(*exc)
        if self._record is not None:
            self._record.__exit__(*exc)


def span(name: str, **args: Any):
    """A context manager over a stretch of host code, named ``name``
    (``uigc.*``), recorded by whichever sink listens: a running torch
    profiler, a ``Tracer`` span open on the thread, or both.  ``args``
    and later :meth:`_Span.set` calls hold host values only; a span never
    reads a tensor."""
    tracer = _SPAN_TLS.tracer
    if tracer is None and not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, args, tracer)
