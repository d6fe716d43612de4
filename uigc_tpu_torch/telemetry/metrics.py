"""Copy of ``uigc_tpu/telemetry/metrics.py`` (pure Python), held against
it by ``tests/test_torch_telemetry.py``.

Typed metrics registry: counters, gauges, bounded-bucket histograms.

The event layer (:mod:`uigc_tpu.utils.events`) answers "what happened in
this process"; this module turns it into something exportable — a typed
registry whose samples render to Prometheus text exposition
(:mod:`uigc_tpu.telemetry.exporter`) or a JSON snapshot.  Population is
two-sided, following Tascade's aggregation shape (PAPERS.md:
hierarchical, asynchronous reduction of per-shard statistics rather
than a central synchronous scrape):

- an :class:`EventMetricsBridge` recorder listener folds the event
  stream into the registry as events commit (GC wave latency, garbage
  per wave, dead letters, undo folds, frame gaps/duplicates, …);
- callback gauges sample live state lazily at export time (shadow-graph
  size, mailbox depth, per-link phi) — nothing is polled until someone
  actually scrapes.

All metric mutation is thread-safe (one registry lock, never nested
with any other lock).  Histograms use fixed bucket bounds, so memory is
O(buckets) regardless of observation count — the same discipline as
:class:`uigc_tpu.utils.events.DurationStat`.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..utils import events
from ..utils.validation import require

#: Default histogram bucket bounds for durations (seconds) — shared
#: geometry with the event recorder's duration stats.
DURATION_BUCKETS = events.DURATION_BUCKET_BOUNDS_S

#: Default bucket bounds for small non-negative counts (garbage per
#: wave, entries per wake): powers of two up to 64k.
COUNT_BUCKETS: Tuple[float, ...] = tuple(float(2**i) for i in range(17))

#: Bucket bounds for byte sizes (writer drain flushes): powers of four
#: from 64B to ~16MB.
BYTES_BUCKETS: Tuple[float, ...] = tuple(float(4**i * 64) for i in range(10))

LabelKey = Tuple[Tuple[str, str], ...]

#: Default per-metric labelset bound (``uigc.telemetry.max-labelsets``).
#: Dynamic labels (per-peer, per-shard, per-source) would otherwise grow
#: every ``_values``/``_data`` dict without bound for the life of the
#: process; past the bound, new labelsets fold into this one.
DEFAULT_MAX_LABELSETS = 512
OVERFLOW_LABELS: LabelKey = (("overflow", "true"),)


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    """Shared shape: name, help text, per-labelset storage."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help_text: str,
        lock: threading.Lock,
        max_labelsets: int = DEFAULT_MAX_LABELSETS,
    ):
        self.name = name
        self.help_text = help_text
        self._lock = lock
        self._max_labelsets = max(1, int(max_labelsets))
        self._overflowed = False

    def _bound_key_locked(self, key: LabelKey, store: Dict[LabelKey, Any]) -> LabelKey:
        """Cardinality bound (caller holds the metric lock): a NEW
        labelset past the cap folds into ``overflow="true"`` so memory
        stays bounded and the aggregate stays observable.  Returns the
        (possibly folded) key; the first fold arms the one-shot
        ``telemetry.labelset_overflow`` event, emitted by the caller
        OUTSIDE the lock."""
        if key in store or len(store) < self._max_labelsets:
            return key
        return OVERFLOW_LABELS

    def _note_overflow_locked(self) -> bool:
        if self._overflowed:
            return False
        self._overflowed = True
        return True

    def _emit_overflow(self) -> None:
        events.recorder.commit(
            events.LABELSET_OVERFLOW,
            scope="registry",
            metric=self.name,
            limit=self._max_labelsets,
        )

    def samples(self) -> List[Tuple[str, LabelKey, float]]:
        """Flat (suffix, labels, value) samples for the exporter."""
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing value, optionally per labelset."""

    kind = "counter"

    def __init__(
        self,
        name: str,
        help_text: str,
        lock: threading.Lock,
        max_labelsets: int = DEFAULT_MAX_LABELSETS,
    ):
        super().__init__(name, help_text, lock, max_labelsets)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        require(
            amount >= 0,
            "metrics.counter_decrease",
            "counters are monotone; inc() amount must be >= 0",
            metric=self.name,
            amount=amount,
        )
        key = _label_key(labels)
        overflowed = False
        with self._lock:
            bounded = self._bound_key_locked(key, self._values)
            if bounded is not key:
                overflowed = self._note_overflow_locked()
            self._values[bounded] = self._values.get(bounded, 0.0) + amount
        if overflowed:
            self._emit_overflow()

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[str, LabelKey, float]]:
        with self._lock:
            items = list(self._values.items())
        if not items:
            items = [((), 0.0)]
        return [("", key, value) for key, value in items]


class Gauge(_Metric):
    """Point-in-time value: set directly, or backed by a callback that
    is sampled lazily at export time.  A callback may return a float or
    a ``{labels_dict | label_str: value}`` mapping for per-label
    fan-out."""

    kind = "gauge"

    def __init__(
        self,
        name: str,
        help_text: str,
        lock: threading.Lock,
        fn: Optional[Callable[[], Any]] = None,
        label_name: str = "key",
        max_labelsets: int = DEFAULT_MAX_LABELSETS,
    ):
        super().__init__(name, help_text, lock, max_labelsets)
        self._values: Dict[LabelKey, float] = {}
        self._fn = fn
        self._label_name = label_name

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        overflowed = False
        with self._lock:
            bounded = self._bound_key_locked(key, self._values)
            if bounded is not key:
                overflowed = self._note_overflow_locked()
            self._values[bounded] = float(value)
        if overflowed:
            self._emit_overflow()

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[str, LabelKey, float]]:
        if self._fn is not None:
            try:
                result = self._fn()
            except Exception:  # a dead callback must not break the scrape
                return []
            if result is None:
                return []
            if isinstance(result, dict):
                return [
                    ("", _label_key({self._label_name: k}), float(v))
                    for k, v in result.items()
                ]
            return [("", (), float(result))]
        with self._lock:
            items = list(self._values.items())
        if not items:
            items = [((), 0.0)]
        return [("", key, value) for key, value in items]


class Histogram(_Metric):
    """Fixed-bound bucket histogram with streaming sum/count/min/max.

    Each labelset is one :class:`uigc_tpu.utils.events.DurationStat` —
    the single bounded-bucket implementation in the repo — and
    :meth:`samples` renders the Prometheus cumulative
    ``_bucket{le=...}`` series plus ``_sum`` and ``_count``."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        lock: threading.Lock,
        buckets: Tuple[float, ...] = DURATION_BUCKETS,
        max_labelsets: int = DEFAULT_MAX_LABELSETS,
    ):
        super().__init__(name, help_text, lock, max_labelsets)
        require(
            len(buckets) > 0 and list(buckets) == sorted(buckets),
            "metrics.bad_buckets",
            "histogram bucket bounds must be a non-empty sorted sequence",
            metric=name,
        )
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._data: Dict[LabelKey, events.DurationStat] = {}

    def _slot(self, key: LabelKey) -> events.DurationStat:
        stat = self._data.get(key)
        if stat is None:
            stat = self._data[key] = events.DurationStat(self.bounds)
        return stat

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        overflowed = False
        with self._lock:
            bounded = self._bound_key_locked(key, self._data)
            if bounded is not key:
                overflowed = self._note_overflow_locked()
            self._slot(bounded).observe(float(value))
        if overflowed:
            self._emit_overflow()

    def snapshot(self, **labels: Any) -> Dict[str, Any]:
        with self._lock:
            stat = self._data.get(_label_key(labels))
            if stat is None:
                return {"counts": [0] * (len(self.bounds) + 1), "sum": 0.0, "n": 0}
            return {
                "counts": list(stat.buckets),
                "sum": stat.total_s,
                "n": stat.n,
                "min": stat.min_s if stat.n else 0.0,
                "max": stat.max_s,
            }

    def samples(self) -> List[Tuple[str, LabelKey, float]]:
        with self._lock:
            items = [
                (k, list(s.buckets), s.total_s, s.n) for k, s in self._data.items()
            ]
        out: List[Tuple[str, LabelKey, float]] = []
        for key, counts, total, n in items:
            cumulative = 0
            for bound, count in zip(self.bounds, counts):
                cumulative += count
                out.append(
                    ("_bucket", key + (("le", _format_le(bound)),), float(cumulative))
                )
            out.append(("_bucket", key + (("le", "+Inf"),), float(n)))
            out.append(("_sum", key, total))
            out.append(("_count", key, float(n)))
        return out


def _format_le(bound: float) -> str:
    """Stable, parse-friendly rendering of a bucket bound."""
    return repr(bound)


class MetricsRegistry:
    """A named collection of metrics with optional constant labels
    (e.g. ``node=<address>``) applied to every sample at export."""

    def __init__(
        self,
        const_labels: Optional[Dict[str, Any]] = None,
        max_labelsets: int = DEFAULT_MAX_LABELSETS,
    ):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self.const_labels = _label_key(const_labels or {})
        self.max_labelsets = max(1, int(max_labelsets))

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                require(
                    type(existing) is type(metric),
                    "metrics.kind_conflict",
                    "metric re-registered with a different kind",
                    metric=metric.name,
                    existing=existing.kind,
                    requested=metric.kind,
                )
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(  # type: ignore[return-value]
            Counter(name, help_text, threading.Lock(), self.max_labelsets)
        )

    def gauge(
        self,
        name: str,
        help_text: str = "",
        fn: Optional[Callable[[], Any]] = None,
        label_name: str = "key",
    ) -> Gauge:
        return self._register(  # type: ignore[return-value]
            Gauge(
                name, help_text, threading.Lock(), fn, label_name,
                self.max_labelsets,
            )
        )

    def histogram(
        self,
        name: str,
        help_text: str = "",
        buckets: Tuple[float, ...] = DURATION_BUCKETS,
    ) -> Histogram:
        return self._register(  # type: ignore[return-value]
            Histogram(
                name, help_text, threading.Lock(), buckets, self.max_labelsets
            )
        )

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def collect(self) -> Iterable[Tuple[_Metric, str, LabelKey, float]]:
        """Yield every (metric, name_suffix, labels, value) sample, with
        the registry's constant labels merged in."""
        for metric in self.metrics():
            for suffix, key, value in metric.samples():
                yield metric, suffix, self.const_labels + key, value

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump: {metric_name: {kind, help, samples}}."""
        out: Dict[str, Any] = {}
        for metric, suffix, key, value in self.collect():
            entry = out.setdefault(
                metric.name,
                {"kind": metric.kind, "help": metric.help_text, "samples": []},
            )
            entry["samples"].append(
                {"suffix": suffix, "labels": dict(key), "value": value}
            )
        return out


class EventMetricsBridge:
    """Recorder listener folding the event stream into a registry.

    One instance per attached system; registered via
    ``events.recorder.add_listener`` and driven synchronously on the
    committing thread, so the cost per event is a couple of dict lookups
    and a histogram insert."""

    def __init__(self, registry: MetricsRegistry, node: Optional[str] = None):
        self.registry = registry
        #: accept only events originating from this node's threads (the
        #: recorder is process-global; without the scope, a multi-system
        #: process would fold every peer's events into every registry).
        #: Origin-less events (untagged user/test threads, shared
        #: in-process fabric workers) are accepted by everyone.
        self.node = node
        r = registry
        self._wave_seconds = r.histogram(
            "uigc_gc_wave_seconds", "Latency of one collection (trace + sweep)."
        )
        self._wave_garbage = r.histogram(
            "uigc_gc_wave_garbage_total",
            "Garbage actors found per collection wave.",
            buckets=COUNT_BUCKETS,
        )
        self._garbage_total = r.counter(
            "uigc_gc_garbage_total", "Total garbage actors collected."
        )
        self._live_actors = r.gauge(
            "uigc_gc_live_actors", "Live actors at the last collection wave."
        )
        self._entries_total = r.counter(
            "uigc_entries_flushed_total", "Mutator entries flushed to the collector."
        )
        self._ingest_seconds = r.histogram(
            "uigc_gc_ingest_seconds", "Latency of one entry-queue drain + fold."
        )
        self._device_seconds = r.histogram(
            "uigc_device_trace_seconds", "Device time of one trace kernel dispatch."
        )
        self._dead_letters = r.counter(
            "uigc_dead_letters_total", "Messages routed through dead-letter accounting."
        )
        self._undo_folds = r.counter(
            "uigc_undo_folds_total", "Dead-node undo logs folded into the shadow graph."
        )
        self._frame_gaps = r.counter(
            "uigc_frame_gaps_total", "Frames the sequence layer observed as missing."
        )
        self._frame_dups = r.counter(
            "uigc_frame_duplicates_total", "Duplicate frames discarded by the sequence layer."
        )
        self._frames_dropped = r.counter(
            "uigc_frames_dropped_total", "Frames dropped (fault injection or admission)."
        )
        self._frames_corrupt = r.counter(
            "uigc_frames_corrupt_total", "Frames whose body failed to decode."
        )
        self._batch_size = r.histogram(
            "uigc_frame_batch_frames_total",
            "Frames coalesced per peer-writer flush (runtime/node.py).",
            buckets=COUNT_BUCKETS,
        )
        self._send_failed = r.counter(
            "uigc_send_failed_total",
            "Frames lost after sequence assignment (link broke mid-flush).",
        )
        self._drain_bytes = r.histogram(
            "uigc_writer_drain_bytes",
            "Wire bytes per peer-writer flush (one sendall / ring record).",
            buckets=BYTES_BUCKETS,
        )
        self._codec_frames = r.counter(
            "uigc_codec_frames_total",
            "App frames encoded per wire codec (schema-native vs pickle "
            "fallback; runtime/schema.py).",
        )
        self._shm_ring_full = r.counter(
            "uigc_shm_ring_full_total",
            "Writer stalls on a full co-located shm ring (backpressure; "
            "runtime/shm_ring.py).",
        )
        self._node_down = r.counter(
            "uigc_node_down_total", "Peer-death verdicts, by reason."
        )
        self._node_suspect = r.counter(
            "uigc_node_suspect_total", "Early-warning phi threshold crossings."
        )
        self._reconnects = r.counter(
            "uigc_link_reconnects_total", "Torn links healed by reconnect."
        )
        self._listener_errors = r.counter(
            "uigc_listener_errors_total", "Recorder listeners that raised during dispatch."
        )
        self._merge_delta_seconds = r.histogram(
            "uigc_merge_delta_seconds", "Latency of folding one peer delta graph."
        )
        self._merge_ingress_seconds = r.histogram(
            "uigc_merge_ingress_seconds", "Latency of folding one ingress entry."
        )
        self._migration_seconds = r.histogram(
            "uigc_shard_migration_seconds",
            "Entity handoff latency, capture to ack (uigc_tpu/cluster).",
        )
        self._migrations = r.counter(
            "uigc_shard_migrations_total", "Completed entity handoffs."
        )
        self._entity_activations = r.counter(
            "uigc_shard_entity_activations_total",
            "Entity cells constructed, by kind (fresh/resumed/migrated).",
        )
        self._entity_passivations = r.counter(
            "uigc_shard_entity_passivations_total",
            "Idle entities spilled to the passivation store.",
        )
        self._table_updates = r.counter(
            "uigc_shard_table_updates_total", "Shard-table versions adopted."
        )
        self._forwards = r.counter(
            "uigc_shard_forwards_total",
            "Entity messages re-routed by a node that no longer owns the key.",
        )
        self._state_conflicts = r.counter(
            "uigc_shard_state_conflicts_total",
            "Migrated snapshots dropped against a resident incarnation.",
        )
        self._lookup_misses = r.counter(
            "uigc_fabric_lookup_miss_total",
            "Well-known-name lookups the peer's hello never resolved.",
        )
        self._leak_suspects = r.counter(
            "uigc_leak_suspects_total",
            "Actors the liveness watchdog flagged (survived N waves "
            "with zero traffic; telemetry/inspect.py).",
        )
        self._inspect_snapshots = r.counter(
            "uigc_inspect_snapshots_total",
            "Flight-recorder shadow-graph snapshots captured.",
        )
        self._alerts = r.counter(
            "uigc_alerts_total",
            "Anomaly/SLO alerts fired, by rule and severity "
            "(uigc_tpu/telemetry/alerts.py).",
        )
        self._labelset_overflows = r.counter(
            "uigc_labelset_overflows_total",
            "Metrics whose labelset count crossed the cardinality bound "
            "(uigc.telemetry.max-labelsets).",
        )
        self._backpressure = r.counter(
            "uigc_backpressure_total",
            "Bounded-queue overflow actions (mailbox / writer-queue / "
            "cluster buffers), by site and action.",
        )
        self._entity_buffer_dropped = r.counter(
            "uigc_entity_buffer_dropped_total",
            "Messages shed from capped EntityRef buffers (handoff / "
            "hold / deferred), by site.",
        )
        self._journal_torn = r.counter(
            "uigc_journal_torn_records_total",
            "Torn journal frames a recovery scan stopped at "
            "(cluster/journal.py CRC framing).",
        )
        self._journal_recovered = r.counter(
            "uigc_journal_recovered_total",
            "Entities reconstructed from the journal (snapshot + "
            "command replay).",
        )
        self._journal_replay_seconds = r.histogram(
            "uigc_journal_replay_seconds",
            "Per-entity journal recovery latency (scan + decode + "
            "replay enqueue).",
        )
        self._cluster_partitions = r.counter(
            "uigc_cluster_partitions_total",
            "Split-brain verdicts settled by the membership arbiter "
            "(cluster/membership.py), by survived.",
        )
        self._sbr_downed = r.counter(
            "uigc_sbr_downed_total",
            "Nodes that downed themselves on a losing split-brain "
            "verdict, by strategy.",
        )
        self._fence_rejected = r.counter(
            "uigc_fence_rejected_total",
            "Work refused by an epoch-fencing site (stale-era journal "
            "appends, recovery conflicts, mig/sgrant frames, "
            "quarantined routing), by site.",
        )
        self._membership_disagreements = r.counter(
            "uigc_membership_disagreements_total",
            "Live peers observed serving alongside a member this node "
            "downed (the split_brain_suspected alert input).",
        )
        self._dist_rounds = r.counter(
            "uigc_dist_wave_rounds_total",
            "Safra-style termination rounds judged by the distributed "
            "collector's reduction-tree root (engines/crgc/distributed.py).",
        )
        self._dist_marks = r.counter(
            "uigc_dist_marks_exchanged_total",
            "Boundary marks shipped between partition owners as dmark "
            "frames (cumulative sets: retransmits count), by dst.",
        )
        self._dist_boundary_edges = r.gauge(
            "uigc_dist_boundary_edges",
            "Edges of this node's owned shadow slice whose destination "
            "lives on another node, at the last distributed sweep.",
        )
        self._dist_refolds = r.counter(
            "uigc_dist_refolds_total",
            "Partition journals re-folded after an ownership transfer "
            "(the absorb-on-death path), by partition owner change.",
        )
        self._dist_mark_bytes = r.counter(
            "uigc_dist_mark_bytes_total",
            "Encoded dmark payload bytes shipped between partition "
            "owners (density-switched key-set codec; suffix flushes "
            "plus retransmits), by dst.",
        )
        self._dist_mirror_evictions = r.counter(
            "uigc_dist_mirror_evictions_total",
            "Foreign-owned boundary mirrors decayed out of the "
            "traversal working set (uigc.crgc.mirror-decay-waves).",
        )
        self._link_heals = r.counter(
            "uigc_link_heals_total",
            "Previously-downed peers that rejoined and were revived "
            "by the heartbeat monitor (heal or fresh incarnation).",
        )
        self._node_draining = r.counter(
            "uigc_node_draining_total",
            "Graceful-drain starts on this node (runtime/node.py "
            "drain(): membership retracted, shards rebalancing).",
        )
        self._sbr_quarantines = r.counter(
            "uigc_sbr_quarantine_total",
            "Entries into split-brain quarantine (routing frozen, "
            "journal checkpointed+frozen), by checkpointed.",
        )
        self._stale_windows = r.counter(
            "uigc_stale_windows_total",
            "Pre-death stragglers of a rejoined incarnation refused "
            "by the undo-log fence (the latent (peer, fence) bug).",
        )
        self._delta_graph_bytes = r.histogram(
            "uigc_delta_graph_bytes",
            "Serialized delta-graph size shipped to the collector "
            "(shadow entries + compression table).",
            buckets=BYTES_BUCKETS,
        )
        self._ingress_entry_bytes = r.histogram(
            "uigc_ingress_entry_bytes",
            "Serialized ingress-entry size crossing the node boundary.",
            buckets=BYTES_BUCKETS,
        )
        self._sanitizer_checks = r.counter(
            "uigc_sanitizer_checks_total",
            "uigcsan oracle cross-checks of the live collector, by "
            "divergent (true = the oracle disagreed: a soundness bug).",
        )
        self._gw_tenant_msgs = r.counter(
            "uigc_gateway_tenant_msgs_total",
            "Client commands admitted through the ingress gateway and "
            "routed into the entity plane, by tenant.",
        )
        self._gw_shed = r.counter(
            "uigc_gateway_shed_total",
            "Client work the gateway refused with a clean ERROR frame "
            "or a slammed socket (overload / quotas / auth / protocol "
            "violations / slow consumers), by reason.",
        )

    def __call__(self, name: str, fields: Dict[str, Any]) -> None:
        if self.node is not None:
            origin = fields.get("origin")
            if origin is not None and origin != self.node:
                return
        duration = fields.get("duration_s")
        if name == events.TRACING:
            if duration is not None:
                self._wave_seconds.observe(duration)
            garbage = fields.get("num_garbage_actors")
            if garbage is not None:
                self._wave_garbage.observe(garbage)
                if garbage:
                    self._garbage_total.inc(garbage)
            live = fields.get("num_live_actors")
            if live is not None:
                self._live_actors.set(live)
        elif name == events.ENTRY_SEND:
            self._entries_total.inc()
        elif name == events.PROCESSING_ENTRIES:
            if duration is not None:
                self._ingest_seconds.observe(duration)
        elif name == events.DEVICE_TRACE:
            if duration is not None:
                self._device_seconds.observe(duration)
        elif name == events.DEAD_LETTER:
            self._dead_letters.inc()
        elif name == events.UNDO_FOLD:
            self._undo_folds.inc(address=fields.get("address", ""))
        elif name == events.FRAME_GAP:
            self._frame_gaps.inc(fields.get("missed", 1), src=fields.get("src", ""))
        elif name == events.FRAME_DUPLICATE:
            self._frame_dups.inc(fields.get("count", 1), src=fields.get("src", ""))
        elif name == events.FRAME_DROPPED:
            self._frames_dropped.inc()
        elif name == events.FRAME_CORRUPT:
            self._frames_corrupt.inc(fields.get("count", 1))
        elif name == events.FRAME_BATCH:
            size = fields.get("size")
            if size is not None:
                self._batch_size.observe(size)
            nbytes = fields.get("bytes")
            if nbytes is not None:
                self._drain_bytes.observe(nbytes)
        elif name == events.CODEC_FRAMES:
            schema_n = fields.get("schema", 0)
            pickle_n = fields.get("pickle", 0)
            if schema_n:
                self._codec_frames.inc(schema_n, codec="schema")
            if pickle_n:
                self._codec_frames.inc(pickle_n, codec="pickle")
        elif name == events.SHM_RING_FULL:
            self._shm_ring_full.inc(dst=fields.get("dst", ""))
        elif name == events.SEND_FAILED:
            self._send_failed.inc(
                fields.get("count", 1), kind=fields.get("kind", "?")
            )
        elif name == events.NODE_DOWN:
            self._node_down.inc(reason=fields.get("reason", "?"))
        elif name == events.NODE_SUSPECT:
            self._node_suspect.inc()
        elif name == events.LINK_RECONNECT:
            self._reconnects.inc()
        elif name == events.LISTENER_ERROR:
            self._listener_errors.inc()
        elif name == events.MERGING_DELTA_GRAPHS:
            if duration is not None:
                self._merge_delta_seconds.observe(duration)
        elif name == events.MERGING_INGRESS_ENTRIES:
            if duration is not None:
                self._merge_ingress_seconds.observe(duration)
        elif name == events.SHARD_MIGRATION:
            self._migrations.inc()
            if duration is not None:
                self._migration_seconds.observe(duration)
        elif name == events.SHARD_ENTITY_ACTIVATED:
            kind = (
                "migrated"
                if fields.get("migrated")
                else "resumed" if fields.get("resumed") else "fresh"
            )
            self._entity_activations.inc(kind=kind)
        elif name == events.SHARD_ENTITY_PASSIVATED:
            self._entity_passivations.inc()
        elif name == events.SHARD_TABLE:
            self._table_updates.inc()
        elif name == events.SHARD_FORWARDED:
            self._forwards.inc()
        elif name == events.SHARD_STATE_CONFLICT:
            self._state_conflicts.inc()
        elif name == events.LOOKUP_MISS:
            self._lookup_misses.inc()
        elif name == events.LEAK_SUSPECT:
            self._leak_suspects.inc()
        elif name == events.SNAPSHOT:
            self._inspect_snapshots.inc()
        elif name == events.ALERT:
            # Firing transitions only: resolve events change state but
            # are not new alerts.  Counted here (not by the engine) so
            # offline JSONL replay rebuilds identical totals.
            if fields.get("state", "firing") == "firing":
                self._alerts.inc(
                    rule=fields.get("rule", "?"),
                    severity=fields.get("severity", "?"),
                )
        elif name == events.LABELSET_OVERFLOW:
            self._labelset_overflows.inc(scope=fields.get("scope", "?"))
        elif name == events.BACKPRESSURE:
            self._backpressure.inc(
                fields.get("count", 1) or 1,
                site=fields.get("site", "?"),
                action=fields.get("action", "?"),
            )
        elif name == events.SHARD_BUFFER_DROPPED:
            self._entity_buffer_dropped.inc(site=fields.get("site", "?"))
        elif name == events.GATEWAY_MSG:
            self._gw_tenant_msgs.inc(
                fields.get("count", 1) or 1,
                tenant=fields.get("tenant", "?"),
            )
        elif name == events.GATEWAY_SHED:
            self._gw_shed.inc(
                fields.get("count", 1) or 1,
                reason=fields.get("reason", "?"),
            )
        elif name == events.JOURNAL_TORN:
            self._journal_torn.inc()
        elif name == events.JOURNAL_RECOVERED:
            self._journal_recovered.inc()
            if duration is not None:
                self._journal_replay_seconds.observe(duration)
        elif name == events.SBR_DECISION:
            self._cluster_partitions.inc(
                survived=str(bool(fields.get("survived"))).lower()
            )
        elif name == events.SBR_DOWNED:
            self._sbr_downed.inc(strategy=fields.get("strategy", "?"))
        elif name == events.FENCE_REJECTED:
            self._fence_rejected.inc(
                fields.get("count", 1) or 1, site=fields.get("site", "?")
            )
        elif name == events.MEMBERSHIP_DISAGREEMENT:
            self._membership_disagreements.inc()
        elif name == events.DIST_ROUND:
            self._dist_rounds.inc()
        elif name == events.DIST_MARKS:
            self._dist_marks.inc(
                fields.get("count", 1) or 1, dst=fields.get("dst", "?")
            )
            nbytes = fields.get("bytes")
            if nbytes:
                self._dist_mark_bytes.inc(nbytes, dst=fields.get("dst", "?"))
        elif name == events.DIST_MIRROR_EVICT:
            self._dist_mirror_evictions.inc(fields.get("count", 1) or 1)
        elif name == events.DIST_WAVE:
            edges = fields.get("boundary_edges")
            if edges is not None:
                self._dist_boundary_edges.set(edges)
        elif name == events.DIST_REFOLD:
            self._dist_refolds.inc()
        elif name == events.LINK_HEALED:
            self._link_heals.inc()
        elif name == events.NODE_DRAINING:
            self._node_draining.inc()
        elif name == events.SBR_QUARANTINE:
            self._sbr_quarantines.inc(
                checkpointed=str(bool(fields.get("checkpointed"))).lower()
            )
        elif name == events.STALE_WINDOW:
            self._stale_windows.inc(peer=fields.get("peer", "?"))
        elif name == events.DELTA_GRAPH_SERIALIZATION:
            size = fields.get("shadow_size", 0) + fields.get(
                "compression_table_size", 0
            )
            if size:
                self._delta_graph_bytes.observe(size)
        elif name == events.INGRESS_ENTRY_SERIALIZATION:
            size = fields.get("size")
            if size is not None:
                self._ingress_entry_bytes.observe(size)
        elif name == events.ANALYSIS_CHECK:
            divergent = fields.get("n_garbage") != fields.get("oracle_garbage")
            self._sanitizer_checks.inc(divergent=str(divergent).lower())


def _shadow_graph_size(system: Any) -> Optional[int]:
    """Duck-typed shadow population across backends: array (slot_of),
    oracle (shadow_map), native (_id_of_cell)."""
    engine = getattr(system, "engine", None)
    bookkeeper = getattr(engine, "bookkeeper", None)
    graph = getattr(bookkeeper, "shadow_graph", None)
    if graph is None:
        return None
    for attr in ("slot_of", "shadow_map", "_id_of_cell"):
        table = getattr(graph, attr, None)
        if table is not None:
            return len(table)
    return None


def _mailbox_depth(system: Any) -> int:
    with system._cells_lock:
        cells = list(system._cells.values())
    return sum(len(cell._mailbox) for cell in cells)


def install_system_gauges(registry: MetricsRegistry, system: Any) -> None:
    """The direct taps: live state sampled lazily at export time."""
    registry.gauge(
        "uigc_shadow_graph_size",
        "Shadows held by the collector's graph.",
        fn=lambda: _shadow_graph_size(system),
    )
    registry.gauge(
        "uigc_mailbox_depth",
        "Application messages pending across all live mailboxes.",
        fn=lambda: _mailbox_depth(system),
    )
    registry.gauge(
        "uigc_live_actors",
        "Cells currently registered with the system.",
        fn=lambda: system.live_actor_count,
    )
    registry.gauge(
        "uigc_dead_letters",
        "Cumulative dead-letter count (system tally).",
        fn=lambda: system.dead_letters,
    )
    registry.gauge(
        "uigc_link_phi",
        "Phi-accrual suspicion per peer link (NodeFabric heartbeat).",
        fn=lambda: _link_phis(system),
        label_name="peer",
    )
    registry.gauge(
        "uigc_fabric_transit_depth",
        "Messages in transit on the fabric's async queue.",
        fn=lambda: _transit_depth(system),
    )
    registry.gauge(
        "uigc_dispatcher_depth",
        "Actor batches waiting for a dispatcher worker.",
        fn=lambda: system.dispatcher.queue_depth(),
    )
    registry.gauge(
        "uigc_writer_queue_depth",
        "Frames queued on the per-peer outbound writer (NodeFabric).",
        fn=lambda: _writer_depths(system),
        label_name="peer",
    )
    # Cluster-sharding gauges: lazy reads of ``system.cluster``, which
    # attaches AFTER telemetry (it needs entity factories) — a callback
    # returning None simply yields no sample until the cluster exists.
    registry.gauge(
        "uigc_shard_table_size",
        "Shards assigned in the current shard table.",
        fn=lambda: _cluster_stat(system, "table_size"),
    )
    registry.gauge(
        "uigc_shard_table_version",
        "Version of the adopted shard table.",
        fn=lambda: _cluster_stat(system, "table_version"),
    )
    registry.gauge(
        "uigc_shard_entities_active",
        "Live entity cells hosted by this node's shard regions.",
        fn=lambda: _cluster_stat(system, "active"),
    )
    registry.gauge(
        "uigc_shard_entities_passivated",
        "Entity snapshots resting in the passivation store.",
        fn=lambda: _cluster_stat(system, "passivated"),
    )
    registry.gauge(
        "uigc_shard_handoff_buffered",
        "Messages buffered behind in-flight handoffs/passivations.",
        fn=lambda: _cluster_stat(system, "buffered"),
    )
    registry.gauge(
        "uigc_shard_migrations_pending",
        "Outbound handoffs awaiting their ack.",
        fn=lambda: _cluster_stat(system, "migrations_pending"),
    )
    # Durability-plane gauges (cluster/journal.py); sampled only while
    # a journal is configured — None yields no sample.
    registry.gauge(
        "uigc_journal_unsynced_records",
        "Journal lag: records appended but not yet fsynced.",
        fn=lambda: _cluster_stat(system, "journal_unsynced"),
    )
    registry.gauge(
        "uigc_journal_live_entities",
        "Keys the journal is actively tracking on this node.",
        fn=lambda: _cluster_stat(system, "journal_live_keys"),
    )
    registry.gauge(
        "uigc_journal_segments",
        "Open + retained journal segment files on this node.",
        fn=lambda: _cluster_stat(system, "journal_segments"),
    )
    # Ingress-gateway gauges (uigc_tpu/gateway): lazy reads of
    # ``system.gateway``, same late-attach contract as the cluster —
    # None until a gateway exists on this node.
    registry.gauge(
        "uigc_gateway_connections",
        "Client connections this gateway currently terminates.",
        fn=lambda: _gateway_stat(system, "connections"),
    )
    registry.gauge(
        "uigc_gateway_egress_queue_depth",
        "Reply frames queued across all per-connection egress queues.",
        fn=lambda: _gateway_stat(system, "egress_depth"),
    )


def _gateway_stat(system: Any, field: str) -> Optional[float]:
    gateway = getattr(system, "gateway", None)
    if gateway is None:
        return None
    return gateway.gauge_value(field)


def _link_phis(system: Any) -> Optional[Dict[str, float]]:
    fabric = getattr(system, "fabric", None)
    monitor = getattr(fabric, "_hb", None)
    if monitor is None:
        return None
    return monitor.phis()


def _transit_depth(system: Any) -> Optional[int]:
    fabric = getattr(system, "fabric", None)
    depth = getattr(fabric, "queue_depth", None)
    return depth() if callable(depth) else None


def _writer_depths(system: Any) -> Optional[Dict[str, int]]:
    fabric = getattr(system, "fabric", None)
    depths = getattr(fabric, "writer_queue_depths", None)
    return depths() if callable(depths) else None


def _cluster_stat(system: Any, field: str) -> Optional[float]:
    cluster = getattr(system, "cluster", None)
    if cluster is None:
        return None
    return cluster.gauge_value(field)
