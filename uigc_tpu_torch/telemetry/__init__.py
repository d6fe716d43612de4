"""Copy of ``uigc_tpu/telemetry/__init__.py`` (pure Python), held against
it by ``tests/test_torch_telemetry.py`` and, across nodes, by
``tests/test_torch_node_telemetry.py``.  Its ``..runtime.wire`` imports
sit behind the ``register_frame_handler`` guard, as in the reference:
the cross-node ``snap``, ``tsq`` and ``tsr`` frames register on a
``NodeFabric`` (``runtime/node.py``), and a single node never loads the
wire codec.

Telemetry: the exportable observability layer.

The event recorder (:mod:`uigc_tpu.utils.events`) is an in-process
counter sink — nothing can be scraped, correlated across nodes, or
attributed to a single GC wave.  This package is the subsystem on top
(see GUIDE.md "Observability"):

- :mod:`uigc_tpu.telemetry.metrics` — typed registry (counters, gauges,
  bounded-bucket histograms) populated from recorder listeners plus
  direct taps on live runtime state;
- :mod:`uigc_tpu.telemetry.tracing` — causal message tracing with
  trace/span ids propagated through ``NodeFabric`` frame headers,
  exported as Chrome-trace/Perfetto JSON;
- :mod:`uigc_tpu.telemetry.profile` — the collector wake profiler
  (ingest/fold/trace/sweep/broadcast phases, device-vs-host time);
- :mod:`uigc_tpu.telemetry.exporter` — Prometheus text exposition over
  a localhost HTTP handle, plus JSONL event persistence (size-capped
  rotation) whose replay feeds ``RaceDetector.feed()`` and the
  violation record offline;
- :mod:`uigc_tpu.telemetry.inspect` — the liveness inspector: why-live
  retaining paths from the marking-parent forest, flight-recorder
  snapshots with retained-set diffing, the leak watchdog, and the
  cross-node merged graph (read-only by the UL008 contract);
- :mod:`uigc_tpu.telemetry.timeseries` — the time plane: per-node
  multi-resolution metric history (ring buffers, O(1) memory), a
  sampler thread feeding it from the registry/wake profiler/send
  matrix, and coordinator-free cluster aggregation over the
  ``tsq``/``tsr`` fabric frames;
- :mod:`uigc_tpu.telemetry.alerts` — declarative anomaly/SLO rules
  (threshold, rate-of-change, EWMA-sigma) evaluated against the store,
  emitting ``telemetry.alert`` events and
  ``uigc_alerts_total{rule,severity}``.

Everything is off by default and attached per-system from the
``uigc.telemetry.*`` config keys; :class:`Telemetry` is the composition
root (`system.telemetry`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, List, Optional

from ..utils import events
from .exporter import (
    JsonlEventSink,
    MetricsHTTPServer,
    prometheus_text,
    replay_jsonl,
    replay_violations,
)
from .alerts import AlertEngine, AlertRule, builtin_rules
from .device import DeviceObservatory, ledger_families, validate_device_doc
from .inspect import FlightRecorder, LeakWatchdog, LivenessInspector
from .metrics import EventMetricsBridge, MetricsRegistry, install_system_gauges
from .profile import WakeProfiler
from .timeseries import MetricsSampler, TimeSeriesStore, merge_series_docs, parse_tiers
from .tracing import Tracer, chrome_trace, write_chrome_trace

if TYPE_CHECKING:  # pragma: no cover
    from ..runtime.system import ActorSystem

__all__ = [
    "Telemetry",
    "MetricsRegistry",
    "EventMetricsBridge",
    "Tracer",
    "WakeProfiler",
    "LivenessInspector",
    "FlightRecorder",
    "LeakWatchdog",
    "DeviceObservatory",
    "ledger_families",
    "validate_device_doc",
    "TimeSeriesStore",
    "MetricsSampler",
    "AlertEngine",
    "AlertRule",
    "builtin_rules",
    "merge_series_docs",
    "parse_tiers",
    "MetricsHTTPServer",
    "JsonlEventSink",
    "prometheus_text",
    "chrome_trace",
    "write_chrome_trace",
    "replay_jsonl",
    "replay_violations",
]


class Telemetry:
    """Per-system composition of the telemetry parts, driven by config.

    Attach order matters only in that listeners register before any
    workload runs; the runtime reads ``system.telemetry`` lazily on its
    hot paths (one attribute check when telemetry is off)."""

    def __init__(self, system: "ActorSystem"):
        self.system = system
        config = system.config
        self.registry: Optional[MetricsRegistry] = None
        self.tracer = Tracer(
            system.address, enabled=config.get_bool("uigc.telemetry.tracing")
        )
        self.profiler: Optional[WakeProfiler] = None
        self.inspector: Optional[LivenessInspector] = None
        self.observatory: Optional[DeviceObservatory] = None
        self.store: Optional[TimeSeriesStore] = None
        self.sampler: Optional[MetricsSampler] = None
        self.alerts: Optional[AlertEngine] = None
        self.http: Optional[MetricsHTTPServer] = None
        self.jsonl: Optional[JsonlEventSink] = None
        self._listeners: List[Any] = []
        self._snap_frame_registered = False
        self._ts_frames_registered = False

        timeseries_on = config.get_bool("uigc.telemetry.timeseries")
        device_on = config.get_bool("uigc.telemetry.device")
        # The time plane samples the registry, so it implies metrics;
        # the device observatory exports through the registry too.
        metrics_on = (
            config.get_bool("uigc.telemetry.metrics")
            or timeseries_on
            or device_on
        )
        profile_on = (
            config.get_bool("uigc.telemetry.wake-profile")
            # ... and feeds wake latency from the profiler's records.
            or timeseries_on
            # The observatory attributes transfers to wake phases and
            # per-sweep device time to wake records — both profiler-fed.
            or device_on
        )
        inspect_on = config.get_bool("uigc.telemetry.inspect")
        http_port = config.get_int("uigc.telemetry.http-port")
        jsonl_path = config.get_string("uigc.telemetry.jsonl-path")

        if metrics_on or http_port >= 0:
            self.registry = MetricsRegistry(
                const_labels={"node": system.address},
                max_labelsets=config.get_int("uigc.telemetry.max-labelsets"),
            )
            install_system_gauges(self.registry, system)
        if metrics_on:
            bridge = EventMetricsBridge(self.registry, node=system.address)
            self._listeners.append(bridge)
        if profile_on:
            # With a registry present the profiler also exports
            # uigc_wake_phase_seconds{phase=...} histograms, not just
            # its BENCH-JSON dump.
            self.profiler = WakeProfiler(system.address, registry=self.registry)
            self._listeners.append(self.profiler)
            engine = getattr(system, "engine", None)
            if engine is not None:
                engine.wake_profiler = self.profiler
        if inspect_on:
            self.inspector = self._attach_inspector()
        if device_on:
            self.observatory = self._attach_observatory()
        if timeseries_on:
            self._attach_timeseries()
        if jsonl_path:
            self.jsonl = JsonlEventSink(
                jsonl_path,
                max_bytes=config.get_int("uigc.telemetry.jsonl-max-bytes"),
                keep=config.get_int("uigc.telemetry.jsonl-keep"),
            )
            self._listeners.append(self.jsonl)
        if http_port >= 0:
            self.http = MetricsHTTPServer(
                self.registry,
                port=http_port,
                inspector=self.inspector,
                node=system.address,
                store=self.store,
                alerts=self.alerts,
                observatory=self.observatory,
            )

        if self._listeners or self.inspector is not None:
            # Listener-fed parts need the process recorder live (the
            # inspector is a committer, not a listener, but its
            # leak_suspect/snapshot events need the same).
            events.recorder.enable()
            for listener in self._listeners:
                events.recorder.add_listener(listener)

    def _attach_inspector(self) -> Optional[LivenessInspector]:
        """Wire the liveness inspector: engine-side capture enablement
        (the inspector itself is read-only by the UL008 contract, so
        every mutation of engine/transport state happens HERE), the
        collector's per-wake hook, and — on a NodeFabric — the "snap"
        frame exchange behind the cross-node merged snapshot."""
        system = self.system
        config = system.config
        engine = getattr(system, "engine", None)
        bookkeeper = getattr(engine, "bookkeeper", None)
        if bookkeeper is None:
            return None  # engines without a collector graph (manual)
        leak_waves = config.get_int("uigc.telemetry.leak-waves")
        # Wall-clock floor on suspicion: N quiet waves AND idle for at
        # least as long as N waves take, so millisecond collector
        # cadences cannot outrun a workload's ordinary message gaps.
        wakeup_s = config.get_int("uigc.crgc.wakeup-interval") / 1000.0
        inspector = LivenessInspector(
            node=system.address,
            graph_fn=lambda: bookkeeper.shadow_graph,
            snapshot_every=config.get_int("uigc.telemetry.snapshot-every"),
            snapshot_keep=config.get_int("uigc.telemetry.snapshot-keep"),
            leak_waves=leak_waves,
            leak_min_idle_s=leak_waves * wakeup_s,
            parent_capture=config.get_bool("uigc.telemetry.why-live-capture"),
            dump_path=config.get_string("uigc.telemetry.inspect-dump-path"),
        )
        engine.liveness_inspector = inspector
        # Enable the send-matrix accumulation on backends that carry it
        # (the placement input, ROADMAP item 5) — a plain dict assigned
        # from here, consulted by every fold plane.
        graph = bookkeeper.shadow_graph
        if hasattr(graph, "send_matrix") and graph.send_matrix is None:
            graph.send_matrix = {}
        # Crash dump: the fabric's crash event triggers a best-effort
        # flight-recorder flush to the configured path.
        if inspector.dump_path:
            node = system.address

            def _crash_listener(name: str, fields: Any) -> None:
                if name == events.NODE_CRASHED and fields.get("address") == node:
                    inspector.on_crash()

            self._listeners.append(_crash_listener)
        # Cross-node merge: register the "snap" frame on fabrics that
        # speak custom frame kinds (NodeFabric).
        fabric = getattr(system, "fabric", None)
        if fabric is not None and hasattr(fabric, "register_frame_handler"):
            from ..runtime import wire

            def _snap_handler(from_address: str, frame: tuple) -> None:
                decoded = wire.decode_snap_frame(frame)
                if decoded is not None:
                    inspector.on_snap_frame(from_address, *decoded)

            fabric.register_frame_handler(wire.SNAP_FRAME_KIND, _snap_handler)
            self._snap_frame_registered = True
            inspector.bind_fabric(
                peers_fn=fabric._live_peers,
                send_request=lambda addr, rid: fabric.send_frame(
                    addr, wire.encode_snap_request(rid, system.address)
                ),
                send_response=lambda addr, rid, payload: fabric.send_frame(
                    addr, wire.encode_snap_response(rid, system.address, payload)
                ),
            )
        return inspector

    def _attach_observatory(self) -> Optional[DeviceObservatory]:
        """Wire the device-plane observatory: a recorder listener (the
        ``tpu.host_transfer`` / ``tpu.compile`` / ``tpu.donation_copy``
        planes), the collector's per-wake ledger hook, and the engine-
        side enablement flags — every mutation of engine state happens
        HERE, the observatory itself only reads (the inspector's
        discipline)."""
        system = self.system
        engine = getattr(system, "engine", None)
        bookkeeper = getattr(engine, "bookkeeper", None)
        graph_fn = None
        if bookkeeper is not None:
            graph_fn = lambda: bookkeeper.shadow_graph  # noqa: E731
        observatory = DeviceObservatory(
            node=system.address,
            registry=self.registry,
            profiler=self.profiler,
            graph_fn=graph_fn,
        )
        self._listeners.append(observatory)
        if engine is not None:
            engine.device_observatory = observatory
        # Donation audits cost a data_ptr() read per in-place update:
        # enabled here, paid only while an observatory is attached.
        graph = getattr(bookkeeper, "shadow_graph", None)
        if graph is not None and hasattr(graph, "donation_audit"):
            graph.donation_audit = True
        return observatory

    def _attach_timeseries(self) -> None:
        """Wire the time plane: store + sampler thread, the anomaly/SLO
        engine, send-matrix capture enablement (a mutation, so it lives
        HERE, not in the read-path modules), and — on a NodeFabric —
        the ``tsq``/``tsr`` frame pair behind coordinator-free cluster
        aggregation."""
        system = self.system
        config = system.config
        self.store = TimeSeriesStore(
            node=system.address,
            tiers=parse_tiers(config.get_string("uigc.telemetry.ts-tiers")),
            max_labelsets=config.get_int("uigc.telemetry.max-labelsets"),
        )
        if config.get_bool("uigc.telemetry.alerts"):
            self.alerts = AlertEngine(self.store, node=system.address)
            self.alerts.add_rules(builtin_rules(config))
        # Send-matrix accumulation: the drift series item 5's
        # partitioner will consume (the inspector enables the same dict
        # when it attaches; either one suffices).
        engine = getattr(system, "engine", None)
        bookkeeper = getattr(engine, "bookkeeper", None)
        graph_fn = None
        if bookkeeper is not None:
            graph = bookkeeper.shadow_graph
            if hasattr(graph, "send_matrix") and graph.send_matrix is None:
                graph.send_matrix = {}
            graph_fn = lambda: bookkeeper.shadow_graph  # noqa: E731
        self.sampler = MetricsSampler(
            self.store,
            registry=self.registry,
            profiler=self.profiler,
            graph_fn=graph_fn,
            alerts=self.alerts,
            interval_s=config.get_int("uigc.telemetry.ts-sample-interval")
            / 1000.0,
        ).start()
        # Cluster pull: register the tsq/tsr frames on fabrics that
        # speak custom frame kinds (NodeFabric).  Dead peers stay in
        # the known set so a merge names them in missing_nodes instead
        # of silently forgetting them.
        fabric = getattr(system, "fabric", None)
        if fabric is not None and hasattr(fabric, "register_frame_handler"):
            from ..runtime import wire

            store = self.store

            def _tsq_handler(from_address: str, frame: tuple) -> None:
                decoded = wire.decode_ts_query(frame)
                if decoded is not None:
                    store.on_query_frame(from_address, *decoded)

            def _tsr_handler(from_address: str, frame: tuple) -> None:
                decoded = wire.decode_ts_response(frame)
                if decoded is not None:
                    store.on_response_frame(*decoded)

            fabric.register_frame_handler(wire.TSQ_FRAME_KIND, _tsq_handler)
            fabric.register_frame_handler(wire.TSR_FRAME_KIND, _tsr_handler)
            self._ts_frames_registered = True
            store.bind_fabric(
                known_peers_fn=lambda: [
                    a for a in list(fabric._conns) if a != system.address
                ],
                live_peers_fn=fabric._live_peers,
                send_query=lambda addr, rid, q: fabric.send_frame(
                    addr, wire.encode_ts_query(rid, system.address, q)
                ),
                send_response=lambda addr, rid, payload: fabric.send_frame(
                    addr, wire.encode_ts_response(rid, system.address, payload)
                ),
            )

    # ------------------------------------------------------------- #

    @classmethod
    def attach(cls, system: "ActorSystem") -> "Telemetry":
        # The "is any telemetry key on" gate lives inline in
        # runtime/system.py (the one caller), so this package is not
        # imported at all for un-instrumented systems.
        return cls(system)

    def close(self) -> None:
        """Detach listeners and release external handles.  The process
        recorder stays enabled — other systems may still be feeding it."""
        for listener in self._listeners:
            events.recorder.remove_listener(listener)
        self._listeners = []
        if self.sampler is not None:
            self.sampler.close()
            self.sampler = None
        if self._ts_frames_registered:
            fabric = getattr(self.system, "fabric", None)
            if fabric is not None:
                from ..runtime import wire

                fabric.register_frame_handler(wire.TSQ_FRAME_KIND, None)
                fabric.register_frame_handler(wire.TSR_FRAME_KIND, None)
            self._ts_frames_registered = False
        self.store = None
        self.alerts = None
        engine = getattr(self.system, "engine", None)
        if engine is not None and engine.wake_profiler is self.profiler:
            engine.wake_profiler = None
        if self.observatory is not None:
            if engine is not None and (
                engine.device_observatory is self.observatory
            ):
                engine.device_observatory = None
            bookkeeper = getattr(engine, "bookkeeper", None)
            graph = getattr(bookkeeper, "shadow_graph", None)
            if graph is not None and getattr(graph, "donation_audit", False):
                graph.donation_audit = False
            self.observatory.close()
            self.observatory = None
        if self.inspector is not None:
            if self.inspector.dump_path:
                self.inspector.on_crash(reason="close")
            if engine is not None and (
                engine.liveness_inspector is self.inspector
            ):
                engine.liveness_inspector = None
            if self._snap_frame_registered:
                fabric = getattr(self.system, "fabric", None)
                if fabric is not None:
                    from ..runtime import wire

                    fabric.register_frame_handler(wire.SNAP_FRAME_KIND, None)
            self.inspector = None
        if self.http is not None:
            self.http.close()
            self.http = None
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None
