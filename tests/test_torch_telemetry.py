"""The port's telemetry package against the JAX package's
(``uigc_tpu/telemetry``): metrics, exporter, tracing, time series,
alerts and the wake profiler, each fed the same seeded input in both
packages, must give the same exposition text and the same documents.
Then the package on the port's live ``ActorSystem``: every
``uigc.telemetry.*`` key attaches and ``terminate()`` closes it, a
profiled device wake carries device seconds inside its trace phase, and
a single node never registers a cross-node frame.
"""

import json
import random
import re
import sys
import time

import numpy as np
import pytest
import torch

import uigc_tpu.config as ref_config
import uigc_tpu.telemetry as ref_tel
import uigc_tpu.telemetry.profile as ref_profile
import uigc_tpu.telemetry.tracing as ref_tracing
import uigc_tpu_torch.config as port_config
import uigc_tpu_torch.telemetry as port_tel
import uigc_tpu_torch.telemetry.profile as port_profile
import uigc_tpu_torch.telemetry.tracing as port_tracing
from uigc_tpu.utils import events as ref_events
from uigc_tpu_torch import ActorSystem
from uigc_tpu_torch.models import run_tree
from uigc_tpu_torch.utils import events as port_events

torch.set_num_threads(1)

SIDES = {"ref": (ref_tel, ref_events, ref_config),
         "port": (port_tel, port_events, port_config)}

#: events the metrics bridge folds, with the fields each reads
BRIDGE_EVENTS = [
    ("TRACING", ("duration_s", "num_garbage_actors", "num_live_actors")),
    ("ENTRY_SEND", ()), ("PROCESSING_ENTRIES", ("duration_s",)),
    ("DEVICE_TRACE", ("duration_s",)), ("DEAD_LETTER", ()),
    ("UNDO_FOLD", ("address",)), ("FRAME_GAP", ("missed", "src")),
    ("FRAME_DUPLICATE", ("count", "src")), ("FRAME_BATCH", ("size", "bytes")),
    ("SEND_FAILED", ("count", "kind")), ("NODE_DOWN", ("reason",)),
    ("LISTENER_ERROR", ()), ("MERGING_DELTA_GRAPHS", ("duration_s",)),
    ("LEAK_SUSPECT", ()), ("SNAPSHOT", ()),
    ("ALERT", ("rule", "severity", "state")),
    ("LABELSET_OVERFLOW", ("scope",)),
    ("BACKPRESSURE", ("count", "site", "action")),
    ("ANALYSIS_CHECK", ("n_garbage", "oracle_garbage")),
    ("DIST_MARKS", ("count", "dst", "bytes")),
    ("SHARD_ENTITY_ACTIVATED", ("migrated", "resumed")),
    ("INGRESS_ENTRY_SERIALIZATION", ("size",)),
]


def seeded_stream(seed, length=600):
    """(event attribute, fields) pairs with seeded values; labels come
    from small vocabularies so label sets repeat."""
    rng = np.random.default_rng(seed)
    words = ["a", "b", "c"]
    out = []
    for _ in range(length):
        attr, keys = BRIDGE_EVENTS[rng.integers(len(BRIDGE_EVENTS))]
        fields = {}
        for key in keys:
            if key == "duration_s":
                fields[key] = float(rng.exponential(0.01))
            elif key in ("migrated", "resumed"):
                fields[key] = bool(rng.integers(2))
            elif key == "state":
                fields[key] = ("firing", "resolved")[rng.integers(2)]
            elif key in ("address", "src", "kind", "reason", "rule",
                         "severity", "scope", "site", "action", "dst"):
                fields[key] = words[rng.integers(len(words))]
            else:
                fields[key] = int(rng.integers(0, 5000))
        out.append((attr, fields))
    return out


def bridge_exposition(side, stream):
    tel, events, _ = SIDES[side]
    registry = tel.MetricsRegistry(const_labels={"node": "uigc://n1"},
                                   max_labelsets=8)
    bridge = tel.EventMetricsBridge(registry, node="uigc://n1")
    for attr, fields in stream:
        bridge(getattr(events, attr), dict(fields))
    bridge(events.TRACING, {"origin": "uigc://other", "duration_s": 9.0})
    return tel.prometheus_text(registry), registry.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_exposition_equals_the_reference(seed):
    stream = seeded_stream(seed)
    ref_text, ref_doc = bridge_exposition("ref", stream)
    port_text, port_doc = bridge_exposition("port", stream)
    assert port_text == ref_text
    assert port_doc == ref_doc
    assert "uigc_gc_wave_seconds_count" in port_text


def test_jsonl_sink_round_trip_equals_the_reference(tmp_path):
    stream = seeded_stream(2, length=200)
    replayed = {}
    for side in SIDES:
        tel, events, _ = SIDES[side]
        path = str(tmp_path / f"{side}.jsonl")
        sink = tel.JsonlEventSink(path, max_bytes=4096, keep=2)
        for attr, fields in stream:
            sink(getattr(events, attr), fields)
        sink(events.ANALYSIS_VIOLATION, {"rule": "verdict.mismatch"})
        sink.close()
        replayed[side] = (list(tel.replay_jsonl(path)),
                          tel.replay_violations(path))
    assert replayed["port"] == replayed["ref"]
    assert replayed["port"][1] == [{"rule": "verdict.mismatch"}]


class FakeClock:
    """A ``time`` stand-in: every read advances by a seeded step."""

    def __init__(self, seed):
        self._rng = random.Random(seed)
        self._now = 1_000.0

    def _tick(self):
        self._now += self._rng.uniform(0.0005, 0.004)
        return self._now

    perf_counter = time = monotonic = _tick


def traced(side, monkeypatch):
    tracing = {"ref": ref_tracing, "port": port_tracing}[side]
    monkeypatch.setattr(tracing, "time", FakeClock(11))
    monkeypatch.setattr(tracing._ID_TLS, "rng", random.Random(12),
                        raising=False)
    tracer = tracing.Tracer("uigc://n1", enabled=True)
    with tracer.span("gc_wave", node="uigc://n1") as wave:
        tracer.note_wave(wave.ctx)
        for i in range(5):
            header = tracer.on_send(target=f"/user/a{i}")
            with tracer.span("invoke", parent=header, actor=f"/user/a{i}"):
                tracer.instant("terminate", actor=f"/user/a{i}")
    return tracing.chrome_trace([tracer])


def test_chrome_trace_equals_the_reference(monkeypatch):
    ref = traced("ref", monkeypatch)
    port = traced("port", monkeypatch)
    assert port == ref
    assert len(port["traceEvents"]) > 10


def series_docs(side):
    tel, _, config = SIDES[side]
    clock = FakeClock(21)
    store = tel.TimeSeriesStore(node="uigc://n1",
                                tiers=tel.parse_tiers("1x30,10x20"),
                                max_labelsets=4, clock=clock.time)
    alerts = tel.AlertEngine(store, node="uigc://n1")
    alerts.add_rules(tel.builtin_rules(config.Config({
        "uigc.telemetry.alert-wake-threshold": 0.05})))
    rng = np.random.default_rng(22)
    t = 1_000.0
    fired = []
    for step in range(120):
        t += 0.5
        store.record("uigc_wake_wall_seconds",
                     float(rng.exponential(0.01 if step < 90 else 0.2)), t=t)
        store.record("uigc_compile_misses_total", float(step // 3), t=t,
                     tag=("trace_fn", "dec_wake")[step % 2])
        store.record("uigc_queue", float(rng.integers(10)), t=t,
                     peer=f"p{rng.integers(6)}")
        if step % 10 == 9:
            fired += [(a["rule"], a["labels"]) if "labels" in a else a["rule"]
                      for a in alerts.evaluate(t)]
    doc = store.to_doc()
    doc.pop("t")
    # every field of every rule; the descriptions' prose may differ
    rules = [{k: v for k, v in rule.items() if k != "description"}
             for rule in alerts.to_doc()["rules"]]
    assert all(rule["description"] for rule in alerts.to_doc()["rules"])
    return (doc, store.range("uigc_wake_wall_seconds", window_s=20, now=t),
            store.stats(), fired, rules)


def test_timeseries_and_alerts_equal_the_reference():
    ref = series_docs("ref")
    port = series_docs("port")
    assert port == ref
    assert port[3], "the planted wake regression fired no alert"
    assert port[2]["dropped_labelsets"] > 0  # the cardinality bound held


def profiled(side, monkeypatch):
    """A wake profiler fed one seeded wake sequence on a fake clock."""
    tel, events, _ = SIDES[side]
    profile = {"ref": ref_profile, "port": port_profile}[side]
    monkeypatch.setattr(profile, "time", FakeClock(31))
    rng = np.random.default_rng(32)
    registry = tel.MetricsRegistry(const_labels={"node": "uigc://n1"})
    prof = tel.WakeProfiler("uigc://n1", registry=registry)
    for _ in range(12):
        wake = prof.begin_wake()
        with wake.phase("ingest"):
            with wake.phase("broadcast"):
                pass
        with wake.phase("fold"):
            pass
        with wake.phase("trace"):
            n = int(rng.integers(1, 6))
            prof(events.DEVICE_TRACE, {
                "duration_s": float(rng.exponential(0.002)),
                "trace_mode": "auto", "n_sweeps": n,
                "sweep_dirty_chunks": rng.integers(0, 40, n).tolist()})
            prof(events.SWEEP, {"duration_s": float(rng.exponential(0.001))})
        wake.end(entries=int(rng.integers(100)),
                 garbage=int(rng.integers(10)))
    return prof.to_json(), tel.prometheus_text(registry)


def test_wake_profiler_equals_the_reference(monkeypatch):
    ref_doc, ref_text = profiled("ref", monkeypatch)
    port_doc, port_text = profiled("port", monkeypatch)
    assert port_doc == ref_doc
    assert port_text == ref_text
    assert set(port_doc["phases"]) == {"ingest", "fold", "trace", "sweep",
                                       "broadcast"}
    assert all(len(r["sweep_device_ms"]) == r["n_sweeps"]
               for r in port_doc["recent"])


# --------------------------------------------------------------------- #
# On the port's live system
# --------------------------------------------------------------------- #

CPU = {"uigc.crgc.device": "cpu", "uigc.crgc.wakeup-interval": 10}
KEYS = [
    {"uigc.telemetry.metrics": True},
    {"uigc.telemetry.tracing": True},
    {"uigc.telemetry.wake-profile": True},
    {"uigc.telemetry.inspect": True},
    {"uigc.telemetry.timeseries": True,
     "uigc.telemetry.ts-sample-interval": 20},
    {"uigc.telemetry.device": True},
    {"uigc.telemetry.http-port": 0},
    {"uigc.telemetry.jsonl-path": "JSONL"},
]
PARTS = ["registry", "tracer", "profiler", "inspector", "store",
         "observatory", "http", "jsonl"]


@pytest.mark.parametrize("key", range(len(KEYS)),
                         ids=lambda i: next(iter(KEYS[i])))
def test_each_key_attaches_its_part_and_terminate_closes_it(key, tmp_path):
    config = dict(KEYS[key])
    if "uigc.telemetry.jsonl-path" in config:
        config["uigc.telemetry.jsonl-path"] = str(tmp_path / "events.jsonl")
    system = ActorSystem(None, name="tel", config=dict(
        CPU, **{"uigc.crgc.shadow-graph": "device"}, **config))
    tel = system.telemetry
    try:
        part = getattr(tel, PARTS[key])
        assert part is not None
        if PARTS[key] == "tracer":
            assert part.enabled
        if PARTS[key] == "http":
            port = part.port
            import urllib.request
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
                assert b"uigc_live_actors" in resp.read()
    finally:
        system.terminate()
    assert tel._listeners == [] and tel.http is None and tel.jsonl is None
    assert system.engine.wake_profiler is None
    assert system.engine.device_observatory is None
    assert system.engine.liveness_inspector is None
    assert tel.sampler is None


def test_single_node_registers_no_cross_node_frame(monkeypatch):
    # Other tests in this process may have loaded the wire codec: take it
    # out of sys.modules for the check, so a single node must not load it
    # again.
    import uigc_tpu_torch.runtime as port_runtime

    monkeypatch.delitem(sys.modules, "uigc_tpu_torch.runtime.wire",
                        raising=False)
    monkeypatch.delattr(port_runtime, "wire", raising=False)
    system = ActorSystem(None, name="solo", config=dict(CPU, **{
        "uigc.telemetry.inspect": True, "uigc.telemetry.timeseries": True,
        "uigc.telemetry.ts-sample-interval": 20}))
    try:
        tel = system.telemetry
        assert not tel._snap_frame_registered
        assert not tel._ts_frames_registered
        assert tel.inspector._peers_fn is None
        assert tel.store._known_peers_fn is None
        assert "uigc_tpu_torch.runtime.wire" not in sys.modules
    finally:
        system.terminate()


def test_a_frame_speaking_fabric_would_take_the_wire_branch():
    """On a port NodeFabric (the fabric that speaks custom frames)
    telemetry registers the ``snap`` handler, which decodes a frame the
    reference's wire codec encoded: a peer's snapshot request, sent over
    the socket in the reference's bytes, is answered with this node's
    snapshot in a frame the reference decodes; closing telemetry
    unregisters the handler."""
    import uigc_tpu.runtime.wire as ref_wire
    from uigc_tpu_torch.runtime.node import NodeFabric

    config = dict(CPU, **{"uigc.crgc.num-nodes": 2})
    fa, fb = NodeFabric(), NodeFabric()
    a = ActorSystem(None, name="framed", config=dict(config, **{
        "uigc.telemetry.inspect": True}), fabric=fa)
    b = ActorSystem(None, name="asker", config=config, fabric=fb)
    answers = []
    try:
        tel = a.telemetry
        assert tel._snap_frame_registered
        fb.register_frame_handler(ref_wire.SNAP_FRAME_KIND,
                                  lambda peer, frame: answers.append(frame))
        fb.connect("127.0.0.1", fa.listen())
        assert fb.send_frame(a.address, ref_wire.encode_snap_request(
            41, b.address))
        assert fb.send_frame(a.address, ("snap", "bogus"))  # ignored
        deadline = time.monotonic() + 10
        while not answers and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(answers) == 1
        kind, req_id, origin, payload = ref_wire.decode_snap_frame(answers[0])
        assert (kind, req_id, origin) == ("rsp", 41, a.address)
        assert json.loads(payload)["node"] == a.address
        tel.close()
        assert ref_wire.SNAP_FRAME_KIND not in fa._frame_handlers
    finally:
        for system in (a, b):
            system.terminate()


def test_profiled_device_wakes_carry_device_seconds():
    """A live run on the device backend (CPU) with the wake profiler and
    metrics on: device seconds land in the trace phase, and the
    exposition parses."""
    def probe(system, stage):
        tel = system.telemetry
        return {"profile": tel.profiler.to_json(),
                "text": port_tel.prometheus_text(tel.registry),
                "doc": tel.observatory.to_doc()}

    out = run_tree(400, fanout=4, config=dict(CPU, **{
        "uigc.crgc.shadow-graph": "device",
        "uigc.telemetry.wake-profile": True,
        "uigc.telemetry.metrics": True,
        "uigc.telemetry.device": True}), hold_wakes=3, probe=probe)
    got = out["probe"]["collected"]
    phases = got["profile"]["phases"]
    assert got["profile"]["wakes"] > 0
    assert 0 < phases["trace"]["device_total_s"] <= phases["trace"]["total_s"]
    assert port_tel.validate_device_doc(got["doc"]) == []
    assert got["doc"]["ledger"]["device_bytes"] > 0
    sample = re.compile(r'^[a-z_]+(\{[^}]*\})? -?[0-9.e+-]+$|^[a-z_]+'
                        r'(\{[^}]*\})? (\+Inf|NaN)$')
    for line in got["text"].splitlines():
        assert line.startswith("#") or sample.match(line), line
    assert "uigc_wake_phase_seconds_count" in got["text"]
    json.dumps(got["doc"])  # the /device document is JSON-able
