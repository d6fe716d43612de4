"""The port's operator tools (``uigc_tpu_torch/tools``) on the CPU:
the reference's tool tests from ``tests/test_device.py`` and
``tests/test_timeseries.py`` with their names kept, run on the port's
tools and systems, plus the demos on ``--device cpu`` and the sweep
profile against the reference's simulation and ``trace_marks_np``.

- device_report: the findings explainer on planted planes, the live
  planted regression (recompile storm + a silent copy) attributed with
  its labels, and ``committed_device_figures`` returning None — the
  port reads no TPU round (changed from the reference's test, which
  reads ``BENCH_WAKE_r*``);
- uigc_top: the device panel degrading, ``replay_device`` on
  origin-tagged events, a live 2-node render (merged view included),
  the offline render from a rotated JSONL set and ``telemetry_dump
  --series`` over it, the sparkline/points renderers;
- ``graph_inspect`` and ``telemetry_dump`` demos with ``--device cpu``;
- ``sweep_profile``: ``--simulate`` equal to the reference's
  ``simulate_sweeps`` on one seeded graph, and a CPU profile at 100k
  whose marks equal ``trace_marks_np`` in every mode.
"""

import importlib.util
import json
import os
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from uigc_tpu_torch import AbstractBehavior, ActorTestKit, Behaviors, NoRefs
from uigc_tpu_torch.engines.crgc.arrays import audit_donation, storage_ptrs
from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.runtime.system import ActorSystem
from uigc_tpu_torch.telemetry.device import DeviceObservatory
from uigc_tpu_torch.tools import (device_report, graph_inspect,
                                  sweep_profile, telemetry_dump, uigc_top)
from uigc_tpu_torch.utils import events

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def clean_recorder():
    """Telemetry enables the process-global recorder; leave no residue
    for the rest of the suite."""
    yield
    events.recorder.disable()
    events.recorder.reset()
    with events.recorder._lock:
        events.recorder._listeners.clear()


def _wait(predicate, timeout_s=30.0, poll_s=0.1):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(poll_s)
    return predicate()


# ------------------------------------------------------------------- #
# device_report (tests/test_device.py)
# ------------------------------------------------------------------- #


def test_findings_attribute_planted_planes():
    """The report's explainer names the planted tag/site, worst first."""
    doc = {
        "compile": {"entries": [
            # shape-key churn: one miss per FRESH geometry, same tag
            {"tag": "dec_wake", "geom": f"g{i}", "hits": 0, "misses": 1}
            for i in range(5)
        ]},
        "donation": {"sites": {"mesh.fold": 2}},
        "transfers": {"sites": [
            {"site": "stray", "phase": "fold", "count": 3, "bytes": 999},
            {"site": "marks.decremental", "phase": "trace", "count": 9,
             "bytes": 100},
        ]},
        "ledger": {"families": {}, "peaks": {}},
        "recent_wakes": [],
    }
    flist = device_report.findings(doc)
    assert flist[0]["plane"] == "compile"
    assert flist[0]["label"] == "dec_wake"
    assert flist[0]["severity"] == "critical"
    planes = {f["plane"]: f for f in flist}
    assert planes["donation"]["label"] == "mesh.fold"
    assert planes["transfer"]["label"] == "stray@fold"
    # the accounted trace-phase readback is NOT a finding
    assert not any("marks.decremental" in f["label"] for f in flist)


def _device_kit(extra=None):
    config = {
        "uigc.crgc.wakeup-interval": 10,
        "uigc.crgc.shadow-graph": "decremental",
        "uigc.crgc.device": "cpu",
        "uigc.telemetry.device": True,
        "uigc.telemetry.timeseries": True,
        "uigc.telemetry.ts-sample-interval": 100,
    }
    config.update(extra or {})
    return ActorTestKit(config=config, name="devtest")


def test_planted_regression_fires_alerts_with_labels():
    """A forced per-wake recompile (fresh geometry every beat, one tag)
    and a tensor moved to new storage by an update meant to be in place,
    both injected, must fire ``recompile_storm`` and the donation audit
    with the planted tag/site labels — and device_report must attribute
    both planes."""
    kit = _device_kit()
    try:
        telemetry = kit.system.telemetry
        obs = telemetry.observatory
        engine = telemetry.alerts
        assert engine is not None
        t0 = time.time()
        beats = 0
        while time.time() - t0 < 3.5:
            events.recorder.commit(
                events.COMPILE, tag="planted_storm", geom=f"g{beats}",
                hit=False,
            )
            state = torch.zeros(256, dtype=torch.int32)
            before = storage_ptrs([state])
            audit_donation("planted.copy", before, state.clone())
            beats += 1
            time.sleep(0.1)

        def fired():
            active = {
                (a["rule"], tuple(sorted(a["labels"].items())))
                for a in engine.active()
            }
            return (
                ("recompile_storm", (("tag", "planted_storm"),)) in active
                and (
                    "donation_copy_detected",
                    (("site", "planted.copy"),),
                ) in active
            )

        assert _wait(fired, timeout_s=15.0), engine.active()

        doc = obs.to_doc()
        flist = device_report.findings(doc)
        compile_findings = [f for f in flist if f["plane"] == "compile"]
        assert any(f["label"] == "planted_storm" for f in compile_findings)
        donation_findings = [f for f in flist if f["plane"] == "donation"]
        assert any(f["label"] == "planted.copy" for f in donation_findings)
        # the planes carried the planted labels all the way through
        assert doc["donation"]["sites"]["planted.copy"] == beats
        storm = [
            e for e in doc["compile"]["entries"]
            if e["tag"] == "planted_storm"
        ]
        assert len(storm) == beats  # one fresh geometry per beat
    finally:
        kit.shutdown()


def test_uigc_top_device_panel_degrades():
    assert "device: -" in uigc_top.render_device_panel(None)[0]
    assert "device: -" in uigc_top.render_device_panel("not a doc")[0]
    obs = DeviceObservatory(node="x")
    try:
        lines = uigc_top.render_device_panel(obs.to_doc())
    finally:
        obs.close()
    assert lines[0].startswith("device: ledger")


def test_committed_device_figures_absent_on_cpu_trajectory(tmp_path):
    """The port compares against no TPU figure: the repo's TPU sessions
    and a WAKE round that would satisfy the reference both give None,
    and the report says why."""
    assert device_report.committed_device_figures(str(REPO)) is None
    doc = {"device_per_wake_ms": 2.5, "sweeps_mean": 4.0}
    (tmp_path / "BENCH_WAKE_r01.json").write_text(json.dumps(doc))
    (tmp_path / "BENCH_TPU_SESSION_r05.json").write_text(
        json.dumps({"device_per_wake_ms": 99.0})
    )
    assert device_report.committed_device_figures(str(tmp_path)) is None
    obs = DeviceObservatory(node="x")
    try:
        text = device_report.render_device_doc(obs.to_doc(), None)
    finally:
        obs.close()
    assert "TPU rounds are not the port's" in text


def test_replay_device_accepts_origin_tagged_events(tmp_path):
    """A real node's JSONL sink stamps every line with the node's
    origin; offline replay must fold them, not scope them away."""
    sink = tmp_path / "events.jsonl"
    lines = [
        {"event": events.COMPILE, "tag": "dec_wake", "geom": "g1",
         "hit": False, "origin": "uigc://node-a"},
        {"event": events.COMPILE, "tag": "dec_wake", "geom": "g1",
         "hit": True, "origin": "uigc://node-a"},
        {"event": events.HOST_TRANSFER, "site": "marks.decremental",
         "bytes": 512, "phase": "trace", "origin": "uigc://node-a"},
        {"event": events.DONATION_COPY, "site": "mesh.fold",
         "origin": "uigc://node-a"},
    ]
    sink.write_text("".join(json.dumps(line) + "\n" for line in lines))
    doc = uigc_top.replay_device(str(sink))
    assert doc is not None
    assert doc["compile"]["entries"] == [
        {"tag": "dec_wake", "geom": "g1", "hits": 1, "misses": 1,
         "compile_s": 0.0}
    ]
    assert doc["transfers"]["total_bytes"] == 512
    assert doc["donation"]["sites"] == {"mesh.fold": 1}
    assert doc["node"].startswith("replay:")


# ------------------------------------------------------------------- #
# uigc_top and telemetry_dump (tests/test_timeseries.py)
# ------------------------------------------------------------------- #


class _Ping(NoRefs):
    pass


class _Worker(AbstractBehavior):
    def on_message(self, msg):
        return self


class _Root(AbstractBehavior):
    def __init__(self, context):
        super().__init__(context)
        self.workers = [
            context.spawn(Behaviors.setup(_Worker), f"w{i}") for i in range(4)
        ]

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, _Ping):
            for worker in self.workers:
                worker.tell(_Ping(), ctx)
        elif self.workers:
            ctx.release(*self.workers)
            self.workers = []
        return self


def _spawn_ts_node(name, num_nodes, overrides=None):
    config = {
        "uigc.crgc.wakeup-interval": 20,
        "uigc.crgc.egress-finalize-interval": 5,
        "uigc.crgc.num-nodes": num_nodes,
        "uigc.crgc.shadow-graph": "device",
        "uigc.crgc.device": "cpu",
        "uigc.telemetry.timeseries": True,
        "uigc.telemetry.ts-sample-interval": 50,
        "uigc.telemetry.ts-tiers": "1x120,10x60",
    }
    if overrides:
        config.update(overrides)
    fabric = NodeFabric()
    system = ActorSystem(None, name=name, config=config, fabric=fabric)
    port = fabric.listen()
    return fabric, system, port


def _terminate_all(*systems):
    for system in systems:
        try:
            system.terminate(timeout_s=5.0)
        except Exception:
            pass


def test_uigc_top_renders_live_2node_system(capsys):
    fa, sa, _pa = _spawn_ts_node("topa", 2, {"uigc.telemetry.http-port": 0})
    fb, sb, pb = _spawn_ts_node("topb", 2)
    try:
        fa.connect("127.0.0.1", pb)
        root = sa.spawn_root(Behaviors.setup_root(_Root), "root")
        for _ in range(30):
            root.tell(_Ping())
            time.sleep(0.005)
        time.sleep(0.8)
        base = f"http://127.0.0.1:{sa.telemetry.http.port}"
        assert uigc_top.main(["--url", base, "--once", "--plain"]) == 0
        out = capsys.readouterr().out
        assert "uigc-top" in out and sa.address in out
        assert "live actors" in out
        assert "alerts:" in out or "ALERTS" in out
        # the merged (cluster) view pulls B's series over tsq/tsr
        assert uigc_top.main(["--url", base, "--once", "--merged"]) == 0
        merged_out = capsys.readouterr().out
        assert "cluster: 2 node(s) merged" in merged_out
        # and the /timeseries?merged=1 doc names both nodes
        doc = json.loads(
            urllib.request.urlopen(base + "/timeseries?merged=1", timeout=5).read()
        )
        assert set(doc["nodes"]) == {sa.address, sb.address}
        assert doc["missing_nodes"] == []
    finally:
        _terminate_all(sa, sb)


def test_uigc_top_and_series_render_offline_from_rotated_jsonl(
    tmp_path, capsys
):
    path = str(tmp_path / "events.jsonl")
    kit = ActorTestKit(
        config={
            "uigc.crgc.wakeup-interval": 10,
            "uigc.telemetry.metrics": True,
            "uigc.telemetry.jsonl-path": path,
            "uigc.telemetry.jsonl-max-bytes": 4096,  # force a rotated set
            "uigc.telemetry.jsonl-keep": 3,
        },
        name="topjsonl",
    )
    try:
        root = kit.spawn(Behaviors.setup_root(_Root), "root")
        for _ in range(60):
            root.tell(_Ping())
            time.sleep(0.002)
        time.sleep(0.4)
    finally:
        kit.shutdown()
    assert (tmp_path / "events.jsonl.1").exists()  # rotation really happened
    assert uigc_top.main(["--from-jsonl", path]) == 0
    out = capsys.readouterr().out
    assert "uigc-top" in out and "replay:events.jsonl" in out
    assert "gc live actors" in out  # bridge-fed series (TRACING events)
    assert "entries/s" in out
    # telemetry_dump --series shares the same renderers and source
    assert (
        telemetry_dump.main(
            ["--series", "uigc_gc_wave_seconds_count", "--from-jsonl", path]
        )
        == 0
    )
    out = capsys.readouterr().out
    assert "uigc_gc_wave_seconds_count" in out
    assert "labelset" in out


def test_sparkline_and_points_renderers():
    assert uigc_top.sparkline([]) == "····"
    line = uigc_top.sparkline([0.0, 1.0, 2.0, 3.0], width=4)
    assert len(line) == 4 and line[0] == "▁" and line[-1] == "█"
    assert " " in uigc_top.sparkline([1.0, None, 2.0])
    series = {
        "name": "uigc_x_total",
        "labels": {},
        "tiers": [
            {"res": 2.0, "buckets": [[5, 1, 10.0, 10.0, 10.0, 10.0],
                                     [6, 1, 14.0, 14.0, 14.0, 14.0]]}
        ],
    }
    rates = uigc_top.series_points(series, "rate")
    assert rates == [(12.0, pytest.approx(2.0))]
    means = uigc_top.series_points(series, "mean")
    assert means == [(10.0, 10.0), (12.0, 14.0)]


# ------------------------------------------------------------------- #
# The demos on the CPU
# ------------------------------------------------------------------- #


def test_graph_inspect_demo_runs_on_the_cpu(capsys):
    assert graph_inspect.main(["snapshot", "--demo", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("snapshot node=uigc://inspect-demo")
    assert "/user/root/keeper" in out
    assert graph_inspect.main(["selfcheck", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["problems"] == [] and doc["live_paths"] > 0


def test_telemetry_dump_demo_runs_on_the_cpu(capsys):
    assert telemetry_dump.main(["--demo", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    counts = [float(ln.rsplit(" ", 1)[1]) for ln in out.splitlines()
              if ln.startswith("uigc_gc_wave_seconds_count")]
    assert counts and counts[0] > 0


def test_demos_default_to_the_card(monkeypatch):
    """No silent CPU fallback: without --device the demos ask for the
    card and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_inspect.DemoSystem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_report.DemoSystem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        telemetry_dump.main(["--demo"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_profile.main(["--n", "4096", "--skip-probes"])


# ------------------------------------------------------------------- #
# sweep_profile
# ------------------------------------------------------------------- #


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", REPO / "tools" / f"{name}.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_simulated_sweeps_equal_the_reference(capsys):
    n = 1 << 15
    graph = powerlaw_actor_graph(n, seed=0, garbage_fraction=0.5)
    modes = ["push", "pull", "jump", "auto"]
    want = _reference_tool("sweep_profile").simulate_sweeps(graph, n, modes)
    got = sweep_profile.simulate_sweeps(graph, n, modes)
    assert got == want
    assert got["jump"] < got["push"]
    assert sweep_profile.main(["--simulate", "--n", str(n)]) == 0
    assert json.loads(capsys.readouterr().out)["sweeps"] == got


def test_cpu_profile_marks_equal_the_oracle():
    n = 100_000
    g = powerlaw_actor_graph(n, seed=0, garbage_fraction=0.5)
    prep = ct.prepare_chunks(g["edge_src"], g["edge_dst"], g["edge_weight"],
                             g["supervisor"], n)
    jp = ct.jump_parents_from_graph(g["edge_src"], g["edge_dst"],
                                    g["edge_weight"], g["supervisor"], n)
    lay = ct.layout_to_device(prep, "cpu")
    doc = sweep_profile.profile(g, lay, jp, device="cpu", reps=1)
    want = trace_ops.trace_marks_np(g["flags"], g["recv_count"],
                                    g["supervisor"], g["edge_src"],
                                    g["edge_dst"], g["edge_weight"])
    sim = sweep_profile.simulate_sweeps(g, n, list(ct.TRACE_MODES))
    for mode in ct.TRACE_MODES:
        assert np.array_equal(doc["marks"][mode], want), mode
        row = doc["modes"][mode]
        assert row["n_sweeps"] == sim[mode]
        assert row["kernel_calls"] == row["n_sweeps"]
        assert 0 <= row["kernel_ms"] <= row["fixpoint_ms"]
        assert len(row["dirty_chunks"]) == row["n_sweeps"]
    for key in ("sweep_full_dirty_ms", "sweep_no_dirty_ms",
                "sweep_half_dirty_ms"):
        assert set(doc[key]) == {"propagate", "propagate_gated"}
    assert doc["pack_bools_ms"] > 0 and doc["pack_hits_words_ms"] > 0
    # the kernel calls the profile made, per form: 2 x 3 probes per form
    # and two runs of every mode's sweeps
    assert doc["launches"] == {
        "propagate": 6 + 2 * (sim["push"] + sim["jump"]),
        "propagate_gated": 6 + 2 * (sim["pull"] + sim["auto"]),
    }
    assert [w["mode"] for w in doc["wake_profile_recent"]] == list(
        ct.TRACE_MODES)
