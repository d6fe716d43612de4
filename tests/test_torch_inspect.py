"""The port's liveness inspector (``telemetry/inspect.py``) against the
JAX package's: snapshots, why-live chains (captured by a wake and
derived on demand, on the host graph and on the device graph, where the
port derives through ``marking_parents_torch``), the flight recorder's
diffs and the leak watchdog on a planted leak, each on the same seeded
input in both packages.  Then why-live on the port's live system.
"""

import time

import numpy as np
import pytest
import torch

from uigc_tpu.engines.crgc import arrays as ref_arrays
from uigc_tpu.engines.crgc import mesh as ref_mesh
from uigc_tpu.engines.crgc.state import CrgcContext as RefContext
from uigc_tpu.telemetry import inspect as ref_inspect
from uigc_tpu_torch import AbstractBehavior, ActorTestKit, Behaviors, Message
from uigc_tpu_torch.engines.crgc import arrays as port_arrays
from uigc_tpu_torch.engines.crgc import mesh as port_mesh
from uigc_tpu_torch.engines.crgc.state import CrgcContext
from uigc_tpu_torch.ops import cuda_trace
from uigc_tpu_torch.ops import trace as F
from uigc_tpu_torch.telemetry import inspect as port_inspect

torch.set_num_threads(1)


class FakeSystem:
    address = "uigc://insp"


class FakeCell:
    """What the inspector reads of a cell: system address, uid, path."""

    system = FakeSystem()

    def __init__(self, uid):
        self.uid = uid
        self.path = f"/user/a{uid}"


def seeded_graphs(backend, seed, n=300):
    """The same seeded graph in both packages (the mesh at 2 shards):
    random roots, busy and halted actors, receive balances, positive and
    dead edges, supervisors."""
    ref_ctx = RefContext(delta_graph_size=64, entry_field_size=4)
    port_ctx = CrgcContext(delta_graph_size=64, entry_field_size=4)
    if backend == "mesh":
        ref = ref_mesh.MeshShadowGraph(ref_ctx, FakeSystem.address,
                                       n_devices=2)
        port = port_mesh.MeshShadowGraph(port_ctx, FakeSystem.address,
                                         n_devices=2, device="cpu")
    else:
        kw = dict(use_device=backend == "device", trace_mode="auto")
        ref = ref_arrays.ArrayShadowGraph(ref_ctx, FakeSystem.address, **kw)
        port = port_arrays.ArrayShadowGraph(port_ctx, FakeSystem.address,
                                            device="cpu", **kw)
    rng = np.random.default_rng(seed)
    cells = [FakeCell(i + 1) for i in range(n)]
    extra = rng.choice([0, F.FLAG_ROOT, F.FLAG_BUSY, F.FLAG_HALTED],
                       n, p=[0.9, 0.04, 0.03, 0.03])
    recv = np.where(rng.random(n) < 0.05, rng.integers(-2, 3, n), 0)
    edges = rng.integers(0, n, (3 * n, 2))
    weights = rng.choice([1, 1, 2, -1], 3 * n)
    sups = np.where(rng.random(n) < 0.3, rng.integers(0, n, n), -1)
    for g in (ref, port):
        slots = [g.slot_for(c) for c in cells]
        for i, s in enumerate(slots):
            g.flags[s] |= F.FLAG_INTERNED | F.FLAG_LOCAL | int(extra[i])
            g.recv_count[s] = int(recv[i])
        for (a, b), w in zip(edges.tolist(), weights.tolist()):
            g._update_edge(slots[a], slots[b], w)
        for i, p in enumerate(sups.tolist()):
            if p >= 0:
                g._set_supervisor(slots[i], slots[p])
    return ref, port, cells


def snapshot(mod, graph):
    snap = mod.snapshot_graph(graph, node=FakeSystem.address)
    snap.pop("t")
    return snap


@pytest.mark.parametrize("backend", ["array", "device", "mesh"])
@pytest.mark.parametrize("seed", [0, 1])
def test_snapshots_and_why_live_chains_equal_the_reference(backend, seed):
    ref, port, cells = seeded_graphs(backend, seed)
    snap = snapshot(port_inspect, port)
    assert snap == snapshot(ref_inspect, ref)
    names = [c.path for c in cells]
    results = {}
    for source in ("derived", "captured"):
        if source == "captured":
            for g in (ref, port):
                g.capture_parents = True
            assert ref.trace(should_kill=False) == port.trace(
                should_kill=False)
            snap = snapshot(port_inspect, port)
            assert snap == snapshot(ref_inspect, ref)
        for name in names:
            want = ref_inspect.why_live_from_parents(ref, snap, name)
            got = port_inspect.why_live_from_parents(port, snap, name)
            assert got == want, name
            assert port_inspect.why_live(snap, name) == ref_inspect.why_live(
                snap, name)
            if got is not None and got["verdict"] == "live":
                assert got["parents"] == source
                assert port_inspect.validate_why_live(snap, got) == []
                results.setdefault(source, []).append(len(got["chain"]))
    # live actors resolved both ways, some through chains of 3 or more
    assert results["derived"] and results["captured"]
    assert max(results["derived"]) >= 3


def test_device_derivation_runs_marking_parents_torch(monkeypatch):
    """On a device graph the on-demand derivation is the port's torch
    fixpoint, on the graph's device."""
    _ref, port, cells = seeded_graphs("device", 2)
    calls = []
    orig = cuda_trace.marking_parents_torch

    def spy(*args, device=None):
        calls.append(device)
        return orig(*args, device=device)

    monkeypatch.setattr(cuda_trace, "marking_parents_torch", spy)
    snap = snapshot(port_inspect, port)
    live = [c.path for c in cells
            if port_inspect.why_live(snap, c.path)["verdict"] == "live"]
    got = port_inspect.why_live_from_parents(port, snap, live[-1])
    assert got["parents"] == "derived"
    assert calls == [port.device] and port.device.type == "cpu"


def snapshot_sequence(seed, waves=8, n=12):
    """Per-wave snapshots of n actors: actor 0 is a planted leak (no
    traffic, its idle clock only grows); the others get traffic in a
    seeded half of the waves (their idle clock resets)."""
    rng = np.random.default_rng(seed)
    idle = np.zeros(n)
    out = []
    for wave in range(waves):
        touched = rng.random(n) < 0.5
        touched[0] = False
        idle = np.where(touched, 0.001, idle + 0.05)
        actors = {
            f"k{i}": {"name": f"/user/a{i}", "recv_count": 0, "busy": False,
                      "root": i == n - 1, "pseudoroot": i == n - 1,
                      "halted": False, "idle_s": float(idle[i]),
                      "mailbox": 0}
            for i in range(n - (wave == waves - 1))  # the last one collected
        }
        out.append({"actors": actors, "wave": wave,
                    "edges": [[f"k{n - 1}", f"k{i}", 1] for i in range(n - 1)]})
    return out


def test_flight_recorder_and_leak_watchdog_equal_the_reference():
    seq = snapshot_sequence(5)
    docs = {}
    for name, mod in (("ref", ref_inspect), ("port", port_inspect)):
        recorder = mod.FlightRecorder(keep=4)
        watchdog = mod.LeakWatchdog(waves=3, min_idle_s=0.1)
        flagged = []
        for snap in seq:
            recorder.record(snap)
            flagged.append(watchdog.observe(snap))
        docs[name] = (recorder.to_json(), recorder.diffs(), flagged,
                      watchdog.suspects())
    assert docs["port"] == docs["ref"]
    doc, diffs, flagged, suspects = docs["port"]
    assert "k0" in suspects  # the planted leak
    assert diffs[-1]["removed"] == ["k11"]
    assert doc["versions"] == len(seq)
    assert sum(len(f) for f in flagged) >= 1


# --------------------------------------------------------------------- #
# On the port's live system
# --------------------------------------------------------------------- #


class Give(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,) if self.ref is not None else ()


class Worker(AbstractBehavior):
    def on_message(self, msg):
        return self


class Keeper(AbstractBehavior):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.held = []

    def on_message(self, msg):
        if isinstance(msg, Give) and msg.ref is not None:
            self.held.append(msg.ref)
        return self


class ChainRoot(AbstractBehavior):
    """root -> keeper -> kept: after the hand-off the kept actor is
    retained only through the keeper."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.keeper = ctx.spawn(Behaviors.setup(Keeper), "keeper")
        self.kept = ctx.spawn(Behaviors.setup(Worker), "kept")

    def on_message(self, msg):
        if isinstance(msg, Give) and self.kept is not None:
            ctx = self.context
            self.keeper.tell(Give(ctx.create_ref(self.kept, self.keeper)), ctx)
            ctx.release(self.kept)
            self.kept = None
        return self


@pytest.mark.parametrize("capture", [False, True])
def test_live_why_live_on_the_device_backend(capture):
    kit = ActorTestKit({
        "uigc.crgc.wakeup-interval": 10, "uigc.crgc.device": "cpu",
        "uigc.crgc.shadow-graph": "device", "uigc.telemetry.inspect": True,
        "uigc.telemetry.why-live-capture": capture})
    try:
        root = kit.spawn(Behaviors.setup_root(ChainRoot), "root")
        root.tell(Give(None))
        insp = kit.system.telemetry.inspector
        deadline = time.monotonic() + 20.0
        result = {}
        while time.monotonic() < deadline:
            result = insp.why_live("kept")
            if result.get("verdict") == "live" and len(result["path"]) >= 2:
                break
            time.sleep(0.05)
        assert result.get("verdict") == "live" and len(result["path"]) >= 2
        assert any("keeper" in (hop["from_name"] or "")
                   for hop in result["path"]), result
        assert result["parents"] in ("captured", "derived")
        if not capture:
            assert result["parents"] == "derived"
        assert port_inspect.validate_why_live(insp.snapshot(), result) == []
    finally:
        kit.shutdown()
