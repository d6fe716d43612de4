"""Port parity and live runs of the mesh backends ("mesh",
"mesh-decremental"): the port's MeshShadowGraph against the JAX
package's, and live actor systems collecting on them.

The parity tests drive both graphs, each at 4 shards, with
``tests/test_torch_arrays.py``'s seeded mutation script: the JAX side on
4 of the repo conftest's virtual CPU devices (Pallas in interpret mode),
the port on 4 CPU shards (``uigc.crgc.device: "cpu"``, the kernel's
plain version).  After every wake the marks, the garbage and kill slot
sets and the freed slots must be equal, exactly, and the port's marks
must equal ``trace_marks_np``.  The live tests run the
shapes of ``tests/test_torch_runtime.py`` on the mesh backends, 4 shards
on the CPU.
"""

import threading
import time

import numpy as np
import pytest
import torch

from test_torch_arrays import Script, wake_and_compare
from uigc_tpu.engines.crgc import mesh as ref_mesh
from uigc_tpu.engines.crgc.state import CrgcContext as RefContext
from uigc_tpu_torch import ActorSystem, ActorTestKit
from uigc_tpu_torch.engines.crgc import mesh as port_mesh
from uigc_tpu_torch.engines.crgc.state import CrgcContext
from uigc_tpu_torch.models import run_rings, run_tree
from uigc_tpu_torch.ops import trace as trace_ops

torch.set_num_threads(1)
SHARDS = 4
CPU = {"uigc.crgc.device": "cpu", "uigc.crgc.wakeup-interval": 10,
       "uigc.crgc.mesh-devices": SHARDS}


def make_pair(backend, mode="auto"):
    kw = dict(n_devices=SHARDS, decremental=backend == "mesh-decremental",
              trace_mode=mode)
    ref = ref_mesh.MeshShadowGraph(
        RefContext(delta_graph_size=64, entry_field_size=4), "uigc://parity",
        **kw)
    port = port_mesh.MeshShadowGraph(
        CrgcContext(delta_graph_size=64, entry_field_size=4), "uigc://parity",
        device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("backend,mode", [
    ("mesh", "push"), ("mesh", "auto"), ("mesh-decremental", "auto"),
    ("mesh-decremental", "push")])
def test_mesh_backend_matches_reference(backend, mode, monkeypatch):
    ref, port = make_pair(backend, mode)
    assert port.mesh.size == ref.mesh.devices.size == SHARDS
    script = Script(10, [ref, port])
    script.intern(700)
    script.churn(1500)
    garbage = 0
    for w in range(4):
        if w:
            script.intern(600)  # the first churn wake crosses 1,024 slots
            script.churn(600)
        assert np.array_equal(port.compute_marks(), trace_ops.trace_marks_np(
            port.flags, port.recv_count, port.supervisor, port.edge_src,
            port.edge_dst, port.edge_weight)), f"wake {w} vs the oracle"
        garbage += wake_and_compare(ref, port, monkeypatch, f"wake {w}")
    assert port.capacity == ref.capacity == 2048
    assert garbage > 0
    assert port.rebuilds == ref.stats["rebuilds"] >= 2
    assert port.stats["anomalies"] == ref.stats["anomalies"] == 0


def test_mesh_pipelined_wake_equals_synchronous_trace(monkeypatch):
    """A launch_trace/harvest_trace pair on the port's mesh-decremental
    sweeps what the reference's synchronous trace sweeps, with the
    capacity growing between launch and harvest (the handle keeps the
    launch snapshot's length; the base harvest pads the grown tail)."""
    ref, port = make_pair("mesh-decremental")
    assert port.can_pipeline
    script = Script(11, [ref, port])
    script.intern(900)
    script.churn(2000)
    wake_and_compare(ref, port, monkeypatch, "warm-up")
    script.churn(800)
    port.launch_trace()
    assert port.has_pending_wake and port.harvest_ready()  # CPU: ready
    assert port._pending_wake[0].n == 1024
    script.intern(1024 - len(port.slot_of) + 100, folded=False)
    assert port.capacity == ref.capacity == 2048
    before = dict(port.slot_of)
    n_port = port.harvest_trace(should_kill=False)
    n_ref = ref.trace(should_kill=False)
    assert n_port == n_ref > 0
    freed = sorted(s for c, s in before.items() if c not in port.slot_of)
    assert freed == sorted(set(before.values()) - set(ref.slot_of.values()))
    assert np.array_equal(ref.flags, port.flags)
    script.churn(400)
    wake_and_compare(ref, port, monkeypatch, "after harvest")


def test_failed_wake_invalidates_the_previous_state(monkeypatch):
    """A wake that raises part way leaves no half-committed state: the
    next wake re-derives from zero state and agrees with the reference."""
    ref, port = make_pair("mesh-decremental")
    script = Script(12, [ref, port])
    script.intern(500)
    script.churn(1000)
    wake_and_compare(ref, port, monkeypatch, "wake 0")
    script.churn(300)
    port._pending_del_dst.add(3)

    def boom(*a, **k):
        raise RuntimeError("wake failed")

    monkeypatch.setattr(port_mesh.sharded_trace, "make_sharded_decremental_wake",
                        lambda *a, **k: boom)
    with pytest.raises(RuntimeError, match="wake failed"):
        port.compute_marks()
    monkeypatch.undo()
    assert port._wake_state is None and not port._pending_del_dst
    wake_and_compare(ref, port, monkeypatch, "after the failed wake")


# --------------------------------------------------------------------- #
# Live systems on the mesh backends
# --------------------------------------------------------------------- #


def kit_for(backend, **extra):
    return ActorTestKit(dict(CPU, **{"uigc.crgc.shadow-graph": backend},
                             **extra))


@pytest.mark.parametrize("backend,pipelined", [
    ("mesh", False), ("mesh-decremental", False), ("mesh-decremental", True)])
def test_cycle_collection_on_the_mesh(backend, pipelined):
    from test_torch_runtime import collect_cycle

    kit = kit_for(backend, **{"uigc.crgc.pipelined": pipelined})
    try:
        graph = kit.system.engine.bookkeeper.shadow_graph
        assert isinstance(graph, port_mesh.MeshShadowGraph)
        assert graph.mesh.size == SHARDS
        assert graph.can_pipeline == (backend == "mesh-decremental")
        collect_cycle(kit)
    finally:
        kit.shutdown()


@pytest.mark.parametrize("backend,pipelined", [
    ("mesh", False), ("mesh-decremental", True)])
def test_run_tree_on_the_mesh(backend, pipelined):
    r = run_tree(2000, fanout=8, timeout_s=60.0, hold_wakes=10, config=dict(
        CPU, **{"uigc.crgc.shadow-graph": backend,
                "uigc.crgc.pipelined": pipelined}))
    assert r["n_collected"] == 2000 and r["held_wakes"] >= 10
    assert r["capacity"] == 2048 and r["rebuilds"] >= 2  # grew past 1,024


def test_run_rings_on_the_mesh():
    r = run_rings(20, 100, timeout_s=60.0, hold_wakes=10, config=dict(
        CPU, **{"uigc.crgc.shadow-graph": "mesh-decremental"}))
    assert r["n_collected"] == 2000 and r["held_wakes"] >= 10


def test_two_mesh_systems_collect_side_by_side():
    """Two systems' collectors wake on their meshes at the same time (the
    reference serializes its mesh wakes process-wide, because two XLA
    collectives interleaved on one device set can deadlock; the port's
    wakes have no rendezvous and take no lock).  Both collect all."""
    results, errors = {}, []

    def run(backend, pipelined):
        try:
            results[backend] = run_tree(2000, fanout=8, timeout_s=60.0,
                                        hold_wakes=10, config=dict(CPU, **{
                                            "uigc.crgc.shadow-graph": backend,
                                            "uigc.crgc.pipelined": pipelined}))
        except Exception as exc:  # surfaced below, on the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=a)
               for a in (("mesh", False), ("mesh-decremental", True))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not errors, errors
    for r in results.values():
        assert r["n_collected"] == 2000 and r["held_wakes"] >= 10
    assert len(results) == 2


def test_mesh_devices_zero_is_one_shard_on_the_cpu():
    system = ActorSystem(None, name="one-shard", config=dict(
        CPU, **{"uigc.crgc.shadow-graph": "mesh",
                "uigc.crgc.mesh-devices": 0}))
    try:
        assert system.engine.bookkeeper.shadow_graph.mesh.size == 1
    finally:
        system.terminate()


def _no_threads_left(threads):
    deadline = time.monotonic() + 5.0
    while threading.active_count() > threads and time.monotonic() < deadline:
        time.sleep(0.01)
    return threading.active_count() <= threads


@pytest.mark.parametrize("backend", ["mesh", "mesh-decremental"])
def test_mesh_raises_without_a_card(backend, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ActorSystem(None, name="nocard", config={
            "uigc.crgc.shadow-graph": backend})  # uigc.crgc.device: "cuda"
    assert _no_threads_left(threads)


@pytest.mark.parametrize("backend", ["mesh", "mesh-decremental"])
def test_mesh_larger_than_the_visible_cards_raises(backend, monkeypatch):
    """Two cards visible, four asked for: the backend refuses before it
    touches a card (the reference asserts the same)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    threads = threading.active_count()
    with pytest.raises(ValueError, match="2 are visible"):
        ActorSystem(None, name="toomany", config={
            "uigc.crgc.shadow-graph": backend,
            "uigc.crgc.mesh-devices": 4})
    assert _no_threads_left(threads)
