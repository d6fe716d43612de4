"""Multi-node CRGC on the port: the counterpart of ``tests/test_multinode.py``
over the port's in-process ``Fabric``.

- Remote spawn and cross-node release, a three-node crash with the
  undo-log recovery (with and without drops on the dead link) and the
  double-crash quorum recheck, on the port's backends (``oracle``,
  ``device`` and ``mesh`` on the CPU, the native graph), over direct and
  wire links.  On ``device`` and ``mesh`` each node's collector folds
  its peers' delta graphs and undo logs into its replica on the array
  path (``merge_delta``, ``merge_undo_log``) and traces it.
- One seeded two-node workload on the reference (``array``) and on the
  port (``device``): the same actors stop, and each node's final replica
  marks equal ``trace_marks_np``.
- BASELINE config 4 (``run_cluster_recovery``) at 2,000 workers collects
  every worker on the port, none before the crash.  The reference's
  in-process fabric fails at that size (``tests/test_torch_fabric.py``
  shows why).
"""

import threading
import time

import numpy as np
import pytest
import torch

import uigc_tpu
import uigc_tpu.runtime.fabric as ref_fabric
import uigc_tpu.runtime.remote as ref_remote
import uigc_tpu.runtime.system as ref_system
import uigc_tpu_torch
import uigc_tpu_torch.runtime.fabric as port_fabric
import uigc_tpu_torch.runtime.remote as port_remote
import uigc_tpu_torch.runtime.system as port_system
from uigc_tpu_torch import AbstractBehavior, Behaviors, Message, NoRefs, PostStop
from uigc_tpu_torch.models import run_cluster_recovery
from uigc_tpu_torch.native import is_available as native_available
from uigc_tpu_torch.ops.trace import trace_marks_np
from uigc_tpu_torch.runtime.fabric import Fabric
from uigc_tpu_torch.runtime.remote import RemoteSpawner
from uigc_tpu_torch.runtime.system import ActorSystem
from uigc_tpu_torch.runtime.testkit import TestProbe as Probe

torch.set_num_threads(1)

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.device": "cpu",
    "uigc.crgc.mesh-devices": 2,
}
BACKENDS = ["oracle", "device", "mesh", pytest.param(
    "native", marks=pytest.mark.skipif(not native_available(),
                                       reason="no C++ toolchain"))]
WIRE_MODES = ["direct", "wire"]


def make_fabric(wire_mode):
    return Fabric(serialize=wire_mode == "wire",
                  async_links=wire_mode == "wire")


def make_system(name, fabric, num_nodes, backend):
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = num_nodes
    config["uigc.crgc.shadow-graph"] = backend
    return ActorSystem(None, name=name, config=config, fabric=fabric)


class Ping(NoRefs):
    pass


class Drop(NoRefs):
    pass


class Share(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,) if self.ref is not None else ()


class Spawned(NoRefs):
    def __init__(self, name):
        self.name = name


class Stopped(NoRefs):
    def __init__(self, name):
        self.name = name


class Worker(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        self.peer = None
        probe.ref.tell(Spawned(context.name))

    def on_message(self, msg):
        if isinstance(msg, Share):
            self.peer = msg.ref
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe.ref.tell(Stopped(self.context.name))
        return None


def worker_factory(probe):
    return Behaviors.setup(lambda ctx: Worker(ctx, probe))


class Root(AbstractBehavior):
    """Root on node A; spawns a worker remotely on node B."""

    def __init__(self, context, probe, spawner_cell):
        super().__init__(context)
        self.spawner_cell = spawner_cell
        self.remote_worker = None

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Spawned):  # the "go" trigger
            self.remote_worker = ctx.spawn_remote("worker", self.spawner_cell)
            for _ in range(5):
                self.remote_worker.tell(Ping(), ctx)
        elif isinstance(msg, Drop):
            ctx.release(self.remote_worker)
        return self


@pytest.mark.parametrize("wire_mode", WIRE_MODES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_two_node_remote_spawn_and_collect(backend, wire_mode):
    fabric = make_fabric(wire_mode)
    sys_a = make_system("pnodeA", fabric, 2, backend)
    sys_b = make_system("pnodeB", fabric, 2, backend)
    try:
        probe = Probe(default_timeout_s=15.0)
        spawner = RemoteSpawner.spawn_service(
            sys_b, {"worker": worker_factory(probe)})
        root = sys_a.spawn_root(
            Behaviors.setup_root(lambda ctx: Root(ctx, probe, spawner)), "root")
        root.tell(Spawned("go"))
        spawned = probe.expect_message_type(Spawned)
        assert "pnodeB" not in spawned.name  # the path is on B's hierarchy
        time.sleep(0.3)
        root.tell(Drop())
        stopped = probe.expect_message_type(Stopped)
        assert stopped.name == spawned.name
    finally:
        sys_a.terminate()
        sys_b.terminate()


class Holder(AbstractBehavior):
    """Root on a doomed node, holding a ref to a remote worker."""

    def __init__(self, context):
        super().__init__(context)
        self.held = None

    def on_message(self, msg):
        if isinstance(msg, Share):
            self.held = msg.ref
            self.held.tell(Ping(), self.context)
        return self


class Owner(AbstractBehavior):
    """Root on node B owning the worker; hands a ref to the doomed node's
    holder, then releases its own."""

    def __init__(self, context, probe, holder_refs):
        super().__init__(context)
        self.worker = context.spawn(worker_factory(probe), "worker")
        self.holder_refs = holder_refs

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Share):
            for holder in self.holder_refs:
                holder.tell(Share(ctx.create_ref(self.worker, holder)), ctx)
        elif isinstance(msg, Drop):
            ctx.release(self.worker)
        return self


def crash_cluster(prefix, backend, wire_mode):
    fabric = make_fabric(wire_mode)
    systems = [make_system(f"{prefix}{n}", fabric, 3, backend) for n in "ABC"]
    probe = Probe(default_timeout_s=20.0)
    sys_a, sys_b, sys_c = systems
    holder = sys_c.spawn_root(
        Behaviors.setup_root(lambda ctx: Holder(ctx)), "holder")
    owner = sys_b.spawn_root(Behaviors.setup_root(
        lambda ctx: Owner(ctx, probe, [ctx.engine.to_root_refob(holder.cell)])),
        "owner")
    probe.expect_message_type(Spawned)
    return fabric, systems, probe, owner


@pytest.mark.parametrize("wire_mode", WIRE_MODES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("with_drops", [False, True], ids=["clean", "drops"])
def test_three_node_crash_recovery(with_drops, backend, wire_mode):
    """A worker on B is kept alive only by a ref held on C.  C crashes;
    the undo-log quorum reverts C's claims and the worker is collected,
    with every ping on the dead link dropped or not."""
    fabric, systems, probe, owner = crash_cluster("pc", backend, wire_mode)
    sys_a, sys_b, sys_c = systems
    try:
        if with_drops:
            fabric.set_drop_filter(
                sys_c, sys_b,
                lambda m: isinstance(getattr(m, "payload", None), Ping))
        owner.tell(Share(None))
        time.sleep(0.4)
        owner.tell(Drop())
        probe.expect_no_message(0.5)
        fabric.crash(sys_c)
        stopped = probe.expect_message_type(Stopped)
        assert stopped.name.endswith("/worker")
    finally:
        for s in systems:
            s.terminate()


@pytest.mark.parametrize("wire_mode", WIRE_MODES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_double_crash_quorum_recheck(backend, wire_mode):
    """A second node dies before delivering its final ingress entry for
    the first: the shrunken quorum is re-evaluated on the membership
    change, and the first node's undo log still folds."""
    fabric, systems, probe, owner = crash_cluster("pd", backend, wire_mode)
    sys_a, sys_b, sys_c = systems
    try:
        owner.tell(Share(None))
        time.sleep(0.4)
        owner.tell(Drop())
        probe.expect_no_message(0.3)
        fabric.crash(sys_c)
        fabric.crash(sys_a)
        stopped = probe.expect_message_type(Stopped)
        assert stopped.name.endswith("/worker")
    finally:
        for s in systems:
            s.terminate()


# --------------------------------------------------------------------- #
# Parity with the reference on one seeded workload
# --------------------------------------------------------------------- #


SIDES = {
    "ref": (uigc_tpu, ref_fabric, ref_system, ref_remote, "array"),
    "port": (uigc_tpu_torch, port_fabric, port_system, port_remote,
             "device"),
}


class RefLink(uigc_tpu.Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


class PortLink(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


LINKS = {"ref": RefLink, "port": PortLink}


def seeded_plan(seed, n_workers=24, n_links=30):
    """Which workers live on node B (the rest on A), the links (worker a
    gets a ref to worker b), which workers the root releases, and the
    garbage that leaves: the released workers no kept worker reaches."""
    rng = np.random.default_rng(seed)
    on_b = (rng.random(n_workers) < 0.5).tolist()
    links = rng.integers(0, n_workers, (n_links, 2)).tolist()
    released = (rng.random(n_workers) < 0.6).tolist()
    live = {i for i in range(n_workers) if not released[i]}
    frontier = list(live)
    while frontier:
        a = frontier.pop()
        for x, b in links:
            if x == a and b not in live:
                live.add(b)
                frontier.append(b)
    return on_b, links, released, set(range(n_workers)) - live


def parity_run(side, seed):
    """Two nodes in wire mode: a root on A spawns the seeded workers (on A
    or, through B's spawner, on B), links them, releases some; returns
    the names that stopped and each node's replica after the release."""
    pkg, fabric_mod, system_mod, remote_mod, backend = SIDES[side]
    on_b, links, released, garbage = seeded_plan(seed)
    stopped, lock = set(), threading.Lock()
    ready = threading.Event()
    Link = LINKS[side]

    class Go(pkg.NoRefs):
        pass

    class Release(pkg.NoRefs):
        pass

    class W(pkg.AbstractBehavior):
        def __init__(self, context, index):
            super().__init__(context)
            self.index = index
            self.held = []

        def on_message(self, msg):
            if isinstance(msg, Link):
                self.held.append(msg.ref)
            return self

        def on_signal(self, signal):
            if signal is pkg.PostStop:
                with lock:
                    stopped.add(self.index)
            return None

    class Root(pkg.AbstractBehavior):
        def __init__(self, context, spawner):
            super().__init__(context)
            self.spawner = spawner
            self.workers = []

        def on_message(self, msg):
            ctx = self.context
            if isinstance(msg, Go):
                for i, remote in enumerate(on_b):
                    if remote:
                        self.workers.append(
                            ctx.spawn_remote(f"w{i}", self.spawner))
                    else:
                        self.workers.append(ctx.spawn(pkg.Behaviors.setup(
                            lambda c, i=i: W(c, i)), f"w{i}"))
                for a, b in links:
                    self.workers[a].tell(
                        Link(ctx.create_ref(self.workers[b], self.workers[a])),
                        ctx)
                ready.set()
            elif isinstance(msg, Release):
                ctx.release(*[w for w, r in zip(self.workers, released) if r])
            return self

    config = {"uigc.crgc.wakeup-interval": 10,
              "uigc.crgc.egress-finalize-interval": 5,
              "uigc.crgc.num-nodes": 2, "uigc.crgc.shadow-graph": backend,
              "uigc.crgc.device": "cpu"}
    if side == "ref":
        config.pop("uigc.crgc.device")
    fabric = fabric_mod.Fabric()
    systems = [system_mod.ActorSystem(None, name=f"par{side}{n}",
                                      config=config, fabric=fabric)
               for n in "AB"]
    try:
        spawner = remote_mod.RemoteSpawner.spawn_service(systems[1], {
            f"w{i}": pkg.Behaviors.setup(lambda c, i=i: W(c, i))
            for i in range(len(on_b))})
        root = systems[0].spawn_root(pkg.Behaviors.setup_root(
            lambda ctx: Root(ctx, spawner)), "root")
        root.tell(Go())
        assert ready.wait(20)
        time.sleep(0.5)
        assert not stopped  # the root holds every worker
        root.tell(Release())
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with lock:
                if len(stopped) >= len(garbage):
                    break
            time.sleep(0.05)
        time.sleep(0.5)  # nothing else may stop
        with lock:
            verdicts = set(stopped)
    finally:
        for s in systems:
            s.terminate()
    replicas = []
    for s in systems:
        graph = s.engine.bookkeeper.shadow_graph
        marks = graph.compute_marks()
        want = trace_marks_np(graph.flags, graph.recv_count, graph.supervisor,
                              graph.edge_src, graph.edge_dst,
                              graph.edge_weight)
        replicas.append((marks, want))
    return verdicts, garbage, replicas


@pytest.mark.parametrize("seed", [3, 11])
def test_two_node_verdicts_equal_the_reference(seed):
    ref_stopped, garbage, _ = parity_run("ref", seed)
    port_stopped, _, replicas = parity_run("port", seed)
    assert garbage  # the seeded release leaves garbage on both nodes
    assert port_stopped == ref_stopped == garbage
    for marks, want in replicas:
        assert np.array_equal(marks, want)


# --------------------------------------------------------------------- #
# BASELINE config 4 at 2,000 workers
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("wire_mode", WIRE_MODES)
def test_cluster_recovery_collects_every_worker(wire_mode):
    out = run_cluster_recovery(
        2000, drop_pings=True, timeout_s=120.0, hold_wakes=3,
        config={"uigc.crgc.shadow-graph": "device", "uigc.crgc.device": "cpu"},
        fabric_kwargs={"serialize": wire_mode == "wire",
                       "async_links": wire_mode == "wire"})
    assert out["n_collected"] == 2000
    assert out["held_wakes"] >= 3
    assert all(out["roots_alive"].values())
    assert out["wakes"]["benchA"] > 0 and out["wakes"]["benchB"] > 0


# --------------------------------------------------------------------- #
# The pipelined collector's idle wakes
# --------------------------------------------------------------------- #


def test_pipelined_idle_wakes_launch_no_device_wake(monkeypatch):
    """A pipelined collector launches a device wake only when something
    folded since its last launch (the reference launches on every tick,
    which starved the crash-recovery quorum on a fabric): once the
    system is quiet, twenty wakes launch nothing."""
    from uigc_tpu_torch.engines.crgc.arrays import ArrayShadowGraph

    launched = []
    plain = ArrayShadowGraph.launch_trace

    def counting(graph):
        launched.append(graph)
        return plain(graph)

    monkeypatch.setattr(ArrayShadowGraph, "launch_trace", counting)
    system = ActorSystem(None, name="idle", config={
        "uigc.crgc.shadow-graph": "decremental", "uigc.crgc.pipelined": True,
        "uigc.crgc.device": "cpu", "uigc.crgc.wakeup-interval": 10})
    try:
        probe = Probe(default_timeout_s=15.0)
        owner = system.spawn_root(Behaviors.setup_root(
            lambda ctx: Owner(ctx, probe, [])), "owner")
        probe.expect_message_type(Spawned)
        owner.tell(Drop())
        probe.expect_message_type(Stopped)
        assert launched  # the release was traced on the device path
        bk = system.engine.bookkeeper
        time.sleep(0.3)  # the stop's death flush folds and is traced
        n0, w0 = len(launched), bk.wakes
        deadline = time.monotonic() + 10
        while bk.wakes < w0 + 20 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert bk.wakes >= w0 + 20
        assert len(launched) == n0
    finally:
        system.terminate()
