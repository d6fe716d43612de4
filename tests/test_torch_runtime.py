"""The port's live actor runtime: the CRGC collector on every ported
shadow-graph backend, with the device backends tracing on the CPU
(``uigc.crgc.device: "cpu"``, the propagate kernel's plain version).

The shapes are the reference's own live tests (tests/test_backends.py,
test_random_churn.py, test_supervision.py, test_self_messaging.py and
the BASELINE config 1 and 3 workloads), driven through the port's API.
Every released actor must be collected, cycles included, and no actor
that is still held may be stopped.
"""

import os
import random
import sys
import threading
import time

import pytest
import torch

from uigc_tpu_torch import (AbstractBehavior, ActorSystem, ActorTestKit,
                            Behaviors, Message, NoRefs, PostStop)
from uigc_tpu_torch.engines.crgc import arrays
from uigc_tpu_torch.engines.crgc.state import CrgcContext
from uigc_tpu_torch.models import run_rings, run_tree
from uigc_tpu_torch.native import is_available as native_available

torch.set_num_threads(1)

CPU = {"uigc.crgc.device": "cpu", "uigc.crgc.wakeup-interval": 10}
NATIVE = pytest.param(
    "native",
    marks=pytest.mark.skipif(not native_available(), reason="no C++ toolchain"),
)


def kit_for(backend, **extra):
    return ActorTestKit(dict(CPU, **{"uigc.crgc.shadow-graph": backend},
                             **extra))


# --------------------------------------------------------------------- #
# Cycles, dead roots, pipelining (tests/test_backends.py shapes)
# --------------------------------------------------------------------- #


class Share(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


class Drop(NoRefs):
    pass


class Spawned(NoRefs):
    def __init__(self, name):
        self.name = name


class Stopped(NoRefs):
    def __init__(self, name):
        self.name = name

    def __eq__(self, other):
        return isinstance(other, Stopped) and other.name == self.name

    def __hash__(self):
        return hash(("Stopped", self.name))


class Node(AbstractBehavior):
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


class CycleRoot(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        ctx = context
        self.a = ctx.spawn(Behaviors.setup(lambda c: Node(c, probe)), "a")
        self.b = ctx.spawn(Behaviors.setup(lambda c: Node(c, probe)), "b")
        self.a.tell(Share(ctx.create_ref(self.b, self.a)), ctx)
        self.b.tell(Share(ctx.create_ref(self.a, self.b)), ctx)

    def on_message(self, msg):
        if isinstance(msg, Drop):
            self.context.release(self.a, self.b)
        return self


def collect_cycle(kit):
    probe = kit.create_test_probe(timeout_s=30.0)
    root = kit.spawn(Behaviors.setup_root(lambda ctx: CycleRoot(ctx, probe)),
                     "root")
    probe.expect_message_type(Spawned)
    probe.expect_message_type(Spawned)
    probe.expect_no_message(0.2)  # the cycle lives while the root holds it
    root.tell(Drop())
    probe.expect_message_type(Stopped)
    probe.expect_message_type(Stopped)


@pytest.mark.parametrize("backend",
                         ["oracle", "array", "device", "decremental", NATIVE])
def test_cycle_collection_all_backends(backend):
    kit = kit_for(backend)
    try:
        collect_cycle(kit)
    finally:
        kit.shutdown()


@pytest.mark.parametrize("mode", ["push", "pull", "jump"])
def test_cycle_collection_device_trace_modes(mode):
    kit = kit_for("device", **{"uigc.crgc.trace-mode": mode})
    try:
        collect_cycle(kit)
    finally:
        kit.shutdown()


def test_pipelined_decremental_collection():
    kit = kit_for("decremental", **{"uigc.crgc.pipelined": True})
    try:
        assert kit.system.engine.bookkeeper.shadow_graph.can_pipeline
        collect_cycle(kit)
    finally:
        kit.shutdown()


class LoneRoot(AbstractBehavior):
    """A root that spawns workers, never releases them, then stops."""

    def __init__(self, context, probe):
        super().__init__(context)
        self.kids = [
            context.spawn(Behaviors.setup(lambda c: Node(c, probe)), f"w{i}")
            for i in range(3)
        ]

    def on_message(self, msg):
        if isinstance(msg, Drop):
            return Behaviors.stopped()
        return self


@pytest.mark.parametrize("backend", ["array", "decremental"])
def test_dead_root_does_not_leak_referents(backend):
    kit = kit_for(backend)
    try:
        probe = kit.create_test_probe(timeout_s=10.0)
        root = kit.spawn(
            Behaviors.setup_root(lambda ctx: LoneRoot(ctx, probe)), "root")
        for _ in range(3):
            probe.expect_message_type(Spawned)
        root.tell(Drop())
        for _ in range(3):
            probe.expect_message_type(Stopped)
        graph = kit.system.engine.bookkeeper.shadow_graph
        deadline = time.monotonic() + 5.0
        while graph.num_in_use > 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert graph.num_in_use <= 1, (
            f"{graph.num_in_use} zombie shadows left after root death")
    finally:
        kit.shutdown()


def test_pipelined_stalled_wake_expires():
    """A wake whose result never lands expires (tracer invalidated,
    pipeline freed) instead of deadlocking collection."""
    graph = arrays.ArrayShadowGraph(
        CrgcContext(delta_graph_size=64, entry_field_size=4), "uigc://test",
        use_device=True, decremental=True, device="cpu",
    )

    class FakeDec:
        invalidated = False
        n = 16

        def invalidate(self):
            self.invalidated = True

    class NeverReady:
        def query(self):
            return False

    dec = FakeDec()
    handle = arrays._WakeHandle(dec, NeverReady())
    graph._pending_wake = (handle, None, None, None, time.monotonic() - 60)
    assert not graph.harvest_ready()
    assert not graph.expire_stalled_wake(max_age_s=120)  # too young
    assert graph.has_pending_wake
    assert graph.expire_stalled_wake(max_age_s=30)
    assert dec.invalidated and not graph.has_pending_wake


def test_cpu_wake_handle_is_always_ready():
    dec = type("D", (), {"n": 4, "invalidate": lambda self: None})()
    assert arrays._WakeHandle(dec, None).is_ready()


# --------------------------------------------------------------------- #
# No silent fallback, and what is not ported yet
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("backend", ["device", "decremental"])
def test_device_backends_raise_without_a_card(backend, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ActorSystem(None, name="nocard", config={
            "uigc.crgc.shadow-graph": backend})  # uigc.crgc.device: "cuda"
    deadline = time.monotonic() + 5.0
    while threading.active_count() > threads and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= threads  # nothing left running


@pytest.mark.parametrize("config", [
    {"uigc.telemetry.tracing": True},
    {"uigc.telemetry.device": True},
    {"uigc.telemetry.metrics": True},
    {"uigc.analysis.sanitizer": True},
], ids=lambda c: "=".join(map(str, next(iter(c.items())))))
def test_unported_parts_raise_not_implemented(config):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ActorSystem(None, name="unported", config=dict(CPU, **config))


def test_host_backends_ignore_the_device_key(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("oracle", "array"):
        system = ActorSystem(None, name="host", config={
            "uigc.crgc.shadow-graph": backend})
        system.terminate()


# --------------------------------------------------------------------- #
# Random churn (tests/test_random_churn.py's contract)
# --------------------------------------------------------------------- #

MAX_ACTORS = int(os.environ.get("UIGC_RANDOM_SPEC_ACTORS", "2000"))


class Link(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


class Ping(NoRefs):
    pass


class Latch:
    def __init__(self, count):
        self._count = count
        self._cond = threading.Condition()

    def count_down(self):
        with self._cond:
            self._count -= 1
            if self._count <= 0:
                self._cond.notify_all()

    def await_zero(self, timeout_s):
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._count > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._count
                self._cond.wait(remaining)
            return 0


class Shared:
    def __init__(self):
        self.spawn_counter = 0
        self.lock = threading.Lock()
        self.latch = Latch(MAX_ACTORS)
        self.rng = random.Random(20260729)

    def try_reserve_spawn(self):
        with self.lock:
            self.spawn_counter += 1
            return self.spawn_counter <= MAX_ACTORS

    def reached_max(self):
        with self.lock:
            return self.spawn_counter >= MAX_ACTORS

    def rand(self):
        with self.lock:
            return self.rng.random()

    def randint(self, n):
        with self.lock:
            return self.rng.randrange(n)


class RandomActor(AbstractBehavior):
    def __init__(self, context, shared, timers):
        super().__init__(context)
        self.shared = shared
        self.timers = timers
        self.acquaintances = []

    def on_message(self, msg):
        if isinstance(msg, (Link, Ping)):
            if isinstance(msg, Link):
                self.acquaintances.append(msg.ref)
            self.do_some_actions()
        return self

    def do_some_actions(self):
        if self.shared.reached_max():
            if self.timers is not None:
                # the root stops the churn and releases everything
                self.timers.cancel_all()
                if self.acquaintances:
                    self.context.release(self.acquaintances)
                    self.acquaintances = []
            return
        self.do_something()
        self.do_something()

    def do_something(self):
        ctx = self.context
        shared = self.shared
        p = shared.rand()
        acq = self.acquaintances
        if p < 0.2:
            if shared.try_reserve_spawn():
                acq.append(ctx.spawn_anonymous(random_actor_factory(shared)))
        elif p < 0.4 and acq:
            owner = acq[shared.randint(len(acq))]
            target = acq[shared.randint(len(acq))]
            owner.tell(Link(ctx.create_ref(target, owner)), ctx)
        elif p < 0.6 and acq:
            ctx.release(acq.pop(shared.randint(len(acq))))
        elif p < 0.8 and acq:
            acq[shared.randint(len(acq))].tell(Ping(), ctx)

    def on_signal(self, signal):
        if signal is PostStop and self.timers is None:  # the root is not counted
            self.shared.latch.count_down()
        return None


def random_actor_factory(shared):
    return Behaviors.setup(lambda ctx: RandomActor(ctx, shared, None))


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["decremental", "decremental-pipelined"])
def test_random_churn_fully_collected(pipelined):
    shared = Shared()
    kit = kit_for("decremental", **{"uigc.crgc.wakeup-interval": 20,
                                    "uigc.crgc.pipelined": pipelined})
    try:
        def make_root(timers):
            def setup(ctx):
                timers.start_timer_at_fixed_rate("ping", Ping(), 0.001)
                return RandomActor(ctx, shared, timers)

            return Behaviors.setup_root(setup)

        kit.spawn(Behaviors.with_timers(make_root), "root")
        remaining = shared.latch.await_zero(timeout_s=120.0)
        assert remaining == 0, (
            f"{remaining} of {MAX_ACTORS} actors were never collected")
        assert kit.system.dead_letters == 0  # no live actor was killed
    finally:
        kit.shutdown()


# --------------------------------------------------------------------- #
# Supervision and self-messaging (the reference's Specs)
# --------------------------------------------------------------------- #


class Init(NoRefs):
    pass


class Initialized(NoRefs):
    def __eq__(self, other):
        return isinstance(other, Initialized)

    def __hash__(self):
        return hash("Initialized")


class ReleaseParent(NoRefs):
    pass


class ReleaseChild(NoRefs):
    def __init__(self, i):
        self.i = i


class GetRef(Share):
    pass


class Child(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        probe.ref.tell(Spawned(context.name))

    def on_message(self, msg):
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe.ref.tell(Stopped(self.context.name))
        return None


class Parent(Child):
    def __init__(self, context, probe):
        super().__init__(context, probe)
        self.kids = [
            context.spawn(Behaviors.setup(lambda c: Child(c, probe)), f"child{i}")
            for i in (1, 2)
        ]

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, GetRef):
            for kid in self.kids:
                msg.ref.tell(GetRef(ctx.create_ref(kid, msg.ref)), ctx)
            ctx.release(*self.kids)
        return self


class SupervisionRoot(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        self.parent = None
        self.kids = []

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Init):
            self.parent = ctx.spawn(
                Behaviors.setup(lambda c: Parent(c, self.probe)), "parent")
            self.parent.tell(GetRef(ctx.create_ref(ctx.self, self.parent)), ctx)
        elif isinstance(msg, GetRef):
            self.kids.append(msg.ref)
            if len(self.kids) == 2:
                self.probe.ref.tell(Initialized())
        elif isinstance(msg, ReleaseParent):
            ctx.release(self.parent)
        elif isinstance(msg, ReleaseChild):
            ctx.release(self.kids[msg.i])
        return self


@pytest.mark.parametrize("backend", ["device", "decremental"])
def test_supervision_ordering(backend):
    """A parent is not collected before the children it supervises."""
    kit = kit_for(backend)
    try:
        probe = kit.create_test_probe(timeout_s=20.0)
        root = kit.spawn(
            Behaviors.setup_root(lambda ctx: SupervisionRoot(ctx, probe)),
            "root")
        root.tell(Init())
        parent = probe.expect_message_type(Spawned).name
        child1 = probe.expect_message_type(Spawned).name
        child2 = probe.expect_message_type(Spawned).name
        probe.expect_message(Initialized())
        root.tell(ReleaseParent())
        probe.expect_no_message(0.3)  # its children still hold it
        root.tell(ReleaseChild(0))
        probe.expect_message(Stopped(child1))
        root.tell(ReleaseChild(1))
        probe.expect_message(Stopped(child2))
        probe.expect_message(Stopped(parent))
    finally:
        kit.shutdown()


class Countdown(NoRefs):
    def __init__(self, n):
        self.n = n


class Counted(NoRefs):
    def __init__(self, n):
        self.n = n

    def __eq__(self, other):
        return isinstance(other, Counted) and other.n == self.n

    def __hash__(self):
        return hash(("Counted", self.n))


class SelfMessenger(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        self.count = 0

    def on_message(self, msg):
        if isinstance(msg, Countdown) and msg.n > 0:
            self.context.self.tell(Countdown(msg.n - 1), self.context)
            self.count += 1
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe.ref.tell(Counted(self.count))
        return None


class Starter(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.b = context.spawn(
            Behaviors.setup(lambda c: SelfMessenger(c, probe)), "b")

    def on_message(self, msg):
        if isinstance(msg, Countdown):
            self.b.tell(Countdown(msg.n), self.context)
            self.context.release(self.b)
        return self


@pytest.mark.parametrize("backend", ["device", "decremental"])
def test_no_premature_termination_with_self_messages(backend):
    """An actor held only by itself, with self-messages in flight, lives
    until its queue drains."""
    kit = kit_for(backend)
    try:
        probe = kit.create_test_probe(timeout_s=30.0)
        a = kit.spawn(Behaviors.setup_root(lambda ctx: Starter(ctx, probe)),
                      "a")
        a.tell(Countdown(3000))
        probe.expect_message(Counted(3000))
    finally:
        kit.shutdown()


# --------------------------------------------------------------------- #
# BASELINE configs 1 and 3 (models/workloads.py)
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("backend,pipelined", [
    ("device", False), ("decremental", False), ("decremental", True)])
def test_run_tree_collects_every_actor(backend, pipelined):
    r = run_tree(2000, fanout=8, timeout_s=60.0, hold_wakes=10, config=dict(
        CPU, **{"uigc.crgc.shadow-graph": backend,
                "uigc.crgc.pipelined": pipelined}))
    assert r["n_collected"] == 2000 and r["held_wakes"] >= 10
    assert r["capacity"] == 2048 and r["rebuilds"] >= 2  # grew past 1,024


def test_run_rings_collects_every_member():
    r = run_rings(20, 100, timeout_s=60.0, hold_wakes=10, config=dict(
        CPU, **{"uigc.crgc.shadow-graph": "decremental"}))
    assert r["n_collected"] == 2000 and r["held_wakes"] >= 10


# --------------------------------------------------------------------- #
# The packed entry plane's drain is a consistent cut
# --------------------------------------------------------------------- #


def _put(ring, plane, tag):
    v = ring.begin()
    v[:] = -1
    v[0] = plane.next_seq()
    v[1] = tag
    ring.commit()


def test_packed_drain_never_takes_a_row_without_its_predecessors():
    """A drain that reads one ring, then sees a row land there and a
    later row land on the next ring before reading it, must not return
    the later row alone: folded without the earlier one (which carries
    the actor's creation edge) it makes a referenced actor garbage."""
    from uigc_tpu_torch.engines.crgc.packed import PackedPlane, PackedRing

    class Hooked(PackedRing):
        __slots__ = ("after",)

        def drain(self, upto=None):
            out = super().drain(upto)
            if self.after is not None:
                after, self.after = self.after, None
                after()
            return out

    plane = PackedPlane(1)
    first = Hooked(plane.width, cut_lock=plane._cut_lock)
    second = PackedRing(plane.width, cut_lock=plane._cut_lock)
    first.after = None
    plane._rings = {1: first, 2: second}

    def commit_both():
        _put(first, plane, 10)  # the busy flush with the creation edge
        _put(second, plane, 11)  # then the same actor's idle flush

    first.after = commit_both
    rows = plane.drain()
    tags = set() if rows is None else set(rows[:, 1].tolist())
    assert 11 not in tags or 10 in tags
    rest = plane.drain()
    assert sorted(tags | set(rest[:, 1].tolist())) == [10, 11]


def test_packed_drain_keeps_causal_order_under_threads():
    """16 threads pass a token round-robin, each committing one row per
    token to its own ring while a drainer runs: a row must never be
    drained before the row that happened before it."""
    from uigc_tpu_torch.engines.crgc.packed import PackedPlane

    plane = PackedPlane(1)
    n_threads, n_tokens = 16, 3000
    turns = [threading.Event() for _ in range(n_threads)]
    done = threading.Event()

    def writer(i):
        k = i
        while k < n_tokens:
            if not turns[i].wait(10):
                return
            turns[i].clear()
            _put(plane.ring(), plane, k)
            k += n_threads
            turns[(i + 1) % n_threads].set()
        if i == (n_tokens - 1) % n_threads:
            done.set()

    seen = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        turns[0].set()
        d = 0
        while not done.is_set():
            rows = plane.drain()
            d += 1
            if rows is not None:
                for tag in rows[:, 1].tolist():
                    seen[tag] = d
        for t in threads:
            t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    rows = plane.drain()
    if rows is not None:
        for tag in rows[:, 1].tolist():
            seen[tag] = d + 1
    assert sorted(seen) == list(range(n_tokens))
    late = [k for k in range(1, n_tokens) if seen[k] < seen[k - 1]]
    assert not late, f"rows drained before their predecessors: {late[:5]}"
