"""Copy of ``uigc_tpu/models/workloads.py`` (pure Python): ``run_tree``,
``run_rings`` and ``run_cluster_recovery``.  Two
additions: ``hold_wakes`` holds the built topology for that many collector
wakes before the release and fails if any actor stopped in that window
(an unsound verdict kills live actors), and the result carries the
collector's counts (``_collector_stats``).  A collector wake is a CRGC
Bookkeeper wake or, for MAC with cycle detection, a detector scan; an
engine with no collector is held for that many wakeup intervals on the
host clock.  ``probe(system, stage)``, when given, is called while the
topology is held (stage ``"held"``, after the hold and before the
release) and once every actor is collected (``"collected"``, before the
system terminates); what it returns is the result's ``probe[stage]``.
``run_cluster_recovery`` holds node B's collector that way before the
crash and, held or not, fails if any worker stopped before it (the refs
on node C keep every worker alive); it takes ``fabric_kwargs`` for the
``Fabric`` (direct or wire links) and returns each node's collector
wakes and whether the survivors' roots (user guardian and root actors of
nodes A and B) still run once the workers are collected.

Live-runtime benchmark workloads (BASELINE configs 1-4).

Each function drives the real actor runtime end to end — spawn a
topology, release the roots' references, and time how long the selected
GC engine takes to detect and stop every garbage actor — and returns
``{"n_collected", "build_s", "collect_s"}``.  These are the in-repo
analogues of the workload shapes the reference is exercised with
(RandomSpec's 10k-actor churn, reference:
src/test/scala/edu/illinois/osl/uigc/RandomSpec.scala:14-125; MAC's
acyclic WRC collection; cyclic rings; and the 3-node crash-recovery path
of BASELINE config 4).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..interfaces import Message, NoRefs
from ..runtime.behaviors import AbstractBehavior, Behaviors
from ..runtime.signals import PostStop
from ..runtime.system import ActorSystem


class _Latch:
    def __init__(self, count: int):
        self._count = count
        self._cond = threading.Condition()

    def count_down(self) -> None:
        with self._cond:
            self._count -= 1
            if self._count <= 0:
                self._cond.notify_all()

    def await_zero(self, timeout_s: float) -> int:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._count > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return self._count
                self._cond.wait(remaining)
            return 0

    @property
    def count(self) -> int:
        with self._cond:
            return self._count


def _wake_counter(system: ActorSystem) -> Optional[Callable[[], int]]:
    """The engine's collector wakes so far, as a function: the CRGC
    Bookkeeper's wakes or the MAC cycle detector's scans; None for an
    engine with no collector."""
    bk = getattr(system.engine, "bookkeeper", None)
    if bk is not None:
        return lambda: bk.wakes
    detector = getattr(system.engine, "detector", None)
    if detector is not None:
        return lambda: detector.scans
    return None


def _hold(system: ActorSystem, latch: _Latch, n_actors: int, wakes: int,
          timeout_s: float) -> int:
    """Let the collector wake ``wakes`` times over the built topology
    (without a collector: wait ``wakes`` wakeup intervals), then check
    that no actor stopped meanwhile.  Returns the wakes held."""
    if wakes <= 0:
        return 0
    count = _wake_counter(system)
    if count is None:
        engine = system.config.get_string("uigc.engine")
        interval_ms = system.config.get(f"uigc.{engine}.wakeup-interval", 50)
        time.sleep(wakes * interval_ms / 1000.0)
        held = wakes
    else:
        w0 = count()
        deadline = time.monotonic() + timeout_s
        while count() - w0 < wakes:
            if time.monotonic() > deadline:
                raise RuntimeError(f"the collector woke {count() - w0} times "
                                   f"in {timeout_s} s, not {wakes}")
            time.sleep(0.005)
        held = count() - w0
    stopped = n_actors - latch.count
    if stopped:
        raise RuntimeError(f"{stopped} live actors stopped while held")
    return held


def _collector_stats(system: ActorSystem) -> Dict[str, Any]:
    """The CRGC collector's wakes and, for the array backends, the shadow
    graph's full layout rebuilds and capacity; the MAC cycle detector's
    scans and cycles collected (empty for other engines)."""
    detector = getattr(system.engine, "detector", None)
    if detector is not None:
        return {"scans": detector.scans,
                "total_cycles_collected": detector.total_cycles_collected}
    bk = getattr(system.engine, "bookkeeper", None)
    if bk is None:
        return {}
    graph = bk.shadow_graph
    return {
        "wakes": bk.wakes,
        "rebuilds": getattr(graph, "rebuilds", None),
        "capacity": getattr(graph, "capacity", None),
    }


class _Release(NoRefs):
    pass


class _Ping(NoRefs):
    pass


class _Share(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


def _tree_node(latch: _Latch, size: int, fanout: int):
    """An actor that spawns a subtree of ``size`` actors (itself included)
    and holds refs to its children until stopped."""

    class TreeNode(AbstractBehavior):
        def __init__(self, context):
            super().__init__(context)
            self.children = []
            remaining = size - 1
            k = min(fanout, remaining)
            for i in range(k):
                share = remaining // k + (1 if i < remaining % k else 0)
                if share > 0:
                    self.children.append(
                        context.spawn(_tree_node(latch, share, fanout), f"c{i}")
                    )

        def on_message(self, msg):
            return self

        def on_signal(self, signal):
            if signal is PostStop:
                latch.count_down()
            return None

    return Behaviors.setup(TreeNode)


def run_tree(
    n_actors: int = 10_000,
    fanout: int = 8,
    engine: str = "crgc",
    config: Optional[Dict[str, Any]] = None,
    timeout_s: float = 300.0,
    hold_wakes: int = 0,
    probe: Optional[Callable[[ActorSystem, str], Any]] = None,
) -> Dict[str, Any]:
    """Configs 1-2: an acyclic ownership tree of ``n_actors`` is released
    by the root and must be fully collected.

    The root spawns the top level directly, so ``fanout >= n_actors``
    yields a flat topology — the shape a weighted-refcount engine (MAC)
    can collect, since WRC cannot reclaim interior nodes that still hold
    refs to children (the reference's MAC has the same reach,
    reference: mac/MAC.scala:237-246 requires children.isEmpty)."""
    latch = _Latch(n_actors)

    class Root(AbstractBehavior):
        def __init__(self, context):
            super().__init__(context)
            self.tops = []
            remaining = n_actors
            k = min(fanout, remaining)
            for i in range(k):
                share = remaining // k + (1 if i < remaining % k else 0)
                if share > 0:
                    self.tops.append(
                        context.spawn(_tree_node(latch, share, fanout), f"t{i}")
                    )

        def on_message(self, msg):
            if isinstance(msg, _Release):
                self.context.release(*self.tops)
                self.tops = []
            return self

    cfg = {"uigc.engine": engine, f"uigc.{engine}.wakeup-interval": 10}
    cfg.update(config or {})
    system = ActorSystem(None, name="bench-tree", config=cfg)
    try:
        t0 = time.perf_counter()
        root = system.spawn_root(Behaviors.setup_root(Root), "root")
        build_s = time.perf_counter() - t0

        held = _hold(system, latch, n_actors, hold_wakes, timeout_s)
        probed = {"held": probe(system, "held")} if probe else {}

        t0 = time.perf_counter()
        root.tell(_Release())
        left = latch.await_zero(timeout_s)
        collect_s = time.perf_counter() - t0
        assert left == 0, f"{left} actors never collected"
        if probe:
            probed["collected"] = probe(system, "collected")
        return {"n_collected": n_actors, "build_s": build_s,
                "collect_s": collect_s, "held_wakes": held,
                **_collector_stats(system), "probe": probed}
    finally:
        system.terminate()


def run_rings(
    n_rings: int = 100,
    ring_size: int = 100,
    config: Optional[Dict[str, Any]] = None,
    timeout_s: float = 300.0,
    hold_wakes: int = 0,
    probe: Optional[Callable[[ActorSystem, str], Any]] = None,
) -> Dict[str, Any]:
    """Config 3: mutually-referencing actor rings — cyclic garbage that a
    trace-based engine must collect after the root releases the heads."""
    n_actors = n_rings * ring_size
    latch = _Latch(n_actors)

    class Member(AbstractBehavior):
        def __init__(self, context):
            super().__init__(context)
            self.next_ref = None

        def on_message(self, msg):
            if isinstance(msg, _Share):
                self.next_ref = msg.ref
            return self

        def on_signal(self, signal):
            if signal is PostStop:
                latch.count_down()
            return None

    class Root(AbstractBehavior):
        def __init__(self, context):
            super().__init__(context)
            self.members = []
            for r in range(n_rings):
                ring = [
                    context.spawn(Behaviors.setup(Member), f"r{r}m{i}")
                    for i in range(ring_size)
                ]
                for i, member in enumerate(ring):
                    nxt = ring[(i + 1) % ring_size]
                    member.tell(_Share(context.create_ref(nxt, member)), context)
                self.members.extend(ring)

        def on_message(self, msg):
            if isinstance(msg, _Release):
                self.context.release(*self.members)
                self.members = []
            return self

    cfg = {"uigc.engine": "crgc", "uigc.crgc.wakeup-interval": 10}
    cfg.update(config or {})
    system = ActorSystem(None, name="bench-rings", config=cfg)
    try:
        t0 = time.perf_counter()
        root = system.spawn_root(Behaviors.setup_root(Root), "root")
        build_s = time.perf_counter() - t0

        held = _hold(system, latch, n_actors, hold_wakes, timeout_s)
        probed = {"held": probe(system, "held")} if probe else {}

        t0 = time.perf_counter()
        root.tell(_Release())
        left = latch.await_zero(timeout_s)
        collect_s = time.perf_counter() - t0
        assert left == 0, f"{left} ring members never collected"
        if probe:
            probed["collected"] = probe(system, "collected")
        return {"n_collected": n_actors, "build_s": build_s,
                "collect_s": collect_s, "held_wakes": held,
                **_collector_stats(system), "probe": probed}
    finally:
        system.terminate()


def _roots_alive(system: ActorSystem) -> bool:
    """Whether the system's user guardian and every root under it still
    run."""
    guardian = system._user_guardian
    cells = [guardian, *list(guardian.children.values())]
    return not any(c.is_terminated for c in cells)


def run_cluster_recovery(
    n_workers: int = 200,
    drop_pings: bool = True,
    config: Optional[Dict[str, Any]] = None,
    timeout_s: float = 300.0,
    hold_wakes: int = 0,
    fabric_kwargs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Config 4: 3-node cluster; workers on node B are pinned solely by
    refs held on node C; C crashes (with message drops injected on the
    C->B link) and the survivors must reach the undo-log quorum, fold it,
    and collect the workers."""
    from ..runtime.fabric import Fabric

    latch = _Latch(n_workers)
    shared_done = threading.Event()

    class Worker(AbstractBehavior):
        def on_message(self, msg):
            return self

        def on_signal(self, signal):
            if signal is PostStop:
                latch.count_down()
            return None

    class Holder(AbstractBehavior):
        """Root on doomed node C, holding the refs that pin B's workers."""

        def __init__(self, context):
            super().__init__(context)
            self.held = []

        def on_message(self, msg):
            if isinstance(msg, _Share):
                self.held.append(msg.ref)
                # Keep traffic flowing across the doomed link so dropped
                # messages skew the admitted counts.
                msg.ref.tell(_Ping(), self.context)
                if len(self.held) == n_workers:
                    shared_done.set()
            return self

    class Owner(AbstractBehavior):
        """Root on node B owning the workers; hands refs to C's holder,
        then releases its own."""

        def __init__(self, context, holder_refs):
            super().__init__(context)
            self.workers = [
                context.spawn(Behaviors.setup(Worker), f"w{i}")
                for i in range(n_workers)
            ]
            self.holder_refs = holder_refs

        def on_message(self, msg):
            ctx = self.context
            if isinstance(msg, _Share):
                holder = self.holder_refs[0]
                for w in self.workers:
                    holder.tell(_Share(ctx.create_ref(w, holder)), ctx)
            elif isinstance(msg, _Release):
                ctx.release(*self.workers)
                self.workers = []
            return self

    cfg = {
        "uigc.engine": "crgc",
        "uigc.crgc.num-nodes": 3,
        "uigc.crgc.wakeup-interval": 10,
        "uigc.crgc.egress-finalize-interval": 5,
    }
    cfg.update(config or {})
    fabric = Fabric(**(fabric_kwargs or {}))
    sys_a = ActorSystem(None, name="benchA", config=cfg, fabric=fabric)
    sys_b = ActorSystem(None, name="benchB", config=cfg, fabric=fabric)
    sys_c = ActorSystem(None, name="benchC", config=cfg, fabric=fabric)
    systems = (sys_a, sys_b, sys_c)
    try:
        t0 = time.perf_counter()
        if drop_pings:
            # Install before any traffic so ping drops skew the admitted
            # counts on the doomed link — the undo-log path under test
            # must reconcile C's claimed sends against what B actually
            # admitted (ref-carrying shares travel B->C, unaffected).
            fabric.set_drop_filter(
                sys_c,
                sys_b,
                lambda m: isinstance(getattr(m, "payload", None), _Ping),
            )
        holder = sys_c.spawn_root(Behaviors.setup_root(Holder), "holder")
        owner = sys_b.spawn_root(
            Behaviors.setup_root(
                lambda ctx: Owner(ctx, [ctx.engine.to_root_refob(holder.cell)])
            ),
            "owner",
        )
        owner.tell(_Share(None))  # hand refs to C's holder
        assert shared_done.wait(timeout_s), "ref hand-off timed out"
        owner.tell(_Release())  # only C's refs keep the workers now
        time.sleep(0.3)  # let releases flush into the collectors
        build_s = time.perf_counter() - t0

        held = _hold(sys_b, latch, n_workers, hold_wakes, timeout_s)
        stopped = n_workers - latch.count
        if stopped:
            raise RuntimeError(f"{stopped} workers stopped before the crash")
        t0 = time.perf_counter()
        fabric.crash(sys_c)
        left = latch.await_zero(timeout_s)
        collect_s = time.perf_counter() - t0
        assert left == 0, f"{left} workers never collected after crash"
        return {"n_collected": n_workers, "build_s": build_s,
                "collect_s": collect_s, "held_wakes": held,
                "wakes": {s.name: _collector_stats(s).get("wakes")
                          for s in systems},
                "roots_alive": {s.name: _roots_alive(s)
                                for s in (sys_a, sys_b)}}
    finally:
        sys_a.terminate()
        sys_b.terminate()
        sys_c.terminate()
