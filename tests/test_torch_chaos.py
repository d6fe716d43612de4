"""Seeded fault plans against the port's TCP node transport: the port's
counterpart of the tier-1 tests of ``tests/test_chaos.py`` (the two
marked slow stay with the reference).

Three NodeFabrics (one ActorSystem each) live in this process and talk
over localhost sockets, with seeded fault injection
(``runtime/faults.py``) at the frame edges:

- drop / duplicate / reorder / truncate faults on the links of a doomed
  node while application churn is in flight;
- silent node death (links muted, engine stopped, sockets left open)
  that only the phi-accrual heartbeat (``runtime/heartbeat.py``) detects;
- post-mortem frames to reclaimed uids, which must still tally on the
  ingress and release carried refs;
- torn sockets healed by reconnect-with-backoff under frame sequence
  numbering.

The invariants are CRGC's crash-safety contract: no actor that should be
alive is collected, recv balances return to zero once the responsible
node's undo log folds, and a seed gives the same plan draws.
"""

import threading
import time

import pytest

from uigc_tpu_torch import AbstractBehavior, Behaviors, Message, NoRefs, PostStop
from uigc_tpu_torch.runtime.behaviors import RawBehavior
from uigc_tpu_torch.runtime.faults import FaultPlan
from uigc_tpu_torch.runtime.heartbeat import PhiAccrualFailureDetector
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.runtime.system import ActorSystem
from uigc_tpu_torch.runtime.testkit import TestProbe
from uigc_tpu_torch.utils import events

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.shadow-graph": "array",
}


class Ping(NoRefs):
    pass


class Share(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,) if self.ref is not None else ()


class Drop(NoRefs):
    pass


class Spawned(NoRefs):
    def __init__(self, name):
        self.name = name


class Stopped(NoRefs):
    def __init__(self, name):
        self.name = name


class RemoteProbe:
    """Probe facade whose .ref is a ProxyCell of node A's forwarder."""

    def __init__(self, cell):
        self.ref = cell


class ProbeForwarder(RawBehavior):
    def __init__(self, probe):
        self.probe = probe

    def on_message(self, msg):
        self.probe._offer(msg)
        return None


class Worker(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        self.pings = 0
        probe.ref.tell(Spawned(context.name))

    def on_message(self, msg):
        if isinstance(msg, Ping):
            self.pings += 1
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe.ref.tell(Stopped(self.context.name))
        return None


class Holder(AbstractBehavior):
    """Root on the doomed node, holding the only ref to a remote worker
    and pinging it (churn on the doomed links)."""

    def __init__(self, context):
        super().__init__(context)
        self.held = None

    def on_message(self, msg):
        if isinstance(msg, Share):
            self.held = msg.ref
        if self.held is not None:
            self.held.tell(Ping(), self.context)
        return self


class Owner(AbstractBehavior):
    """Root on node B owning a worker; hands the ref to the doomed
    node's holder, then releases its own."""

    def __init__(self, context, probe, holder_ref):
        super().__init__(context)
        self.worker = context.spawn(
            Behaviors.setup(lambda ctx: Worker(ctx, probe)), "worker"
        )
        self.holder_ref = holder_ref

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Share):
            self.holder_ref.tell(
                Share(ctx.create_ref(self.worker, self.holder_ref)), ctx
            )
        elif isinstance(msg, Drop):
            ctx.release(self.worker)
        return self


class KeptWorkerRoot(AbstractBehavior):
    """Root on node A holding a worker it spawned remotely-by-share; its
    worker must SURVIVE every chaos run (the over-collection canary)."""

    def __init__(self, context, worker_ref):
        super().__init__(context)
        self.worker = worker_ref

    def on_message(self, msg):
        if isinstance(msg, Ping) and self.worker is not None:
            self.worker.tell(Ping(), self.context)
        return self


class Node:
    __slots__ = ("fabric", "system", "port", "address")

    def __init__(self, name, config, plan):
        self.fabric = NodeFabric(fault_plan=plan)
        self.system = ActorSystem(None, name=name, config=config, fabric=self.fabric)
        self.port = self.fabric.listen()
        self.address = self.system.address


def build_cluster(names, plan=None, overrides=None):
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = len(names)
    if overrides:
        config.update(overrides)
    nodes = [Node(n, config, plan) for n in names]
    return nodes


def connect_mesh(nodes):
    for i, a in enumerate(nodes):
        for b in nodes[i + 1 :]:
            a.fabric.connect("127.0.0.1", b.port)


def terminate_all(nodes):
    for n in nodes:
        try:
            n.system.terminate(timeout_s=5.0)
        except Exception:
            pass


def settle(predicate, timeout_s=20.0, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


def nonzero_recv(node):
    return node.system.engine.bookkeeper.shadow_graph.investigate_live_set()[
        "nonzero_recv"
    ]


class EventLog:
    """Capture the structured failure-event stream for assertions."""

    def __init__(self):
        self.entries = []
        self._lock = threading.Lock()

    def __call__(self, name, fields):
        with self._lock:
            self.entries.append((name, fields))

    def names(self):
        with self._lock:
            return [n for n, _ in self.entries]

    def of(self, name):
        with self._lock:
            return [f for n, f in self.entries if n == name]


@pytest.fixture
def event_log():
    log = EventLog()
    events.recorder.enable()
    events.recorder.add_listener(log)
    yield log
    events.recorder.disable()
    events.recorder.remove_listener(log)
    events.recorder.reset()


# ------------------------------------------------------------------- #
# Unit layer: the plan and the detector
# ------------------------------------------------------------------- #


def test_fault_plan_is_deterministic_per_seed():
    def draw(seed):
        plan = (
            FaultPlan(seed)
            .drop(src="a", dst="b", kind="app", prob=0.4)
            .duplicate(src="a", dst="b", prob=0.3)
            .truncate(src="b", dst="a", prob=0.5)
        )
        return (
            [plan.outbound("a", "b", "app")[0] for _ in range(50)],
            [plan.outbound("b", "a", "app")[0] for _ in range(50)],
        )

    assert draw(11) == draw(11)
    assert draw(11) != draw(12)


def test_fault_plan_links_are_independent_streams():
    plan = FaultPlan(3).drop(prob=0.5)
    ab = [plan.outbound("a", "b", "app")[0] for _ in range(40)]
    # interleaving traffic on another link must not perturb a->b draws
    plan2 = FaultPlan(3).drop(prob=0.5)
    ab2 = []
    for _ in range(40):
        plan2.outbound("c", "d", "app")
        ab2.append(plan2.outbound("a", "b", "app")[0])
    assert ab == ab2


def test_fault_plan_partition_and_crash_budget():
    plan = FaultPlan(0).partition("a", "b").crash_at("a", 3)
    assert plan.outbound("a", "b", "app")[0] == "drop"
    assert plan.outbound("b", "a", "hb")[0] == "drop"
    plan.heal("a", "b")
    assert plan.outbound("a", "b", "app")[0] == "deliver"
    assert [plan.record_sent("a") for _ in range(4)] == [False, False, True, False]


def test_phi_accrual_detector_rises_on_silence():
    det = PhiAccrualFailureDetector(threshold=8.0, acceptable_pause_s=0.1)
    t = 0.0
    for _ in range(30):
        det.heartbeat(t)
        t += 0.05
    assert det.phi(t + 0.05) < 1.0  # a normal gap is unsuspicious
    assert det.phi(t + 5.0) > 8.0  # long silence crosses the threshold
    det.heartbeat(t + 6.0)
    assert det.phi(t + 6.05) < 1.0  # recovery resets suspicion


# ------------------------------------------------------------------- #
# Integration layer: real sockets, seeded chaos
# ------------------------------------------------------------------- #


def _run_crash_scenario(seed):
    """One full run of the acceptance scenario: three nodes, churn, a
    seeded fault barrage on the doomed node's links, then silent death
    detected by the heartbeat.  Returns the outcome tuple the
    determinism assertion compares."""
    names = [f"chs{seed}a", f"chs{seed}b", f"chs{seed}c"]
    plan = FaultPlan(seed)
    nodes = build_cluster(
        names,
        plan=plan,
        overrides={
            "uigc.node.heartbeat-interval": 40,
            "uigc.node.phi-threshold": 6.0,
            "uigc.node.heartbeat-pause": 400,
        },
    )
    a, b, c = nodes
    try:
        probe = TestProbe(default_timeout_s=30.0)
        probe_cell = a.system.spawn_system_raw(ProbeForwarder(probe), "probe-fwd")
        a.fabric.register_name("probe", probe_cell)
        connect_mesh(nodes)

        # Seeded barrage on the doomed node's app links, both directions.
        for src, dst in ((b.address, c.address), (c.address, b.address),
                         (a.address, c.address), (c.address, a.address)):
            plan.drop(src=src, dst=dst, kind="app", prob=0.2)
            plan.duplicate(src=src, dst=dst, kind="app", prob=0.2)
            plan.reorder(src=src, dst=dst, kind="app", prob=0.1)
            plan.truncate(src=src, dst=dst, kind="app", prob=0.1)

        remote_probe = RemoteProbe(probe_cell)
        holder = c.system.spawn_root(
            Behaviors.setup_root(lambda ctx: Holder(ctx)), "holder"
        )
        # B's route to C's holder: the cached proxy for its (address, uid)
        # token (what a name lookup would resolve to).
        holder_proxy = b.fabric._proxy(c.address, holder.cell.uid)
        owner = b.system.spawn_root(
            Behaviors.setup_root(
                lambda ctx: Owner(
                    ctx, remote_probe, ctx.engine.to_root_refob(holder_proxy)
                )
            ),
            "owner",
        )
        spawned = probe.expect_message_type(Spawned)

        owner.tell(Share(None))  # hand the only surviving ref to C
        # churn: C's holder pings the worker across the faulty link
        for _ in range(30):
            holder.tell(Ping())
            time.sleep(0.005)
        owner.tell(Drop())  # B releases; only C's ref keeps the worker
        probe.expect_no_message(0.4)

        # Silent death: C's links go dark and its engine stops, but the
        # sockets stay open — no EOF.  Only the heartbeat can see this.
        plan.isolate(c.address)
        c.system.engine.on_crash()

        stopped = probe.expect_message_type(Stopped, timeout_s=30.0)
        assert stopped.name == spawned.name

        # Survivors converge: every recv balance folds back to zero.
        assert settle(lambda: nonzero_recv(a) == 0 and nonzero_recv(b) == 0), (
            f"recv balances never converged: A={nonzero_recv(a)} "
            f"B={nonzero_recv(b)}"
        )
        assert c.address not in a.fabric.members()
        assert c.address not in b.fabric.members()
        return (
            stopped.name,
            sorted(a.fabric.members()),
            sorted(b.fabric.members()),
        )
    finally:
        terminate_all(nodes)


@pytest.mark.parametrize("seed", [101, 202])
def test_chaos_silent_crash_heartbeat_recovery(seed, event_log):
    """The acceptance scenario: a seeded FaultPlan batters the doomed
    node's links mid-churn, the node dies silently, the phi-accrual
    heartbeat declares it dead, finalize_dead_link + the undo-log quorum
    revert its claims, and the only-held-by-the-dead worker collapses —
    with zero surviving recv imbalance."""
    outcome = _run_crash_scenario(seed)

    names = event_log.names()
    downs = [
        f for f in event_log.of(events.NODE_DOWN) if f.get("reason") == "heartbeat"
    ]
    assert downs, f"no heartbeat-driven down verdict in {set(names)}"
    assert events.DEAD_LINK_FINALIZED in names
    assert events.UNDO_FOLD in names
    # fault injection visibly happened on the wire
    assert events.FRAME_DROPPED in names

    assert outcome[0].endswith("/worker")


@pytest.mark.parametrize("seed", [5, 6])
def test_chaos_churn_never_overcollects(seed, event_log):
    """Bounded drop/duplicate/reorder/truncate faults on a surviving
    link must never collect a live actor: the canary worker (held by a
    live root throughout) survives the barrage, and the seq layer's
    duplicate/gap detections are visible."""
    names = [f"chn{seed}a", f"chn{seed}b"]
    plan = FaultPlan(seed)
    nodes = build_cluster(names)
    a, b = nodes
    try:
        probe = TestProbe(default_timeout_s=20.0)
        probe_cell = a.system.spawn_system_raw(ProbeForwarder(probe), "probe-fwd")
        a.fabric.register_name("probe", probe_cell)
        connect_mesh(nodes)

        remote_probe = RemoteProbe(probe_cell)
        # worker lives on B, held by a root on B that keeps it pinned
        worker_holder = b.system.spawn_root(
            Behaviors.setup_root(
                lambda ctx: KeptWorkerRoot(
                    ctx,
                    ctx.spawn(
                        Behaviors.setup(lambda c2: Worker(c2, remote_probe)),
                        "canary",
                    ),
                )
            ),
            "keeper",
        )
        spawned = probe.expect_message_type(Spawned)
        assert spawned.name.endswith("/canary")

        # Bounded faults (count=) so the link heals by exhaustion.
        plan.drop(src=a.address, dst=b.address, kind="app", prob=0.3, count=10)
        plan.duplicate(src=a.address, dst=b.address, prob=0.3, count=10)
        plan.reorder(src=a.address, dst=b.address, kind="app", prob=0.2, count=6)
        plan.truncate(src=a.address, dst=b.address, kind="app", prob=0.2, count=6)
        a.fabric.set_fault_plan(plan)
        b.fabric.set_fault_plan(plan)

        for _ in range(120):
            worker_holder.tell(Ping())
        time.sleep(1.0)

        # The canary never died, membership never wavered.
        probe.expect_no_message(0.5)
        assert sorted(a.fabric.members()) == sorted([a.address, b.address])
        assert sorted(b.fabric.members()) == sorted([a.address, b.address])
        st = b.fabric._peer_state(a.address)
        dup_events = event_log.of(events.FRAME_DUPLICATE)
        gap_events = event_log.of(events.FRAME_GAP)
        assert st.dups == len(
            [f for f in dup_events if f.get("src") == a.address]
        )
        assert (st.dups + st.gaps) > 0 or (len(dup_events) + len(gap_events)) > 0
    finally:
        terminate_all(nodes)


def test_postmortem_dead_letter_tally(event_log):
    """Regression for the node.py dead-letter hole: app frames to a
    reclaimed uid must still tally on the ingress, keyed by the uid's
    tombstone proxy.  A managed root on A sends pings to a uid that
    never resolves on B; the sender's claims (delta gossip) and B's
    dead-letter accounting must cancel, so the tombstone's recv balance
    converges to zero instead of leaking a permanently nonzero count."""
    names = ["dlta", "dltb"]
    nodes = build_cluster(names)
    a, b = nodes
    try:
        connect_mesh(nodes)
        bogus_uid = 10**9  # never allocated on B
        tomb_proxy = a.fabric._proxy(b.address, bogus_uid)

        class DeadLetterRoot(AbstractBehavior):
            def __init__(self, context):
                super().__init__(context)
                self.tomb = context.engine.to_root_refob(tomb_proxy)

            def on_message(self, msg):
                if isinstance(msg, Ping):
                    self.tomb.tell(Ping(), self.context)
                return self

        root = a.system.spawn_root(
            Behaviors.setup_root(lambda ctx: DeadLetterRoot(ctx)), "dlroot"
        )
        dead_letters_before = b.system.dead_letters
        for _ in range(20):
            root.tell(Ping())
        assert settle(
            lambda: b.system.dead_letters >= dead_letters_before + 20
        ), "post-mortem frames were not routed through dead-letter accounting"

        # Sender claims (A's deltas) + B's dead-letter tallies cancel:
        # the tombstone's recv balance converges to zero on B.
        assert settle(lambda: nonzero_recv(b) == 0, timeout_s=15.0), (
            f"tombstone recv balance leaked: {nonzero_recv(b)}"
        )
        assert event_log.of(events.DEAD_LETTER)
    finally:
        terminate_all(nodes)


def test_postmortem_share_releases_carried_ref(event_log):
    """The ref-release half of the dead-letter fix: a worker on B kept
    alive only by an edge owned by a dead uid must be collected once the
    Share lands in the dead-letter path and deactivates the ref."""
    names = ["dlra", "dlrb"]
    nodes = build_cluster(names)
    a, b = nodes
    try:
        probe = TestProbe(default_timeout_s=20.0)
        probe_cell = a.system.spawn_system_raw(ProbeForwarder(probe), "probe-fwd")
        a.fabric.register_name("probe", probe_cell)
        connect_mesh(nodes)
        remote_probe = RemoteProbe(probe_cell)

        bogus_uid = 10**9 + 7
        tomb_proxy = a.fabric._proxy(b.address, bogus_uid)

        class SharingOwner(AbstractBehavior):
            """Root on B: owns the worker, shares it to A's root."""

            def __init__(self, context, a_root):
                super().__init__(context)
                self.worker = context.spawn(
                    Behaviors.setup(lambda c2: Worker(c2, remote_probe)),
                    "worker",
                )
                self.a_root = a_root

            def on_message(self, msg):
                ctx = self.context
                if isinstance(msg, Share):
                    self.a_root.tell(
                        Share(ctx.create_ref(self.worker, self.a_root)), ctx
                    )
                elif isinstance(msg, Drop):
                    ctx.release(self.worker)
                return self

        class AHolder(AbstractBehavior):
            """Root on A: receives the worker ref, then re-homes it onto
            the dead uid and releases its own copy."""

            def __init__(self, context):
                super().__init__(context)
                self.tomb = context.engine.to_root_refob(tomb_proxy)
                self.worker = None

            def on_message(self, msg):
                ctx = self.context
                if isinstance(msg, Share) and msg.ref is not None:
                    self.worker = msg.ref
                elif isinstance(msg, Drop) and self.worker is not None:
                    self.tomb.tell(
                        Share(ctx.create_ref(self.worker, self.tomb)), ctx
                    )
                    ctx.release(self.worker)
                    self.worker = None
                return self

        a_root = a.system.spawn_root(
            Behaviors.setup_root(lambda ctx: AHolder(ctx)), "aholder"
        )
        a_root_proxy = b.fabric._proxy(a.address, a_root.cell.uid)
        owner = b.system.spawn_root(
            Behaviors.setup_root(
                lambda ctx: SharingOwner(
                    ctx, ctx.engine.to_root_refob(a_root_proxy)
                )
            ),
            "sowner",
        )
        spawned = probe.expect_message_type(Spawned)

        owner.tell(Share(None))  # B shares worker -> A's root
        time.sleep(0.4)
        a_root.tell(Drop())  # A re-homes the ref onto the dead uid
        time.sleep(0.4)
        owner.tell(Drop())  # B releases its own; only the dead uid holds it

        stopped = probe.expect_message_type(Stopped, timeout_s=30.0)
        assert stopped.name == spawned.name
        assert settle(lambda: nonzero_recv(b) == 0, timeout_s=15.0)
    finally:
        terminate_all(nodes)


def test_reconnect_heals_torn_socket(event_log):
    """A torn TCP connection with reconnect-retries > 0 heals without a
    membership change: the dialer re-dials with backoff, sequence
    numbers bridge the streams, and traffic resumes."""
    names = ["rca", "rcb"]
    nodes = build_cluster(
        names,
        overrides={
            "uigc.node.reconnect-retries": 6,
            "uigc.node.reconnect-backoff": 30,
        },
    )
    a, b = nodes
    try:
        probe = TestProbe(default_timeout_s=20.0)
        probe_cell = a.system.spawn_system_raw(ProbeForwarder(probe), "probe-fwd")
        a.fabric.register_name("probe", probe_cell)
        connect_mesh(nodes)
        remote_probe = RemoteProbe(probe_cell)

        keeper = b.system.spawn_root(
            Behaviors.setup_root(
                lambda ctx: KeptWorkerRoot(
                    ctx,
                    ctx.spawn(
                        Behaviors.setup(lambda c2: Worker(c2, remote_probe)),
                        "canary",
                    ),
                )
            ),
            "keeper",
        )
        probe.expect_message_type(Spawned)

        # Tear the socket out from under both fabrics.
        a.fabric._conns[b.address].sock.close()

        assert settle(
            lambda: bool(event_log.of(events.LINK_RECONNECT)), timeout_s=10.0
        ), "link never reconnected"
        # No member was removed on either side.
        assert sorted(a.fabric.members()) == sorted([a.address, b.address])
        assert sorted(b.fabric.members()) == sorted([a.address, b.address])
        # Traffic still flows end to end after the heal.
        keeper.tell(Ping())
        probe.expect_no_message(0.3)  # canary alive, no Stopped
        assert not event_log.of(events.NODE_DOWN)
    finally:
        terminate_all(nodes)


