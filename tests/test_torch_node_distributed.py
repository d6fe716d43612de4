"""The port's partitioned collector on its TCP node transport
(``uigc_tpu_torch/runtime/node.py``): the counterparts of
``tests/test_distributed.py``'s NodeFabric tests, and the tests of the
two repairs the transport needed.

- Seeded dmark/dmack drops, duplicates and reorders over three
  NodeFabrics converge with the verdicts sanitizer-clean; a node that
  dies silently mid-collection is absorbed (fence bump, partition
  transfer, journal re-fold) and the survivors collect.
- **The wave stamp on the wire**: a ``DDelta`` crosses ``NodeFabric``
  with its ``fence`` and ``cut`` as trailing fields of the reference's
  ``"delta"`` frame, a plain ``DeltaMsg`` in the reference's bytes, and
  the receiver folds a delta routed before its wave into that wave (the
  reference's transport delivers it unstamped, so its wave relays no
  mark for the new actor).
- **The per-link cut**: an owner is not settled in a wave until every
  peer's ``dcut`` marker for it is in and the stamped deltas it counts
  have arrived; over sockets, a delta held back by a FaultPlan delay
  holds the wave, and one lost to a reorder (the sequence layer drops
  the late frame) stops that era's waves instead of sweeping on a cut
  that misses it.
"""


import time
import types

import pytest

import uigc_tpu.engines.crgc.collector as ref_collector
import uigc_tpu.runtime.node as ref_node
from test_torch_fabric import FakeCell
from uigc_tpu_torch import AbstractBehavior, Behaviors, Message, NoRefs, PostStop
from uigc_tpu_torch.analysis.sanitizer import cross_check_distributed
from uigc_tpu_torch.engines.crgc import distributed as port_dist
from uigc_tpu_torch.parallel.partition import cell_key
from uigc_tpu_torch.runtime.behaviors import RawBehavior
from uigc_tpu_torch.runtime.faults import FaultPlan
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.runtime.remote import RemoteSpawner
from uigc_tpu_torch.runtime.system import ActorSystem
from uigc_tpu_torch.runtime.testkit import TestProbe
from uigc_tpu_torch.utils import events

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.num-nodes": 3,
    "uigc.crgc.distributed": True,
    "uigc.analysis.sanitizer": True,
}


# ------------------------------------------------------------------- #
# Workload actors (module-level: they cross pickling fabrics)
# ------------------------------------------------------------------- #


class Hold(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,) if self.ref is not None else ()


class Go(NoRefs):
    def __init__(self, rings, kept=0):
        self.rings = rings
        self.kept = kept


class Drop(NoRefs):
    pass


class Spawned(NoRefs):
    pass


class Stopped(NoRefs):
    pass


class ProbeForwarder(RawBehavior):
    def __init__(self, probe):
        self.probe = probe

    def on_message(self, msg):
        self.probe._offer(msg)
        return None


class Worker(AbstractBehavior):
    def __init__(self, context, probe_ref):
        super().__init__(context)
        self.probe_ref = probe_ref
        self.held = []
        probe_ref.tell(Spawned())

    def on_message(self, msg):
        if isinstance(msg, Hold):
            self.held.append(msg.ref)
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe_ref.tell(Stopped())
        return None


class RingMaster(AbstractBehavior):
    """Spawns rings of workers, one per node via the spawner services:
    every ring is a reference cycle spanning the whole cluster.  Kept
    rings stay pinned by the master's own refs (the over-collection
    canary); dropped rings are garbage only the cross-node trace can
    prove dead."""

    def __init__(self, context, spawners):
        super().__init__(context)
        self.spawners = spawners
        self.workers = []
        self.kept = []

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Go):
            for r in range(msg.rings + msg.kept):
                ring = [ctx.spawn_remote("worker", sc) for sc in self.spawners]
                n = len(ring)
                for i, w in enumerate(ring):
                    nxt = ring[(i + 1) % n]
                    w.tell(Hold(ctx.create_ref(nxt, w)), ctx)
                (self.kept if r >= msg.rings else self.workers).extend(ring)
        elif isinstance(msg, Drop):
            for w in self.workers:
                ctx.release(w)
            self.workers = []
        return self


# ------------------------------------------------------------------- #
# Cluster builders
# ------------------------------------------------------------------- #


class _Node:
    __slots__ = ("fabric", "system", "port", "address")

    def __init__(self, name, config, plan):
        self.fabric = NodeFabric(fault_plan=plan)
        self.system = ActorSystem(None, name=name, config=config, fabric=self.fabric)
        self.port = self.fabric.listen()
        self.address = self.system.address


def build_nodefabric(names, probe, plan=None, overrides=None):
    """3 NodeFabrics over localhost sockets; the probe forwarder and
    each node's spawner service are registered as well-known names
    BEFORE the mesh connects (names ride the hello)."""
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = len(names)
    if overrides:
        config.update(overrides)
    nodes = [_Node(n, config, plan) for n in names]
    probe_cell = nodes[0].system.spawn_system_raw(
        ProbeForwarder(probe), "probe-fwd"
    )
    nodes[0].fabric.register_name("probe", probe_cell)
    addr0 = nodes[0].address
    for n in nodes:
        if n is nodes[0]:
            factory = Behaviors.setup(lambda ctx: Worker(ctx, probe_cell))
        else:
            fab = n.fabric

            def factory_for(fab=fab):
                return Behaviors.setup(
                    lambda ctx: Worker(ctx, fab.lookup(addr0, "probe"))
                )

            factory = factory_for()
        sc = RemoteSpawner.spawn_service(n.system, {"worker": factory})
        n.fabric.register_name("spawner", sc)
    for i, a in enumerate(nodes):
        for b in nodes[i + 1 :]:
            a.fabric.connect("127.0.0.1", b.port)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if all(len(n.fabric.members()) == len(names) for n in nodes):
            break
        time.sleep(0.02)
    spawners = [
        nodes[0].fabric.lookup(n.address, "spawner") if n is not nodes[0]
        else n.fabric._names["spawner"]
        for n in nodes
    ]
    master = nodes[0].system.spawn_root(
        Behaviors.setup_root(lambda ctx: RingMaster(ctx, spawners)), "master"
    )
    return nodes, master


def terminate_all(items):
    for it in items:
        system = getattr(it, "system", it)
        try:
            system.terminate(timeout_s=5.0)
        except Exception:
            pass


def collect_stopped(probe, expected, timeout_s=30.0):
    stopped = 0
    deadline = time.monotonic() + timeout_s
    while stopped < expected and time.monotonic() < deadline:
        try:
            probe.expect_message_type(Stopped, timeout_s=2.0)
            stopped += 1
        except AssertionError:
            continue
    return stopped


class EventLog:
    def __init__(self):
        import threading

        self.entries = []
        self._lock = threading.Lock()

    def __call__(self, name, fields):
        with self._lock:
            self.entries.append((name, dict(fields)))

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


def test_nodefabric_dmark_drops_tolerated(event_log):
    """Seeded drops, duplicates and reorders on the dmark/dmack
    frames: the position-addressed suffix protocol (idempotent set
    union + watermark acks + wake-driven retransmit) converges anyway
    and the verdicts stay sanitizer-clean."""
    plan = FaultPlan(1234)
    names = ["dda", "ddb", "ddc"]
    probe = TestProbe(default_timeout_s=30.0)
    nodes, master = build_nodefabric(names, probe, plan=plan)
    addrs = [n.address for n in nodes]
    for src in addrs:
        for dst in addrs:
            if src != dst:
                plan.drop(src=src, dst=dst, kind="dmark", prob=0.35)
                plan.drop(src=src, dst=dst, kind="dmack", prob=0.35)
                plan.duplicate(src=src, dst=dst, kind="dmark", prob=0.15)
                plan.reorder(src=src, dst=dst, kind="dmark", prob=0.15)
                plan.duplicate(src=src, dst=dst, kind="dmack", prob=0.15)
    rings = 4
    try:
        master.tell(Go(rings))
        for _ in range(rings * 3):
            probe.expect_message_type(Spawned)
        time.sleep(0.5)
        master.tell(Drop())
        stopped = collect_stopped(probe, rings * 3, timeout_s=40.0)
        assert stopped == rings * 3
        dropped = [
            f
            for f in event_log.of(events.FRAME_DROPPED)
            if f.get("kind") in ("dmark", "dmack")
        ]
        assert dropped, "the fault plan never actually dropped a dmark"
        for n in nodes:
            assert n.system.sanitizer.violations == []
        assert cross_check_distributed([n.system for n in nodes]) == []
    finally:
        terminate_all(nodes)


def test_nodefabric_node_death_absorbs_partition(event_log):
    """A node dies silently mid-collection: the heartbeat verdict bumps
    the fence, ownership of its partitions transfers by rendezvous, the
    survivors re-fold their retained journals, and the surviving
    members of every broken ring collect — sanitizer-clean throughout."""
    names = ["nka", "nkb", "nkc"]
    probe = TestProbe(default_timeout_s=30.0)
    nodes, master = build_nodefabric(
        names,
        probe,
        overrides={
            "uigc.node.heartbeat-interval": 40,
            "uigc.node.phi-threshold": 6.0,
            "uigc.node.heartbeat-pause": 400,
        },
    )
    a, b, c = nodes
    rings = 4
    try:
        master.tell(Go(rings))
        for _ in range(rings * 3):
            probe.expect_message_type(Spawned)
        time.sleep(0.5)
        fences_before = [
            n.system.engine.bookkeeper.fence for n in (a, b)
        ]
        master.tell(Drop())
        # Kill c immediately: the drop's collection waves are in flight.
        c.fabric.die()
        # The dead node's workers die with it; the survivors' ring
        # members must still collect once the undo fold reverts c's
        # claims and the absorb re-folds its partitions.
        stopped = collect_stopped(probe, rings * 2, timeout_s=60.0)
        assert stopped >= rings * 2
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if all(
                c.address not in n.fabric.members() for n in (a, b)
            ):
                break
            time.sleep(0.05)
        for i, n in enumerate((a, b)):
            bk = n.system.engine.bookkeeper
            assert c.address not in bk.pmap.members
            assert bk.fence > fences_before[i]
            # Ownership covers the whole space between the survivors.
            owners = set(bk.pmap.assignments().values())
            assert owners <= {a.address, b.address}
        for n in (a, b):
            assert n.system.sanitizer.violations == []
        assert cross_check_distributed([a.system, b.system]) == []
    finally:
        terminate_all(nodes)


# ------------------------------------------------------------------- #
# Stub collectors: one DistributedBookkeeper over a stub engine, per
# package, for the protocol units below
# ------------------------------------------------------------------- #

PKG = {"ref": "uigc_tpu", "port": "uigc_tpu_torch"}
ABC = ["uigc://a", "uigc://b", "uigc://c"]


def mod(side, name):
    return __import__(f"{PKG[side]}.{name}", fromlist=["x"])


def stub_bookkeeper(side, members=ABC, me="uigc://a"):
    """``side``'s DistributedBookkeeper for node ``me`` of ``members``,
    started, fence 0, over a stub engine whose fabric records what the
    collector sends (the message objects of the in-process route)."""
    dist = mod(side, "engines.crgc.distributed")
    part = mod(side, "parallel.partition")
    state = mod(side, "engines.crgc.state")
    undo = mod(side, "engines.crgc.undo")
    context = state.CrgcContext(delta_graph_size=64, entry_field_size=8)
    sent = []
    config = types.SimpleNamespace(get_int=lambda key: {
        "uigc.crgc.dist-partitions": 8, "uigc.cluster.num-shards": 8,
        "uigc.crgc.mirror-decay-waves": 0}[key])
    system = types.SimpleNamespace(
        address=me, config=config,
        fabric=types.SimpleNamespace(
            control_send=lambda system, gc, msg: sent.append(msg)))
    engine = types.SimpleNamespace(
        system=system, crgc_context=context, num_nodes=len(members),
        make_shadow_graph=lambda: dist.PartitionedShadowGraph(context, me))
    bk = dist.DistributedBookkeeper(engine)
    bk.pmap = part.PartitionMap(list(members), 8, fence=0, self_address=me)
    bk.tree = part.ReductionTree(list(members))
    bk.started = True
    for peer in members:
        if peer != me:
            bk.remote_gcs[peer] = object()
            bk.undo_logs[peer] = undo.UndoLog(peer, fence=0, own_address=me)
    bk.shadow_graph.set_partition_map(bk.pmap)
    return bk, dist, context, sent


def cell_in(bk, address, want_owner, after=None):
    """A fake cell hosted at ``address`` whose key ``bk``'s map gives to
    ``want_owner`` (and, with ``after``, that map gives to ``after``)."""
    for uid in range(1, 4096):
        key = (address, uid)
        p = bk.pmap.partition_of(key)
        if bk.pmap.owner(p) == want_owner and (
                after is None or after.owner(p) == bk._me):
            return FakeCell(address, uid)
    raise AssertionError("no such cell")


def delta_of(side, context, address, fold):
    graph = mod(side, "engines.crgc.delta").DeltaGraph(address, context)
    fold(graph)
    return graph


# ------------------------------------------------------------------- #
# The wave stamp across three NodeFabrics
# ------------------------------------------------------------------- #


def test_a_delta_routed_before_the_wave_folds_into_it():
    """Three port NodeFabrics: b routes the created edge master -> w to
    a, the master's owner, which has already entered wave 1.  The edge
    crosses b's socket as a stamped DDelta (cut 0) and folds into wave
    1, so a relays the master's mark to w; one stamped within wave 1
    (cut 1), or c's plain DeltaMsg, waits.  The reference's transport
    delivers the same stamped frame as a plain delta, which its wave
    defers: no mark for w (the premature sweep of ROADMAP.md Queue 3
    item 4, over sockets)."""
    fabrics, systems = [], []
    for name in ("pdwa", "pdwb", "pdwc"):
        fabric = NodeFabric()
        systems.append(ActorSystem(None, name=name, fabric=fabric, config={
            "uigc.crgc.wakeup-interval": 10, "uigc.crgc.num-nodes": 3,
            "uigc.crgc.shadow-graph": "oracle"}))
        fabrics.append(fabric)
    a, b, c = systems
    got = []
    real_cell = a.engine.bookkeeper_cell
    try:
        ports = [f.listen() for f in fabrics]
        fabrics[0].connect("127.0.0.1", ports[1])
        fabrics[0].connect("127.0.0.1", ports[2])
        fabrics[1].connect("127.0.0.1", ports[2])
        a.engine.bookkeeper_cell = types.SimpleNamespace(
            tell=lambda msg: got.append(msg) if isinstance(
                msg, port_dist.DeltaMsg) else real_cell.tell(msg))
        bk, dist, context, _ = stub_bookkeeper("port")
        master = cell_in(bk, "uigc://a", "uigc://a")
        w = cell_in(bk, "uigc://b", "uigc://b")
        for fabric, system, msg in (
                (fabrics[1], b, dist.DDelta(0, delta_of(
                    "port", context, "uigc://b",
                    lambda g: g.fold_created(master, w)), 0, 0, 0)),
                (fabrics[1], b, dist.DDelta(1, delta_of(
                    "port", context, "uigc://b",
                    lambda g: g.fold_created(master, w)), 0, 1, 1)),
                (fabrics[2], c, dist.DeltaMsg(0, delta_of(
                    "port", context, "uigc://b",
                    lambda g: g.fold_created(master, w))))):
            gc = fabric.systems[a.address].engine.bookkeeper_cell
            fabric.control_send(system, gc, msg)
        deadline = time.monotonic() + 10
        while len(got) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        # b's two frames arrive in b's order; c's on its own link
        got = sorted(got, key=lambda m: type(m) is not port_dist.DDelta)
        assert [type(m).__name__ for m in got] == ["DDelta", "DDelta",
                                                  "DeltaMsg"]
        assert [(m.fence, m.cut, m.index) for m in got[:2]] == [
            (0, 0, 0), (0, 1, 1)]
        stamped_frame = ("delta", 0, got[0].graph.serialize(
            mod("port", "runtime.wire").encode_cell), 0, 0, 0)
    finally:
        a.engine.bookkeeper_cell = real_cell
        for system in systems:
            system.terminate()

    def relayed(side, msg):
        bk, dist, context, _ = stub_bookkeeper(side, ["uigc://a", "uigc://b"])
        own = delta_of(side, context, "uigc://a",
                       lambda g: g.fold_self(master, 0, False, True))
        bk.shadow_graph.merge_delta(own)  # the master: a root
        bk.wave = 1
        bk.ws = dist._WaveState(1, 0)
        bk._fixpoint(bk.ws)
        bk.on_message(msg)
        bk._fixpoint(bk.ws)
        return cell_key(w) in bk.ws.out_sets.get("uigc://b", set())

    # what a reference node receives for the same stamped frame
    ref_got = []
    ref_fabric = ref_node.NodeFabric("uigc://a")
    ref_bk, _, ref_context, _ = stub_bookkeeper(
        "ref", ["uigc://a", "uigc://b"])
    ref_fabric.system = types.SimpleNamespace(
        address="uigc://a", resolve_cell=lambda uid: None,
        engine=types.SimpleNamespace(
            crgc_context=ref_context,
            bookkeeper_cell=types.SimpleNamespace(tell=ref_got.append)))
    ref_fabric._on_frame("uigc://b", stamped_frame)
    assert type(ref_got[0]) is ref_collector.DeltaMsg
    assert [relayed("port", m) for m in got] == [True, False, False]
    assert relayed("ref", ref_got[0]) is False


# ------------------------------------------------------------------- #
# The per-link cut
# ------------------------------------------------------------------- #


def test_a_wave_waits_for_every_peers_cut():
    """Node a enters wave 1 of {a, b, c}: it marks both links and is not
    settled until each peer's marker for wave 1 (or later) is in and the
    stamped deltas the marker counts have arrived.  A marker of an older
    era or wave does not count."""
    bk, dist, context, sent = stub_bookkeeper("port")
    x = cell_in(bk, "uigc://b", "uigc://a")
    bk._cut_sent[("uigc://b", 0)] = 2  # a routed two deltas to b
    assert bk._enter_wave(1, 0)
    ws = bk.ws
    cuts = [m for m in sent if isinstance(m, dist.DCut)]  # one per link
    assert [(m.wave, m.fence, m.origin) for m in cuts] == [(1, 0, "uigc://a")] * 2
    assert sorted(m.count for m in cuts) == [0, 2]
    assert ws.cut_open == {"uigc://b", "uigc://c"} and not ws.settled()
    bk.on_message(dist.DCut(1, 0, "uigc://b", 1, 1))
    assert ws.cut_open == {"uigc://b", "uigc://c"}  # its delta is missing
    late = delta_of("port", context, "uigc://b",
                    lambda g: g.fold_self(x, 0, False, True))
    bk.on_message(dist.DDelta(1, late, 0, 0, index=1))  # index 0 was lost
    assert ws.cut_open == {"uigc://b", "uigc://c"}  # a later one stands for none
    bk.on_message(dist.DDelta(0, late, 0, 0, index=0))
    assert ws.cut_open == {"uigc://c"}
    bk.on_message(dist.DCut(0, 0, "uigc://c", 0, 1))  # an older wave
    bk.on_message(dist.DCut(5, -1, "uigc://c", 0, 1))  # an older era
    assert ws.cut_open == {"uigc://c"} and not ws.settled()
    bk.on_message(dist.DCut(2, 0, "uigc://c", 0, 1))  # a later wave counts
    assert not ws.cut_open and ws.settled()


def test_a_restarted_wave_restarts_its_links_accounting():
    """b aborted wave 1 (its remap in an adopted era) and re-entered it
    with fresh counters: its marker carries a new entry number, so a
    re-sends its marks to b from the start and counts b's from the
    start.  The reference has no such signal: the marks b's aborted
    state acknowledged are never sent again, and no round is quiet."""
    for side in ("port", "ref"):
        bk, dist, context, sent = stub_bookkeeper(side)
        bk._enter_wave(1, 0)
        ws = bk.ws
        keys = [cell_key(cell_in(bk, "uigc://b", "uigc://b")),
                cell_key(cell_in(bk, "uigc://c", "uigc://b"))]
        for key in keys:
            bk._relay_key(ws, key)
        bk._send_dmarks(ws)
        ws.acked["uigc://b"] = 2
        ws.recv_upto["uigc://b"] = 3
        if side == "port":
            bk.on_message(dist.DCut(1, 0, "uigc://b", 0, 1))
            del sent[:]
            bk.on_message(dist.DCut(1, 0, "uigc://b", 0, 2))
        else:
            del sent[:]
        bk._send_dmarks(ws, retransmit=True)
        resent = [m for m in sent if isinstance(m, dist.DMark)]
        if side == "port":
            assert [(m.start, sorted(m.keys)) for m in resent][:1] == [
                (0, sorted(keys))]
            assert "uigc://b" not in ws.recv_upto
        else:
            assert resent == []


def test_a_delayed_delta_holds_the_wave(event_log):
    """A FaultPlan stalls the first stamped deltas b routes to a, and
    the frames behind them on that link (b's cut markers among them).
    No wave of a above such a delta's cut ends before the delta
    arrives, waves above the held deltas' cuts do end after them, and
    the rings still collect, sanitizer-clean."""
    plan = FaultPlan(7)
    probe = TestProbe(default_timeout_s=30.0)
    nodes, master = build_nodefabric(["dya", "dyb", "dyc"], probe, plan=plan)
    a, b, c = nodes
    plan.delay(src=b.address, dst=a.address, kind="delta", count=3,
               frames=40)
    bk = a.system.engine.bookkeeper
    sent_at, arrivals, sweeps = {}, [], []
    control_send, on_message, sweep = (b.fabric.control_send, bk.on_message,
                                       bk._sweep)

    def sending(src, target, msg):
        if isinstance(msg, port_dist.DDelta) and (
                target.system.address == a.address):
            sent_at[msg.seqnum] = time.monotonic()
        return control_send(src, target, msg)

    def watched(msg):
        if isinstance(msg, port_dist.DDelta) and msg.graph.address == b.address:
            arrivals.append((time.monotonic(), msg.fence, msg.cut, msg.seqnum))
        return on_message(msg)

    def swept(ws):
        sweeps.append((time.monotonic(), ws.fence, ws.wave))
        return sweep(ws)

    b.fabric.control_send = sending
    bk.on_message, bk._sweep = watched, swept
    rings = 4
    try:
        master.tell(Go(rings))
        for _ in range(rings * 3):
            probe.expect_message_type(Spawned)
        time.sleep(0.5)
        master.tell(Drop())
        assert collect_stopped(probe, rings * 3, timeout_s=40.0) == rings * 3
        held = [(t, fence, cut) for t, fence, cut, seq in arrivals
                if t - sent_at[seq] > 0.02]
        assert held, "the fault plan held no delta back"
        for t, fence, cut, _ in arrivals:
            early = [s for s in sweeps if s[0] < t and s[1] == fence
                     and s[2] > cut]
            assert not early, (fence, cut, early)
        assert any(s[0] > t and s[1] == fence and s[2] > cut
                   for t, fence, cut in held for s in sweeps)
        for n in nodes:
            assert n.system.sanitizer.violations == []
        assert cross_check_distributed([n.system for n in nodes]) == []
    finally:
        terminate_all(nodes)


def test_a_reordered_delta_stops_the_era_instead_of_sweeping(event_log):
    """A FaultPlan reorders the first stamped delta b routes to a: the
    sequence layer discards it (it arrives behind a newer frame).  a's
    cut for b then never completes, so no wave of the era ends: the
    dropped rings are not collected, no kept worker stops, and nothing
    is swept on a cut that misses the delta."""
    plan = FaultPlan(11)
    probe = TestProbe(default_timeout_s=30.0)
    nodes, master = build_nodefabric(["roa", "rob", "roc"], probe, plan=plan)
    a, b, c = nodes
    # one era agreed by the whole membership (a delta lost in an earlier
    # era is forgiven with it: the guarantee holds per era)
    bks = [n.system.engine.bookkeeper for n in nodes]
    deadline = time.monotonic() + 10
    while not (all(k.pmap is not None and len(k.pmap.members) == 3
                   for k in bks) and len({k.fence for k in bks}) == 1):
        assert time.monotonic() < deadline  # the first waves carry it
        time.sleep(0.05)
    plan.reorder(src=b.address, dst=a.address, kind="delta", count=1)
    bk = a.system.engine.bookkeeper
    try:
        master.tell(Go(2, kept=1))
        for _ in range(9):
            probe.expect_message_type(Spawned)
        deadline = time.monotonic() + 10
        while a.fabric._peer_state(b.address).dups < 1:  # the lost delta
            assert time.monotonic() < deadline, "the delta was never lost"
            time.sleep(0.02)
        master.tell(Drop())
        assert collect_stopped(probe, 1, timeout_s=2.0) == 0
        fence = bk.fence
        mark = bk._cut_marks.get(b.address)
        assert mark is not None and mark[0] == fence
        assert bk._cut_recv.get((b.address, fence), 0) < mark[2]
        for n in nodes:
            assert n.system.sanitizer.violations == []
        assert cross_check_distributed([n.system for n in nodes]) == []
    finally:
        terminate_all(nodes)


# ------------------------------------------------------------------- #
# The absorb path's repairs (the failures of the node-death test)
# ------------------------------------------------------------------- #


def remap_without(bk, dead):
    bk.remote_gcs.pop(dead)
    bk._remap_partitions()


def test_an_adopted_era_keeps_its_journals_until_its_remap():
    """a adopts era 1 from a peer's frame before its own MemberRemoved
    for c: a journal b re-shipped for a partition a gains at that remap
    must wait for it.  The reference judges it against the re-stamped
    old member view, where c still owns the partition, and drops it:
    b's facts for the partition are lost (a leak; the node-death test's
    rare failure)."""
    for side in ("ref", "port"):
        bk, dist, context, _ = stub_bookkeeper(side)
        after = mod(side, "parallel.partition").PartitionMap(
            ["uigc://a", "uigc://b"], 8, fence=1, self_address="uigc://a")
        r = cell_in(bk, "uigc://b", "uigc://c", after=after)
        journal = delta_of(side, context, "uigc://b",
                           lambda g: g.fold_self(r, 1, False, True))
        bk.on_message(dist.DJournal(1, bk.pmap.partition_of(cell_key(r)),
                                    journal))
        bk._adopt_fence(1)
        remap_without(bk, "uigc://c")
        shadow = bk.shadow_graph.shadow_for_key(cell_key(r))
        folded = shadow is not None and shadow.interned
        assert folded is (side == "port"), side


def test_an_adopted_era_keeps_its_routed_facts_for_gained_partitions():
    """After adopting era 1, a folds a stamped delta of that era for a
    partition it gains only at its own remap.  The reference's remap
    resets the gained partition and wipes the fact (no journal repeats
    it: the sender routed it after its own remap); the port reset the
    unowned slices at the adoption and keeps it."""
    for side in ("ref", "port"):
        bk, dist, context, _ = stub_bookkeeper(side)
        after = mod(side, "parallel.partition").PartitionMap(
            ["uigc://a", "uigc://b"], 8, fence=1, self_address="uigc://a")
        r = cell_in(bk, "uigc://b", "uigc://c", after=after)
        bk._adopt_fence(1)
        graph = delta_of(side, context, "uigc://b",
                         lambda g: g.fold_self(r, 1, False, True))
        if side == "port":
            bk.on_message(dist.DDelta(0, graph, 1, 0, 0))
        else:
            bk.on_message(ref_collector.DeltaMsg(0, graph))
        assert bk.shadow_graph.shadow_for_key(cell_key(r)).interned
        remap_without(bk, "uigc://c")
        kept = bk.shadow_graph.shadow_for_key(cell_key(r)).interned
        assert kept is (side == "port"), side


def test_the_undo_fold_reaches_shadows_made_after_it():
    """The undo log of dead c folds at a before the journal that re-folds
    a gained partition arrives: c's actor d, re-folded with an edge to
    r, must be halted, and r's admitted-count revert must apply when r
    appears.  The reference's fold reaches only the shadows present:
    d stays a pseudoroot-free live holder and r keeps a nonzero balance,
    a pseudoroot, so the survivors' cycle through c never collects."""
    for side in ("ref", "port"):
        bk, dist, context, _ = stub_bookkeeper(side, ["uigc://a", "uigc://b"])
        g = bk.shadow_graph
        r = cell_in(bk, "uigc://b", "uigc://a")
        d = cell_in(bk, "uigc://c", "uigc://a")
        log = mod(side, "engines.crgc.undo").UndoLog(
            "uigc://c", fence=0, own_address="uigc://a")
        log._field(r).message_count = -1  # one admitted message from c
        g.merge_undo_log(log)
        journal = delta_of(side, context, "uigc://b", lambda j: (
            j.fold_self(r, 1, False, False), j.fold_created(d, r)))
        g.merge_delta(journal)
        rs, ds = g.shadow_for_key(cell_key(r)), g.shadow_for_key(cell_key(d))
        if side == "port":
            assert rs.recv_count == 0 and ds.is_halted
            assert not g.is_pseudo_root(rs) and not g.is_pseudo_root(ds)
        else:
            assert rs.recv_count == 1 and not ds.is_halted
            assert g.is_pseudo_root(rs) and g.is_pseudo_root(ds)


def test_a_negative_edge_keeps_its_mirror_across_a_sweep():
    """An owned root holds a -1 edge to a foreign mirror (the release
    folded before its create, which is still in a journal on its way).
    The reference's sweep drops the mirror, so the create lands on a
    fresh shadow and the two never cancel: the target stays marked
    forever.  The port keeps the mirror; the create cancels the
    release."""
    for side in ("ref", "port"):
        bk, dist, context, _ = stub_bookkeeper(side, ["uigc://a", "uigc://b"])
        g = bk.shadow_graph
        o = cell_in(bk, "uigc://a", "uigc://a")
        m = cell_in(bk, "uigc://b", "uigc://b")
        g.merge_delta(delta_of(side, context, "uigc://a", lambda j: (
            j.fold_self(o, 0, False, True), j.fold_deactivate(o, m))))
        bk.wave = 1
        ws = bk.ws = dist._WaveState(1, 0)
        bk._fixpoint(ws)
        bk._sweep(ws)
        g.merge_delta(delta_of(side, context, "uigc://b",
                               lambda j: j.fold_created(o, m)))
        counts = sorted(g.shadow_for_key(cell_key(o)).outgoing.values())
        assert counts == ([] if side == "port" else [-1, 1]), side
