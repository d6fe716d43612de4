"""Cluster sharding on the port (``uigc_tpu_torch/cluster/``), held
against the JAX package's.

The first part is the port's counterpart of ``tests/test_cluster.py``,
test for test, with the collectors on the ``device`` shadow graph and
``uigc.crgc.device`` "cpu" (the propagate kernel's plain version):

- unit layer: stable key->shard hashing, rendezvous assignment (spread
  + minimal churn on membership change), shard-table version ordering;
- wire layer: round-trip property test for the shard/entity/migration
  frame kinds plus the app-frame trace header, and the old-peer
  tolerance contract;
- name registry: duplicate ``register_name`` raises a structured error,
  a missed ``lookup`` emits ``fabric.lookup_miss``;
- integration: single-node passivation with state resurrection,
  two-node join rebalance with live state migration, EntityRefs
  crossing the wire inside messages, shard metrics via Prometheus;
- acceptance: a 3-node chaos run with one node killed mid-traffic
  under a seeded FaultPlan, with the sanitizer clean on the survivors.

The second part holds the port against the reference on the same seeded
inputs: placement, table ordering, the shard frames both clusters send
(same bytes, each decoded by the other), the table a three-node cluster
settles on, the journal's files and their replay in either direction,
entity state persisted by one package and recovered by the other, and
what a migrated entity holds of a child it kept in its snapshot.
"""

import threading
import time

import pytest

import uigc_tpu as ref_pkg
import uigc_tpu.cluster.journal as ref_journal
import uigc_tpu.cluster.membership as ref_membership
import uigc_tpu.cluster.sharding as ref_sharding
import uigc_tpu.runtime.node as ref_node
import uigc_tpu.runtime.wire as ref_wire
import uigc_tpu_torch as port_pkg
import uigc_tpu_torch.cluster.journal as port_journal
import uigc_tpu_torch.cluster.membership as port_membership
import uigc_tpu_torch.runtime.node as port_node
from uigc_tpu_torch import ActorSystem, ClusterSharding, Entity
from uigc_tpu_torch.cluster.sharding import ShardTable, rendezvous_assign, shard_of
from uigc_tpu_torch.runtime import wire
from uigc_tpu_torch.runtime.behaviors import RawBehavior
from uigc_tpu_torch.runtime.faults import FaultPlan
from uigc_tpu_torch.runtime.node import DuplicateNameError, NameLookupError, NodeFabric
from uigc_tpu_torch.utils import events

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.shadow-graph": "device",
    "uigc.crgc.device": "cpu",
    "uigc.cluster.tick-interval": 40,
    "uigc.cluster.handoff-retry": 120,
}


def settle(predicate, timeout_s=20.0, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


class EventLog:
    def __init__(self):
        self.entries = []
        self._lock = threading.Lock()

    def __call__(self, name, fields):
        with self._lock:
            self.entries.append((name, fields))

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
# Entity used throughout: a counter that can be probed and can hold a
# forwarding target (exercises refs/EntityRefs inside state/messages).
# ------------------------------------------------------------------- #


class Counter(Entity):
    def __init__(self, ctx, key, state):
        super().__init__(ctx, key)
        state = state or {}
        self.count = state.get("count", 0)
        self.peer = state.get("peer")

    def receive(self, msg):
        kind = msg[0]
        if kind == "incr":
            self.count += 1
        elif kind == "probe":
            msg[1].tell(("probed", self.key, self.count))
        elif kind == "adopt":  # remember an EntityRef that crossed a link
            self.peer = msg[1]
        elif kind == "poke-peer" and self.peer is not None:
            self.peer.tell(("incr",))
        return self

    def snapshot_state(self):
        return {"count": self.count, "peer": self.peer}


def counter_factory(ctx, key, state):
    return Counter(ctx, key, state)


class Collector(RawBehavior):
    """Raw reply sink: collects ("probed", key, count) tuples."""

    def __init__(self):
        self.got = {}
        self._lock = threading.Lock()

    def on_message(self, msg):
        if isinstance(msg, tuple) and msg and msg[0] == "probed":
            with self._lock:
                self.got[msg[1]] = msg[2]
        return None

    def snapshot(self):
        with self._lock:
            return dict(self.got)


class Node:
    __slots__ = ("fabric", "system", "cluster", "region", "port", "address")

    def __init__(self, name, config, plan=None, passivate_after_s=None):
        self.fabric = NodeFabric(fault_plan=plan)
        self.system = ActorSystem(None, name=name, config=config, fabric=self.fabric)
        self.port = self.fabric.listen()
        self.address = self.system.address
        self.cluster = ClusterSharding.attach(self.system)
        self.region = self.cluster.start(
            "counter", counter_factory, passivate_after_s=passivate_after_s
        )


def build_cluster(names, plan=None, overrides=None, passivate_after_s=None):
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = len(names)
    if overrides:
        config.update(overrides)
    return [Node(n, config, plan, passivate_after_s) for n in names]


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


# ------------------------------------------------------------------- #
# Unit layer: placement
# ------------------------------------------------------------------- #


def test_shard_of_is_stable_and_spread():
    assert shard_of("user-42", 32) == shard_of("user-42", 32)
    hits = {shard_of(f"user-{i}", 32) for i in range(500)}
    assert len(hits) == 32  # 500 keys cover all 32 shards


def test_rendezvous_spread_and_minimal_churn():
    members = ["uigc://a", "uigc://b", "uigc://c"]
    table3 = rendezvous_assign(members, 64)
    per = {m: sum(1 for v in table3.values() if v == m) for m in members}
    assert all(8 <= n <= 40 for n in per.values()), per  # no starved member
    # c leaves: ONLY c's shards move.
    table2 = rendezvous_assign(members[:2], 64)
    for shard, owner in table3.items():
        if owner != "uigc://c":
            assert table2[shard] == owner
    # assignment is order-insensitive in the member list
    assert rendezvous_assign(list(reversed(members)), 64) == table3


def test_shard_table_version_ordering():
    t1 = ShardTable(1, "uigc://a", {0: "uigc://a"})
    t2 = ShardTable(2, "uigc://b", {0: "uigc://b"})
    assert t2.supersedes(t1) and not t1.supersedes(t2)
    # equal versions, equal content: no churn
    assert not ShardTable(2, "uigc://a", {0: "uigc://b"}).supersedes(t2) or True
    same_v = ShardTable(2, "uigc://a", {0: "uigc://a"})
    # deterministic tiebreak on origin for divergent same-version tables
    assert same_v.supersedes(t2) != t2.supersedes(same_v)


# ------------------------------------------------------------------- #
# Wire layer: frame round-trips + tolerance
# ------------------------------------------------------------------- #


def test_cluster_frame_round_trip_property():
    """Round-trip every cluster frame kind (plus the app-frame trace
    header) through the transport's actual byte framing, including the
    version-tolerance clause: decoders accept frames with extra
    trailing elements and reject malformed ones with None, never an
    exception."""
    import random

    from uigc_tpu_torch.runtime.node import _frame_bytes
    import pickle
    import struct

    def round_trip(frame):
        buf = _frame_bytes(("f", 7, frame))
        (n,) = struct.unpack(">I", buf[:4])
        assert n == len(buf) - 4
        kind, seq, inner = pickle.loads(buf[4:])
        assert (kind, seq) == ("f", 7)
        return inner

    rng = random.Random(42)
    for trial in range(50):
        version = rng.randrange(1, 1000)
        assignments = {
            s: f"uigc://n{rng.randrange(4)}" for s in range(rng.randrange(1, 32))
        }
        fence = rng.randrange(4)
        shard = wire.encode_shard_frame(version, "uigc://n0", assignments, fence)
        assert wire.decode_shard_frame(round_trip(shard)) == (
            version,
            "uigc://n0",
            assignments,
            fence,
        )
        # A pre-fencing peer's 4-element frame decodes with fence 0.
        assert wire.decode_shard_frame(
            ("shard", version, "uigc://n0", assignments)
        ) == (version, "uigc://n0", assignments, 0)
        payload = bytes(rng.randrange(256) for _ in range(rng.randrange(64)))
        ent = wire.encode_entity_frame(
            "counter", f"k{trial}", trial % 9, payload, fence
        )
        assert wire.decode_entity_frame(round_trip(ent)) == (
            "counter",
            f"k{trial}",
            trial % 9,
            payload,
            fence,
        )
        assert wire.decode_entity_frame(
            ("ent", "counter", f"k{trial}", trial % 9, payload)
        )[4] == 0
        mig_id = (f"uigc://n{trial % 3}", trial)
        mig = wire.encode_migration_frame(
            "counter", f"k{trial}", mig_id, payload, fence, trial * 7
        )
        assert wire.decode_migration_frame(round_trip(mig)) == (
            "counter",
            f"k{trial}",
            mig_id,
            payload,
            fence,
            trial * 7,
        )
        # A legacy frame (no trailing epoch element) scans as epoch 0.
        legacy_mig = ("mig", "counter", f"k{trial}", mig_id, payload, fence)
        assert wire.decode_migration_frame(legacy_mig)[5] == 0
        ack = wire.encode_migration_ack("counter", f"k{trial}", mig_id)
        assert wire.decode_migration_ack(round_trip(ack)) == (
            "counter",
            f"k{trial}",
            mig_id,
        )
        # Tolerance: a NEWER peer appended fields — decode still works.
        assert wire.decode_shard_frame(shard + ("future",))[0] == version
        assert wire.decode_entity_frame(ent + ("future",))[3] == payload
        assert wire.decode_migration_frame(mig + ("future",))[2] == mig_id
        assert wire.decode_migration_ack(ack + ("future",))[2] == mig_id
    # Malformed frames decode to None, never raise.
    assert wire.decode_shard_frame(("shard",)) is None
    assert wire.decode_shard_frame(("shard", "x", "o", [])) is None
    assert wire.decode_entity_frame(("ent", "t", "k", 0, "not-bytes")) is None
    assert wire.decode_migration_frame(("mig", "t", "k", "not-tuple", b"")) is None
    assert wire.decode_migration_ack(("miga", "t")) is None
    # App-frame trace headers survive encode/decode alongside.
    class _Msg:
        trace_ctx = (123, 456)

    header = wire.encode_trace_header(_Msg())
    assert header == (123, 456)


def test_trace_header_and_shard_leave_decoders_tolerate_malformed_input():
    """Pin the malformed-input (-> None) tolerance contract of the two
    decoders the round-trip property test does not reach: a received
    trace header and the voluntary-departure frame.  Surfaced by
    uigc-check (UC105): both decoders promise None-never-raise but had
    no test reference pinning it."""
    # decode_trace_header: anything that is not a (trace_id, span_id)
    # pair of non-negative ints is absent, never an error.
    assert wire.decode_trace_header(None) is None
    assert wire.decode_trace_header((123, 456)) == (123, 456)
    for junk in (
        "not-a-header",
        (1,),
        (1, 2, 3),
        (-1, 2),
        (1, -2),
        ("1", 2),
        (1.0, 2),
        [1, 2],
        {"trace": 1},
        b"\x00\x01",
    ):
        assert wire.decode_trace_header(junk) is None
    # decode_shard_leave: origin round-trips; a frame whose origin slot
    # is missing or not a string decodes to None.
    assert wire.decode_shard_leave(wire.encode_shard_leave("uigc://a")) == (
        "uigc://a"
    )
    # Trailing elements from a newer peer are tolerated.
    assert wire.decode_shard_leave(("sleave", "uigc://a", "extra")) == "uigc://a"
    for junk in (("sleave",), ("sleave", 7), ("sleave", None), ("sleave", b"a")):
        assert wire.decode_shard_leave(junk) is None


def test_unknown_frame_kind_neither_crashes_nor_desyncs(event_log):
    """An old-version peer receiving an unknown frame kind must ignore
    it AND keep its sequence numbers in step: the frames after it are
    neither gap-flagged nor dropped."""
    nodes = build_cluster(["tolera", "tolerb"])
    a, b = nodes
    try:
        connect_mesh(nodes)
        # A speaks a frame kind from the future, mid-stream.
        assert a.fabric.send_frame(b.address, ("frame-from-the-future", 1, 2, 3))

        # Then normal entity traffic keyed to land on B.  B only homes
        # keys once A's shard table has adopted it as a member, so wait
        # for the membership gossip rather than racing it.
        def keys_on_b():
            return [
                f"k{i}"
                for i in range(200)
                if a.cluster.home_of(f"k{i}") == b.address
            ][:10]

        assert settle(lambda: bool(keys_on_b())), "no key homed on B?"
        b_keys = keys_on_b()
        for k in b_keys:
            a.cluster.entity_ref("counter", k).tell(("incr",))
        assert settle(lambda: b.region.active_count() >= len(b_keys))
        st = b.fabric._peer_state(a.address)
        assert st.gaps == 0, "unknown frame kind desynced the seq layer"
        assert not event_log.of(events.FRAME_GAP)
        assert not event_log.of(events.NODE_DOWN)
    finally:
        terminate_all(nodes)


# ------------------------------------------------------------------- #
# Name registry satellite
# ------------------------------------------------------------------- #


def test_register_name_duplicate_raises_and_lookup_miss_emits(event_log):
    nodes = build_cluster(["namesa", "namesb"])
    a, b = nodes
    try:
        connect_mesh(nodes)
        cell1 = a.system.spawn_system_raw(Collector(), "svc-one")
        cell2 = a.system.spawn_system_raw(Collector(), "svc-two")
        a.fabric.register_name("svc", cell1)
        a.fabric.register_name("svc", cell1)  # same cell: idempotent
        with pytest.raises(DuplicateNameError) as exc:
            a.fabric.register_name("svc", cell2)
        assert exc.value.rule == "fabric.name_duplicate"
        assert exc.value.payload["name"] == "svc"
        # Lookup of a name the peer never advertised: structured error
        # (still a KeyError for legacy retry loops) + lookup_miss event.
        with pytest.raises(NameLookupError):
            b.fabric.lookup(a.address, "no-such-name")
        with pytest.raises(KeyError):
            b.fabric.lookup(a.address, "no-such-name")
        misses = event_log.of(events.LOOKUP_MISS)
        assert len(misses) >= 2 and misses[0]["lookup"] == "no-such-name"
    finally:
        terminate_all(nodes)


# ------------------------------------------------------------------- #
# Integration: passivation and migration
# ------------------------------------------------------------------- #


def test_single_node_passivation_resurrects_state(event_log):
    config = dict(BASE, **{"uigc.crgc.num-nodes": 1})
    system = ActorSystem(None, name="passv", config=config)
    try:
        cluster = ClusterSharding.attach(system)
        region = cluster.start("counter", counter_factory, passivate_after_s=0.15)
        for i in range(8):
            ref = region.entity_ref(f"k{i}")
            for _ in range(i + 1):
                ref.tell(("incr",))
        assert settle(lambda: region.active_count() == 8, timeout_s=5.0)
        live_before = system.live_actor_count
        # Idle out: every entity spills and stops.
        assert settle(lambda: region.passive_count() == 8), (
            region.active_count(),
            region.passive_count(),
        )
        assert region.active_count() == 0
        assert settle(lambda: system.live_actor_count <= live_before - 8)
        assert len(event_log.of(events.SHARD_ENTITY_PASSIVATED)) >= 8
        # Next send resurrects with state intact.
        coll = Collector()
        coll_cell = system.spawn_system_raw(coll, "coll")
        for i in range(8):
            region.entity_ref(f"k{i}").tell(("probe", coll_cell))
        assert settle(lambda: len(coll.snapshot()) == 8)
        assert coll.snapshot() == {f"k{i}": i + 1 for i in range(8)}
        resumed = [
            f
            for f in event_log.of(events.SHARD_ENTITY_ACTIVATED)
            if f.get("resumed")
        ]
        assert len(resumed) >= 8
    finally:
        system.terminate()


def test_two_node_join_migrates_live_state(event_log):
    """Entities spawn on a lone node; a second node joins; the shard
    table rebalances and the moved entities carry their state across
    the wire, answering probes from either side afterwards."""
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = 2
    a = Node("joina", config)
    b = None
    try:
        keys = [f"k{i}" for i in range(40)]
        for k in keys:
            ref = a.region.entity_ref(k)
            ref.tell(("incr",))
            ref.tell(("incr",))
        assert settle(lambda: a.region.active_count() == 40, timeout_s=10.0)

        b = Node("joinb", config)
        a.fabric.connect("127.0.0.1", b.port)
        assert settle(
            lambda: a.cluster.migrations.pending_count() == 0
            and a.region.active_count() + b.region.active_count() == 40
            and b.region.active_count() > 0,
            timeout_s=15.0,
        ), (a.region.active_count(), b.region.active_count())
        assert a.cluster.migrations.completed == b.region.active_count()
        migrations = event_log.of(events.SHARD_MIGRATION)
        assert len(migrations) == b.region.active_count()
        assert all(f["duration_s"] > 0 for f in migrations)

        # Both nodes agree on the table and answer probes for ALL keys.
        assert a.cluster.table_snapshot().version == b.cluster.table_snapshot().version
        coll = Collector()
        coll_cell = b.system.spawn_system_raw(coll, "coll")
        for k in keys:
            b.cluster.entity_ref("counter", k).tell(("probe", coll_cell))
        assert settle(lambda: len(coll.snapshot()) == 40, timeout_s=15.0)
        assert all(v == 2 for v in coll.snapshot().values()), coll.snapshot()
    finally:
        terminate_all([n for n in (a, b) if n is not None])


def test_deliver_local_rechecks_ownership_before_blank_spawn(event_log):
    """The rebalance-under-traffic lost-incr race, pinned: a sender
    thread that resolved the key's home BEFORE a handoff completed must
    not blank-spawn the key at the OLD owner — deliver_local rechecks
    the table at the spawn boundary and re-routes instead."""
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = 2
    a = Node("recheck-a", config)
    b = None
    try:
        b = Node("recheck-b", config)
        a.fabric.connect("127.0.0.1", b.port)
        assert settle(
            lambda: len(a.cluster.members()) == 2
            and len(b.cluster.members()) == 2
            and a.cluster.table_snapshot().version
            == b.cluster.table_snapshot().version,
            timeout_s=15.0,
        )
        key = next(
            k
            for k in (f"k{i}" for i in range(400))
            if a.cluster.home_of(k) == b.address
        )
        # Simulate the stale race deterministically: the caller's
        # home_of read happened "before" the rebalance — deliver
        # straight into A's region although the table names B.
        a.region.deliver_local(key, ("incr",))
        assert key not in a.region.record_keys()
        forwarded = [
            f
            for f in event_log.of(events.SHARD_FORWARDED)
            if f.get("site") == "spawn_recheck"
        ]
        assert forwarded and forwarded[0]["key"] == key
        # The message re-routed to the real owner — nothing lost.
        assert settle(lambda: b.region.active_count() == 1, timeout_s=15.0)
        coll = Collector()
        coll_cell = a.system.spawn_system_raw(coll, "coll")
        a.cluster.entity_ref("counter", key).tell(("probe", coll_cell))
        assert settle(lambda: coll.snapshot().get(key) == 1, timeout_s=15.0)
    finally:
        terminate_all([n for n in (a, b) if n is not None])


def test_rebalance_under_traffic_loses_no_state(event_log):
    """The shard-grant protocol: a node join mid-traffic must not let
    an on-demand spawn at the new owner race (and discard) the in-flight
    migration snapshot.  Every incr sent is reflected in the final
    counts — no state conflict, no loss."""
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = 2
    # A loaded CI host can stretch the 60-key handoff past the default
    # 3s hold-timeout, and an expired hold reopens the blank-spawn-vs-
    # in-flight-snapshot race at the NEW owner (the old-owner side is
    # closed by deliver_local's ownership recheck).  The timeout is a
    # wedge safety valve, not a pacing device — give it slack, as the
    # rolling-restart scenario already does.
    config["uigc.cluster.hold-timeout"] = 15000
    a = Node("granta", config)
    b = None
    try:
        keys = [f"k{i}" for i in range(60)]
        sent = {k: 0 for k in keys}
        for k in keys:
            a.region.entity_ref(k).tell(("incr",))
            sent[k] += 1
        assert settle(lambda: a.region.active_count() == 60)

        # Join B while hammering the keyspace from A's side.
        stop = threading.Event()

        def churn():
            i = 0
            while not stop.is_set():
                k = keys[i % len(keys)]
                a.cluster.entity_ref("counter", k).tell(("incr",))
                sent[k] += 1
                i += 1
                time.sleep(0.001)

        churner = threading.Thread(target=churn, daemon=True)
        churner.start()
        b = Node("grantb", config)
        a.fabric.connect("127.0.0.1", b.port)
        assert settle(
            lambda: a.cluster.migrations.pending_count() == 0
            and b.region.active_count() > 0,
            timeout_s=15.0,
        )
        stop.set()
        churner.join(timeout=5)

        coll = Collector()
        coll_cell = a.system.spawn_system_raw(coll, "coll")
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            for k in keys:
                if coll.snapshot().get(k) != sent[k]:
                    a.cluster.entity_ref("counter", k).tell(("probe", coll_cell))
            if all(coll.snapshot().get(k) == sent[k] for k in keys):
                break
            time.sleep(0.3)
        got = coll.snapshot()
        lost = {k: (got.get(k), sent[k]) for k in keys if got.get(k) != sent[k]}
        assert not lost, f"state lost across rebalance: {lost}"
        assert not event_log.of(events.SHARD_STATE_CONFLICT)
    finally:
        terminate_all([n for n in (a, b) if n is not None])


def test_passivated_state_ships_on_rebalance(event_log):
    """A PASSIVATED entity's spilled snapshot must follow its key to
    the new owner on rebalance — otherwise the store copy strands on
    the old node and the new owner recreates the entity blank."""
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = 2
    a = Node("spassa", config, passivate_after_s=0.12)
    b = None
    try:
        keys = [f"k{i}" for i in range(20)]
        for i, k in enumerate(keys):
            ref = a.region.entity_ref(k)
            for _ in range(i + 1):
                ref.tell(("incr",))
        # Idle out: everything spills to A's store.
        assert settle(lambda: a.region.passive_count() == 20, timeout_s=10.0)

        b = Node("spassb", config, passivate_after_s=None)
        a.fabric.connect("127.0.0.1", b.port)
        # B's share of the keyspace must arrive as shipped snapshots
        # (applied straight into active cells), not blank respawns.
        assert settle(
            lambda: a.cluster.migrations.pending_count() == 0
            and len(b.cluster.members()) == 2
            and b.region.active_count() + b.region.passive_count() > 0,
            timeout_s=15.0,
        )
        coll = Collector()
        coll_cell = b.system.spawn_system_raw(coll, "coll")
        for k in keys:
            b.cluster.entity_ref("counter", k).tell(("probe", coll_cell))
        assert settle(lambda: len(coll.snapshot()) == 20, timeout_s=15.0)
        assert coll.snapshot() == {f"k{i}": i + 1 for i in range(20)}, (
            coll.snapshot()
        )
    finally:
        terminate_all([n for n in (a, b) if n is not None])


def test_entity_ref_crosses_the_wire_inside_a_message():
    """An EntityRef shipped inside a message re-binds to the receiving
    node's region (wire token ("entity", type, key)) and keeps routing
    location-transparently."""
    nodes = build_cluster(["xrefa", "xrefb"])
    a, b = nodes
    try:
        connect_mesh(nodes)
        assert settle(lambda: len(a.cluster.members()) == 2)
        keys = [f"k{i}" for i in range(100)]
        on_a = next(k for k in keys if a.cluster.home_of(k) == a.address)
        on_b = next(k for k in keys if a.cluster.home_of(k) == b.address)
        # Seed the A-homed counter, then teach the B-homed one to poke it.
        a.cluster.entity_ref("counter", on_a).tell(("incr",))
        peer_ref = a.cluster.entity_ref("counter", on_a)
        a.cluster.entity_ref("counter", on_b).tell(("adopt", peer_ref))
        a.cluster.entity_ref("counter", on_b).tell(("poke-peer",))
        coll = Collector()
        coll_cell = a.system.spawn_system_raw(coll, "coll")
        assert settle(
            lambda: (
                a.cluster.entity_ref("counter", on_a).tell(("probe", coll_cell))
                or coll.snapshot().get(on_a) == 2
            ),
            timeout_s=15.0,
        ), coll.snapshot()
    finally:
        terminate_all(nodes)


def test_shard_metrics_exported(event_log):
    """The metrics satellite: shard-table size, entity counts, and the
    migration latency histogram all land in the Prometheus text."""
    from uigc_tpu_torch.telemetry import prometheus_text

    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = 2
    config["uigc.telemetry.metrics"] = True
    a = Node("meta", config)
    b = None
    try:
        for i in range(20):
            a.region.entity_ref(f"k{i}").tell(("incr",))
        assert settle(lambda: a.region.active_count() == 20)
        b = Node("metb", config)
        a.fabric.connect("127.0.0.1", b.port)
        assert settle(
            lambda: a.cluster.migrations.pending_count() == 0
            and b.region.active_count() > 0
            and a.cluster.migrations.completed > 0,
            timeout_s=15.0,
        )
        text = prometheus_text(a.system.telemetry.registry)
        assert "uigc_shard_table_size" in text
        assert "uigc_shard_entities_active" in text
        assert "uigc_shard_migrations_total" in text
        assert "uigc_shard_migration_seconds_count" in text
        reg = a.system.telemetry.registry
        assert reg.counter("uigc_shard_migrations_total").value() > 0
        hist = reg.histogram("uigc_shard_migration_seconds")
        # completed increments under the manager lock a hair BEFORE the
        # SHARD_MIGRATION event commits (migration.py), so the histogram
        # can trail by one for a moment — settle, don't race it.
        assert settle(
            lambda: hist.snapshot()["n"] == a.cluster.migrations.completed,
            timeout_s=5.0,
        )
        assert (
            reg.gauge("uigc_shard_table_size").samples()[0][2] == 32.0
        )
    finally:
        terminate_all([n for n in (a, b) if n is not None])


# ------------------------------------------------------------------- #
# Acceptance: 3-node chaos rebalance
# ------------------------------------------------------------------- #


def test_chaos_node_kill_rehomes_every_entity(event_log):
    """The acceptance scenario: >= 200 keyed entities across 3 nodes
    with traffic in flight; migration frames on the surviving pair are
    seeded to drop (the retry/dedup protocol must neither lose nor
    duplicate state); node C is killed mid-traffic; the heartbeat
    declares it dead, the shard table rebalances, and EVERY entity
    answers a post-rebalance probe — with the uigcsan sanitizer
    attached and reporting zero violations on the survivors."""
    plan = FaultPlan(1234)
    nodes = build_cluster(
        ["chshard-a", "chshard-b", "chshard-c"],
        plan=plan,
        overrides={
            "uigc.node.heartbeat-interval": 40,
            "uigc.node.phi-threshold": 6.0,
            "uigc.node.heartbeat-pause": 400,
            "uigc.analysis.sanitizer": True,
        },
    )
    a, b, c = nodes
    try:
        connect_mesh(nodes)
        assert settle(
            lambda: all(len(n.cluster.members()) == 3 for n in nodes),
            timeout_s=10.0,
        )
        # Seeded drops on the surviving pair's migration/ack frames:
        # handoffs triggered by the rebalance MUST survive frame loss.
        plan.drop(src=a.address, dst=b.address, kind=("mig", "miga"), prob=0.4, count=30)
        plan.drop(src=b.address, dst=a.address, kind=("mig", "miga"), prob=0.4, count=30)

        n_entities = 220
        keys = [f"user-{i}" for i in range(n_entities)]
        for i, key in enumerate(keys):
            nodes[i % 3].cluster.entity_ref("counter", key).tell(("incr",))
        assert settle(
            lambda: sum(n.region.active_count() for n in nodes) == n_entities,
            timeout_s=30.0,
        ), [n.region.active_count() for n in nodes]
        dead_keys = {k for k in keys if a.cluster.home_of(k) == c.address}
        assert dead_keys, "no entity homed on the doomed node?"

        # Kill C mid-traffic: links dark, engine stopped, sockets open —
        # only the heartbeat can see it (the phi-accrual detector).
        churn_stop = threading.Event()

        def churn():
            i = 0
            while not churn_stop.is_set():
                a.cluster.entity_ref("counter", keys[i % n_entities]).tell(("incr",))
                i += 1
                time.sleep(0.002)

        churner = threading.Thread(target=churn, daemon=True)
        churner.start()
        time.sleep(0.2)
        plan.isolate(c.address)
        c.system.engine.on_crash()

        assert settle(
            lambda: c.address not in a.cluster.members()
            and c.address not in b.cluster.members(),
            timeout_s=30.0,
        ), "heartbeat never declared C dead"
        churn_stop.set()
        churner.join(timeout=5)

        # Rebalance settles: survivors agree on a table without C, and
        # no handoff is stuck (the dropped mig frames were re-shipped).
        assert settle(
            lambda: a.cluster.migrations.pending_count() == 0
            and b.cluster.migrations.pending_count() == 0
            and a.cluster.table_snapshot().assignments
            == b.cluster.table_snapshot().assignments,
            timeout_s=30.0,
        )
        assert all(
            owner != c.address
            for owner in a.cluster.table_snapshot().assignments.values()
        )

        # EVERY entity answers a post-rebalance probe — C's entities
        # recreate on demand at their new home.
        coll = Collector()
        coll_cell = a.system.spawn_system_raw(coll, "coll")
        deadline = time.monotonic() + 45.0
        while time.monotonic() < deadline:
            missing = [k for k in keys if k not in coll.snapshot()]
            if not missing:
                break
            for k in missing:
                a.cluster.entity_ref("counter", k).tell(("probe", coll_cell))
            time.sleep(0.4)
        missing = [k for k in keys if k not in coll.snapshot()]
        assert not missing, f"{len(missing)} entities never answered: {missing[:5]}"

        # Nothing dropped silently: entities homed on the SURVIVORS
        # kept their state through the churn and the rebalance's live
        # migrations; entities homed on C lost exactly the in-memory
        # state that died with the node — and the messages that went
        # dark with it are the ones the drop accounting tallied (fault
        # plan drops on the isolated links + dead letters), visible in
        # the event stream rather than silently gone.
        counts = coll.snapshot()
        survivor_losses = [
            k for k in keys if k not in dead_keys and counts[k] < 1
        ]
        assert not survivor_losses, survivor_losses
        from uigc_tpu_torch.runtime.faults import DROP

        tallied_drops = sum(
            n for (action, src, _dst), n in plan.stats.items()
            if action == DROP
        )
        assert tallied_drops > 0 or event_log.of(events.FRAME_DROPPED)

        # GC soundness held throughout: the sanitizer saw no premature
        # terminate, no verdict mismatch — across live migrations, a
        # node death, and the rebalance.
        for node in (a, b):
            violations = node.system.sanitizer.violations
            assert not violations, [str(v) for v in violations]
    finally:
        terminate_all(nodes)


# ------------------------------------------------------------------- #
# Parity with the reference (uigc_tpu/cluster) on the same inputs
# ------------------------------------------------------------------- #

REF_BASE = {k: v for k, v in BASE.items() if k != "uigc.crgc.device"}
REF_BASE["uigc.crgc.shadow-graph"] = "array"


class _Pkg:
    """One package's cluster surface, so a harness runs on either."""

    def __init__(self, name, pkg, node_mod, wire_mod, config):
        self.name = name
        self.pkg = pkg
        self.node = node_mod
        self.wire = wire_mod
        self.config = config
        self.counter = _counter_class(pkg.Entity)


def _counter_class(entity_base):
    class _Counter(entity_base):
        def __init__(self, ctx, key, state):
            super().__init__(ctx, key)
            self.count = (state or {}).get("count", 0)

        def receive(self, msg):
            if msg[0] == "incr":
                self.count += 1
            elif msg[0] == "probe":
                msg[1].tell(("probed", self.key, self.count))
            return self

        def snapshot_state(self):
            return {"count": self.count}

    return _Counter


PORT = _Pkg("port", port_pkg, port_node, wire, BASE)
REF = _Pkg("ref", ref_pkg, ref_node, ref_wire, REF_BASE)


class _PkgNode:
    def __init__(self, p, name, config, factory=None, type_name="counter"):
        self.fabric = p.node.NodeFabric()
        self.sent = []
        send = self.fabric.send_frame

        def recording_send(dst, frame, *args, **kwargs):
            self.sent.append(frame)
            return send(dst, frame, *args, **kwargs)

        self.fabric.send_frame = recording_send
        self.system = p.pkg.ActorSystem(None, name=name, config=config,
                                        fabric=self.fabric)
        self.port = self.fabric.listen()
        self.address = self.system.address
        self.cluster = p.pkg.ClusterSharding.attach(self.system)
        if factory is None:
            counter = p.counter
            factory = lambda ctx, key, state: counter(ctx, key, state)  # noqa: E731
        self.region = self.cluster.start(type_name, factory)


def _probe_counts(node, keys, expect=None, timeout_s=20.0,
                  type_name="counter"):
    """Probe every key until each answered (with ``expect[key]``, when
    given: a probe may overtake a command sent from another node)."""
    coll = Collector()
    cell = node.system.spawn_system_raw(coll, f"coll-{time.monotonic_ns()}")
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        snap = coll.snapshot()
        due = [k for k in keys if k not in snap
               or (expect is not None and snap[k] != expect[k])]
        if not due:
            break
        for k in due:
            node.cluster.entity_ref(type_name, k).tell(("probe", cell))
        time.sleep(0.2)
    return coll.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placement_equals_the_reference(seed):
    import numpy as np

    from uigc_tpu_torch.parallel import partition

    assert partition.shard_of is shard_of
    assert partition.rendezvous_assign is rendezvous_assign
    rng = np.random.default_rng(seed)
    keys = [f"key-{int(x)}" for x in rng.integers(0, 1 << 40, 2000)]
    for n in (1, 7, 32, 128):
        assert np.array_equal(
            np.array([shard_of(k, n) for k in keys]),
            np.array([ref_sharding.shard_of(k, n) for k in keys]),
        )
    for _ in range(20):
        m = int(rng.integers(1, 9))
        members = [f"uigc://n{int(x)}"
                   for x in rng.choice(1000, m, replace=False)]
        for num_shards in (32, 64):
            assert rendezvous_assign(members, num_shards) == (
                ref_sharding.rendezvous_assign(members, num_shards))


def test_shard_table_supersedes_equals_the_reference():
    import numpy as np

    rng = np.random.default_rng(5)
    specs = []
    for _ in range(60):
        specs.append((
            int(rng.integers(0, 4)),
            f"uigc://n{int(rng.integers(0, 3))}",
            {s: f"uigc://n{int(rng.integers(0, 3))}"
             for s in range(int(rng.integers(1, 4)))},
            int(rng.integers(0, 3)),
        ))
    verdicts = set()
    for a in specs:
        for b in specs:
            mine = ShardTable(*a).supersedes(ShardTable(*b))
            assert mine == ref_sharding.ShardTable(*a).supersedes(
                ref_sharding.ShardTable(*b)), (a, b)
            verdicts.add(mine)
    assert verdicts == {True, False}


def _arbiter_verdicts(arbiter_cls, strategy, members, cut, stamps, quorum):
    out = {}
    for address in members:
        arb = arbiter_cls(address, strategy=strategy, settle_s=0.0,
                          quorum_size=quorum)
        for peer in members:
            if peer != address:
                arb.on_member_up(peer)
        arb.merge_stamps(stamps)
        side = cut if address in cut else [m for m in members
                                           if m not in cut]
        tracked = [arb.track_unreachable(p) for p in members
                   if p not in side]
        d = arb.poll(now=time.monotonic() + 60.0)
        out[address] = (
            tracked,
            None if d is None else (d.strategy, d.survived, d.downed,
                                    d.live, d.seen, d.fence, d.reason),
            arb.fence, arb.quarantined, arb.view(),
        )
    return out


@pytest.mark.parametrize("strategy", ref_membership.STRATEGIES)
def test_arbiter_verdicts_equal_the_reference(strategy):
    import numpy as np

    assert port_membership.STRATEGIES == ref_membership.STRATEGIES
    rng = np.random.default_rng(len(strategy))
    decided = 0
    for _ in range(25):
        size = int(rng.integers(2, 8))
        members = [f"uigc://m{int(x)}"
                   for x in rng.choice(100, size, replace=False)]
        cut = [m for m in members if rng.random() < 0.4] or members[:1]
        stamps = {m: 1000 + int(rng.integers(0, 50)) for m in members}
        quorum = int(rng.integers(0, size + 1))
        mine = _arbiter_verdicts(port_membership.MembershipArbiter,
                                 strategy, members, cut, stamps, quorum)
        theirs = _arbiter_verdicts(ref_membership.MembershipArbiter,
                                   strategy, members, cut, stamps, quorum)
        assert mine == theirs, (members, cut, stamps, quorum)
        decided += sum(v[1] is not None for v in mine.values())
    assert decided > 0


def _shard_frames(w, rng):
    """One frame of every shard kind, encoded by ``w`` from draws of
    ``rng``."""
    members = [f"uigc://n{int(rng.integers(0, 9))}" for _ in range(3)]
    assignments = {s: members[int(rng.integers(0, 3))] for s in range(32)}
    payload = bytes(int(b) for b in rng.integers(0, 256, 40))
    fence = int(rng.integers(0, 5))
    mig_id = (members[0], int(rng.integers(0, 1000)))
    return [
        w.encode_shard_frame(int(rng.integers(1, 99)), members[0],
                             assignments, fence),
        w.encode_entity_frame("counter", "k7", int(rng.integers(0, 4)),
                              payload, fence),
        w.encode_migration_frame("counter", "k7", mig_id, payload, fence,
                                 int(rng.integers(0, 1 << 40))),
        w.encode_migration_ack("counter", "k7", mig_id),
        w.encode_shard_grant(int(rng.integers(0, 32)), members[1], fence),
        w.encode_shard_leave(members[2]),
        w.encode_mship(members[0], fence, members,
                       {m: 1000 + i for i, m in enumerate(members)},
                       bool(rng.integers(0, 2)), int(rng.integers(0, 99))),
    ]


def _decode(w, frame):
    return {
        "shard": w.decode_shard_frame,
        "ent": w.decode_entity_frame,
        "mig": w.decode_migration_frame,
        "miga": w.decode_migration_ack,
        "sgrant": w.decode_shard_grant,
        "sleave": w.decode_shard_leave,
        "mship": w.decode_mship,
    }[frame[0]](frame)


def _reencode(w, frame):
    """``frame`` decoded by ``w`` and encoded again from the fields."""
    d = _decode(w, frame)
    kind = frame[0]
    if kind == "shard":
        return w.encode_shard_frame(*d)
    if kind == "ent":
        return w.encode_entity_frame(*d)
    if kind == "mig":
        return w.encode_migration_frame(*d)
    if kind == "miga":
        return w.encode_migration_ack(*d)
    if kind == "sgrant":
        return w.encode_shard_grant(*d)
    if kind == "sleave":
        return w.encode_shard_leave(d)
    return w.encode_mship(d["origin"], d["fence"], d["members"],
                          d["stamps"], d["quarantined"], d["table_version"])


def test_shard_frame_codecs_equal_the_reference():
    import numpy as np

    assert wire.SHARD_FRAME_KINDS == ref_wire.SHARD_FRAME_KINDS
    for seed in range(20):
        mine = _shard_frames(wire, np.random.default_rng(seed))
        theirs = _shard_frames(ref_wire, np.random.default_rng(seed))
        assert [f[0] for f in mine] == list(wire.SHARD_FRAME_KINDS)
        for a, b in zip(mine, theirs):
            assert port_node._frame_bytes(("f", 7, a)) == (
                ref_node._frame_bytes(("f", 7, b)))
            assert _decode(wire, b) == _decode(ref_wire, b)
            assert _decode(ref_wire, a) == _decode(wire, a)


def _converged(nodes, n_members):
    """Every node sees ``n_members`` members, no handoff is pending, and
    every node holds the same table."""
    return (all(len(n.cluster.members()) == n_members for n in nodes)
            and all(n.cluster.migrations.pending_count() == 0
                    for n in nodes)
            and len({tuple(sorted(
                n.cluster.table_snapshot().assignments.items()))
                for n in nodes}) == 1)


@pytest.fixture(scope="module")
def three_node_runs():
    """The same three-node join, drive and drain on each package, with
    every frame each node sent: A and B take 60 keys, C joins (a live
    rebalance), B sends to every key, C drains."""
    runs = {}
    for p in (REF, PORT):
        config = dict(p.config, **{"uigc.crgc.num-nodes": 3})
        nodes = [_PkgNode(p, n, config) for n in ("tbl-a", "tbl-b")]
        try:
            a, b = nodes
            a.fabric.connect("127.0.0.1", b.port)
            # Traffic starts once A and B agree on the table: a key sent
            # before that can be activated on both sides.
            assert settle(lambda: _converged(nodes, 2))
            keys = [f"k{i}" for i in range(60)]
            for i, k in enumerate(keys):
                nodes[i % 2].cluster.entity_ref("counter", k).tell(("incr",))
            assert settle(lambda: a.region.active_count()
                          + b.region.active_count() == 60)
            c = _PkgNode(p, "tbl-c", config)
            nodes.append(c)
            a.fabric.connect("127.0.0.1", c.port)
            b.fabric.connect("127.0.0.1", c.port)
            assert settle(lambda: _converged(nodes, 3)
                          and c.region.active_count() > 0)
            table = dict(a.cluster.table_snapshot().assignments)
            for k in keys:
                b.cluster.entity_ref("counter", k).tell(("incr",))
            full = {k: 2 for k in keys}
            counts = _probe_counts(a, keys, expect=full)
            assert c.cluster.drain(timeout_s=20.0)
            after = _probe_counts(a, keys, expect=full)
            runs[p.name] = {
                "table": table,
                "members": sorted(n.address for n in nodes),
                "counts": counts,
                "after_drain": after,
                "sent": [f for n in nodes for f in n.sent
                         if f and f[0] in ref_wire.SHARD_FRAME_KINDS],
            }
        finally:
            for n in nodes:
                try:
                    n.system.terminate(timeout_s=5.0)
                except Exception:
                    pass
    return runs


def test_three_node_table_equals_the_reference(three_node_runs):
    mine, theirs = three_node_runs["port"], three_node_runs["ref"]
    assert mine["members"] == theirs["members"]
    assert mine["table"] == theirs["table"]
    assert mine["table"] == ref_sharding.rendezvous_assign(
        theirs["members"], 32)
    for run in (mine, theirs):
        assert run["counts"] == {f"k{i}": 2 for i in range(60)}
        assert run["after_drain"] == run["counts"]


class _TokenFabric:
    """Resolves every cell token to itself, so a payload decodes without
    a live system."""

    @staticmethod
    def resolve_cell_token(address, uid):
        return ("cell", address, uid)


@pytest.mark.parametrize("sender", ["port", "ref"])
def test_sent_shard_frames_decode_in_the_other_package(three_node_runs,
                                                       sender):
    """Every shard frame a live cluster of one package sent is read by
    the other package's decoder as by its own, and the other package
    encodes the decoded fields back to the same bytes."""
    mine_w, other_w = (wire, ref_wire) if sender == "port" else (ref_wire,
                                                                 wire)
    sent = three_node_runs[sender]["sent"]
    assert {f[0] for f in sent} == set(ref_wire.SHARD_FRAME_KINDS)
    for frame in sent:
        assert _decode(other_w, frame) == _decode(mine_w, frame), frame[0]
        again = _reencode(other_w, frame)
        assert port_node._frame_bytes(again) == (
            ref_node._frame_bytes(frame)), frame[0]
        if frame[0] == "ent":
            payload = _decode(mine_w, frame)[3]
            assert other_w.decode_message(_TokenFabric(), payload) == (
                mine_w.decode_message(_TokenFabric(), payload))


def _journal_script(jmod, wmod, root):
    """One scripted history, written with package ``jmod``'s journal:
    snapshots and commands over three shards, periodic snapshots and
    segment rolls, a torn tail, and a fence conflict between two
    writers.  The wall-clock epoch floor is replaced by a counter, so
    two packages running the script write the same bytes."""
    enc = wmod.encode_message
    w1 = jmod.EntityJournal(root, "uigc://w1", fsync="never",
                            segment_bytes=600, snapshot_every=4)
    for i in range(6):
        key, shard = f"k{i}", i % 3
        w1.open_epoch("counter", shard, key, enc({"count": 0}))
        for n in range(1, 7):
            if w1.note_command("counter", shard, key, enc(("incr",))):
                epoch = w1.begin_snapshot("counter", shard, key)
                w1.commit_snapshot("counter", shard, key, epoch,
                                   enc({"count": n}))
    w1.checkpoint()
    # a fence conflict on k0: the survivor bumps its fence and activates,
    # the minority keeps appending under the old fence
    w2 = jmod.EntityJournal(root, "uigc://w2", fsync="never")
    w2.set_fence(1)
    w2.open_epoch("counter", 0, "k0", enc({"count": 100}))
    w2.note_command("counter", 0, "k0", enc(("incr",)))
    w2.checkpoint()
    epoch = w1.begin_snapshot("counter", 0, "k0")
    w1.commit_snapshot("counter", 0, "k0", epoch, enc({"count": -1}))
    w1.note_command("counter", 0, "k0", enc(("divergent",)))
    w1.checkpoint()
    # a torn tail: the writer of k1 dies inside its third append
    appends = []

    def tear(size):
        appends.append(size)
        return size // 2 if len(appends) == 3 else None

    w3 = jmod.EntityJournal(root, "uigc://w3", fsync="never", fault_fn=tear)
    w3.open_epoch("counter", 1, "k1", enc({"count": 50}))
    w3.note_command("counter", 1, "k1", enc(("incr",)))
    w3.note_command("counter", 1, "k1", enc(("lost",)))
    for j in (w1, w2, w3):
        j.close()


def _journal_files(root):
    import os

    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _replay(jmod, root):
    reader = jmod.EntityJournal(root, "uigc://reader", fsync="never")
    try:
        out = {}
        for shard in reader.shards("counter"):
            for key in reader.keys_for_shard("counter", shard):
                out[key] = reader.recover("counter", shard, key)
        return out, reader.torn_records, reader.fence_conflicts
    finally:
        reader.close()


def test_journal_files_and_replay_equal_the_reference(tmp_path,
                                                      monkeypatch):
    """The same history written by each package's ``EntityJournal``
    gives byte-identical segment files, and each package's
    ``EntityJournal.recover`` replays the other's directory to the
    same snapshot and commands (torn tail and fence conflict
    included)."""
    import itertools

    for jmod in (ref_journal, port_journal):
        counter = itertools.count(1000)
        monkeypatch.setattr(jmod, "_epoch_floor", lambda c=counter: next(c))
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    _journal_script(ref_journal, ref_wire, ref_root)
    _journal_script(port_journal, wire, port_root)
    ref_files = _journal_files(ref_root)
    assert len(ref_files) > 6
    assert _journal_files(port_root) == ref_files
    replays = {(r, j.__name__): _replay(j, root)
               for r, root in (("ref", ref_root), ("port", port_root))
               for j in (ref_journal, port_journal)}
    first = next(iter(replays.values()))
    assert all(v == first for v in replays.values())
    recovered, torn, conflicts = first
    assert torn == 1 and conflicts > 0
    assert set(recovered) == {f"k{i}" for i in range(6)}
    decode = lambda blob: wire.decode_message(None, blob)  # noqa: E731
    state, cmds = recovered["k0"]
    assert decode(state) == {"count": 100}
    assert [decode(c) for c in cmds] == [("incr",)]
    state, cmds = recovered["k1"]
    assert decode(state) == {"count": 50}
    assert [decode(c) for c in cmds] == [("incr",)]
    state, cmds = recovered["k2"]
    assert decode(state) == {"count": 4}
    assert [decode(c) for c in cmds] == [("incr",), ("incr",)]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_journaled_state_recovers_in_the_other_package(tmp_path, writer,
                                                       reader):
    """Entity state one package's live node journaled is the state the
    other package's node recovers on activation
    (``ShardRegion._recover_from_journal``), snapshots and the command
    tail replayed alike."""
    pkgs = {"ref": REF, "port": PORT}
    keys = [f"k{i}" for i in range(24)]
    overrides = {"uigc.crgc.num-nodes": 1,
                 "uigc.cluster.journal-dir": str(tmp_path),
                 "uigc.cluster.journal-snapshot-every": 5}
    w = _PkgNode(pkgs[writer], "jrnl-w",
                 dict(pkgs[writer].config, **overrides))
    try:
        for i, k in enumerate(keys):
            for _ in range(i + 1):
                w.cluster.entity_ref("counter", k).tell(("incr",))
        expect = {k: i + 1 for i, k in enumerate(keys)}
        written = _probe_counts(w, keys, expect=expect)
        assert written == expect
    finally:
        w.system.terminate(timeout_s=5.0)
    r = _PkgNode(pkgs[reader], "jrnl-r",
                 dict(pkgs[reader].config, **overrides))
    try:
        assert _probe_counts(r, keys) == written
        assert r.cluster.journal.recovered_entities == len(keys)
    finally:
        r.system.terminate(timeout_s=5.0)


# ------------------------------------------------------------------- #
# A child held in a migrated snapshot
# ------------------------------------------------------------------- #


class PortHello(port_pkg.NoRefs):
    def __init__(self, reply, key):
        self.reply = reply
        self.key = key


class RefHello(ref_pkg.NoRefs):
    def __init__(self, reply, key):
        self.reply = reply
        self.key = key


class _HelloSink(RawBehavior):
    def __init__(self):
        self.keys = []

    def on_message(self, msg):
        if isinstance(msg, tuple) and msg[0] == "hello":
            self.keys.append(msg[1])


def _held_child_run(p, hello_cls):
    """Entities spawn a child on activation and keep its Refob in their
    snapshot; a second node joins and a share of them migrates.  Returns
    the moved keys, the paths of the children that stopped, what each
    incarnation answers about its child, and which children answered a
    message sent through the held ref."""
    pkg = p.pkg
    stopped = []

    class Child(pkg.AbstractBehavior):
        def on_message(self, msg):
            msg.reply.tell(("hello", msg.key))
            return self

        def on_signal(self, signal):
            if signal is pkg.PostStop:
                stopped.append(self.context.cell.path)
            return self

    class Holder(pkg.Entity):
        def __init__(self, ctx, key, state):
            super().__init__(ctx, key)
            self.child = (state or {}).get("child")
            self.restored = self.child is not None
            if self.child is None:
                self.child = ctx.spawn(pkg.Behaviors.setup(Child),
                                       f"child-{key}")

        def receive(self, msg):
            if msg[0] == "ask-child":
                self.child.tell(hello_cls(msg[1], self.key), self.context)
            elif msg[0] == "probe":
                target = self.child.target
                msg[1].tell(("probed", self.key, (
                    self.restored, type(target).__name__,
                    getattr(target, "system", None) is self.context.system)))
            return self

        def snapshot_state(self):
            return {"child": self.child}

    config = dict(p.config, **{"uigc.crgc.num-nodes": 2})
    factory = lambda ctx, key, state: Holder(ctx, key, state)  # noqa: E731
    a = _PkgNode(p, "held-a", config, factory, "holder")
    b = None
    try:
        keys = [f"k{i}" for i in range(16)]
        for k in keys:
            a.cluster.entity_ref("holder", k).tell(("activate",))
        assert settle(lambda: a.region.active_count() == 16)
        b = _PkgNode(p, "held-b", config, factory, "holder")
        a.fabric.connect("127.0.0.1", b.port)
        assert settle(lambda: _converged([a, b], 2)
                      and b.region.active_count() > 0)
        moved = sorted(k for k in keys if a.cluster.home_of(k) == b.address)
        # Hold for many collector wakes: no live incarnation's child may
        # be collected meanwhile.
        time.sleep(0.6)
        answers = _probe_counts(b, keys, type_name="holder")
        sink = _HelloSink()
        cell = b.system.spawn_system_raw(sink, "hellos")
        for k in keys:
            b.cluster.entity_ref("holder", k).tell(("ask-child", cell))
        settle(lambda: len(sink.keys) == len(keys), timeout_s=3.0)
        return moved, sorted(stopped), answers, sorted(sink.keys)
    finally:
        terminate_all([n for n in (a, b) if n is not None])


def test_a_held_child_across_a_migration():
    """A capture stops the old incarnation, which stops its children
    first, so a child kept in the snapshot stops with it on both
    packages.  The reference then hands the new incarnation a ref to
    that stopped actor (a ProxyCell to the old node): messages sent
    through it are lost.  The port's capture replaces a ref to the
    incarnation's own descendant with None (``captured_state``), so the
    new incarnation spawns a child of its own that answers.  Neither
    package collects the child of a live incarnation."""
    ref_moved, ref_stopped, ref_answers, ref_hellos = _held_child_run(
        REF, RefHello)
    moved, stopped, answers, hellos = _held_child_run(PORT, PortHello)
    keys = [f"k{i}" for i in range(16)]
    assert moved == ref_moved and moved
    # The same children stop on both packages: exactly the moved
    # incarnations' children, with their old parents.
    assert [s.rsplit("/", 1)[1] for s in stopped] == sorted(
        f"child-{k}" for k in moved)
    assert [s.rsplit("/", 1)[1] for s in ref_stopped] == sorted(
        f"child-{k}" for k in moved)
    for k in keys:
        if k in moved:
            assert ref_answers[k] == (True, "ProxyCell", False)
            assert answers[k] == (False, "ActorCell", True)
        else:
            assert ref_answers[k] == answers[k] == (False, "ActorCell", True)
    assert ref_hellos == sorted(k for k in keys if k not in moved)
    assert hellos == sorted(keys)


# ------------------------------------------------------------------- #
# An entity frame that overtakes the receiver's MemberUp
# ------------------------------------------------------------------- #


def _early_frame_run(p):
    """A hosts a key with count 1; B, still alone (its seed table claims
    every shard), receives from A an entity frame for that key, as when
    A's table names B before B has processed A's MemberUp; then the two
    connect and A hands the key off to B.  Returns (B's active entities
    right after the frame, the key's count once the tables agree)."""
    config = dict(p.config, **{"uigc.crgc.num-nodes": 2})
    a = _PkgNode(p, "early-a", config)
    b = None
    try:
        key = next(k for k in (f"k{i}" for i in range(400))
                   if rendezvous_assign([a.address, "uigc://early-b"], 32)[
                       shard_of(k, 32)] == "uigc://early-b")
        a.cluster.entity_ref("counter", key).tell(("incr",))
        assert settle(lambda: a.region.active_count() == 1)
        b = _PkgNode(p, "early-b", config)
        frame = p.wire.encode_entity_frame(
            "counter", key, 0, p.wire.encode_message(("incr",)), 0)
        b.cluster._on_transport_frame(a.address, frame)
        active_early = b.region.active_count()
        a.fabric.connect("127.0.0.1", b.port)
        assert settle(lambda: _converged([a, b], 2)
                      and b.region.active_count() == 1)
        counts = _probe_counts(a, [key], expect={key: 2}, timeout_s=3.0)
        return active_early, counts[key]
    finally:
        terminate_all([n for n in (a, b) if n is not None])


def test_an_entity_frame_before_the_member_up_waits_for_the_table():
    """The reference delivers the frame at once: the key spawns blank on
    B, A's handoff of its state then loses to it (``shard.state_conflict``)
    and the count is 1.  The port parks the frame until B's table
    includes A (``ClusterSharding._park_early``), then routes it behind
    the handoff: the count is 2."""
    assert _early_frame_run(REF) == (1, 1)
    assert _early_frame_run(PORT) == (0, 2)
