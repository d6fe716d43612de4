"""Partition tolerance on the port (``uigc_tpu_torch/cluster/``): the
port's counterpart of ``tests/test_partition.py``, test for test, with
the collectors on the ``device`` shadow graph and ``uigc.crgc.device``
"cpu".  The reference's UL013 lint test waits for the port's static
analyzers (ROADMAP.md Queue 1 item 10b); the arbiter's verdicts are
held against the reference's in ``tests/test_torch_cluster.py``.

Split-brain resolution, fencing, heal-time merge, end to end:

- fault layer: asymmetric (one-way) partitions and scheduled heals
  (``FaultPlan.partition(oneway=True)`` / ``heal_after``);
- arbiter units: every strategy (keep-majority incl. the 50/50
  tie-break, static-quorum, keep-oldest via merged join stamps,
  down-all) reaching COMPLEMENTARY verdicts on both halves, and the
  below-``sbr-min-members`` legacy escape;
- fencing units: fence-first shard-table ordering, the ``mship``
  handshake codec (tolerant both directions), journal records carrying
  fences with the recovery-time conflict rule (lower-fence records
  that claim to supersede a higher-fence base are quarantined, plain
  history replays), and the frozen append plane refusing stale writes;
- chaos matrix (3-node NodeFabric clusters under traffic): symmetric,
  asymmetric and flapping partitions x SBR strategies, asserting that
  exactly ONE side serves each shard, the loser quarantines (drained
  to the journal, zero active entities), the uigcsan sanitizer stays
  clean on the survivors, and — after the heal — the rejoined peer
  re-enters placement with every key answering at full count.
"""

import threading
import time

import pytest

from uigc_tpu_torch import ActorSystem, ClusterSharding, Entity
from uigc_tpu_torch.cluster.journal import EntityJournal
from uigc_tpu_torch.cluster.membership import MembershipArbiter
from uigc_tpu_torch.cluster.sharding import ShardTable
from uigc_tpu_torch.runtime import wire
from uigc_tpu_torch.runtime.behaviors import RawBehavior
from uigc_tpu_torch.runtime.faults import FaultPlan
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.utils import events

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.shadow-graph": "device",
    "uigc.crgc.device": "cpu",
    "uigc.cluster.tick-interval": 40,
    "uigc.cluster.handoff-retry": 120,
    "uigc.cluster.sbr-settle": 150,
    "uigc.node.heartbeat-interval": 40,
    # Lenient detector: the tier-1 suite runs these 3-node chaos tests
    # on a fully loaded host, where scheduler stalls of several hundred
    # ms are routine — a tight pause turns them into false verdicts
    # that cascade into spurious splits before the scripted one.
    "uigc.node.phi-threshold": 6.0,
    "uigc.node.heartbeat-pause": 700,
    "uigc.analysis.sanitizer": True,
}


def settle(predicate, timeout_s=25.0, interval_s=0.05):
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


class Counter(Entity):
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


def counter_factory(ctx, key, state):
    return Counter(ctx, key, state)


class Collector(RawBehavior):
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

    def __init__(self, name, config, plan=None):
        self.fabric = NodeFabric(fault_plan=plan)
        self.system = ActorSystem(None, name=name, config=config, fabric=self.fabric)
        self.port = self.fabric.listen()
        self.address = self.system.address
        self.cluster = ClusterSharding.attach(self.system)
        self.region = self.cluster.start("counter", counter_factory)


def build_cluster(names, plan=None, overrides=None, join_gap_s=0.0):
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = len(names)
    if overrides:
        config.update(overrides)
    nodes = []
    for name in names:
        nodes.append(Node(name, config, plan))
        if join_gap_s:
            time.sleep(join_gap_s)  # distinct keep-oldest join stamps
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


def sanitizer_violations(node):
    san = getattr(node.system, "sanitizer", None)
    return list(san.violations) if san is not None else []


# ------------------------------------------------------------------- #
# Fault layer: one-way cuts + scheduled heals
# ------------------------------------------------------------------- #


def test_oneway_partition_drops_single_direction():
    plan = FaultPlan(7)
    plan.partition("uigc://a", "uigc://b", oneway=True)
    assert plan.outbound("uigc://a", "uigc://b", "app")[0] == "drop"
    assert plan.outbound("uigc://b", "uigc://a", "app")[0] == "deliver"
    # inbound verdicts agree with outbound ones
    assert plan.drop_inbound("uigc://a", "uigc://b", object())
    assert not plan.drop_inbound("uigc://b", "uigc://a", object())
    plan.heal("uigc://a", "uigc://b")
    assert plan.outbound("uigc://a", "uigc://b", "app")[0] == "deliver"


def test_oneway_isolate_silences_only_outbound():
    plan = FaultPlan(7)
    plan.isolate("uigc://c", oneway=True)
    assert plan.outbound("uigc://c", "uigc://a", "hb")[0] == "drop"
    assert plan.outbound("uigc://a", "uigc://c", "hb")[0] == "deliver"
    plan.heal("uigc://c", "*")
    assert plan.outbound("uigc://c", "uigc://a", "hb")[0] == "deliver"


def test_heal_after_schedules_mend():
    plan = FaultPlan(7)
    plan.partition("uigc://a", "uigc://b")
    plan.partition("uigc://a", "uigc://c", oneway=True)
    plan.heal_after(0.08)
    assert plan.outbound("uigc://a", "uigc://b", "app")[0] == "drop"
    time.sleep(0.1)
    # the due heal applies lazily on the next check, both cut kinds
    assert plan.outbound("uigc://a", "uigc://b", "app")[0] == "deliver"
    assert plan.outbound("uigc://a", "uigc://c", "app")[0] == "deliver"


def test_heal_after_specific_pair_leaves_other_cuts():
    plan = FaultPlan(7)
    plan.partition("uigc://a", "uigc://b")
    plan.partition("uigc://a", "uigc://c")
    plan.heal_after(0.05, "uigc://a", "uigc://b")
    time.sleep(0.08)
    assert plan.outbound("uigc://a", "uigc://b", "app")[0] == "deliver"
    assert plan.outbound("uigc://a", "uigc://c", "app")[0] == "drop"


# ------------------------------------------------------------------- #
# Arbiter units: complementary verdicts per strategy
# ------------------------------------------------------------------- #


def _halves(strategy, members, cut, **kw):
    """Build one arbiter per member, feed each side the other half's
    unreachability, and return {address: decision}."""
    arbiters = {}
    stamps = {}
    for i, address in enumerate(members):
        arb = MembershipArbiter(address, strategy=strategy, settle_s=0.01, **kw)
        arbiters[address] = arb
        stamps[address] = 1000 + i  # join order = seniority
    for address, arb in arbiters.items():
        for peer in members:
            if peer != address:
                arb.on_member_up(peer)
        arb.merge_stamps(stamps)
    decisions = {}
    for address, arb in arbiters.items():
        my_side = cut[0] if address in cut[0] else cut[1]
        other = cut[1] if address in cut[0] else cut[0]
        for peer in other:
            assert arb.track_unreachable(peer)
        time.sleep(0.02)
        decisions[address] = arb.poll()
        assert decisions[address] is not None, (strategy, address, my_side)
    return arbiters, decisions


def test_keep_majority_complementary_verdicts():
    members = ["uigc://a", "uigc://b", "uigc://c"]
    arbiters, decisions = _halves(
        "keep-majority", members, ({"uigc://a", "uigc://b"}, {"uigc://c"})
    )
    assert decisions["uigc://a"].survived and decisions["uigc://b"].survived
    assert not decisions["uigc://c"].survived
    assert arbiters["uigc://c"].quarantined
    # survivors bumped the fence, the loser froze
    assert arbiters["uigc://a"].fence == arbiters["uigc://b"].fence == 1
    assert arbiters["uigc://c"].fence == 0


def test_keep_majority_tie_keeps_lowest_address_side():
    members = ["uigc://aa", "uigc://ab", "uigc://ba", "uigc://bb"]
    _arb, decisions = _halves(
        "keep-majority",
        members,
        ({"uigc://aa", "uigc://ab"}, {"uigc://ba", "uigc://bb"}),
    )
    assert decisions["uigc://aa"].survived and decisions["uigc://ab"].survived
    assert not decisions["uigc://ba"].survived
    assert not decisions["uigc://bb"].survived


def test_static_quorum_strategy():
    members = ["uigc://a", "uigc://b", "uigc://c"]
    _arb, decisions = _halves(
        "static-quorum",
        members,
        ({"uigc://a", "uigc://b"}, {"uigc://c"}),
        quorum_size=2,
    )
    assert decisions["uigc://a"].survived
    assert not decisions["uigc://c"].survived
    # an unreachable quorum downs EVERY side
    _arb, decisions = _halves(
        "static-quorum",
        members,
        ({"uigc://a", "uigc://b"}, {"uigc://c"}),
        quorum_size=3,
    )
    assert not any(d.survived for d in decisions.values())


def test_keep_oldest_survives_even_in_minority():
    members = ["uigc://x", "uigc://y", "uigc://z"]
    # uigc://x has the earliest merged stamp: its SIDE survives even as
    # the 1-of-3 minority.
    _arb, decisions = _halves(
        "keep-oldest", members, ({"uigc://x"}, {"uigc://y", "uigc://z"})
    )
    assert decisions["uigc://x"].survived
    assert not decisions["uigc://y"].survived
    assert not decisions["uigc://z"].survived


def test_down_all_downs_every_side():
    members = ["uigc://a", "uigc://b", "uigc://c"]
    arbiters, decisions = _halves(
        "down-all", members, ({"uigc://a", "uigc://b"}, {"uigc://c"})
    )
    assert not any(d.survived for d in decisions.values())
    assert all(a.quarantined for a in arbiters.values())


def test_below_min_members_is_not_arbitrated():
    arb = MembershipArbiter("uigc://a", settle_s=0.01, min_members=3)
    arb.on_member_up("uigc://b")
    # 2-node topology: majority undefined — the verdict is immediate
    # (legacy availability semantics), never deferred or quarantined.
    assert not arb.track_unreachable("uigc://b")
    assert not arb.quarantined and arb.fence == 0


def test_flap_heal_before_settle_cancels_verdict():
    arb = MembershipArbiter("uigc://a", settle_s=0.2)
    arb.on_member_up("uigc://b")
    arb.on_member_up("uigc://c")
    assert arb.track_unreachable("uigc://c")
    # the peer reconnects before the settle window expires
    assert arb.on_member_up("uigc://c")
    time.sleep(0.25)
    assert arb.poll() is None
    assert arb.fence == 0 and not arb.quarantined


# ------------------------------------------------------------------- #
# Fencing units
# ------------------------------------------------------------------- #


def test_shard_table_fence_orders_before_lamport_pair():
    low = ShardTable(99, "uigc://a", {1: "uigc://a"}, fence=0)
    high = ShardTable(1, "uigc://b", {1: "uigc://b"}, fence=1)
    assert high.supersedes(low)
    assert not low.supersedes(high)
    # equal fences fall back to the (version, origin) lamport order
    v2 = ShardTable(2, "uigc://a", {1: "uigc://a"}, fence=1)
    assert v2.supersedes(high)


def test_mship_codec_round_trip_and_tolerance():
    frame = wire.encode_mship(
        "uigc://a", 3, ["uigc://a", "uigc://b"], {"uigc://a": 17}, True, 9
    )
    doc = wire.decode_mship(frame)
    assert doc["fence"] == 3
    assert doc["members"] == ["uigc://a", "uigc://b"]
    assert doc["stamps"] == {"uigc://a": 17}
    assert doc["quarantined"] is True
    # trailing elements tolerated; malformed payloads -> None
    assert wire.decode_mship(frame + ("future",))["fence"] == 3
    assert wire.decode_mship(("mship", "uigc://a", b"not json")) is None
    assert wire.decode_mship(("mship", "uigc://a", "not-bytes")) is None
    # grants carry fences, old 3-element grants decode as fence 0
    assert wire.decode_shard_grant(wire.encode_shard_grant(4, "uigc://a", 2)) == (
        4,
        "uigc://a",
        2,
    )
    assert wire.decode_shard_grant(("sgrant", 4, "uigc://a")) == (4, "uigc://a", 0)


def test_journal_fence_conflict_quarantined_not_merged(tmp_path, event_log):
    """The heal-time merge rule: a minority's post-partition records
    (lower fence, epochs reaching the survivor's base) are quarantined
    out of the replay; its plain pre-partition history replays."""
    shared = str(tmp_path)
    minority = EntityJournal(shared, "uigc://min", fsync="never")
    # pre-partition history at fence 0
    epoch0 = minority.open_epoch("t", 1, "k", b"base-state")
    minority.note_command("t", 1, "k", b"old-cmd")
    minority.checkpoint()
    # the survivor inherits the shard, bumps its fence, and activates —
    # its hybrid-logical epoch supersedes everything it SAW
    survivor = EntityJournal(shared, "uigc://maj", fsync="never")
    survivor.set_fence(1)
    epoch1 = survivor.open_epoch("t", 1, "k", b"survivor-state")
    assert epoch1 > epoch0
    survivor.note_command("t", 1, "k", b"survivor-cmd")
    survivor.checkpoint()
    # meanwhile the partitioned minority keeps appending under fence 0
    # with WALL-CLOCK epochs that overtake the survivor's numbers
    minority.begin_snapshot("t", 1, "k")
    minority.commit_snapshot(
        "t", 1, "k", minority._live[("t", "k")][0], b"divergent-state"
    )
    minority.note_command("t", 1, "k", b"divergent-cmd")
    minority.checkpoint()
    # a fresh reader (the post-heal owner) merges all files
    reader = EntityJournal(shared, "uigc://reader", fsync="never")
    state, cmds = reader.recover("t", 1, "k")
    assert state == b"survivor-state", "highest-fence base must win"
    assert b"survivor-cmd" in cmds
    assert b"divergent-cmd" not in cmds and b"divergent-state" != state
    assert reader.fence_conflicts > 0
    sites = [f.get("site") for f in event_log.of(events.FENCE_REJECTED)]
    assert "recovery" in sites
    for j in (minority, survivor, reader):
        j.close()


def test_journal_fence_continuation_epoch_is_not_a_conflict(tmp_path):
    """A SURVIVOR's live entity keeps journaling across its own fence
    bump: same epoch, records at both fences.  That is continuation,
    not dual activation — the pre-verdict snapshot and commands must
    replay in full (the rule that quarantined them lost acked state)."""
    shared = str(tmp_path)
    j = EntityJournal(shared, "uigc://surv", fsync="never")
    j.open_epoch("t", 4, "k4", b"base")
    j.note_command("t", 4, "k4", b"pre-verdict")
    j.set_fence(1)  # the split-brain verdict: stamp moves, epoch stays
    j.note_command("t", 4, "k4", b"post-verdict")
    j.checkpoint()
    reader = EntityJournal(shared, "uigc://reader", fsync="never")
    state, cmds = reader.recover("t", 4, "k4")
    assert state == b"base"
    assert cmds == [b"pre-verdict", b"post-verdict"]
    assert reader.fence_conflicts == 0
    j.close()
    reader.close()


def test_journal_foreign_writer_in_continuation_epoch_still_conflicts(
    tmp_path, event_log
):
    """The continuation carve-out is a (writer, epoch) property: the
    survivor continuing its own epoch across the fence must not excuse
    a DIFFERENT writer's concurrent records in that same epoch — that
    is dual activation even though no fresh activation ever opened."""
    import os
    import pickle
    import struct
    import zlib

    shared = str(tmp_path)

    def write_file(node, records):
        j = EntityJournal(shared, node, fsync="never")
        d = j._shard_dir("t", 5)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{j.node_safe}.00000.uj")
        with open(path, "wb") as fh:
            for rec in records:
                payload = pickle.dumps(rec, protocol=4)
                fh.write(
                    struct.pack(
                        ">2sII", b"uJ", len(payload), zlib.crc32(payload)
                    )
                    + payload
                )
        j.close()

    # Writer A: epoch 10 continues across the fence bump (0 -> 1).
    write_file(
        "uigc://A",
        [
            ("k", 10, 0, "s", b"A-base", 0),
            ("k", 10, 1, "c", b"A-pre", 0),
            ("k", 10, 2, "c", b"A-post", 1),
        ],
    )
    # Writer B (the quarantined loser): a concurrent record in the
    # SAME wall-clock epoch, still at fence 0.
    write_file("uigc://B", [("k", 10, 3, "c", b"B-divergent", 0)])
    reader = EntityJournal(shared, "uigc://reader", fsync="never")
    state, cmds = reader.recover("t", 5, "k")
    assert state == b"A-base"
    assert b"A-pre" in cmds and b"A-post" in cmds
    assert b"B-divergent" not in cmds, "foreign writer must be quarantined"
    assert reader.fence_conflicts == 1
    reader.close()


def test_journal_writer_identity_survives_dotted_node_names(tmp_path):
    """Segment filenames are '<node_safe>.<NNNNN>.uj' and node_safe
    preserves dots ('10.0.0.5'): the merge must parse the writer from
    the RIGHT or dotted names alias (breaking the continuation
    carve-out) and live-vs-disk writers diverge for one node."""
    shared = str(tmp_path)
    dotted = "uigc://10.0.0.5:7001"
    j = EntityJournal(shared, dotted, fsync="never")
    j.open_epoch("t", 6, "k6", b"base")
    j.note_command("t", 6, "k6", b"pre")
    j.set_fence(1)  # same writer continues its epoch across the bump
    j.note_command("t", 6, "k6", b"post")
    j.checkpoint()
    reader = EntityJournal(shared, "uigc://10.0.0.6:7001", fsync="never")
    state, cmds = reader.recover("t", 6, "k6")
    assert state == b"base" and cmds == [b"pre", b"post"]
    assert reader.fence_conflicts == 0
    # and the disk-parsed writer matches the live-append writer
    cache = reader._load_shard("t", 6)
    assert {r[5] for r in cache["k6"]} == {j.node_safe}
    j.close()
    reader.close()


def test_quarantine_drain_not_settled_with_active_records(tmp_path):
    """An ACTIVE record (an activation that raced the quarantine gate)
    must hold the freeze open so the next sweep can capture it."""
    config = dict(BASE)
    config["uigc.cluster.journal-dir"] = str(tmp_path)
    node = Node("drain-a", config)
    try:
        node.region.deliver_local("stray", ("incr",))
        assert settle(lambda: node.region.active_count() == 1, 10.0)
        node.cluster._quarantined = True
        assert not node.cluster._quarantine_drained()
        # the re-scan captures it; the drain settles once it lands
        node.cluster._quarantine_scan()
        assert settle(node.cluster._quarantine_drained, 10.0)
    finally:
        node.cluster._quarantined = False
        terminate_all([node])


def test_heal_wildcard_sweeps_specific_pairs_either_order():
    """heal(x, '*') / heal('*', x) must mend EVERY cut naming x —
    specific symmetric pairs, one-way cuts and wildcard isolations —
    identically for both argument orders."""
    for order in ((lambda p, x: p.heal(x, "*")), (lambda p, x: p.heal("*", x))):
        plan = FaultPlan(3)
        plan.partition("uigc://x", "uigc://y")
        plan.partition("uigc://z", "uigc://x", oneway=True)
        plan.isolate("uigc://x")
        plan.partition("uigc://y", "uigc://z")  # unrelated: must survive
        order(plan, "uigc://x")
        assert plan.outbound("uigc://x", "uigc://y", "app")[0] == "deliver"
        assert plan.outbound("uigc://z", "uigc://x", "app")[0] == "deliver"
        assert plan.outbound("uigc://y", "uigc://z", "app")[0] == "drop"
    # a specific-pair heal leaves a wildcard isolation in place (it
    # covers more than the pair)
    plan = FaultPlan(3)
    plan.isolate("uigc://x")
    plan.heal("uigc://x", "uigc://y")
    assert plan.outbound("uigc://x", "uigc://y", "app")[0] == "drop"


def test_rejoin_waits_for_quarantine_drain(tmp_path):
    """A survivor's handshake arriving mid-drain must NOT unfreeze the
    journal: the remaining captures would stamp the loser's divergent
    state with the survivor's fence, making it unrejectable at the
    next merge.  The rejoin only proceeds once the drain settled."""
    config = dict(BASE)
    config["uigc.cluster.journal-dir"] = str(tmp_path)
    node = Node("gate-a", config)
    try:
        arb = node.cluster.arbiter
        assert arb is not None
        # Force the quarantined-mid-drain state directly (single node;
        # the transition machinery is exercised by the chaos matrix).
        node.cluster._quarantined = True
        node.cluster._quarantine_checkpointed = False
        arb.quarantined = True
        frame = wire.encode_mship(
            "uigc://gate-b", 7, ["uigc://gate-b"], {}, False, 1
        )
        node.cluster._on_mship("uigc://gate-b", frame)
        assert node.cluster.quarantined, "rejoin must wait for the drain"
        assert arb.fence == 0 and not node.cluster.journal.frozen
        # drain settles -> the retried handshake completes the rejoin
        node.cluster._quarantine_settle()
        assert node.cluster.journal.frozen
        node.cluster._on_mship("uigc://gate-b", frame)
        assert not node.cluster.quarantined
        assert arb.fence == 7
        assert not node.cluster.journal.frozen
        assert node.cluster.journal.fence == 7
    finally:
        terminate_all([node])


def test_journal_single_fence_replays_fully(tmp_path):
    """No fence divergence (the key was never dual-activated): the
    minority's whole suffix — snapshot and commands — replays."""
    shared = str(tmp_path)
    j = EntityJournal(shared, "uigc://solo", fsync="never")
    j.open_epoch("t", 2, "k2", b"s0")
    j.note_command("t", 2, "k2", b"c1")
    j.note_command("t", 2, "k2", b"c2")
    j.checkpoint()
    reader = EntityJournal(shared, "uigc://reader", fsync="never")
    state, cmds = reader.recover("t", 2, "k2")
    assert state == b"s0" and cmds == [b"c1", b"c2"]
    j.close()
    reader.close()


def test_frozen_journal_refuses_appends(tmp_path, event_log):
    j = EntityJournal(str(tmp_path), "uigc://q", fsync="never")
    j.open_epoch("t", 3, "k3", b"s")
    j.freeze()
    before = j.appended_records
    j.note_command("t", 3, "k3", b"post-verdict")
    assert j.appended_records == before, "frozen journal must not append"
    assert j.stats()["fence_rejected_appends"] >= 1
    assert any(
        f.get("site") == "journal" for f in event_log.of(events.FENCE_REJECTED)
    )
    j.unfreeze(5)
    j.note_command("t", 3, "k3", b"post-heal")
    assert j.appended_records == before + 1
    assert j.fence == 5
    j.close()


def test_journal_record_fence_stamp_and_legacy_tolerance(tmp_path):
    """Records carry the writer's fence; a pre-fencing 5-tuple record
    (an old build's file) scans as fence 0."""
    import pickle
    import struct
    import zlib

    j = EntityJournal(str(tmp_path), "uigc://w", fsync="never")
    j.set_fence(4)
    j.open_epoch("t", 0, "k", b"s")
    j.checkpoint()
    scanned = []
    shard_dir = j._shard_dir("t", 0)
    import os

    for name in os.listdir(shard_dir):
        scanned += j._scan_file(os.path.join(shard_dir, name))
    assert scanned and all(rec[5] == 4 for rec in scanned)
    # hand-write a legacy 5-tuple record into a fresh file
    payload = pickle.dumps(("k", 1, 0, "s", b"legacy"), protocol=4)
    legacy = struct.pack(">2sII", b"uJ", len(payload), zlib.crc32(payload)) + payload
    path = os.path.join(shard_dir, "old-node.00000.uj")
    with open(path, "wb") as fh:
        fh.write(legacy)
    recs = j._scan_file(path)
    assert recs == [("k", 1, 0, "s", b"legacy", 0)]
    assert j.torn_records == 0
    j.close()


# ------------------------------------------------------------------- #
# Chaos matrix: 3-node clusters under traffic
# ------------------------------------------------------------------- #

N_KEYS = 60


def _warm_keyspace(nodes):
    keys = [f"user-{i}" for i in range(N_KEYS)]
    for i, key in enumerate(keys):
        nodes[i % len(nodes)].cluster.entity_ref("counter", key).tell(("incr",))
    warmed = lambda: sum(n.region.active_count() for n in nodes) == N_KEYS
    if not settle(warmed, timeout_s=20.0):
        # Re-kick once: a table-convergence hiccup under full-suite
        # load can park the first burst in the deferred queue past its
        # flush; counts baseline AFTER warm-up, so re-telling is safe.
        for key in keys:
            nodes[0].cluster.entity_ref("counter", key).tell(("incr",))
    assert settle(warmed, timeout_s=30.0), [
        n.region.active_count() for n in nodes
    ]
    return keys


def _probe_all(node, keys, expect=None, timeout_s=45.0):
    coll = Collector()
    coll_cell = node.system.spawn_system_raw(coll, f"coll-{time.monotonic_ns()}")
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        snap = coll.snapshot()
        missing = [k for k in keys if k not in snap]
        short = (
            [k for k in keys if snap.get(k, -1) < expect.get(k, 0)]
            if expect
            else []
        )
        if not missing and not short:
            return snap
        for k in set(missing) | set(short):
            node.cluster.entity_ref("counter", k).tell(("probe", coll_cell))
        time.sleep(0.3)
    return coll.snapshot()


def _assert_single_side_serves(majority, minority, keys):
    """Exactly one side serves each shard: the majority's tables name
    no minority owner, and the quarantined minority hosts nothing."""
    for node in majority:
        owners = set(node.cluster.table_snapshot().assignments.values())
        assert minority.address not in owners, owners
    assert minority.cluster.quarantined
    assert minority.region.active_count() == 0, "quarantine must drain"
    assert minority.cluster.journal is None or minority.cluster.journal.frozen


def _partition_cycle(
    event_log,
    strategy="keep-majority",
    oneway=False,
    flap=False,
    overrides=None,
    journal_dir=None,
):
    plan = FaultPlan(99)
    conf = {"uigc.cluster.sbr-strategy": strategy}
    if journal_dir is not None:
        conf["uigc.cluster.journal-dir"] = journal_dir
        conf["uigc.cluster.journal-fsync"] = "interval"
    if overrides:
        conf.update(overrides)
    nodes = build_cluster(
        [f"part-{strategy}-a", f"part-{strategy}-b", f"part-{strategy}-c"],
        plan=plan,
        overrides=conf,
        join_gap_s=0.01,
    )
    a, b, c = nodes
    try:
        connect_mesh(nodes)
        assert settle(
            lambda: all(len(n.cluster.members()) == 3 for n in nodes),
            timeout_s=10.0,
        )
        keys = _warm_keyspace(nodes)
        pre = _probe_all(a, keys)
        assert len(pre) == N_KEYS

        if flap:
            # A short flap that heals before any verdict can settle:
            # the cluster must absorb it without a single down.
            plan.isolate(c.address)
            plan.heal_after(0.08, c.address, "*")
            time.sleep(0.4)
            assert not c.cluster.quarantined
            assert settle(
                lambda: all(len(n.cluster.members()) == 3 for n in nodes),
                timeout_s=15.0,
            ), "flap must heal without membership loss"

        # The real cut: c against the majority, >= 10 heartbeat windows.
        plan.isolate(c.address, oneway=oneway)
        assert settle(
            lambda: c.address not in a.cluster.members()
            and c.address not in b.cluster.members()
            and c.cluster.quarantined,
            timeout_s=30.0,
        ), (a.cluster.members(), b.cluster.members(), c.cluster.stats())
        # the quarantine drain settles: every entity stopped, and the
        # journal freezes one tick later
        assert settle(lambda: c.region.active_count() == 0, timeout_s=20.0)
        assert settle(
            lambda: c.cluster.journal is None or c.cluster.journal.frozen,
            timeout_s=10.0,
        )
        _assert_single_side_serves((a, b), c, keys)

        # Majority keeps serving the WHOLE keyspace during the cut.
        assert settle(
            lambda: a.cluster.migrations.pending_count() == 0
            and b.cluster.migrations.pending_count() == 0,
            timeout_s=20.0,
        )
        during = _probe_all(a, keys, expect=pre)
        assert len(during) == N_KEYS
        assert all(during[k] >= pre[k] for k in keys)

        assert not sanitizer_violations(a) and not sanitizer_violations(b)

        # -- heal: mend the fault plan, re-dial, handshake, rejoin ---- #
        plan.heal(c.address, "*")
        c.fabric.connect("127.0.0.1", a.port)
        c.fabric.connect("127.0.0.1", b.port)
        assert settle(
            lambda: not c.cluster.quarantined
            and all(len(n.cluster.members()) == 3 for n in nodes),
            timeout_s=30.0,
        ), (c.cluster.stats(), a.cluster.members())
        assert c.cluster.current_fence == a.cluster.current_fence
        # the rejoined peer serves again and no count regressed
        assert settle(
            lambda: all(
                n.cluster.migrations.pending_count() == 0 for n in nodes
            ),
            timeout_s=30.0,
        )
        post = _probe_all(a, keys, expect=during)
        assert len(post) == N_KEYS
        assert all(post[k] >= during[k] for k in keys), "acked state regressed"
        assert settle(lambda: c.region.active_count() > 0, timeout_s=30.0), (
            "rejoined peer never re-hosted a shard"
        )
        # rejoined peer's collector/sanitizer state is clean
        assert not sanitizer_violations(a)
        assert not sanitizer_violations(b)
        assert not sanitizer_violations(c)
        downs = event_log.of(events.SBR_DOWNED)
        assert any(f.get("strategy") == strategy for f in downs)
        assert event_log.of(events.SBR_REJOIN)
    finally:
        terminate_all(nodes)


def test_symmetric_partition_keep_majority_full_cycle(event_log, tmp_path):
    _partition_cycle(event_log, "keep-majority", journal_dir=str(tmp_path))


def test_symmetric_partition_static_quorum(event_log, tmp_path):
    _partition_cycle(
        event_log,
        "static-quorum",
        overrides={"uigc.cluster.sbr-quorum-size": 2},
        journal_dir=str(tmp_path),
    )


def test_asymmetric_partition_converges_to_one_side(event_log, tmp_path):
    """A one-way cut (c transmits into the void but still hears the
    majority) must still converge: the majority's verdicts stand, c
    eventually observes its own removal (EOF on the closed links) and
    quarantines, and the heal cycle completes."""
    _partition_cycle(event_log, "keep-majority", oneway=True, journal_dir=str(tmp_path))


def test_flapping_partition_absorbs_then_resolves(event_log, tmp_path):
    _partition_cycle(event_log, "keep-majority", flap=True, journal_dir=str(tmp_path))


def test_keep_oldest_majority_downs_itself(event_log):
    """keep-oldest with the oldest node isolated: the MAJORITY loses.
    Both b and c quarantine; the senior minority keeps serving its
    view of the keyspace."""
    plan = FaultPlan(7)
    nodes = build_cluster(
        ["oldest-a", "oldest-b", "oldest-c"],
        plan=plan,
        overrides={"uigc.cluster.sbr-strategy": "keep-oldest"},
        join_gap_s=0.01,
    )
    a, b, c = nodes
    try:
        connect_mesh(nodes)
        assert settle(
            lambda: all(len(n.cluster.members()) == 3 for n in nodes),
            timeout_s=10.0,
        )
        # let the mship gossip converge the join stamps
        time.sleep(0.5)
        _warm_keyspace(nodes)
        plan.isolate(a.address)
        assert settle(
            lambda: b.cluster.quarantined and c.cluster.quarantined,
            timeout_s=30.0,
        ), (b.cluster.stats(), c.cluster.stats())
        assert not a.cluster.quarantined
        # a's own verdict (its detectors starve on their own clock) may
        # lag b/c's quarantine — settle, don't assert instantly.
        assert settle(lambda: a.cluster.current_fence >= 1, timeout_s=20.0), (
            a.cluster.stats()
        )
        assert settle(
            lambda: b.region.active_count() == 0
            and c.region.active_count() == 0,
            timeout_s=20.0,
        )
        assert not sanitizer_violations(a)
    finally:
        terminate_all(nodes)


def test_down_all_quarantines_every_side(event_log):
    plan = FaultPlan(7)
    nodes = build_cluster(
        ["dall-a", "dall-b", "dall-c"],
        plan=plan,
        overrides={"uigc.cluster.sbr-strategy": "down-all"},
    )
    a, b, c = nodes
    try:
        connect_mesh(nodes)
        assert settle(
            lambda: all(len(n.cluster.members()) == 3 for n in nodes),
            timeout_s=10.0,
        )
        _warm_keyspace(nodes)
        plan.isolate(c.address)
        assert settle(
            lambda: all(n.cluster.quarantined for n in nodes), timeout_s=30.0
        ), [n.cluster.stats() for n in nodes]
        assert settle(
            lambda: all(n.region.active_count() == 0 for n in nodes),
            timeout_s=20.0,
        )
        downed = event_log.of(events.SBR_DOWNED)
        assert len(downed) >= 3
        assert all(f.get("strategy") == "down-all" for f in downed)
    finally:
        terminate_all(nodes)


def test_split_brain_suspected_disagreement_event(event_log):
    """An asymmetric verdict (a downs c, b still lists it live) must
    surface as a membership disagreement — the split_brain_suspected
    alert input — on the side that reached the verdict."""
    plan = FaultPlan(11)
    nodes = build_cluster(
        ["dis-a", "dis-b", "dis-c"],
        plan=plan,
        # b tolerates silence far longer than a: only a reaches a
        # verdict inside the test window, so the views disagree.
        overrides={"uigc.cluster.sbr-min-members": 4},
    )
    a, b, c = nodes
    try:
        connect_mesh(nodes)
        assert settle(
            lambda: all(len(n.cluster.members()) == 3 for n in nodes),
            timeout_s=10.0,
        )
        # min-members=4 keeps arbitration out of the way: a's verdict
        # removes c immediately (legacy path) while b keeps both.
        plan.partition(a.address, c.address)
        assert settle(
            lambda: c.address not in a.cluster.members(), timeout_s=30.0
        )
        assert c.address in b.cluster.members()
        # a's arbiter saw no verdict (not arbitrated) — plant one
        # explicitly at the arbiter level to exercise the detector.
        a.cluster.arbiter._downed.add(c.address)
        assert settle(
            lambda: bool(event_log.of(events.MEMBERSHIP_DISAGREEMENT)),
            timeout_s=15.0,
        ), "b's gossip listing c live must flag a disagreement on a"
        flagged = event_log.of(events.MEMBERSHIP_DISAGREEMENT)
        assert any(c.address in f.get("conflicts", []) for f in flagged)
    finally:
        terminate_all(nodes)
