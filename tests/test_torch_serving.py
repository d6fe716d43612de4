"""The port's counterpart of ``tests/test_serving.py``: the same tests, names and
assertions, on ``uigc_tpu_torch``.

Both tests the reference has beyond these stay out:
``test_ul012_flags_unbounded_queues_and_accepts_annotated`` waits for
the port's static checker (ROADMAP Queue 1 item 10b), and
``test_bench_check_scenario_family_gates_lost_acked`` reads
``tools/bench_check.py`` and uses nothing of the port.

Durability plane: journal framing/recovery, backpressure, drain.

Covers the durability plane end to end:

- journal unit layer: CRC frame round-trip, torn-tail stop (replay
  ends at the last valid frame, ``journal.torn_record`` reported),
  segment roll + compaction keeping recovery exact;
- crash recovery: entities journaled on one node are reconstructed —
  snapshot + command replay — by the node that inherits their shards
  after ``NodeFabric.die()``; passivated-only nodes recover too (the
  StateStore's durable backend);
- torn-record fault injection: ``FaultPlan.torn_journal_append``
  tears a record mid-write; replay stops cleanly at the tear and
  everything before it survives;
- backpressure: bounded mailboxes (shed-oldest accounting, the error
  policy raising to local senders, blocked-sender propagation) and the
  capped EntityRef handoff buffer
  (``uigc_entity_buffer_dropped_total``);
- drain: a drained node hands every entity off with zero loss and its
  table excludes it;
- acceptance: a 3-node cluster with >= 200 journaled sessions under
  sustained acked traffic has EVERY node drained + restarted in
  sequence plus one abrupt ``die()`` — and loses zero acknowledged
  commands (journal replay verified against the client ledger), with
  the uigcsan sanitizer clean on the survivors.
"""

import os
import threading
import time

import pytest

from uigc_tpu_torch import ActorSystem, ClusterSharding, Entity
from uigc_tpu_torch.cluster.journal import EntityJournal, _frame_record
from uigc_tpu_torch.runtime import wire
from uigc_tpu_torch.runtime.behaviors import RawBehavior
from uigc_tpu_torch.runtime.cell import MailboxOverflowError
from uigc_tpu_torch.runtime.faults import FaultPlan
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.utils import events

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.shadow-graph": "array",
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


class Counter(Entity):
    def __init__(self, ctx, key, state):
        super().__init__(ctx, key)
        state = state or {}
        self.count = state.get("count", 0)

    def receive(self, msg):
        kind = msg[0]
        if kind == "incr":
            self.count += 1
        elif kind == "incr-ack":
            self.count += 1
            msg[1].tell(("ack", self.key, self.count))
        elif kind == "probe":
            msg[1].tell(("probed", self.key, self.count))
        elif kind == "slow":
            time.sleep(msg[1])  # uigc-lint: disable=UL003
        return self

    def snapshot_state(self):
        return {"count": self.count}


def counter_factory(ctx, key, state):
    return Counter(ctx, key, state)


class Collector(RawBehavior):
    def __init__(self):
        self.got = {}
        self.acked = {}
        self._lock = threading.Lock()

    def on_message(self, msg):
        if isinstance(msg, tuple) and msg:
            if msg[0] == "probed":
                with self._lock:
                    self.got[msg[1]] = msg[2]
            elif msg[0] == "ack":
                with self._lock:
                    if msg[2] > self.acked.get(msg[1], 0):
                        self.acked[msg[1]] = msg[2]
        return None

    def snapshot(self):
        with self._lock:
            return dict(self.got)

    def acked_snapshot(self):
        with self._lock:
            return dict(self.acked)


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


def build_cluster(names, journal_dir, plan=None, overrides=None,
                  passivate_after_s=None):
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = len(names)
    config["uigc.cluster.journal-dir"] = str(journal_dir)
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
# Unit layer: framing, torn records, compaction
# ------------------------------------------------------------------- #


def test_journal_round_trip_and_torn_tail(tmp_path, event_log):
    j = EntityJournal(str(tmp_path), "uigc://jr", fsync="never")
    j.open_epoch("t", 3, "k1", b"S0")
    for i in range(5):
        j.note_command("t", 3, "k1", b"C%d" % i)
    j.checkpoint()
    state, cmds = j.recover("t", 3, "k1")
    assert state == b"S0" and cmds == [b"C0", b"C1", b"C2", b"C3", b"C4"]

    # Tear the segment's tail mid-frame: replay stops at the last
    # valid frame and reports journal.torn_record — never raises,
    # never guesses at bytes past the tear.
    shard_dir = j._shard_dir("t", 3)
    (seg,) = [n for n in os.listdir(shard_dir) if n.endswith(".uj")]
    path = os.path.join(shard_dir, seg)
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size - 7)
    j2 = EntityJournal(str(tmp_path), "uigc://jr2", fsync="never")
    state, cmds = j2.recover("t", 3, "k1")
    assert state == b"S0" and cmds == [b"C0", b"C1", b"C2", b"C3"]
    assert j2.torn_records == 1
    torn = event_log.of(events.JOURNAL_TORN)
    assert torn and torn[0]["path"] == path and torn[0]["offset"] > 0
    # Garbage INSIDE a frame (crc mismatch) stops the scan too.
    with open(path, "r+b") as fh:
        fh.seek(12)
        fh.write(b"\xff\xff")
    j3 = EntityJournal(str(tmp_path), "uigc://jr3", fsync="never")
    found = j3.recover("t", 3, "k1")
    assert found is None or found[0] is None  # base snap was corrupted
    j.close()
    j2.close()
    j3.close()


def test_journal_epoch_supersedes_and_missing_snapshot_replays(tmp_path):
    j = EntityJournal(str(tmp_path), "uigc://je", fsync="never")
    j.open_epoch("t", 0, "k", b"OLD")
    j.note_command("t", 0, "k", b"c1")
    # Periodic snapshot: bump first (enqueue time), commit later.
    epoch = j.begin_snapshot("t", 0, "k")
    j.note_command("t", 0, "k", b"c2-new-epoch")
    j.commit_snapshot("t", 0, "k", epoch, b"NEW")
    state, cmds = j.recover("t", 0, "k")
    assert state == b"NEW" and cmds == [b"c2-new-epoch"]
    # A bump whose snapshot never lands (crash between): the previous
    # snapshot replays, PLUS the new epoch's commands on top.
    j.begin_snapshot("t", 0, "k")
    j.note_command("t", 0, "k", b"c3-unsnapped")
    j2 = EntityJournal(str(tmp_path), "uigc://je2", fsync="never")
    state, cmds = j2.recover("t", 0, "k")
    assert state == b"NEW" and cmds == [b"c2-new-epoch", b"c3-unsnapped"]
    j.close()
    j2.close()


def test_open_epoch_min_epoch_supersedes_source_capture(tmp_path):
    """The rolling-restart acked-highwater flake, pinned: a handoff's
    destination activation must open STRICTLY past the source's
    capture epoch even when the destination's shard scan is stale and
    both land in the same wall-clock millisecond.  Without the floor,
    the recovery merge sorts the source's capture snapshot past the
    destination's later acked commands and replays short of them."""
    import unittest.mock as mock

    from uigc_tpu_torch.cluster import journal as journal_mod

    j_src = EntityJournal(str(tmp_path), "uigc://src", fsync="never")
    j_dst = EntityJournal(str(tmp_path), "uigc://dst", fsync="never")
    # Freeze the wall floor: every epoch decision lands "in the same
    # millisecond", the regime where only the causal floor can order
    # the two writers.
    frozen = journal_mod._epoch_floor()
    with mock.patch.object(journal_mod, "_epoch_floor", lambda: frozen):
        j_src.open_epoch("t", 0, "k", b"S0")
        for i in range(3):
            j_src.note_command("t", 0, "k", b"C%d" % i)
        # Prime the destination's shard scan BEFORE the capture: the
        # stale view the real race depends on (shard indexes are
        # cached between membership changes).
        j_dst.keys_for_shard("t", 0)
        cap = j_src.open_epoch("t", 0, "k", b"S3")  # migration capture
        # Destination applies the shipped state, floor = the capture
        # epoch that rode the mig frame.
        dst_epoch = j_dst.open_epoch("t", 0, "k", b"S3", min_epoch=cap)
        assert dst_epoch > cap
        # Two more ACKED commands land at the destination.
        j_dst.note_command("t", 0, "k", b"C3")
        j_dst.note_command("t", 0, "k", b"C4")
    # A fresh reader (the node inheriting the shard after a die())
    # must replay the destination's acked tail on top of the shipped
    # snapshot — not resurrect the source's capture as the base.
    j_reader = EntityJournal(str(tmp_path), "uigc://rdr", fsync="never")
    state, cmds = j_reader.recover("t", 0, "k")
    assert state == b"S3" and cmds == [b"C3", b"C4"]
    # Mixed-version tolerance: a PR-14 peer's mig frame carries no
    # epoch element — it decodes as floor 0 and the wall/known floors
    # apply exactly as before.
    frame = ("mig", "t", "k", ("uigc://src", 1), b"blob", 0)
    assert wire.decode_migration_frame(frame)[5] == 0
    j_src.close()
    j_dst.close()
    j_reader.close()


def test_journal_segment_roll_and_compaction(tmp_path):
    j = EntityJournal(
        str(tmp_path), "uigc://jc", fsync="never", segment_bytes=512,
        snapshot_every=1000,
    )
    j.open_epoch("t", 1, "k", b"S")
    for i in range(60):
        due = j.note_command("t", 1, "k", b"payload-%03d" % i)
        if due:  # segment rolled: the region would re-snapshot; do it
            epoch = j.begin_snapshot("t", 1, "k")
            j.commit_snapshot("t", 1, "k", epoch, b"S%03d" % i)
    assert j.segment_count() >= 2
    # Rolling re-snapshots let old segments compact away...
    assert j.segment_count() < 60
    # ...without ever losing the recovery invariant.
    j2 = EntityJournal(str(tmp_path), "uigc://jc2", fsync="never")
    found = j2.recover("t", 1, "k")
    assert found is not None
    state, cmds = found
    assert state is not None and state.startswith(b"S")
    j.close()
    j2.close()


def test_frame_record_is_crc_framed():
    frame = _frame_record(b"hello")
    assert frame[:2] == b"uJ" and len(frame) == 10 + 5


# ------------------------------------------------------------------- #
# Crash recovery across nodes
# ------------------------------------------------------------------- #


def test_die_recovers_journaled_entities_on_survivor(tmp_path, event_log):
    nodes = build_cluster(["jda", "jdb"], tmp_path)
    a, b = nodes
    try:
        connect_mesh(nodes)
        assert settle(lambda: len(a.cluster.members()) == 2)
        keys = [f"k{i}" for i in range(40)]
        for i, k in enumerate(keys):
            ref = a.cluster.entity_ref("counter", k)
            for _ in range(i % 4 + 1):
                ref.tell(("incr",))
        assert settle(
            lambda: a.region.active_count() + b.region.active_count() == 40
        )
        dead_keys = [k for k in keys if a.cluster.home_of(k) == b.address]
        assert dead_keys, "no key homed on the doomed node?"
        b.fabric.die()
        assert settle(lambda: b.address not in a.cluster.members())
        # Eager recovery: the survivor reconstructs the dead node's
        # entities from the shared journal without waiting for traffic.
        assert settle(
            lambda: a.region.active_count() == 40, timeout_s=30.0
        ), (a.region.active_count(), len(dead_keys))
        coll = Collector()
        cell = a.system.spawn_system_raw(coll, "coll")
        for k in keys:
            a.cluster.entity_ref("counter", k).tell(("probe", cell))
        assert settle(lambda: len(coll.snapshot()) == 40)
        expected = {k: i % 4 + 1 for i, k in enumerate(keys)}
        assert coll.snapshot() == expected, {
            k: (coll.snapshot().get(k), expected[k])
            for k in keys
            if coll.snapshot().get(k) != expected[k]
        }
        recovered = event_log.of(events.JOURNAL_RECOVERED)
        assert len(recovered) >= len(dead_keys)
        assert all(f["duration_s"] >= 0 for f in recovered)
    finally:
        terminate_all(nodes)


def test_passivated_entities_survive_node_death(tmp_path, event_log):
    """The StateStore satellite: a node holding ONLY passivated
    entities dies; its spilled snapshots came through the journal, so
    the survivor recovers them with state intact."""
    nodes = build_cluster(
        ["jpa", "jpb"], tmp_path, passivate_after_s=0.12
    )
    a, b = nodes
    try:
        connect_mesh(nodes)
        assert settle(lambda: len(a.cluster.members()) == 2)
        keys = [f"k{i}" for i in range(24)]
        for i, k in enumerate(keys):
            ref = a.cluster.entity_ref("counter", k)
            for _ in range(i + 1):
                ref.tell(("incr",))
        # All 24 exist (active OR already idled out — under full-suite
        # load the 0.12s passivation can outrun the tail of the spawn
        # burst, so a pure active_count==24 settle races by design).
        assert settle(
            lambda: a.region.active_count() + b.region.active_count()
            + a.region.passive_count() + b.region.passive_count() == 24
        )
        # Idle out: every entity passivates (spilling through the
        # journal), leaving B with passivated-only state.
        assert settle(
            lambda: a.region.passive_count() + b.region.passive_count() == 24,
            timeout_s=10.0,
        )
        b_keys = [k for k in keys if a.cluster.home_of(k) == b.address]
        assert b_keys, "no key homed on the doomed node?"
        b.fabric.die()
        assert settle(lambda: b.address not in a.cluster.members())
        coll = Collector()
        cell = a.system.spawn_system_raw(coll, "coll")
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and len(coll.snapshot()) < 24:
            for k in keys:
                if k not in coll.snapshot():
                    a.cluster.entity_ref("counter", k).tell(("probe", cell))
            time.sleep(0.3)
        expected = {f"k{i}": i + 1 for i in range(24)}
        assert coll.snapshot() == expected, {
            k: (coll.snapshot().get(k), expected[k])
            for k in keys
            if coll.snapshot().get(k) != expected[k]
        }
    finally:
        terminate_all(nodes)


def test_torn_append_replay_stops_at_last_valid_frame(tmp_path, event_log):
    """FaultPlan crash-at-byte injection: node B's journal tears on its
    N-th append (the process 'dies inside write(2)'); B then crashes.
    The survivor's replay stops at the tear, keeps everything before
    it, and reports journal.torn_record."""
    plan = FaultPlan(7)
    nodes = build_cluster(["jta", "jtb"], tmp_path, plan=plan)
    a, b = nodes
    try:
        connect_mesh(nodes)
        assert settle(lambda: len(a.cluster.members()) == 2)
        keys = [f"k{i}" for i in range(30)]
        b_key = next(k for k in keys if a.cluster.home_of(k) == b.address)
        ref = b.cluster.entity_ref("counter", b_key)
        for _ in range(10):
            ref.tell(("incr",))
        assert settle(
            lambda: b.region.active_count() >= 1
        )
        coll = Collector()
        cell = b.system.spawn_system_raw(coll, "c0")
        b.cluster.entity_ref("counter", b_key).tell(("probe", cell))
        assert settle(lambda: coll.snapshot().get(b_key) == 10)
        # Arm the tear: the NEXT append on B is written only halfway,
        # then B's journal is dead (everything later is lost).
        plan.torn_journal_append(b.address, after_appends=1)
        for _ in range(5):
            ref.tell(("incr",))
        assert settle(lambda: b.cluster.journal.stats()["dead"], 10.0)
        b.fabric.die()
        assert settle(lambda: b.address not in a.cluster.members())
        coll2 = Collector()
        cell2 = a.system.spawn_system_raw(coll2, "c1")
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and b_key not in coll2.snapshot():
            a.cluster.entity_ref("counter", b_key).tell(("probe", cell2))
            time.sleep(0.2)
        # 10 journaled commands, then the 11th tore mid-frame and the
        # rest never reached the file: recovery replays exactly the
        # clean prefix.
        assert coll2.snapshot().get(b_key) == 10, coll2.snapshot()
        assert event_log.of(events.JOURNAL_TORN), "tear never reported"
    finally:
        terminate_all(nodes)


# ------------------------------------------------------------------- #
# Backpressure
# ------------------------------------------------------------------- #


def test_bounded_mailbox_shed_oldest_accounts(event_log):
    config = dict(
        BASE,
        **{
            "uigc.crgc.num-nodes": 1,
            "uigc.runtime.mailbox-limit": 8,
            "uigc.runtime.overflow-policy": "shed-oldest",
        },
    )
    system = ActorSystem(None, name="bp-shed", config=config)
    try:
        cluster = ClusterSharding.attach(system)
        region = cluster.start("counter", counter_factory)
        ref = region.entity_ref("k")
        ref.tell(("slow", 0.4))
        time.sleep(0.05)  # entity is busy; the mailbox now backs up
        for _ in range(40):
            ref.tell(("incr",))
        assert settle(lambda: bool(event_log.of(events.BACKPRESSURE)), 5.0)
        sheds = [
            f
            for f in event_log.of(events.BACKPRESSURE)
            if f.get("site") == "mailbox" and f.get("action") == "shed"
        ]
        assert sheds, event_log.of(events.BACKPRESSURE)
        coll = Collector()
        cell = system.spawn_system_raw(coll, "coll")
        ref.tell(("probe", cell))
        assert settle(lambda: "k" in coll.snapshot(), 10.0)
        # Some increments were shed (dead-lettered), the rest landed.
        assert coll.snapshot()["k"] < 40
        assert system.dead_letters > 0
    finally:
        system.terminate()


def test_bounded_mailbox_error_policy_raises_locally():
    config = dict(
        BASE,
        **{
            "uigc.crgc.num-nodes": 1,
            "uigc.runtime.mailbox-limit": 4,
            "uigc.runtime.overflow-policy": "error",
        },
    )
    system = ActorSystem(None, name="bp-err", config=config)
    try:
        cluster = ClusterSharding.attach(system)
        region = cluster.start("counter", counter_factory)
        ref = region.entity_ref("k")
        ref.tell(("slow", 0.5))
        time.sleep(0.05)
        with pytest.raises(MailboxOverflowError) as exc:
            for _ in range(40):
                ref.tell(("incr",))
        assert exc.value.rule == "mailbox.overflow"
    finally:
        system.terminate()


def test_bounded_mailbox_block_propagates_and_recovers(event_log):
    """The block policy: senders WAIT for a saturated entity instead of
    growing its mailbox; once the consumer catches up everything that
    was admitted is processed — nothing lost, nothing unbounded."""
    config = dict(
        BASE,
        **{
            "uigc.crgc.num-nodes": 1,
            "uigc.runtime.mailbox-limit": 16,
            "uigc.runtime.overflow-policy": "block",
            "uigc.runtime.mailbox-block-ms": 4000,
        },
    )
    system = ActorSystem(None, name="bp-block", config=config)
    try:
        cluster = ClusterSharding.attach(system)
        region = cluster.start("counter", counter_factory)
        ref = region.entity_ref("k")
        ref.tell(("slow", 0.3))
        time.sleep(0.05)
        sent = 80
        t0 = time.monotonic()
        for _ in range(sent):
            ref.tell(("incr",))
        blocked_s = time.monotonic() - t0
        waits = [
            f
            for f in event_log.of(events.BACKPRESSURE)
            if f.get("site") == "mailbox" and f.get("action") == "wait"
        ]
        assert waits, "full mailbox never blocked the sender"
        assert blocked_s > 0.05, "sender never actually waited"
        coll = Collector()
        cell = system.spawn_system_raw(coll, "coll")
        ref.tell(("probe", cell))
        assert settle(lambda: coll.snapshot().get("k") == sent, 15.0), (
            coll.snapshot()
        )
    finally:
        system.terminate()


def test_error_policy_degrades_on_remote_and_rerouted_paths(event_log):
    """The "error" overflow policy raises only to a LOCAL
    EntityRef.tell; a remote 'ent'-frame delivery must degrade to
    shed-oldest on the transport thread (a raise there would kill the
    link's receive loop) and the link must stay healthy."""
    config = dict(
        BASE,
        **{
            "uigc.crgc.num-nodes": 2,
            "uigc.runtime.mailbox-limit": 8,
            "uigc.runtime.overflow-policy": "error",
        },
    )
    nodes = [Node(n, config) for n in ("erra", "errb")]
    a, b = nodes
    try:
        connect_mesh(nodes)
        assert settle(lambda: len(a.cluster.members()) == 2)
        b_key = next(
            f"k{i}" for i in range(200) if a.cluster.home_of(f"k{i}") == b.address
        )
        ref = a.cluster.entity_ref("counter", b_key)
        ref.tell(("slow", 0.4))
        time.sleep(0.1)
        for _ in range(60):  # floods B's bounded mailbox over the wire
            ref.tell(("incr",))
        # The receive loop survived: the entity still answers, the link
        # never went down, and the overflow surfaced as sheds.
        coll = Collector()
        cell = a.system.spawn_system_raw(coll, "coll")
        assert settle(
            lambda: (
                a.cluster.entity_ref("counter", b_key).tell(("probe", cell))
                or b_key in coll.snapshot()
            ),
            timeout_s=15.0,
        )
        assert not event_log.of(events.NODE_DOWN)
        sheds = [
            f
            for f in event_log.of(events.BACKPRESSURE)
            if f.get("site") == "mailbox" and f.get("action") == "shed"
        ]
        assert sheds, "remote overflow never degraded to shed-oldest"
    finally:
        terminate_all(nodes)


def test_handoff_buffer_bound_sheds_with_accounting(tmp_path, event_log):
    """The EntityRef buffer-during-handoff satellite: a key stuck in
    transition cannot buffer unboundedly — past the cap the oldest
    parked message is shed with shard.buffer_dropped accounting."""
    config = dict(
        BASE,
        **{
            "uigc.crgc.num-nodes": 1,
            "uigc.cluster.buffer-limit": 10,
        },
    )
    system = ActorSystem(None, name="bufcap", config=config)
    try:
        cluster = ClusterSharding.attach(system)
        region = cluster.start("counter", counter_factory)
        region.entity_ref("k").tell(("incr",))
        assert settle(lambda: region.active_count() == 1)
        # Wedge the key mid-transition (simulate a handoff that never
        # completes) and flood it.
        from collections import deque

        from uigc_tpu_torch.cluster.sharding import _HANDOFF

        with region._lock:
            region._entities["k"].status = _HANDOFF
            region._buffers.setdefault("k", deque())
        for _ in range(50):
            region.entity_ref("k").tell(("incr",))
        assert region.buffered_depth() == 10, region.buffered_depth()
        drops = event_log.of(events.SHARD_BUFFER_DROPPED)
        assert len(drops) == 40 and drops[0]["site"] == "handoff"
        with region._lock:
            region._entities["k"].status = "active"
    finally:
        system.terminate()


def test_writer_queue_backpressure_event(tmp_path, event_log):
    """A saturated remote consumer surfaces on the SENDER as writer-
    queue pushback with a structured fabric.backpressure event."""
    config = dict(
        BASE,
        **{
            "uigc.crgc.num-nodes": 2,
            "uigc.node.writer-queue-limit": 32,
        },
    )
    nodes = [Node(n, config) for n in ("wqa", "wqb")]
    a, b = nodes
    try:
        connect_mesh(nodes)
        assert settle(lambda: len(a.cluster.members()) == 2)
        keys = [f"k{i}" for i in range(100)]
        b_keys = [k for k in keys if a.cluster.home_of(k) == b.address]
        # Slow B's intake: a long-running entity invocation stalls its
        # dispatcher while A floods the link.
        a.cluster.entity_ref("counter", b_keys[0]).tell(("slow", 0.3))
        for _ in range(3000):
            for k in b_keys[:4]:
                a.cluster.entity_ref("counter", k).tell(("incr",))
            if any(
                f.get("site") == "writer-queue"
                for f in event_log.of(events.BACKPRESSURE)
            ):
                break
        waits = [
            f
            for f in event_log.of(events.BACKPRESSURE)
            if f.get("site") == "writer-queue"
        ]
        assert waits and waits[0]["depth"] >= 32
    finally:
        terminate_all(nodes)


# ------------------------------------------------------------------- #
# Drain
# ------------------------------------------------------------------- #


def test_drain_hands_off_everything_zero_loss(tmp_path, event_log):
    nodes = build_cluster(["dra", "drb"], tmp_path)
    a, b = nodes
    try:
        connect_mesh(nodes)
        assert settle(lambda: len(a.cluster.members()) == 2)
        keys = [f"k{i}" for i in range(50)]
        for i, k in enumerate(keys):
            ref = a.cluster.entity_ref("counter", k)
            for _ in range(i % 3 + 1):
                ref.tell(("incr",))
        assert settle(
            lambda: a.region.active_count() + b.region.active_count() == 50
        )
        assert b.region.active_count() > 0, "nothing to drain?"
        assert b.fabric.drain(timeout_s=20.0)
        # Everything lives on A now; B's region is empty and the
        # shared table excludes B.
        assert a.region.active_count() == 50
        assert b.region.active_count() == 0
        assert all(
            owner == a.address
            for owner in a.cluster.table_snapshot().assignments.values()
        )
        drained = event_log.of(events.NODE_DRAINED)
        assert drained and drained[-1]["complete"]
        coll = Collector()
        cell = a.system.spawn_system_raw(coll, "coll")
        for k in keys:
            a.cluster.entity_ref("counter", k).tell(("probe", cell))
        assert settle(lambda: len(coll.snapshot()) == 50)
        expected = {k: i % 3 + 1 for i, k in enumerate(keys)}
        assert coll.snapshot() == expected
    finally:
        terminate_all(nodes)


# ------------------------------------------------------------------- #
# Acceptance: rolling restart chaos
# ------------------------------------------------------------------- #


def test_rolling_restart_chaos_loses_zero_acked_state(tmp_path, event_log):
    """The acceptance scenario: >= 200 journaled sessions on 3 nodes
    under sustained ACKED mixed traffic; every node is drained +
    restarted in sequence; then one restarted node is killed abruptly
    (die()); the survivors journal-recover its sessions.  The client
    ledger's acked highwater per key must be covered by the final
    probed counts — zero acknowledged commands lost — and the uigcsan
    sanitizer must be clean on the survivors."""
    overrides = {
        "uigc.analysis.sanitizer": True,
        # A loaded CI host can stretch a drain past the default 3s
        # hold-timeout; an expired hold reopens the stale-recovery-vs-
        # migration race the grant protocol exists to close.  The
        # timeout is a wedge safety valve, not a pacing device — give
        # it slack.
        "uigc.cluster.hold-timeout": 15000,
    }
    names = ["roll-a", "roll-b", "roll-c"]
    by_name = dict(zip(names, build_cluster(names, tmp_path, overrides=overrides)))
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = 3
    config["uigc.cluster.journal-dir"] = str(tmp_path)
    config.update(overrides)
    acked = {}
    #: the node client traffic enters through; rebound when it rolls
    frontend = {"name": "roll-a"}

    def merge_acked(coll):
        for k, v in coll.acked_snapshot().items():
            if v > acked.get(k, 0):
                acked[k] = v

    try:
        connect_mesh(list(by_name.values()))
        assert settle(
            lambda: all(
                len(n.cluster.members()) == 3 for n in by_name.values()
            ),
            timeout_s=15.0,
        )
        n_entities = 210
        keys = [f"user-{i}" for i in range(n_entities)]

        def frontend_node():
            return by_name[frontend["name"]]

        coll = Collector()
        coll_cell = frontend_node().system.spawn_system_raw(coll, "led0")
        for key in keys:
            frontend_node().cluster.entity_ref("counter", key).tell(
                ("incr-ack", coll_cell)
            )
        assert settle(
            lambda: sum(
                n.region.active_count() for n in by_name.values()
            )
            == n_entities,
            timeout_s=30.0,
        )

        # sustained mixed traffic (acked writes + probes) from a
        # background churner addressing the CURRENT frontend
        churn_stop = threading.Event()
        churn_pause = threading.Event()

        def churn():
            i = 0
            while not churn_stop.is_set():
                if churn_pause.is_set():
                    time.sleep(0.01)
                    continue
                key = keys[i % n_entities]
                try:
                    fe = frontend_node()
                    fe.cluster.entity_ref("counter", key).tell(
                        ("incr-ack", coll_cell)
                    )
                    if i % 7 == 0:
                        fe.cluster.entity_ref("counter", key).tell(
                            ("probe", coll_cell)
                        )
                except Exception:
                    pass
                i += 1
                time.sleep(0.002)

        churner = threading.Thread(target=churn, daemon=True)
        churner.start()
        time.sleep(0.5)

        # -- roll b and c with traffic running ---------------------- #
        for name in ("roll-b", "roll-c"):
            node = by_name[name]
            assert node.fabric.drain(timeout_s=30.0), f"{name} drain residue"
            node.system.terminate(timeout_s=10.0)
            assert settle(
                lambda: node.address
                not in frontend_node().cluster.members(),
                timeout_s=20.0,
            )
            fresh = Node(name, config)
            by_name[name] = fresh
            for other_name, other in by_name.items():
                if other_name != name:
                    fresh.fabric.connect("127.0.0.1", other.port)
            assert settle(
                lambda: len(fresh.cluster.members()) == 3
                and all(
                    n.cluster.migrations.pending_count() == 0
                    for n in by_name.values()
                )
                and fresh.region.active_count() > 0,
                timeout_s=40.0,
            ), f"{name} never rejoined"

        # -- roll a (the frontend): move client + ledger first ------ #
        churn_pause.set()
        time.sleep(0.2)
        merge_acked(coll)
        a_old = by_name["roll-a"]
        coll = Collector()
        coll_cell = by_name["roll-b"].system.spawn_system_raw(coll, "led1")
        frontend["name"] = "roll-b"
        churn_pause.clear()
        assert a_old.fabric.drain(timeout_s=30.0), "roll-a drain residue"
        a_old.system.terminate(timeout_s=10.0)
        assert settle(
            lambda: a_old.address not in by_name["roll-b"].cluster.members(),
            timeout_s=20.0,
        )
        fresh_a = Node("roll-a", config)
        by_name["roll-a"] = fresh_a
        for other_name, other in by_name.items():
            if other_name != "roll-a":
                fresh_a.fabric.connect("127.0.0.1", other.port)
        assert settle(
            lambda: len(fresh_a.cluster.members()) == 3
            and all(
                n.cluster.migrations.pending_count() == 0
                for n in by_name.values()
            ),
            timeout_s=40.0,
        ), "roll-a never rejoined"

        # -- one abrupt kill on top: c dies, journal recovers ------- #
        time.sleep(0.5)
        victim = by_name["roll-c"]
        churn_pause.set()
        time.sleep(0.2)
        merge_acked(coll)
        victim.fabric.die()
        assert settle(
            lambda: victim.address
            not in by_name["roll-b"].cluster.members(),
            timeout_s=20.0,
        )
        churn_stop.set()
        churner.join(timeout=5)
        survivors = [by_name["roll-a"], by_name["roll-b"]]
        assert settle(
            lambda: all(
                s.cluster.migrations.pending_count() == 0 for s in survivors
            ),
            timeout_s=30.0,
        )

        # -- the ledger check: zero acked commands lost ------------- #
        merge_acked(coll)
        probe = Collector()
        probe_cell = by_name["roll-b"].system.spawn_system_raw(probe, "led2")
        deadline = time.monotonic() + 60.0
        lost = keys
        while time.monotonic() < deadline:
            got = probe.snapshot()
            lost = [k for k in keys if got.get(k, -1) < acked.get(k, 0)]
            if not lost:
                break
            for k in lost:
                by_name["roll-b"].cluster.entity_ref("counter", k).tell(
                    ("probe", probe_cell)
                )
            time.sleep(0.3)
        assert not lost, (
            f"{len(lost)} sessions below their acked highwater, e.g. "
            f"{[(k, probe.snapshot().get(k), acked.get(k)) for k in lost[:5]]}"
        )
        assert sum(acked.values()) > n_entities, "ledger never accumulated"
        recovered = event_log.of(events.JOURNAL_RECOVERED)
        assert recovered, "the kill never exercised journal recovery"

        # Sanitizer clean on the survivors: GC soundness held through
        # three drains, three rejoins and an abrupt death.
        for node in survivors:
            violations = node.system.sanitizer.violations
            assert not violations, [str(v) for v in violations]
    finally:
        try:
            churn_stop.set()
        except Exception:
            pass
        terminate_all(list(by_name.values()))
