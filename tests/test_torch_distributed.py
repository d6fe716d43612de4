"""The port's distributed collector (``uigc_tpu_torch/engines/crgc/
distributed.py``, ``parallel/partition.py``) against the JAX package's.

- Placement: ``PartitionMap``, ``ReductionTree``, ``cell_key``,
  ``shard_of`` and ``rendezvous_assign`` equal the reference's on seeded
  member sets and keys.
- The counterparts of ``tests/test_distributed.py``'s in-process tests,
  run on the port: partition churn and tree shape, the key-set codec,
  mirror decay, the fenced ingress entry and undo log, the fold-locality
  audit, dmark retransmit and reorder, and the three-node cycle on the
  in-process fabric with the sanitizer's distributed cross-check.
- Verdict parity: one ring workload on the port's partitioned collector,
  on the port's single-host collector and on the reference's partitioned
  collector stops the same actors.

The reference's ``nodefabric_*`` chaos tests (the TCP transport) and its
UL014/UL015 lint tests (the static analyzers) have no counterpart here:
the port has neither yet.
"""

import random
import threading
import time
import types

import numpy as np
import pytest
import torch

import uigc_tpu
import uigc_tpu.cluster.sharding as ref_sharding
import uigc_tpu.parallel.partition as ref_partition
import uigc_tpu.runtime.fabric as ref_fabric
import uigc_tpu.runtime.remote as ref_remote
import uigc_tpu.runtime.system as ref_system
import uigc_tpu_torch
import uigc_tpu_torch.parallel.partition as port_partition
import uigc_tpu_torch.runtime.fabric as port_fabric
import uigc_tpu_torch.runtime.remote as port_remote
import uigc_tpu_torch.runtime.system as port_system
from uigc_tpu_torch.analysis.sanitizer import cross_check_distributed, merged_oracle
from uigc_tpu_torch.engines.crgc.delta import DeltaGraph
from uigc_tpu_torch.engines.crgc.distributed import PartitionedShadowGraph
from uigc_tpu_torch.engines.crgc.gateways import IngressEntry
from uigc_tpu_torch.engines.crgc.state import CrgcContext
from uigc_tpu_torch.engines.crgc.undo import UndoLog
from uigc_tpu_torch.parallel.partition import PartitionMap, ReductionTree, cell_key
from uigc_tpu_torch.runtime import schema, wire
from uigc_tpu_torch.utils import events

torch.set_num_threads(1)

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.num-nodes": 3,
    "uigc.crgc.distributed": True,
    "uigc.analysis.sanitizer": True,
}


class FakeCell:
    """The (system.address, uid) coordinate every graph-level API reads."""

    __slots__ = ("system", "uid", "path")

    def __init__(self, address, uid):
        self.system = types.SimpleNamespace(address=address)
        self.uid = uid
        self.path = f"{address}/fake-{uid}"


# --------------------------------------------------------------------- #
# Placement against the reference
# --------------------------------------------------------------------- #


def seeded_members(rng, n):
    return [f"uigc://node-{int(x)}" for x in rng.choice(1000, n, replace=False)]


@pytest.mark.parametrize("seed", range(4))
def test_placement_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    members = seeded_members(rng, int(rng.integers(1, 9)))
    parts = int(rng.choice([8, 32, 64]))
    me = members[0]
    port = port_partition.PartitionMap(members, parts, fence=seed,
                                       self_address=me)
    ref = ref_partition.PartitionMap(members, parts, fence=seed,
                                     self_address=me)
    assert port.assignments() == ref.assignments()
    for m in members:
        assert port.owned_partitions(m) == ref.owned_partitions(m)
    if len(members) > 1:
        port_s = port_partition.PartitionMap(members[:-1], parts,
                                             fence=seed + 1, self_address=me)
        ref_s = ref_partition.PartitionMap(members[:-1], parts,
                                           fence=seed + 1, self_address=me)
        assert port_s.moved_partitions(port) == ref_s.moved_partitions(ref)
    for x, uid in zip(rng.integers(0, len(members), 50),
                      rng.integers(0, 1 << 40, 50)):
        cell = FakeCell(members[int(x)], int(uid))
        key = port_partition.cell_key(cell)
        assert key == ref_partition.cell_key(cell)
        assert port.partition_of(key) == ref.partition_of(key)
        assert port.owner_of(key) == ref.owner_of(key)
        assert port.owns(key) == ref.owns(key)
        assert (port_partition.partition_of_cell(cell, parts)
                == ref_partition.partition_of_cell(cell, parts))
        text = port_partition.key_text(key)
        assert (port_partition.shard_of(text, parts)
                == ref_sharding.shard_of(text, parts))
    assert (port_partition.rendezvous_assign(members, parts)
            == ref_sharding.rendezvous_assign(members, parts))
    port_tree = port_partition.ReductionTree(members)
    ref_tree = ref_partition.ReductionTree(members)
    assert port_tree.root == ref_tree.root
    for m in members:
        assert port_tree.parent(m) == ref_tree.parent(m)
        assert port_tree.children(m) == ref_tree.children(m)
        assert port_tree.subtree_size(m) == ref_tree.subtree_size(m)


def test_partition_map_minimal_churn_and_coverage():
    members = ["uigc://a", "uigc://b", "uigc://c"]
    pmap = PartitionMap(members, 32, fence=0, self_address="uigc://a")
    owners = pmap.assignments()
    assert sorted(owners) == list(range(32))
    assert set(owners.values()) <= set(members)
    again = PartitionMap(list(reversed(members)), 32, self_address="uigc://a")
    assert again.assignments() == owners
    survivors = PartitionMap(["uigc://a", "uigc://b"], 32, fence=1,
                             self_address="uigc://a")
    moved = survivors.moved_partitions(pmap)
    assert moved == pmap.owned_partitions("uigc://c")
    for p in moved:
        assert survivors.owner(p) in ("uigc://a", "uigc://b")
    key = ("uigc://a", 1234)
    assert pmap.owner_of(key) == owners[pmap.partition_of(key)]


def test_reduction_tree_shape_and_reroot():
    members = sorted(f"uigc://n{i}" for i in range(7))
    tree = ReductionTree(members)
    assert tree.root == members[0]
    seen = []
    for m in members:
        for c in tree.children(m):
            assert tree.parent(c) == m
            seen.append(c)
    assert sorted(seen + [tree.root]) == members
    assert tree.subtree_size(tree.root) == len(members)
    rebuilt = ReductionTree(members[1:])
    assert rebuilt.root == members[1]
    assert rebuilt.subtree_size(rebuilt.root) == len(members) - 1


# --------------------------------------------------------------------- #
# Codecs, graph units, fences
# --------------------------------------------------------------------- #


def test_keyset_codec_round_trip_property():
    rng = random.Random(99)
    addresses = ["uigc://a", "uigc://bb", "uigc://much-longer-name-0"]
    for _ in range(40):
        keys = set()
        for _ in range(rng.randrange(1, 120)):
            addr = rng.choice(addresses)
            if rng.random() < 0.5:
                uid = rng.randrange(0, 200)
            else:
                uid = rng.randrange(0, 1 << rng.randrange(8, 50))
            keys.add((addr, uid))
        payload = schema.encode_keyset(keys)
        assert payload[0] == schema.KEYSET_MAGIC
        assert set(schema.decode_keyset(payload)) == keys
        assert set(schema.decode_keyset_any(payload)) == keys
        assert set(schema.decode_keyset_any(
            schema.encode_keyset_json(keys))) == keys
    assert schema.decode_keyset(schema.encode_keyset([])) == []
    assert schema.SCHEMA_DIST_KEYS in schema.peer_schema_ids(
        (schema.capability(),))


def owned_and_foreign(pmap, address="uigc://a"):
    owned = foreign = None
    for uid in range(200):
        cell = FakeCell(address, uid)
        if pmap.owns(cell_key(cell)):
            owned = owned or cell
        else:
            foreign = foreign or cell
        if owned is not None and foreign is not None:
            return owned, foreign
    raise AssertionError("no owned/foreign pair")


def two_node_graph():
    context = CrgcContext(delta_graph_size=64, entry_field_size=8)
    g = PartitionedShadowGraph(context, "uigc://a")
    pmap = PartitionMap(["uigc://a", "uigc://b"], 32, fence=0,
                        self_address="uigc://a")
    g.set_partition_map(pmap)
    return context, g, pmap


def test_mirror_decay_evicts_and_revives():
    context, g, pmap = two_node_graph()
    owned, foreign = owned_and_foreign(pmap)
    delta = DeltaGraph("uigc://a", context)
    delta.fold_self(owned, 0, False, True)
    delta.fold_created(owned, foreign)
    g.merge_delta(delta)
    g.audit_fold_locality()
    assert g.shadow_for_key(cell_key(foreign)) is not None
    pop0 = len(g.from_set)
    assert g.decay_mirrors(3) == 0
    touch = DeltaGraph("uigc://a", context)
    touch.fold_self(owned, 0, False, True)
    touch.touch(foreign)
    g.merge_delta(touch)
    g.audit_fold_locality()
    assert g.decay_mirrors(3) == 0 and g.decay_mirrors(3) == 0
    evicted = sum(g.decay_mirrors(3) for _ in range(5))
    assert evicted == 1
    assert len(g.from_set) == pop0 - 1
    assert g.shadow_for_key(cell_key(foreign)) is None
    foreign_shadow = g.shadow_map[foreign]
    owned_shadow = g.shadow_map[owned]
    assert owned_shadow.outgoing.get(foreign_shadow) == 1
    release = DeltaGraph("uigc://a", context)
    release.fold_self(owned, 0, False, True)
    release.fold_deactivate(owned, foreign)
    g.merge_delta(release)
    g.audit_fold_locality()
    assert owned_shadow.outgoing.get(foreign_shadow) is None
    g.evicted[foreign] = foreign_shadow  # a still-parked mirror
    g.set_partition_map(PartitionMap(["uigc://a"], 32, fence=1,
                                     self_address="uigc://a"))
    assert g.shadow_for_key(cell_key(foreign)) is not None
    assert not g.evicted


def test_fold_locality_audit_flags_foreign_fold():
    context, g, pmap = two_node_graph()
    owned, foreign = owned_and_foreign(pmap)
    delta = DeltaGraph("uigc://a", context)
    delta.fold_self(owned, 0, False, False)
    delta.fold_self(foreign, 1, False, False)
    g.merge_delta(delta)
    assert g.audit_fold_locality() == [cell_key(foreign)]
    delta2 = DeltaGraph("uigc://a", context)
    delta2.fold_self(owned, 0, True, False)
    g.merge_delta(delta2)
    assert g.audit_fold_locality() == []


def test_ingress_entry_fence_wire_round_trip():
    entry = IngressEntry()
    entry.id, entry.fence, entry.nonce = 3, 2, 0xDEADBEEFCAFE
    entry.egress_address, entry.ingress_address = "uigc://dead", "uigc://obs"
    entry.on_message(FakeCell("uigc://obs", 77), [])
    cells = {}

    def encode_cell(c):
        cells[b"t"] = c
        return b"t"

    buf = entry.serialize(encode_cell)
    back = IngressEntry.deserialize(buf, lambda b: cells[b])
    assert (back.fence, back.id, back.nonce) == (2, 3, 0xDEADBEEFCAFE)
    assert back == entry
    fence_only = IngressEntry.deserialize(buf[:-8], lambda b: cells[b])
    assert (fence_only.fence, fence_only.nonce) == (2, 0)
    legacy = IngressEntry.deserialize(buf[:-12], lambda b: cells[b])
    assert (legacy.fence, legacy.nonce) == (0, 0)
    assert legacy.admitted == entry.admitted


def straggler(ingress, fence, recipient=None, n_msgs=0, wid=0, final=False):
    e = IngressEntry()
    e.id, e.fence, e.is_final = wid, fence, final
    e.egress_address, e.ingress_address = "uigc://dead", ingress
    for _ in range(n_msgs):
        e.on_message(recipient, [])
    return e


def test_undo_log_fences_refuse_stragglers():
    """The undo log's fence discipline: pre-death stragglers, floors
    seeded across a rejoin, incarnation nonces, and supersession."""
    log = UndoLog("uigc://dead", fence=1, own_address="uigc://me")
    assert log.stale_fence(straggler("uigc://me", 0)) is True
    assert log.stale_fence(straggler("uigc://me", 1)) is False
    assert log.stale_fence(straggler("uigc://peer", 0)) is False
    assert log.stale_fence(straggler("uigc://peer", 1)) is False
    assert log.stale_fence(straggler("uigc://peer", 0)) is True
    assert log.stale_fence(straggler("uigc://me", 0, final=True)) is True
    assert "uigc://me" not in log.finalized_by

    me = FakeCell("uigc://me", 9)
    old = UndoLog("uigc://dead", fence=0, own_address="uigc://me")
    assert old.stale_fence(straggler("uigc://b", 0, me, 1)) is False
    fresh = UndoLog("uigc://dead", fence=1, own_address="uigc://me")
    fresh.seed_floors(old)
    assert fresh.stale_fence(straggler("uigc://b", 0, me, 1)) is True
    assert fresh.stale_fence(straggler("uigc://b", 1, me, 1)) is False
    assert fresh.stale_fence(straggler("uigc://c", 0, me, 1)) is False
    third = UndoLog("uigc://dead", fence=2, own_address="uigc://me")
    third.seed_floors(fresh)
    assert third.stale_fence(straggler("uigc://b", 0, me, 1)) is True

    log = UndoLog("uigc://dead", fence=1, own_address="uigc://me",
                  expected_nonce=0xA1)
    stale = straggler("uigc://c", 0, me, 3, final=True)
    stale.nonce = 0xA0
    assert log.stale_fence(stale) is True
    assert "uigc://c" not in log.finalized_by
    genuine = straggler("uigc://c", 0, me, 2, final=True)
    genuine.nonce = 0xA1
    assert log.stale_fence(genuine) is False
    log.merge_ingress_entry(genuine)
    assert "uigc://c" in log.finalized_by
    assert log.admitted[me].message_count == -2
    assert log.stale_fence(straggler("uigc://d", 0, me, 1)) is False

    log = UndoLog("uigc://dead", fence=1, own_address="uigc://me")
    stale = straggler("uigc://b", 0, me, 3, wid=7, final=True)
    assert log.stale_fence(stale) is False
    log.merge_ingress_entry(stale)
    assert log.admitted[me].message_count == -3
    live = straggler("uigc://b", 1, me, 2)
    assert log.stale_fence(live) is False
    log.merge_ingress_entry(live)
    assert "uigc://b" not in log.finalized_by
    assert log.admitted[me].message_count == -2
    log.merge_ingress_entry(straggler("uigc://b", 1, me, 1, wid=1, final=True))
    assert "uigc://b" in log.finalized_by
    assert log.admitted[me].message_count == -3
    assert log.stale_fence(straggler("uigc://b", 0, me, 5)) is True
    for wid in range(2, 52):
        log.merge_ingress_entry(straggler("uigc://b", 1, me, 0, wid=wid))
    assert len(log._applied_net.get("uigc://b", {})) <= 1
    assert log._applied_counts.get("uigc://b", 0) == 2


def test_ingress_windows_key_by_peer_fence():
    from uigc_tpu_torch.engines.crgc.gateways import Ingress
    from uigc_tpu_torch.engines.crgc.messages import AppMsg

    sent = []

    class FakeEngine:
        def __init__(self):
            self._fence = 0
            self.bookkeeper_cell = types.SimpleNamespace(
                tell=lambda msg: sent.append(msg.entry))

        def link_fence(self, address):
            return self._fence

    link = types.SimpleNamespace(
        src=types.SimpleNamespace(address="uigc://peer"),
        dst=types.SimpleNamespace(address="uigc://me"))
    engine = FakeEngine()
    ingress = Ingress(link, engine)
    recipient = FakeCell("uigc://me", 5)
    msg = AppMsg(None, (), None)
    msg.window_id = 0
    ingress.on_message(recipient, msg)
    engine._fence = 1
    ingress.on_messages(recipient, [msg, msg])
    assert sorted(ingress.open_windows()) == [(0, 0), (1, 0)]
    assert ingress.entries[(0, 0)].admitted[recipient].message_count == 1
    assert ingress.entries[(1, 0)].admitted[recipient].message_count == 2
    ingress.finalize_window(0)
    assert ingress.open_windows() == [(0, 0)]
    assert sent[-1].fence == 1
    ingress.finalize_all(is_final=True)
    assert sent[-1].is_final and sent[-1].fence == 1
    assert ingress.open_windows() == []


def test_dmark_retransmit_reorder_cannot_lose_marks():
    from uigc_tpu_torch.engines.crgc.distributed import (
        DistributedBookkeeper, DMark, _WaveState)

    context = CrgcContext(delta_graph_size=64, entry_field_size=8)

    class StubConfig:
        def get_int(self, key):
            return {"uigc.crgc.dist-partitions": 8,
                    "uigc.cluster.num-shards": 8,
                    "uigc.crgc.mirror-decay-waves": 0}[key]

    class StubSystem:
        address = "uigc://a"
        fabric = None
        config = StubConfig()

    class StubEngine:
        system = StubSystem()
        crgc_context = context
        num_nodes = 2

        def make_shadow_graph(self):
            return PartitionedShadowGraph(context, "uigc://a")

    bk = DistributedBookkeeper(StubEngine())
    early = wire.decode_dmark(wire.encode_dmark(1, 0, "uigc://b",
                                                [("uigc://a", 1)]))
    bk._on_dmark(DMark(*early))  # before the partition map: refused
    assert bk.ws is None
    members = ["uigc://a", "uigc://b"]
    bk.pmap = PartitionMap(members, 8, fence=0, self_address="uigc://a")
    bk.tree = ReductionTree(members)
    bk.started = True
    g = bk.shadow_graph
    g.set_partition_map(bk.pmap)
    owned = [u for u in range(64) if bk.pmap.owns(("uigc://a", u))][:3]
    assert len(owned) == 3
    sender_list = [("uigc://a", owned[1]), ("uigc://a", owned[0]),
                   ("uigc://a", owned[2])]
    for _a, uid in sender_list:
        g.make_shadow(FakeCell("uigc://a", uid))
    bk.ws = _WaveState(1, 0)
    bk.ws.seeded = True

    def deliver(chunk, start):
        decoded = wire.decode_dmark(
            wire.encode_dmark(1, 0, "uigc://b", chunk, start=start))
        assert decoded is not None
        bk._on_dmark(DMark(*decoded))

    deliver([sender_list[0]], 0)
    deliver(sender_list, 0)  # a full retransmit, decoded in sorted order
    marked = {cell_key(s.self_cell) for s in bk.ws.marked}
    assert set(sender_list) <= marked
    assert bk.ws.recv_upto["uigc://b"] == 3
    assert bk.ws.recv_total() == 3
    foreign = next(u for u in range(64) if not bk.pmap.owns(("uigc://a", u)))
    deliver([("uigc://a", foreign)], 3)  # misrouted: forwarded, not consumed
    assert ("uigc://a", foreign) in bk.ws.out_sets.get("uigc://b", set())
    assert ("uigc://a", foreign) not in {cell_key(s.self_cell)
                                         for s in bk.ws.marked}


def wave_bookkeeper(side):
    """``side``'s DistributedBookkeeper for node a of {a, b}, in wave 1,
    over a stub engine whose fabric records what it is sent."""
    root = {"ref": "uigc_tpu", "port": "uigc_tpu_torch"}[side]
    dist = __import__(f"{root}.engines.crgc.distributed", fromlist=["x"])
    part = __import__(f"{root}.parallel.partition", fromlist=["x"])
    state = __import__(f"{root}.engines.crgc.state", fromlist=["x"])
    undo = __import__(f"{root}.engines.crgc.undo", fromlist=["x"])
    context = state.CrgcContext(delta_graph_size=64, entry_field_size=8)
    sent = []

    class StubConfig:
        def get_int(self, key):
            return {"uigc.crgc.dist-partitions": 8,
                    "uigc.cluster.num-shards": 8,
                    "uigc.crgc.mirror-decay-waves": 0}[key]

    class StubSystem:
        address = "uigc://a"
        fabric = types.SimpleNamespace(
            control_send=lambda system, gc, msg: sent.append(msg))
        config = StubConfig()

    class StubEngine:
        system = StubSystem()
        crgc_context = context
        num_nodes = 2

        def make_shadow_graph(self):
            return dist.PartitionedShadowGraph(context, "uigc://a")

    bk = dist.DistributedBookkeeper(StubEngine())
    members = ["uigc://a", "uigc://b"]
    bk.pmap = part.PartitionMap(members, 8, fence=0, self_address="uigc://a")
    bk.tree = part.ReductionTree(members)
    bk.started = True
    bk.remote_gcs["uigc://b"] = object()
    bk.undo_logs["uigc://b"] = undo.UndoLog("uigc://b", fence=0,
                                            own_address="uigc://a")
    bk.shadow_graph.set_partition_map(bk.pmap)
    return bk, dist, context, sent


def test_a_delta_routed_before_the_wave_folds_into_it():
    """Node b folds its own half of a new actor w's first entry (w
    interned, its receive balance settled) and ships the other half, the
    created edge master -> w, to a, the master's owner, which has
    already entered wave 1.  The edge must count in wave 1: the master's
    mark must reach w.  The reference defers the delta past the wave, so
    wave 1 relays no mark for w and b's sweep gates w's kill through a,
    where the master is marked.  The port folds the delta into the wave
    because its stamp says b routed it before b's wave 1; a delta routed
    within wave 1 still waits."""
    relayed = {}
    for side in ("ref", "port", "port-late"):
        bk, dist, context, sent = wave_bookkeeper(side.split("-")[0])
        owns = bk.pmap.owns
        master = next(FakeCell("uigc://a", u) for u in range(1, 64)
                      if owns(("uigc://a", u)))
        w = next(FakeCell("uigc://b", u) for u in range(1, 64)
                 if not owns(("uigc://b", u)))
        own = DeltaGraph("uigc://a", context)
        own.fold_self(master, 0, False, True)  # the master: a root
        bk.shadow_graph.merge_delta(own)
        bk.wave = 1
        bk.ws = dist._WaveState(1, 0)
        bk._fixpoint(bk.ws)
        edge = DeltaGraph("uigc://b", context)
        edge.fold_created(master, w)
        if side == "ref":
            bk.handle_delta(edge)
        else:
            cut = 1 if side == "port-late" else 0
            bk.on_message(dist.DDelta(0, edge, 0, cut))
        bk._fixpoint(bk.ws)
        relayed[side] = cell_key(w) in bk.ws.out_sets.get("uigc://b", set())
    assert relayed == {"ref": False, "port": True, "port-late": False}


# --------------------------------------------------------------------- #
# Three nodes on the in-process fabric
# --------------------------------------------------------------------- #


class PortHold(uigc_tpu_torch.Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


class RefHold(uigc_tpu.Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


class PortTag(uigc_tpu_torch.NoRefs):
    def __init__(self, tag):
        self.tag = tag


class RefTag(uigc_tpu.NoRefs):
    def __init__(self, tag):
        self.tag = tag


SIDES = {
    "port": (uigc_tpu_torch, port_fabric, port_system, port_remote,
             (PortHold, PortTag)),
    "ref": (uigc_tpu, ref_fabric, ref_system, ref_remote, (RefHold, RefTag)),
}


class Rings:
    """The ring workload of ``tests/test_distributed.py`` on one package:
    each ring has one worker per spawner (a cycle across the cluster),
    the master keeps the last ``kept`` rings and drops the rest.  Stops
    are recorded as (ring, position)."""

    def __init__(self, side, systems, spawner_systems):
        pkg, _, _, remote, (hold, tag) = SIDES[side]
        self.spawned = 0
        self.stopped = []
        self.cond = threading.Condition()
        rings = self

        class Worker(pkg.AbstractBehavior):
            def __init__(self, context):
                super().__init__(context)
                self.held = []
                self.tag = None
                with rings.cond:
                    rings.spawned += 1
                    rings.cond.notify_all()

            def on_message(self, msg):
                if isinstance(msg, hold):
                    self.held.append(msg.ref)
                elif isinstance(msg, tag):  # (ring, position)
                    self.tag = msg.tag
                return self

            def on_signal(self, signal):
                if signal is pkg.PostStop:
                    with rings.cond:
                        rings.stopped.append(self.tag)
                        rings.cond.notify_all()
                return None

        class Master(pkg.AbstractBehavior):
            def __init__(self, context, spawners):
                super().__init__(context)
                self.spawners = spawners
                self.workers = []
                self.kept = []

            def on_message(self, msg):
                ctx = self.context
                if msg[0] == "go":
                    _, n_rings, n_kept = msg
                    for r in range(n_rings + n_kept):
                        ring = [ctx.spawn_remote("worker", sc)
                                for sc in self.spawners]
                        for i, w in enumerate(ring):
                            w.tell(hold(ctx.create_ref(ring[(i + 1) % len(ring)],
                                                       w)), ctx)
                            w.tell(tag((r, i)), ctx)
                        (self.kept if r >= n_rings else self.workers).extend(ring)
                elif msg[0] == "drop":
                    for w in self.workers:
                        ctx.release(w)
                    self.workers = []
                return self

        spawners = [remote.RemoteSpawner.spawn_service(
            s, {"worker": pkg.Behaviors.setup(Worker)})
            for s in spawner_systems]
        self.master = systems[0].spawn_root(pkg.Behaviors.setup_root(
            lambda ctx: Master(ctx, spawners)), "master")

    def wait(self, pred, timeout_s=30.0):
        with self.cond:
            return self.cond.wait_for(lambda: pred(self), timeout_s)

    def run(self, n_rings, n_kept, width):
        """Build, hold, drop; returns the (ring, position) tags that
        stopped after the drop, or raises if anything stopped early."""
        self.master.tell(("go", n_rings, n_kept))
        assert self.wait(lambda r: r.spawned == (n_rings + n_kept) * width)
        time.sleep(0.4)
        assert self.stopped == []  # the master holds every ring
        self.master.tell(("drop",))
        assert self.wait(lambda r: len(r.stopped) >= n_rings * width)
        time.sleep(0.5)  # the kept rings must survive more waves
        with self.cond:
            return sorted(self.stopped)


def build(side, name, distributed=True, nodes=3):
    _, fabric_mod, system_mod, _, _ = SIDES[side]
    config = dict(BASE, **{"uigc.crgc.num-nodes": nodes})
    if not distributed:
        config.update({"uigc.crgc.num-nodes": 1,
                       "uigc.crgc.distributed": False,
                       "uigc.crgc.shadow-graph": "oracle"})
        system = system_mod.ActorSystem(None, name=name, config=config)
        return [system], [system] * 3
    fabric = fabric_mod.Fabric()
    systems = [system_mod.ActorSystem(None, name=f"{name}{i}", config=config,
                                      fabric=fabric) for i in range(nodes)]
    return systems, systems


class EventLog:
    def __init__(self):
        self.entries = []
        self._lock = threading.Lock()

    def __call__(self, name, fields):
        with self._lock:
            self.entries.append((name, dict(fields)))

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


def test_three_node_cycle_collected_without_full_replica(event_log):
    """Garbage cycles spanning all three nodes collect while no node folds
    the full graph, every fold stays inside its owned slice, and the
    merged per-node oracles confirm every sweep verdict."""
    systems, spawner_systems = build("port", "pdn")
    rings, kept = 5, 2
    try:
        work = Rings("port", systems, spawner_systems)
        stopped = work.run(rings, kept, 3)
        assert stopped == [(r, i) for r in range(rings) for i in range(3)]
        graphs = [s.engine.bookkeeper.shadow_graph for s in systems]
        pops = [len(g.from_set) for g in graphs]
        owned = [g.owned_population() for g in graphs]
        assert sum(owned) >= kept * 3
        for pop, own in zip(pops, owned):
            assert own <= pop
            assert own < sum(owned)
        assert not event_log.of(events.DIST_LOCALITY)
        for g in graphs:
            assert g.audit_fold_locality() == []
        assert event_log.of(events.DIST_WAVE)
        assert event_log.of(events.DIST_MARKS)
        assert event_log.of(events.DIST_ROUND)
        time.sleep(0.3)
        assert len(merged_oracle(systems).garbage) >= rings * 3
        assert cross_check_distributed(systems) == []
        for s in systems:
            assert s.sanitizer.violations == []
            assert s.sanitizer.dist_sweeps > 0
    finally:
        for s in systems:
            s.terminate()


def test_verdict_parity_with_single_host_and_the_reference():
    """The same ring workload on the port's partitioned three-node
    collector, the port's single-host collector and the reference's
    partitioned collector: the same actors stop."""
    rings, kept = 4, 2
    results = {}
    for key, side, distributed in (("port", "port", True),
                                   ("single", "port", False),
                                   ("ref", "ref", True)):
        systems, spawner_systems = build(side, f"vp{key}", distributed)
        try:
            results[key] = Rings(side, systems, spawner_systems).run(
                rings, kept, 3)
        finally:
            for s in systems:
                s.terminate()
    want = [(r, i) for r in range(rings) for i in range(3)]
    assert results["port"] == results["single"] == results["ref"] == want
