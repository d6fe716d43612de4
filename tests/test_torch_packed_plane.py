"""The port's counterpart of ``tests/test_packed_plane.py``: the same tests, names and
assertions, on ``uigc_tpu_torch``.

Differential test: the packed entry plane (packed.py) against the
object Entry plane over identical operation scripts.

Two independent worlds run the same random script of CRGC mutator
operations (create ref / spawn / receive / send+update / release /
flush), one flushing object Entries folded by ``merge_entries``, the
other flushing packed rows folded by ``merge_packed``.  After every
drain — and after a kill sweep that frees slots and forces uid
re-interning — the graphs must agree exactly (flags, receive counts,
supervisors, edge weights), keyed by actor uid since slot numbering
legitimately differs between planes.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from uigc_tpu_torch.engines.crgc.arrays import ArrayShadowGraph
from uigc_tpu_torch.engines.crgc.packed import PackedPlane, PackedRing
from uigc_tpu_torch.engines.crgc.refob import CrgcRefob
from uigc_tpu_torch.engines.crgc.state import CrgcContext, CrgcState, Entry
from uigc_tpu_torch.ops import trace as trace_ops

_F = trace_ops


class FakeSystem:
    def __init__(self, address="uigc://packedtest"):
        self.address = address


class FakeCell:
    __slots__ = ("uid", "system")

    def __init__(self, uid, system):
        self.uid = uid
        self.system = system

    def tell(self, msg):
        pass


class World:
    """One plane's half of the differential: its own cells (same uids),
    states, refobs, graph, and flush route."""

    def __init__(self, n, packed: bool):
        self.packed = packed
        self.ctx = CrgcContext(delta_graph_size=64, entry_field_size=4)
        system = FakeSystem()
        self.cells = [FakeCell(uid, system) for uid in range(1, n + 1)]
        self.states = [
            CrgcState(CrgcRefob(c), self.ctx) for c in self.cells
        ]
        self.graph = ArrayShadowGraph(self.ctx, system.address)
        self.refobs = {}  # (owner idx, target idx) -> live refob
        self.entries = []
        if packed:
            self.plane = PackedPlane(self.ctx.entry_field_size)
            by_uid = {c.uid: c for c in self.cells}
            self.graph.attach_packed_plane(self.plane, by_uid.get)

    def flush(self, a, busy):
        if self.packed:
            self.states[a].flush_to_ring(busy, self.plane)
        else:
            e = Entry(self.ctx)
            self.states[a].flush_to_entry(busy, e)
            self.entries.append(e)

    def drain(self):
        if self.packed:
            rows = self.plane.drain()
            if rows is not None:
                self.graph.merge_packed(rows)
        else:
            if self.entries:
                self.graph.merge_entries(self.entries)
                self.entries = []

    def snapshot(self):
        """uid-keyed graph state (slot numbering is plane-specific)."""
        g = self.graph
        slot_uid = {}
        for cell, slot in g.slot_of.items():
            slot_uid[slot] = cell.uid
        nodes = {
            uid: (
                int(g.flags[slot]),
                int(g.recv_count[slot]),
                slot_uid.get(int(g.supervisor[slot]), -1),
            )
            for slot, uid in slot_uid.items()
        }
        edges = {}
        for key, eid in g.edge_of.items():
            w = int(g.edge_weight[eid])
            if w != 0:
                edges[(slot_uid[key >> 32], slot_uid[key & 0xFFFFFFFF])] = w
        return nodes, edges


def _run_script(rng, worlds, n, ops_per_round):
    """One round of identical random mutator ops on every world."""
    for _ in range(ops_per_round):
        a = int(rng.integers(0, n))
        r = rng.random()
        if r < 0.3:  # create a ref owner -> target
            o = int(rng.integers(0, n))
            t = int(rng.integers(0, n))
            for w in worlds:
                st = w.states[a]
                if not st.can_record_new_refob():
                    w.flush(a, True)
                st.record_new_refob(
                    CrgcRefob(w.cells[o]), CrgcRefob(w.cells[t])
                )
        elif r < 0.45:  # spawn child
            c = int(rng.integers(0, n))
            for w in worlds:
                st = w.states[a]
                if not st.can_record_new_actor():
                    w.flush(a, True)
                st.record_new_actor(CrgcRefob(w.cells[c]))
        elif r < 0.6:  # receive a message
            for w in worlds:
                st = w.states[a]
                if not st.can_record_message_received():
                    w.flush(a, True)
                st.record_message_received()
        elif r < 0.85:  # send along a (possibly new) refob
            t = int(rng.integers(0, n))
            for w in worlds:
                st = w.states[a]
                ref = w.refobs.get((a, t))
                if ref is None:
                    ref = CrgcRefob(w.cells[t])
                    w.refobs[(a, t)] = ref
                if not ref.can_inc_send_count() or not st.can_record_updated_refob(ref):
                    w.flush(a, True)
                ref.inc_send_count()
                st.record_updated_refob(ref)
        else:  # release the refob if one is live
            t = int(rng.integers(0, n))
            for w in worlds:
                st = w.states[a]
                ref = w.refobs.pop((a, t), None)
                if ref is None:
                    continue
                if not st.can_record_updated_refob(ref):
                    w.flush(a, True)
                ref.deactivate()
                st.record_updated_refob(ref)
    # end-of-round: every actor flushes (idle), half busy
    for a in range(n):
        busy = bool(a & 1)
        for w in worlds:
            w.flush(a, busy)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_plane_matches_object_plane(seed):
    rng = np.random.default_rng(seed)
    n = 64
    obj = World(n, packed=False)
    pk = World(n, packed=True)
    worlds = [obj, pk]
    # mark some roots (mirrored)
    for a in range(0, n, 16):
        obj.states[a].mark_as_root()
        pk.states[a].mark_as_root()

    for round_ in range(6):
        _run_script(rng, worlds, n, ops_per_round=200)
        for w in worlds:
            w.drain()
        no, eo = obj.snapshot()
        np_, ep = pk.snapshot()
        assert no == np_, f"seed {seed} round {round_}: node state diverged"
        assert eo == ep, f"seed {seed} round {round_}: edge state diverged"

    # Kill sweep: frees slots, must invalidate uid mappings in the
    # packed graph; the next rounds re-intern freed uids.
    for w in worlds:
        w.graph.trace(should_kill=True)
    no, eo = obj.snapshot()
    np_, ep = pk.snapshot()
    assert no == np_ and eo == ep, f"seed {seed}: post-sweep state diverged"

    for round_ in range(3):
        _run_script(rng, worlds, n, ops_per_round=150)
        for w in worlds:
            w.drain()
        for w in worlds:
            w.graph.trace(should_kill=True)
        no, eo = obj.snapshot()
        np_, ep = pk.snapshot()
        assert no == np_, f"seed {seed} churn round {round_}: nodes diverged"
        assert eo == ep, f"seed {seed} churn round {round_}: edges diverged"


def test_out_of_order_batches_respect_flush_stamps():
    """Per-thread rings drain independently, so a LATER batch can carry
    an EARLIER flush of the same actor (the actor migrated workers
    between flushes).  Stale busy/root and supervisor writes must lose
    to the stamps already applied; commutative facts (recv) still
    sum."""
    from uigc_tpu_torch.engines.crgc.packed import row_width
    from uigc_tpu_torch.ops import trace as F

    ctx = CrgcContext(delta_graph_size=64, entry_field_size=4)
    system = FakeSystem()
    cells = [FakeCell(uid, system) for uid in range(1, 6)]
    graph = ArrayShadowGraph(ctx, system.address)
    plane = PackedPlane(4)
    by_uid = {c.uid: c for c in cells}
    graph.attach_packed_plane(plane, by_uid.get)
    W = row_width(4)

    def row(seq, uid, busy, root, recv=0, spawned=(), sup_parent=None):
        r = np.full(W, -1, dtype=np.int64)
        r[0] = seq
        r[1] = uid
        r[2] = (1 if busy else 0) | (2 if root else 0)
        r[3] = recv
        for i, s in enumerate(spawned):
            r[4 + 8 + i] = s
        return r

    # seq 10: actor 1 busy, root, supervisor(child 2 -> parent 1)
    newer = row(10, 1, busy=True, root=True, recv=3, spawned=(2,))
    # seq 5: the STALE flush — not busy, not root, child 2's parent = 3
    stale_parent = np.full(W, -1, dtype=np.int64)
    stale_parent[0] = 5
    stale_parent[1] = 3
    stale_parent[2] = 0
    stale_parent[3] = 1
    stale_parent[4 + 8] = 2  # actor 3 claims child 2
    stale_self = row(4, 1, busy=False, root=False, recv=2)

    graph.merge_packed(np.stack([newer]))
    s1 = graph.slot_of[cells[0]]
    s2 = graph.slot_of[cells[1]]
    assert graph.flags[s1] & F.FLAG_BUSY and graph.flags[s1] & F.FLAG_ROOT
    assert graph.supervisor[s2] == s1

    # the stale batch arrives afterwards
    graph.merge_packed(np.stack([stale_self, stale_parent]))
    assert graph.flags[s1] & F.FLAG_BUSY, "stale busy=0 must not regress"
    assert graph.flags[s1] & F.FLAG_ROOT, "stale root=0 must not regress"
    assert graph.supervisor[s2] == s1, "stale supervisor must not regress"
    # commutative recv still summed from both batches
    assert graph.recv_count[s1] == 5

    # a genuinely newer flush still wins
    graph.merge_packed(np.stack([row(20, 1, busy=False, root=False)]))
    assert not (graph.flags[s1] & F.FLAG_BUSY)
    assert not (graph.flags[s1] & F.FLAG_ROOT)


def test_proven_garbage_uid_fields_dropped():
    """A row naming a uid that was swept AND whose cell is gone must
    fold without error, its fields dropped (garbage is monotone)."""
    ctx = CrgcContext(delta_graph_size=64, entry_field_size=4)
    system = FakeSystem()
    registry = {}
    graph = ArrayShadowGraph(ctx, system.address)
    plane = PackedPlane(4)
    graph.attach_packed_plane(plane, registry.get)
    from uigc_tpu_torch.engines.crgc.packed import row_width

    W = row_width(4)
    live = FakeCell(1, system)
    registry[1] = live
    r = np.full(W, -1, dtype=np.int64)
    r[0] = 0
    r[1] = 1
    r[2] = 1
    r[3] = 0
    # created pair: owner 1 -> target 99 (uid 99 resolves nowhere)
    r[4] = 1
    r[5] = 99
    graph.merge_packed(np.stack([r]))
    s1 = graph.slot_of[live]
    assert graph.flags[s1]  # row itself folded
    assert len(graph.edge_of) == 0  # dead-uid edge dropped
    assert 99 not in [c.uid for c in graph.slot_of]


def test_sweep_unpins_uid_strong():
    """The sweep must drop the plane's strong pins for freed uids or
    every actor ever spawned stays pinned forever."""
    import time

    from uigc_tpu_torch.interfaces import Message
    from uigc_tpu_torch.runtime.behaviors import AbstractBehavior, Behaviors
    from uigc_tpu_torch.runtime.testkit import ActorTestKit

    class Release(Message):
        @property
        def refs(self):
            return []

    class Kid(AbstractBehavior):
        def on_message(self, msg):
            return self

    kit = ActorTestKit({"uigc.crgc.wakeup-interval": 10})
    try:
        eng = kit.system.engine
        state = {}

        def root_setup(ctx):
            state["kids"] = [
                ctx.spawn(Behaviors.setup(lambda c: Kid(c)), f"k{i}")
                for i in range(10)
            ]

            class Root(AbstractBehavior):
                def on_message(self, msg):
                    if isinstance(msg, Release):
                        ctx.release(state["kids"])
                    return self

            return Root(ctx)

        root = kit.spawn(Behaviors.setup_root(root_setup), "root")
        time.sleep(0.3)
        kid_uids = {k.target.uid for k in state["kids"]}
        root.tell(Release())
        deadline = time.time() + 20
        leaked = kid_uids
        while time.time() < deadline:
            leaked = kid_uids & set(eng.packed_plane.uid_strong)
            if not leaked:
                break
            time.sleep(0.1)
        assert not leaked, f"uid pins leaked for dead actors: {leaked}"
    finally:
        kit.shutdown()


def test_ring_wraps_and_grows():
    ring = PackedRing(width=4, cap=8)
    out = []
    for i in range(5):
        v = ring.begin()
        v[:] = i
        ring.commit()
    got = ring.drain()
    out.append(got)
    assert got.shape == (5, 4) and got[:, 0].tolist() == [0, 1, 2, 3, 4]
    # wrap across the boundary
    for i in range(5, 11):
        v = ring.begin()
        v[:] = i
        ring.commit()
    got = ring.drain()
    assert got[:, 0].tolist() == [5, 6, 7, 8, 9, 10]
    # overflow without a drain: grows, order preserved
    for i in range(20):
        v = ring.begin()
        v[:] = 100 + i
        ring.commit()
    got = ring.drain()
    assert got[:, 0].tolist() == [100 + i for i in range(20)]
    assert ring.cap >= 16
    assert ring.drain() is None


def test_ring_concurrent_writer_reader():
    """Smoke the SPSC contract: one writer thread, one reader thread,
    every committed row arrives exactly once in order."""
    import time

    ring = PackedRing(width=2, cap=16)
    total = 20_000
    seen = []
    stop = threading.Event()

    def reader():
        while True:
            got = ring.drain()
            if got is not None:
                seen.append(got[:, 0].copy())
            elif stop.is_set():
                # one final drain AFTER observing stop: the writer may
                # have committed between our empty drain and the flag
                got = ring.drain()
                if got is not None:
                    seen.append(got[:, 0].copy())
                break
            else:
                # yield instead of busy-spinning: under a loaded
                # machine a spinning reader can starve the writer (and
                # this test's join) for tens of seconds
                time.sleep(0.0005)

    t = threading.Thread(target=reader)
    t.start()
    for i in range(total):
        v = ring.begin()
        v[0] = i
        v[1] = -i
        ring.commit()
    stop.set()
    t.join(timeout=120)
    assert not t.is_alive()
    flat = np.concatenate(seen) if seen else np.empty(0)
    assert flat.shape[0] == total
    assert flat.tolist() == list(range(total))


def test_packed_plane_default_on_single_node():
    """Engine wiring: single-node array backend gets the plane; the
    oracle backend (no array fold) does not."""
    from uigc_tpu_torch.runtime.testkit import ActorTestKit

    kit = ActorTestKit({"uigc.crgc.wakeup-interval": 10})
    try:
        assert kit.system.engine.packed_plane is not None
    finally:
        kit.shutdown()
    kit = ActorTestKit(
        {"uigc.crgc.wakeup-interval": 10, "uigc.crgc.shadow-graph": "oracle"}
    )
    try:
        assert kit.system.engine.packed_plane is None
    finally:
        kit.shutdown()


# --------------------------------------------------------------------- #
# Parity: the same seeded script drains the same rows in both packages
# --------------------------------------------------------------------- #


def _script_ops(rng, n, ops_per_round):
    """One round of ``_run_script``'s random mutator ops, drawn as data
    so each package's world can replay it with its own classes."""
    ops = []
    for _ in range(ops_per_round):
        a = int(rng.integers(0, n))
        r = rng.random()
        if r < 0.3:
            ops.append(("create", a, int(rng.integers(0, n)), int(rng.integers(0, n))))
        elif r < 0.45:
            ops.append(("spawn", a, int(rng.integers(0, n))))
        elif r < 0.6:
            ops.append(("recv", a))
        elif r < 0.85:
            ops.append(("send", a, int(rng.integers(0, n))))
        else:
            ops.append(("release", a, int(rng.integers(0, n))))
    return ops


class _PkgPackedWorld:
    """A packed-plane world built from one package's classes (the
    reference's or the port's), replaying scripted ops."""

    def __init__(self, pkg, n):
        import importlib

        def mod(name):
            return importlib.import_module(f"{pkg}.{name}")

        state = mod("engines.crgc.state")
        self.Refob = mod("engines.crgc.refob").CrgcRefob
        self.ctx = state.CrgcContext(delta_graph_size=64, entry_field_size=4)
        system = FakeSystem()
        self.cells = [FakeCell(uid, system) for uid in range(1, n + 1)]
        self.states = [state.CrgcState(self.Refob(c), self.ctx)
                       for c in self.cells]
        self.graph = mod("engines.crgc.arrays").ArrayShadowGraph(
            self.ctx, system.address)
        self.plane = mod("engines.crgc.packed").PackedPlane(
            self.ctx.entry_field_size)
        by_uid = {c.uid: c for c in self.cells}
        self.graph.attach_packed_plane(self.plane, by_uid.get)
        self.refobs = {}
        for a in range(0, n, 16):
            self.states[a].mark_as_root()

    def apply(self, ops):
        for op in ops:
            kind, a = op[0], op[1]
            st = self.states[a]
            if kind == "create":
                if not st.can_record_new_refob():
                    st.flush_to_ring(True, self.plane)
                st.record_new_refob(self.Refob(self.cells[op[2]]),
                                    self.Refob(self.cells[op[3]]))
            elif kind == "spawn":
                if not st.can_record_new_actor():
                    st.flush_to_ring(True, self.plane)
                st.record_new_actor(self.Refob(self.cells[op[2]]))
            elif kind == "recv":
                if not st.can_record_message_received():
                    st.flush_to_ring(True, self.plane)
                st.record_message_received()
            elif kind == "send":
                ref = self.refobs.get((a, op[2]))
                if ref is None:
                    ref = self.Refob(self.cells[op[2]])
                    self.refobs[(a, op[2])] = ref
                if not ref.can_inc_send_count() or not st.can_record_updated_refob(ref):
                    st.flush_to_ring(True, self.plane)
                ref.inc_send_count()
                st.record_updated_refob(ref)
            else:
                ref = self.refobs.pop((a, op[2]), None)
                if ref is None:
                    continue
                if not st.can_record_updated_refob(ref):
                    st.flush_to_ring(True, self.plane)
                ref.deactivate()
                st.record_updated_refob(ref)
        for a, st in enumerate(self.states):
            st.flush_to_ring(bool(a & 1), self.plane)

    def drain(self):
        rows = self.plane.drain()
        if rows is not None:
            self.graph.merge_packed(rows)
        return rows

    snapshot = World.snapshot


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_drains_equal_the_reference(seed):
    """The reference's and the port's packed planes replay one seeded
    script: every drain returns the same rows, the folded graphs hold the
    same uid-keyed state, and each kill sweep finds the same garbage."""
    rng = np.random.default_rng(seed)
    n = 64
    ref = _PkgPackedWorld("uigc_tpu", n)
    port = _PkgPackedWorld("uigc_tpu_torch", n)
    for round_ in range(8):
        ops = _script_ops(rng, n, 200 if round_ < 5 else 150)
        rows = []
        for w in (ref, port):
            w.apply(ops)
            rows.append(w.drain())
        assert (rows[0] is None) == (rows[1] is None)
        if rows[0] is not None:
            assert rows[0].dtype == rows[1].dtype
            assert np.array_equal(rows[0], rows[1]), f"round {round_}"
        assert ref.snapshot() == port.snapshot(), f"round {round_}"
        if round_ >= 4:
            killed = [w.graph.trace(should_kill=True) for w in (ref, port)]
            assert killed[0] == killed[1], f"round {round_}"
            assert ref.snapshot() == port.snapshot(), f"round {round_}"
