"""The port's counterpart of ``tests/test_trace_parity.py``: the same tests, names and
assertions, on ``uigc_tpu_torch``.

The device and mesh backends run on the CPU (``device="cpu"``: the
propagate kernel's plain version), and the native backend is the
port's own C++ data plane.

Differential liveness-parity tests: oracle vs array vs device graphs.

The reference author debugged CRGC by folding the same entries into two
graphs and asserting equality (reference: ShadowGraph.java:176-199,
commented testGraph at LocalGC.scala:65,137-141).  We do the same, at the
verdict level: a randomized protocol simulator produces faithful entry
streams (same State/Entry machinery the engine uses), folds them into the
pointer-based oracle and the array/device graphs, and asserts the garbage
sets agree on every collection round.
"""

import random

import pytest

from uigc_tpu_torch.engines.crgc import refob as refob_info
from uigc_tpu_torch.engines.crgc.arrays import ArrayShadowGraph
from uigc_tpu_torch.engines.crgc.refob import CrgcRefob
from uigc_tpu_torch.engines.crgc.shadow import ShadowGraph
from uigc_tpu_torch.engines.crgc.state import CrgcContext, CrgcState, Entry


class FakeSystem:
    def __init__(self, address="uigc://parity"):
        self.address = address


class FakeCell:
    """Just enough of ActorCell for the data plane: identity + address."""

    _count = 0

    def __init__(self, system):
        FakeCell._count += 1
        self.uid = FakeCell._count
        self.path = f"/sim/{self.uid}"
        self.system = system
        self.received_stop = False

    def tell(self, msg):
        self.received_stop = True

    def __repr__(self):
        return self.path


class SimActor:
    """A simulated mutator following the CRGC recording protocol exactly
    (the same sequences as CRGC.scala:100-221)."""

    def __init__(self, sim, cell, creator_ref, context):
        self.sim = sim
        self.cell = cell
        self.self_ref = CrgcRefob(cell)
        self.state = CrgcState(self.self_ref, context)
        self.state.record_new_refob(self.self_ref, self.self_ref)
        if creator_ref is not None:
            self.state.record_new_refob(creator_ref, self.self_ref)
        else:
            self.state.mark_as_root()
        self.acquaintances = []  # refobs this actor owns
        self.inbox = []  # in-flight messages: lists of refobs carried
        self.alive = True

    def flush(self, is_busy=False):
        entry = Entry(self.sim.context)
        self.state.flush_to_entry(is_busy, entry)
        self.sim.entries.append(entry)

    # Engine-mirroring operations --------------------------------- #

    def spawn(self):
        child_cell = FakeCell(self.sim.system)
        child = SimActor(self.sim, child_cell, self.self_ref, self.sim.context)
        self.sim.actors[child_cell] = child
        self.sim.children.setdefault(self.cell, []).append(child_cell)
        ref = CrgcRefob(child_cell)
        if not self.state.can_record_new_actor():
            self.flush(is_busy=True)
        self.state.record_new_actor(ref)
        self.acquaintances.append(ref)
        # Child's initial flush (on-block style start batch).
        child.flush()
        return child

    def create_ref(self, target_ref, owner_ref):
        ref = CrgcRefob(target_ref.target)
        if not self.state.can_record_new_refob():
            self.flush(is_busy=True)
        self.state.record_new_refob(owner_ref, target_ref)
        return ref

    def send(self, target_ref, carried_refs=()):
        if not target_ref.can_inc_send_count() or not self.state.can_record_updated_refob(
            target_ref
        ):
            self.flush(is_busy=True)
        target_ref.inc_send_count()
        self.state.record_updated_refob(target_ref)
        target = self.sim.actors[target_ref.target]
        # CRGC soundness: a collected actor never receives another message
        # from a LIVE actor.  (In-flight messages between mutually-garbage
        # actors are legitimately dropped.)
        assert target.alive or not self.alive, (
            f"live {self.cell} sent to collected {target.cell} — GC unsound"
        )
        target.inbox.append(list(carried_refs))

    def receive(self):
        if not self.inbox:
            return
        carried = self.inbox.pop(0)
        if not self.state.can_record_message_received():
            self.flush(is_busy=True)
        self.state.record_message_received()
        self.acquaintances.extend(carried)
        self.flush()  # on-block: drained the mailbox

    def release(self, ref):
        if not self.state.can_record_updated_refob(ref):
            self.flush(is_busy=True)
        ref.deactivate()
        self.state.record_updated_refob(ref)
        if ref in self.acquaintances:
            self.acquaintances.remove(ref)
        self.flush()


def graph_cells(graph):
    """The set of actors currently interned in a graph, regardless of
    backend (oracle/array/native)."""
    if hasattr(graph, "shadow_map"):
        return set(graph.shadow_map.keys())
    if hasattr(graph, "slot_of"):
        return set(graph.slot_of.keys())
    return set(graph._id_of_cell.keys())


class Sim:
    def __init__(self, seed, backend="array"):
        self.rng = random.Random(seed)
        self.system = FakeSystem()
        self.context = CrgcContext(delta_graph_size=64, entry_field_size=4)
        self.entries = []
        self.actors = {}
        self.children = {}
        self.oracle = ShadowGraph(self.context, self.system.address)
        if backend == "native":
            from uigc_tpu_torch.native import NativeShadowGraph

            self.array = NativeShadowGraph(self.context, self.system.address)
        elif backend in ("mesh", "mesh-decremental"):
            from uigc_tpu_torch.engines.crgc.mesh import MeshShadowGraph

            self.array = MeshShadowGraph(
                self.context,
                self.system.address,
                decremental=(backend == "mesh-decremental"),
                device="cpu",
            )
        else:
            self.array = ArrayShadowGraph(
                self.context,
                self.system.address,
                use_device=(backend in ("device", "decremental")),
                decremental=(backend == "decremental"),
                device="cpu",
            )
        root_cell = FakeCell(self.system)
        self.root = SimActor(self, root_cell, None, self.context)
        self.actors[root_cell] = self.root
        self.root.flush()

    def live_actors(self):
        return [a for a in self.actors.values() if a.alive]

    def random_step(self):
        actors = self.live_actors()
        actor = self.rng.choice(actors)
        p = self.rng.random()
        if p < 0.15 and len(self.actors) < 400:
            actor.spawn()
        elif p < 0.35 and actor.acquaintances:
            # Share a ref: create for a random owner, deliver in a message.
            owner_ref = self.rng.choice(actor.acquaintances)
            target_ref = self.rng.choice(actor.acquaintances)
            new_ref = actor.create_ref(target_ref, owner_ref)
            actor.send(owner_ref, carried_refs=[new_ref])
        elif p < 0.55 and actor.acquaintances:
            actor.send(self.rng.choice(actor.acquaintances))
        elif p < 0.7 and actor.acquaintances:
            actor.release(self.rng.choice(actor.acquaintances))
        else:
            actor.receive()
        # CRGC's on-block invariant: every processing batch ends with a
        # flush before the actor goes idle (reference: CRGC.scala:84-88).
        # An actor that appears blocked in the folded view has therefore
        # flushed everything it did — soundness depends on this.
        actor.flush()

    def drain_inboxes(self):
        progressed = True
        while progressed:
            progressed = False
            for actor in self.live_actors():
                if actor.inbox:
                    actor.receive()
                    progressed = True

    def collect_round(self):
        """Fold all pending entries into both graphs, trace, compare."""
        for entry in self.entries:
            self.oracle.merge_entry(entry)
            self.array.merge_entry(entry)
        self.entries = []

        before_oracle = set(self.oracle.shadow_map.keys())
        before_array = graph_cells(self.array)
        assert before_oracle == before_array

        self.oracle.trace(should_kill=False)
        self.array.trace(should_kill=False)

        after_oracle = set(self.oracle.shadow_map.keys())
        after_array = graph_cells(self.array)
        garbage_oracle = before_oracle - after_oracle
        garbage_array = before_array - after_array
        assert garbage_oracle == garbage_array, (
            f"verdict divergence: oracle-only="
            f"{sorted(c.path for c in garbage_oracle - garbage_array)} "
            f"array-only={sorted(c.path for c in garbage_array - garbage_oracle)}"
        )
        assert after_oracle == after_array

        # Apply the verdicts: garbage actors (and their subtrees, via the
        # runtime's stop cascade) terminate.
        for cell in garbage_oracle:
            actor = self.actors.get(cell)
            if actor is not None:
                # Soundness: any in-flight message to a collected actor
                # must come from an actor that is itself garbage (dropped
                # as a dead-to-dead send); the send-to-dead assertion in
                # SimActor.send covers the live-sender case.
                actor.alive = False
                # Death accounting, mirroring CRGC.pre_signal(PostStop):
                # count undelivered messages as received, release their
                # carried refs, and flush a final entry.
                for carried in actor.inbox:
                    if not actor.state.can_record_message_received():
                        actor.flush(is_busy=True)
                    actor.state.record_message_received()
                    for ref in carried:
                        if not actor.state.can_record_updated_refob(ref):
                            actor.flush(is_busy=True)
                        ref.deactivate()
                        actor.state.record_updated_refob(ref)
                actor.inbox.clear()
                actor.flush()
        return garbage_oracle


from uigc_tpu_torch.native import is_available as _native_available

#: the port's C++ data plane, built at first use; skipped (visibly) when
#: no C++ toolchain is present, as the reference's conftest does
NATIVE_AVAILABLE = _native_available()
NATIVE_BACKEND = pytest.param(
    "native",
    marks=pytest.mark.skipif(not NATIVE_AVAILABLE, reason="no C++ toolchain"),
)


@pytest.mark.parametrize(
    "backend",
    ["array", "device", "mesh", "decremental", "mesh-decremental",
     NATIVE_BACKEND],
)
@pytest.mark.parametrize("seed", [7, 42, 20260729])
def test_random_protocol_parity(seed, backend):
    sim = Sim(seed, backend=backend)
    for round_no in range(20):
        for _ in range(150):
            sim.random_step()
        sim.collect_round()

    # Quiesce: deliver everything, then release the whole world from the
    # root and make sure both graphs agree it all collapses.
    sim.drain_inboxes()
    for actor in sim.live_actors():
        for ref in list(actor.acquaintances):
            actor.release(ref)
    sim.drain_inboxes()
    for actor in sim.live_actors():
        actor.flush()

    for _ in range(5):
        sim.collect_round()

    survivors = {a.cell for a in sim.live_actors()}
    # Everything except the root must eventually be collected in both
    # graphs (completeness).
    assert survivors == {sim.root.cell}, (
        f"{len(survivors) - 1} actors never collected"
    )


def test_supervisor_marking_parity():
    """A live child must keep its (otherwise-garbage) parent alive in both
    implementations (reference: ShadowGraph.java:242-267)."""
    backends = ["array", "device"] + (["native"] if NATIVE_AVAILABLE else [])
    for backend in backends:
        sim = Sim(1, backend=backend)
        parent = sim.root.spawn()
        parent_ref = sim.root.acquaintances[0]
        child = parent.spawn()
        child_ref = parent.acquaintances[0]
        # Give parent a ref back to root, so it can reply.
        to_root = sim.root.create_ref(sim.root.self_ref, parent_ref)
        sim.root.send(parent_ref, carried_refs=[to_root])
        parent.receive()
        root_ref = parent.acquaintances[-1]
        # Parent hands root a direct ref to the child.
        for_root = parent.create_ref(child_ref, root_ref)
        parent.send(root_ref, carried_refs=[for_root])
        sim.root.receive()
        parent.flush()
        # Parent releases everything it owns; root releases the parent but
        # keeps its ref to the child.
        for r in list(parent.acquaintances):
            parent.release(r)
        sim.root.release(parent_ref)
        sim.drain_inboxes()
        for a in sim.live_actors():
            a.flush()

        garbage = sim.collect_round()
        # Parent is garbage-in-waiting but must NOT be collected while the
        # child lives.
        assert parent.cell not in garbage
        assert child.cell not in garbage

        # Now the root releases the child too: both collapse.
        for r in list(sim.root.acquaintances):
            sim.root.release(r)
        sim.drain_inboxes()
        for a in sim.live_actors():
            a.flush()
        garbage = sim.collect_round()
        assert parent.cell in garbage and child.cell in garbage


@pytest.mark.parametrize("seed", [3, 99])
def test_debug_inspectors_parity(seed):
    """The debug inspectors (reference: ShadowGraph.java:331-394) must
    agree between the oracle and the array backend on an identical
    entry stream."""
    sim = Sim(seed, backend="array")
    for _ in range(10):
        for _ in range(120):
            sim.random_step()
        sim.collect_round()

    assert sim.oracle.addresses_in_graph() == sim.array.addresses_in_graph()
    o = sim.oracle.investigate_live_set()
    a = sim.array.investigate_live_set()
    assert o == a, f"live-set dumps diverged:\noracle={o}\narray={a}"


def test_inspectors_cross_locality():
    """Cross-locality acquaintances show up in the live-set dump: a
    local actor holding a ref to a remote one is reported (the leak
    shape the reference prints these inspectors for)."""
    system = FakeSystem("uigc://local")
    remote_system = FakeSystem("uigc://remote")
    context = CrgcContext(delta_graph_size=64, entry_field_size=4)
    graphs = [
        ShadowGraph(context, system.address),
        ArrayShadowGraph(context, system.address),
    ]
    local_cell = FakeCell(system)
    remote_cell = FakeCell(remote_system)
    for g in graphs:
        e = Entry(context)
        e.self_ref = CrgcRefob(local_cell)
        e.is_busy = False
        e.is_root = True
        e.created_owners[0] = CrgcRefob(local_cell)
        e.created_targets[0] = CrgcRefob(remote_cell)
        g.merge_entry(e)
    dumps = [g.investigate_live_set() for g in graphs]
    assert dumps[0] == dumps[1]
    d = dumps[0]
    assert d["roots"] == 1
    assert d["nonlocal"] == 1
    assert d["local_to_remote"] == [(local_cell.path, remote_cell.path, 1)]
    addr = [g.addresses_in_graph() for g in graphs]
    assert addr[0] == addr[1] == {
        "uigc://local": 1,
        "uigc://remote": 1,
    }
