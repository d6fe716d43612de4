"""The port's in-process fabric and wire codecs (``uigc_tpu_torch/runtime/
{fabric,wire,schema,faults}.py``) against the JAX package's.

- Seeded messages round-trip the port's ``encode_message`` /
  ``decode_message``; plain data and the schema value plane encode to the
  reference's bytes, and refs re-bind to the same cells across a
  serialized fabric.
- The distributed collector's frame codecs (``dwave`` ... ``djnl``), the
  key-set payloads (``encode_keyset``, ``encode_keyset_json``) and the
  DeltaGraph and IngressEntry wire formats give the reference's bytes on
  the same inputs.
- ``FaultPlan`` makes the reference's drop decisions for a seed.
- The stale-token fault: on a two-system serialized ``Fabric`` a
  ``DeltaMsg`` naming a stopped and reclaimed cell makes the reference's
  ``control_send`` raise ``LookupError`` inside the sender's wake; the
  port delivers it, every mention folding onto one stable slot.  A cell
  resolves by uid while its setup runs on the port, not on the reference.
"""

import gc
import time
import types

import numpy as np
import pytest

import uigc_tpu
import uigc_tpu.engines.crgc.collector as ref_collector
import uigc_tpu.engines.crgc.delta as ref_delta
import uigc_tpu.engines.crgc.gateways as ref_gateways
import uigc_tpu.engines.crgc.state as ref_state
import uigc_tpu.runtime.fabric as ref_fabric
import uigc_tpu.runtime.faults as ref_faults
import uigc_tpu.runtime.schema as ref_schema
import uigc_tpu.runtime.system as ref_system
import uigc_tpu.runtime.wire as ref_wire
import uigc_tpu_torch
import uigc_tpu_torch.engines.crgc.arrays as port_arrays
import uigc_tpu_torch.engines.crgc.collector as port_collector
import uigc_tpu_torch.engines.crgc.delta as port_delta
import uigc_tpu_torch.engines.crgc.gateways as port_gateways
import uigc_tpu_torch.engines.crgc.shadow as port_shadow
import uigc_tpu_torch.engines.crgc.state as port_state
import uigc_tpu_torch.runtime.fabric as port_fabric
import uigc_tpu_torch.runtime.faults as port_faults
import uigc_tpu_torch.runtime.schema as port_schema
import uigc_tpu_torch.runtime.system as port_system
import uigc_tpu_torch.runtime.wire as port_wire

SIDES = {
    "ref": types.SimpleNamespace(
        pkg=uigc_tpu, wire=ref_wire, schema=ref_schema, fabric=ref_fabric,
        faults=ref_faults, delta=ref_delta, gateways=ref_gateways,
        state=ref_state, collector=ref_collector, system=ref_system),
    "port": types.SimpleNamespace(
        pkg=uigc_tpu_torch, wire=port_wire, schema=port_schema,
        fabric=port_fabric, faults=port_faults, delta=port_delta,
        gateways=port_gateways, state=port_state, collector=port_collector,
        system=port_system),
}
CONFIG = {"uigc.crgc.wakeup-interval": 10, "uigc.crgc.num-nodes": 2,
          "uigc.crgc.shadow-graph": "oracle"}


class FakeCell:
    """The (system.address, uid, path) coordinates every codec reads."""

    __slots__ = ("system", "uid", "path")

    def __init__(self, address, uid):
        self.system = types.SimpleNamespace(address=address)
        self.uid = uid
        self.path = f"{address}/user/fake-{uid}"


def seeded_value(rng, depth=0):
    """A nested payload of the value plane's types, drawn from ``rng``."""
    kind = int(rng.integers(0, 8 if depth < 3 else 5))
    if kind == 0:
        return int(rng.integers(-2**62, 2**62))
    if kind == 1:
        return float(rng.normal())
    if kind == 2:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x3000, 6))
    if kind == 3:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 9))).tolist())
    if kind == 4:
        return [None, True, False][int(rng.integers(0, 3))]
    n = int(rng.integers(0, 5))
    if kind == 5:
        return [seeded_value(rng, depth + 1) for _ in range(n)]
    if kind == 6:
        return tuple(seeded_value(rng, depth + 1) for _ in range(n))
    return {f"k{int(rng.integers(0, 1000))}": seeded_value(rng, depth + 1)
            for _ in range(n)}


def seeded_keys(rng, n, addresses=("uigc://a", "uigc://b", "uigc://c"),
                span=1 << 20):
    return sorted({(addresses[int(rng.integers(0, len(addresses)))],
                    int(rng.integers(0, span))) for _ in range(n)})


# --------------------------------------------------------------------- #
# Message codec
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(6))
def test_plain_messages_encode_to_the_reference_bytes(seed):
    value = seeded_value(np.random.default_rng(seed))
    data = port_wire.encode_message(value)
    assert data == ref_wire.encode_message(value)
    assert port_wire.decode_message(None, data) == value
    if port_schema.value_safe(value):
        body = port_schema.encode_value(value)
        assert body == ref_schema.encode_value(value)
        assert port_schema.decode_value(body) == value


class Carry(uigc_tpu_torch.Message):
    """A port message carrying refs and a seeded payload (module level:
    it crosses a pickling fabric)."""

    def __init__(self, ref, raw, payload):
        self.ref = ref
        self.raw = raw
        self.payload = payload

    @property
    def refs(self):
        return (self.ref,)


class Capture(uigc_tpu_torch.RawBehavior):
    def __init__(self):
        self.got = []

    def on_message(self, msg):
        self.got.append(msg)
        return None


def two_systems(side, name, **fabric_kwargs):
    s = SIDES[side]
    fabric = s.fabric.Fabric(**fabric_kwargs)
    systems = [s.system.ActorSystem(None, name=f"{name}{i}", config=CONFIG,
                                    fabric=fabric) for i in range(2)]
    return fabric, systems


@pytest.mark.parametrize("seed", range(3))
def test_refs_rebind_across_a_serialized_fabric(seed):
    fabric, (sys_a, sys_b) = two_systems("port", f"rt{seed}-")
    assert fabric.serialize and fabric.async_links  # wire mode by default
    try:
        target = sys_b.spawn_system_raw(Capture(), "target")
        root = sys_b.spawn_root(uigc_tpu_torch.Behaviors.setup_root(
            lambda ctx: Idle(ctx)), "root")
        payload = seeded_value(np.random.default_rng(100 + seed))
        msg = Carry(sys_b.engine.to_root_refob(root.cell),
                    uigc_tpu_torch.RawRef(target), payload)
        back = port_wire.decode_message(fabric, port_wire.encode_message(msg))
        assert type(back) is Carry and back is not msg
        assert back.payload == payload
        assert back.ref.target is root.cell
        assert type(back.ref) is type(msg.ref)
        assert back.raw.cell is target
    finally:
        sys_a.terminate()
        sys_b.terminate()


class Idle(uigc_tpu_torch.AbstractBehavior):
    def on_message(self, msg):
        return self


# --------------------------------------------------------------------- #
# Frame codecs and payloads
# --------------------------------------------------------------------- #


def frame_cases(rng):
    keys = seeded_keys(rng, int(rng.integers(1, 40)))
    pairs = [tuple(seeded_keys(rng, 2)) for _ in range(3)]
    stats = {"settled": bool(rng.integers(0, 2)), "changed": False,
             "sent": int(rng.integers(0, 99)),
             "recv": int(rng.integers(0, 99)), "nodes": 3}
    w, f, r = (int(x) for x in rng.integers(0, 1 << 20, 3))
    report = tuple(int(x) for x in rng.integers(0, 9, 5))
    return {
        "dwave": lambda W: W.encode_dwave(w, f, "uigc://a", round_id=r),
        "dmark": lambda W: W.encode_dmark(w, f, "uigc://a", keys, start=r,
                                          round_id=r % 7),
        "dmark-json": lambda W: W.encode_dmark(w, f, "uigc://a", keys,
                                               binary=False),
        "dmack": lambda W: W.encode_dmack(w, "uigc://b", r, fence=f,
                                          round_id=r % 5, report=report),
        "dprobe": lambda W: W.encode_dprobe(w, r, "uigc://a", fence=f),
        "dstat": lambda W: W.encode_dstat(w, r, "uigc://a", stats),
        "dfin": lambda W: W.encode_dfin(w, f, "uigc://c"),
        "dgate": lambda W: W.encode_dgate(w, f, "uigc://a", pairs),
        "dgack": lambda W: W.encode_dgack(w, "uigc://a", r, fence=f),
        "ddirty": lambda W: W.encode_ddirty("uigc://b"),
        "djnl": lambda W: W.encode_djournal(
            f, r % 64, bytes(rng.integers(0, 256, 33).tolist())),
    }


DECODERS = {"dwave": "decode_dwave", "dmark": "decode_dmark",
            "dmark-json": "decode_dmark", "dmack": "decode_dmack",
            "dprobe": "decode_dprobe", "dstat": "decode_dstat",
            "dfin": "decode_dfin", "dgate": "decode_dgate",
            "dgack": "decode_dgack", "ddirty": "decode_ddirty",
            "djnl": "decode_djournal"}


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_dist_frames_equal_the_reference(kind):
    for seed in range(4):
        # each side draws from its own generator of the same seed: the
        # djnl payload is drawn when the frame is built
        ref = frame_cases(np.random.default_rng(seed))[kind](ref_wire)
        port = frame_cases(np.random.default_rng(seed))[kind](port_wire)
        assert port == ref
        assert port[0] in port_wire.DIST_FRAME_KINDS
        decode = DECODERS[kind]
        got = getattr(port_wire, decode)(ref)
        assert got is not None
        assert got == getattr(ref_wire, decode)(ref)
        # the tolerance contract: trailing elements ignored, truncation
        # malformed
        assert getattr(port_wire, decode)(ref + ("future",)) == got
        assert getattr(port_wire, decode)(ref[:1]) is None


@pytest.mark.parametrize("n,span", [(1, 16), (50, 64), (50, 1 << 30),
                                    (2000, 4096), (300, 1 << 12)])
def test_keyset_payloads_equal_the_reference(n, span):
    keys = seeded_keys(np.random.default_rng(n + span), n, span=span)
    for enc in ("encode_keyset", "encode_keyset_json"):
        data = getattr(port_schema, enc)(keys)
        assert data == getattr(ref_schema, enc)(keys)
        assert sorted(port_schema.decode_keyset_any(data)) == keys
    assert port_schema.decode_keyset_any(b"\x07garbage") is None


def fold_script(side, seed, n_cells=40, n_ops=120):
    """A seeded fold script over fake cells into ``side``'s DeltaGraph
    and IngressEntry; returns their wire bytes."""
    s = SIDES[side]
    rng = np.random.default_rng(seed)
    cells = [FakeCell(("uigc://a", "uigc://b")[i % 2], 10 + 7 * i)
             for i in range(n_cells)]
    ctx = s.state.CrgcContext(delta_graph_size=256, entry_field_size=4)
    graph = s.delta.DeltaGraph("uigc://a", ctx)
    for op, a, b, k in rng.integers(0, n_cells, (n_ops, 4)):
        a, b = cells[a], cells[b]
        op %= 5
        if op == 0:
            graph.fold_self(a, int(k), bool(k % 2), bool(k % 3 == 0))
        elif op == 1:
            graph.fold_created(a, b)
        elif op == 2:
            graph.fold_spawned(a, b)
        elif op == 3:
            graph.fold_sends(a, int(k))
        else:
            graph.fold_deactivate(a, b)
    entry = s.gateways.IngressEntry()
    entry.id, entry.fence = int(rng.integers(0, 99)), 3
    entry.egress_address, entry.ingress_address = "uigc://a", "uigc://b"
    for a, b in rng.integers(0, n_cells, (20, 2)):
        entry.on_message(cells[a], [types.SimpleNamespace(target=cells[b])])
    return (graph.serialize(s.wire.encode_cell),
            entry.serialize(s.wire.encode_cell))


@pytest.mark.parametrize("seed", range(3))
def test_delta_graph_and_ingress_entry_bytes_equal_the_reference(seed):
    port_graph, port_entry = fold_script("port", seed)
    ref_graph, ref_entry = fold_script("ref", seed)
    assert port_graph == ref_graph
    assert port_entry == ref_entry


# --------------------------------------------------------------------- #
# Fault plans
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(3))
def test_fault_plan_drops_as_the_reference(seed):
    def decisions(faults):
        plan = (faults.FaultPlan(seed)
                .drop_messages("a", "b", prob=0.3)
                .drop_messages("b", "*", match=lambda m: m % 3 == 0,
                               prob=0.5)
                .drop(src="c", prob=0.4))
        rng = np.random.default_rng(seed)
        out = []
        for src, dst, msg in zip(rng.integers(0, 3, 300),
                                 rng.integers(0, 3, 300),
                                 rng.integers(0, 100, 300)):
            src, dst = "abc"[src], "abc"[dst]
            out.append(plan.drop_inbound(src, dst, int(msg)))
            out.append(plan.outbound(src, dst, "app"))
        return out, dict(plan.stats)

    assert decisions(port_faults) == decisions(ref_faults)


def test_fabric_applies_a_fault_plan_at_admission():
    fabric, (sys_a, sys_b) = two_systems("port", "fp-", serialize=False,
                                         async_links=False)
    try:
        capture = Capture()
        target = sys_b.spawn_system_raw(capture, "target")
        fabric.set_fault_plan(port_faults.FaultPlan(0).drop_messages(
            sys_a.address, sys_b.address, match=lambda m: m % 2 == 0))
        for i in range(10):
            fabric.deliver(sys_a, target, i)
        fabric.flush()
        deadline = time.monotonic() + 5
        while len(capture.got) < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert capture.got == [1, 3, 5, 7, 9]
    finally:
        sys_a.terminate()
        sys_b.terminate()


# --------------------------------------------------------------------- #
# The stale-token fault
# --------------------------------------------------------------------- #


def reclaimed_uid(system):
    """The uid of a cell that ran on ``system``, stopped and is gone."""
    cell = system.spawn_system_raw(Capture(), "doomed")
    uid = cell.uid
    cell.stop()
    for _ in range(200):
        if cell.is_terminated:
            break
        time.sleep(0.01)
    assert cell.is_terminated
    del cell
    gc.collect()
    assert system.resolve_cell(uid) is None
    return uid


def stale_delta(side, sys_a, uid):
    s = SIDES[side]
    graph = s.delta.DeltaGraph(sys_a.address, sys_a.engine.crgc_context)
    dead = FakeCell(sys_a.address, uid)
    live = sys_a.engine.bookkeeper_cell
    graph.fold_self(dead, 2, False, False)
    graph.fold_spawned(dead, live)
    graph.fold_created(live, dead)
    return s.collector.DeltaMsg(7, graph)


def test_reference_raises_on_a_reclaimed_cell_in_a_delta():
    fabric, (sys_a, sys_b) = two_systems("ref", "stale-ref-")
    try:
        uid = reclaimed_uid(sys_a)
        target = sys_b.spawn_system_raw(Capture(), "target")
        with pytest.raises(LookupError, match=f"no cell uid={uid}"):
            fabric.control_send(sys_a, target, stale_delta("ref", sys_a, uid))
    finally:
        sys_a.terminate()
        sys_b.terminate()


@pytest.mark.parametrize("backend", ["oracle", "array"])
def test_port_folds_a_reclaimed_cell_onto_one_stable_slot(backend):
    fabric, (sys_a, sys_b) = two_systems("port", f"stale-{backend}-")
    try:
        uid = reclaimed_uid(sys_a)
        capture = Capture()
        target = sys_b.spawn_system_raw(capture, "target")
        for _ in range(3):
            fabric.control_send(sys_a, target,
                                stale_delta("port", sys_a, uid))
        deadline = time.monotonic() + 5
        while len(capture.got) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(capture.got) == 3
        stones = set()
        for msg in capture.got:
            for cell in msg.graph.compression_table:
                if cell.uid == uid:
                    stones.add(id(cell))
                    assert isinstance(cell, port_fabric.Tombstone)
                    assert cell.system is sys_a
        assert len(stones) == 1  # one tombstone for every mention
        ctx = sys_b.engine.crgc_context
        if backend == "oracle":
            graph = port_shadow.ShadowGraph(ctx, sys_b.address)
        else:
            graph = port_arrays.ArrayShadowGraph(ctx, sys_b.address)
        for msg in capture.got:
            graph.merge_delta(msg.graph)
        if backend == "oracle":
            keys = [c for c in graph.shadow_map if c.uid == uid]
            assert len(keys) == 1
            assert graph.shadow_map[keys[0]].recv_count == 6
        else:
            keys = [c for c in graph.slot_of if c.uid == uid]
            assert len(keys) == 1
            assert graph.recv_count[graph.slot_of[keys[0]]] == 6
        # a message told to the tombstone is a dead letter of its system
        before = sys_a.dead_letters
        keys[0].tell("late")
        assert sys_a.dead_letters == before + 1
    finally:
        sys_a.terminate()
        sys_b.terminate()


@pytest.mark.parametrize("side", ["ref", "port"])
def test_a_cell_resolves_while_its_setup_runs(side):
    s = SIDES[side]
    seen = {}

    class Root(s.pkg.AbstractBehavior):
        def __init__(self, context):
            super().__init__(context)
            cell = context.self.target
            seen["during"] = cell.system.resolve_cell(cell.uid) is cell

        def on_message(self, msg):
            return self

    system = s.system.ActorSystem(None, name=f"setup-{side}",
                                  config={"uigc.crgc.wakeup-interval": 10})
    try:
        ref = system.spawn_root(s.pkg.Behaviors.setup_root(Root), "root")
        assert system.resolve_cell(ref.cell.uid) is ref.cell
    finally:
        system.terminate()
    # the reference registers the cell only after its setup returns
    assert seen["during"] is (side == "port")
