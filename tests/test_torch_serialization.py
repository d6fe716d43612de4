"""The port's counterpart of ``tests/test_serialization.py``: the same tests, names and
assertions, on ``uigc_tpu_torch``.

Wire-format round trips for cross-node batches.

Analogue of the reference's SerializationSpec (reference:
src/test/scala/.../crgc/SerializationSpec.scala:10-126): DeltaShadow,
DeltaGraph (built through a real State -> Entry -> DeltaGraph pipeline),
and IngressEntry round-trip through their binary encodings.
"""

import pytest

from uigc_tpu_torch.engines.crgc.delta import DeltaGraph, DeltaShadow
from uigc_tpu_torch.engines.crgc.gateways import IngressEntry
from uigc_tpu_torch.engines.crgc.refob import CrgcRefob
from uigc_tpu_torch.engines.crgc.state import CrgcContext, CrgcState, Entry


class FakeSystem:
    address = "uigc://ser"


class FakeCell:
    _count = 0

    def __init__(self):
        FakeCell._count += 1
        self.uid = FakeCell._count
        self.path = f"/ser/{self.uid}"
        self.system = FakeSystem()


class Registry:
    """Cell <-> bytes codec standing in for actor-ref serialization."""

    def __init__(self):
        self.by_id = {}

    def encode(self, cell):
        self.by_id[cell.uid] = cell
        return str(cell.uid).encode()

    def decode(self, data):
        return self.by_id[int(data.decode())]


def test_delta_shadow_roundtrip():
    shadow = DeltaShadow()
    shadow.recv_count = -7
    shadow.supervisor = 3
    shadow.interned = True
    shadow.is_root = False
    shadow.is_busy = True
    shadow.outgoing = {0: 2, 5: -1}
    data = shadow.serialize()
    back, offset = DeltaShadow.deserialize(data, 0)
    assert offset == len(data)
    assert back == shadow

    # Empty shadow, like the reference's 13-byte case.
    empty = DeltaShadow()
    data = empty.serialize()
    back, offset = DeltaShadow.deserialize(data, 0)
    assert offset == len(data)
    assert back == empty


def test_delta_graph_roundtrip_via_state_pipeline():
    """Build entries through the real State machinery, fold into a
    DeltaGraph, round-trip it (reference: SerializationSpec.scala:85-97)."""
    context = CrgcContext(delta_graph_size=64, entry_field_size=4)
    registry = Registry()

    a, b, c = FakeCell(), FakeCell(), FakeCell()
    ref_a, ref_b, ref_c = CrgcRefob(a), CrgcRefob(b), CrgcRefob(c)

    state = CrgcState(ref_a, context)
    state.record_new_refob(ref_a, ref_a)
    state.record_new_refob(ref_a, ref_b)
    state.record_new_actor(ref_c)
    ref_b.inc_send_count()
    state.record_updated_refob(ref_b)
    state.record_message_received()

    entry = Entry(context)
    state.flush_to_entry(is_busy=True, entry=entry)

    graph = DeltaGraph(FakeSystem.address, context)
    graph.merge_entry(entry)
    assert graph.non_empty()

    data = graph.serialize(registry.encode)
    back = DeltaGraph.deserialize(data, context, registry.decode)
    assert back == graph
    assert back.decoder() == graph.decoder()


def test_delta_graph_fills_and_reports():
    context = CrgcContext(delta_graph_size=16, entry_field_size=2)
    graph = DeltaGraph("x", context)
    cells = [FakeCell() for _ in range(12)]
    for cell in cells:
        entry = Entry(context)
        entry.self_ref = CrgcRefob(cell)
        entry.recv_count = 1
        graph.merge_entry(entry)
        if graph.is_full():
            break
    assert graph.is_full()


def test_ingress_entry_roundtrip():
    registry = Registry()
    entry = IngressEntry()
    entry.id = 42
    entry.is_final = True
    entry.egress_address = "uigc://a"
    entry.ingress_address = "uigc://b"
    x, y, z = FakeCell(), FakeCell(), FakeCell()
    entry.on_message(x, [CrgcRefob(y), CrgcRefob(z), CrgcRefob(y)])
    entry.on_message(x, [])
    entry.on_message(z, [CrgcRefob(x)])

    data = entry.serialize(registry.encode)
    back = IngressEntry.deserialize(data, registry.decode)
    assert back == entry
    assert back.admitted[x].message_count == 2
    assert back.admitted[x].created_refs[y] == 2


# --------------------------------------------------------------------- #
# Parity: the same seeded batches serialize to the reference's bytes
# --------------------------------------------------------------------- #


def _seeded_batches(pkg, seed):
    """A DeltaShadow, a DeltaGraph built through the State -> Entry
    pipeline and an IngressEntry, all drawn from one numpy seed with the
    classes of ``pkg`` (the reference or the port)."""
    import importlib

    import numpy as np

    delta = importlib.import_module(f"{pkg}.engines.crgc.delta")
    gateways = importlib.import_module(f"{pkg}.engines.crgc.gateways")
    refob = importlib.import_module(f"{pkg}.engines.crgc.refob")
    state_mod = importlib.import_module(f"{pkg}.engines.crgc.state")

    rng = np.random.default_rng(seed)
    shadow = delta.DeltaShadow()
    shadow.recv_count = int(rng.integers(-1000, 1000))
    shadow.supervisor = int(rng.integers(-1, 40))
    shadow.interned = bool(rng.integers(0, 2))
    shadow.is_root = bool(rng.integers(0, 2))
    shadow.is_busy = bool(rng.integers(0, 2))
    shadow.outgoing = {int(k): int(rng.integers(-5, 6))
                       for k in rng.integers(0, 40, size=rng.integers(0, 6))}

    context = state_mod.CrgcContext(delta_graph_size=64, entry_field_size=4)
    cells = [FakeCell() for _ in range(12)]
    graph = delta.DeltaGraph(FakeSystem.address, context)
    for _ in range(int(rng.integers(1, 6))):
        me = cells[int(rng.integers(0, len(cells)))]
        state = state_mod.CrgcState(refob.CrgcRefob(me), context)
        for _ in range(int(rng.integers(0, 4))):
            owner, target = rng.integers(0, len(cells), size=2)
            state.record_new_refob(refob.CrgcRefob(cells[owner]),
                                   refob.CrgcRefob(cells[target]))
        if rng.integers(0, 2):
            state.record_new_actor(
                refob.CrgcRefob(cells[int(rng.integers(0, len(cells)))]))
        for _ in range(int(rng.integers(0, 4))):
            ref = refob.CrgcRefob(cells[int(rng.integers(0, len(cells)))])
            for _ in range(int(rng.integers(1, 4))):
                ref.inc_send_count()
            if rng.integers(0, 2):
                ref.deactivate()
            if state.can_record_updated_refob(ref):
                state.record_updated_refob(ref)
        for _ in range(int(rng.integers(0, 3))):
            state.record_message_received()
        entry = state_mod.Entry(context)
        state.flush_to_entry(is_busy=bool(rng.integers(0, 2)), entry=entry)
        graph.merge_entry(entry)

    ingress = gateways.IngressEntry()
    ingress.id = int(rng.integers(0, 1 << 30))
    ingress.is_final = bool(rng.integers(0, 2))
    ingress.egress_address = "uigc://a"
    ingress.ingress_address = "uigc://b"
    for _ in range(int(rng.integers(1, 6))):
        recipient = cells[int(rng.integers(0, len(cells)))]
        refs = [refob.CrgcRefob(cells[int(i)])
                for i in rng.integers(0, len(cells), size=rng.integers(0, 4))]
        ingress.on_message(recipient, refs)
    return delta, gateways, context, shadow, graph, ingress


@pytest.mark.parametrize("seed", range(8))
def test_serialized_bytes_equal_the_reference(seed):
    """Each batch serializes to the same bytes in both packages, and
    each package deserializes the other's bytes to a batch equal to its
    own (each package's cells resolve through its own registry: the
    same uids, the package's own cell objects)."""
    reg_r, reg_p = Registry(), Registry()
    FakeCell._count = 0
    ref = _seeded_batches("uigc_tpu", seed)
    FakeCell._count = 0
    port = _seeded_batches("uigc_tpu_torch", seed)
    (r_delta, r_gw, r_ctx, r_shadow, r_graph, r_ingress) = ref
    (p_delta, p_gw, p_ctx, p_shadow, p_graph, p_ingress) = port

    assert r_shadow.serialize() == p_shadow.serialize()
    data = r_shadow.serialize()
    assert p_delta.DeltaShadow.deserialize(data, 0)[0] == p_shadow
    assert r_delta.DeltaShadow.deserialize(p_shadow.serialize(), 0)[0] == r_shadow

    r_bytes = r_graph.serialize(reg_r.encode)
    p_bytes = p_graph.serialize(reg_p.encode)
    assert r_bytes == p_bytes
    back = p_delta.DeltaGraph.deserialize(r_bytes, p_ctx, reg_p.decode)
    assert back == p_graph
    assert r_delta.DeltaGraph.deserialize(p_bytes, r_ctx, reg_r.decode) == r_graph

    r_bytes = r_ingress.serialize(reg_r.encode)
    p_bytes = p_ingress.serialize(reg_p.encode)
    assert r_bytes == p_bytes
    assert p_gw.IngressEntry.deserialize(r_bytes, reg_p.decode) == p_ingress
    assert r_gw.IngressEntry.deserialize(p_bytes, reg_r.decode) == r_ingress
