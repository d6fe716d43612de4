"""The port's TCP node transport (``uigc_tpu_torch/runtime/{node,shm_ring,
heartbeat}.py``) against the JAX package's, where bytes must match:

- the hello frame, with and without batching, the schema codec and the
  shm capability;
- the ``"fb"`` batch unit of a drained writer queue, schema-admitted
  runs collapsing into ``"appr"`` blocks, other frames pickled in stream
  position;
- ``ProxyCell`` tokens through the message codec, both ways;
- shared-memory ring records, byte for byte in the mapped segment, and a
  ring written by one package read by the other;
- ``PhiAccrualFailureDetector``'s phi for a seeded heartbeat series;
- the ``"delta"`` frame: a plain ``DeltaMsg`` crosses in the reference's
  bytes, a stamped ``DDelta`` as those bytes plus ``(fence, cut,
  index)``; the
  port's receiver rebuilds the ``DDelta``, the reference's reads the
  same frame as a plain delta.
"""

import struct
import types

import numpy as np
import pytest

import uigc_tpu.engines.crgc.collector as ref_collector
import uigc_tpu.runtime.heartbeat as ref_heartbeat
import uigc_tpu.runtime.node as ref_node
import uigc_tpu.runtime.schema as ref_schema
import uigc_tpu.runtime.shm_ring as ref_ring
import uigc_tpu.runtime.system as ref_system
import uigc_tpu.runtime.wire as ref_wire
import uigc_tpu_torch.engines.crgc.collector as port_collector
import uigc_tpu_torch.engines.crgc.distributed as port_distributed
import uigc_tpu_torch.runtime.heartbeat as port_heartbeat
import uigc_tpu_torch.runtime.node as port_node
import uigc_tpu_torch.runtime.schema as port_schema
import uigc_tpu_torch.runtime.shm_ring as port_ring
import uigc_tpu_torch.runtime.system as port_system
import uigc_tpu_torch.runtime.wire as port_wire
from test_torch_fabric import SIDES, FakeCell, fold_script, seeded_value

NODE = {
    "ref": types.SimpleNamespace(node=ref_node, wire=ref_wire,
                                 schema=ref_schema, system=ref_system,
                                 collector=ref_collector),
    "port": types.SimpleNamespace(node=port_node, wire=port_wire,
                                  schema=port_schema, system=port_system,
                                  collector=port_collector),
}
BASE = {"uigc.crgc.wakeup-interval": 10, "uigc.crgc.num-nodes": 2,
        "uigc.crgc.shadow-graph": "oracle"}


def node_system(side, name, config):
    fabric = NODE[side].node.NodeFabric()
    system = NODE[side].system.ActorSystem(None, name=name, config=config,
                                           fabric=fabric)
    return fabric, system


@pytest.mark.parametrize("overrides", [
    {}, {"uigc.node.shm-transport": True},
    {"uigc.node.frame-batching": False, "uigc.node.schema-codec": False},
], ids=["default", "shm", "legacy"])
def test_hello_frames_equal_the_reference(overrides):
    """Same names, same config, same incarnation nonce: the same hello
    tuple and the same framed bytes."""
    config = dict(BASE, **overrides)
    hellos = {}
    for side in ("ref", "port"):
        fabric, system = node_system(side, "hello", config)
        try:
            fabric.register_name("collector", system.engine.bookkeeper_cell)
            fabric._nonce = 0x1234_5678_9ABC
            hellos[side] = fabric._hello()
        finally:
            system.terminate()
    assert hellos["port"] == hellos["ref"]
    assert (port_node._frame_bytes(hellos["port"])
            == ref_node._frame_bytes(hellos["ref"]))


def drained_items(rng, n=120):
    """A writer drain's (seq, inner, truncate) triples: runs of
    schema-admitted app frames to one uid, class-instance payloads the
    schema refuses, markers and heartbeats, in one stream."""
    items, seq = [], 0
    uid = 7
    for _ in range(n):
        seq += 1
        kind = int(rng.integers(0, 10))
        if kind < 6:
            if rng.random() < 0.2:
                uid = int(rng.integers(1, 12))
            items.append((seq, ("app", uid, ("n", int(rng.integers(0, 99)),
                                             seeded_value(rng))), False))
        elif kind < 8:
            items.append((seq, ("app", uid, ValueError(int(seq))), False))
        elif kind == 8:
            items.append((seq, ("marker", int(rng.integers(0, 1 << 20))),
                          False))
        else:
            items.append((seq, ("hb",), False))
    return items


@pytest.mark.parametrize("seed", range(3))
def test_fb_batch_units_equal_the_reference(seed):
    """``_encode_fb_parts`` over the same drained items: the same parts
    (so the same ``"fb"`` body), with ``"appr"`` runs and pickled
    blocks in the same places; each side decodes the other's body."""
    bodies = {}
    for side in ("ref", "port"):
        s = NODE[side]
        fabric = s.node.NodeFabric()
        st = s.node._PeerState()
        st.schema_table = s.schema.encoder_table(
            frozenset(s.schema.registry.ids()))
        parts, schema_n, pickle_n, nframes, failed = fabric._encode_fb_parts(
            st, drained_items(np.random.default_rng(seed)))
        assert not failed and schema_n > 0 and pickle_n > 0
        bodies[side] = (b"".join(parts), schema_n, pickle_n, nframes)
    assert bodies["port"] == bodies["ref"]
    body = bodies["port"][0]
    kinds = [inner[0] for _, inner in ref_wire.decode_batch(body)]
    assert "appr" in kinds and "app" in kinds and "marker" in kinds
    assert port_wire.decode_batch(body) == ref_wire.decode_batch(body)


def test_proxy_cell_tokens_equal_the_reference():
    """A ProxyCell crosses as the ``cell`` token it was decoded from:
    the same pickled bytes on both packages, and each package decodes
    the other's bytes to its own cached proxy for that (address, uid)."""
    enc = {}
    fabrics = {}
    for side in ("ref", "port"):
        s = NODE[side]
        fabrics[side] = fabric = s.node.NodeFabric("uigc://here")
        proxies = [fabric._proxy(f"uigc://peer{i % 3}", 40 + 3 * i)
                   for i in range(8)]
        enc[side] = s.wire.encode_message(("refs", proxies, {"p": proxies[2]}))
    assert enc["port"] == enc["ref"]
    msg = port_wire.decode_message(fabrics["port"], enc["ref"])
    proxies = msg[1]
    assert all(isinstance(p, port_node.ProxyCell) for p in proxies)
    assert [(p.system.address, p.uid) for p in proxies] == [
        (f"uigc://peer{i % 3}", 40 + 3 * i) for i in range(8)]
    assert msg[2]["p"] is proxies[2] is fabrics["port"]._proxy(
        "uigc://peer2", 46)


def ring_records(seed, n=300):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, int(rng.integers(1, 300))).tolist())
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(2))
def test_shm_ring_records_equal_the_reference(seed):
    """The same records through a 4 KiB ring (wrapping many times) leave
    the same bytes in the segment after the name-free header, and the
    other package's reader reads them back in order."""
    records = ring_records(seed)
    segments = {}
    for side, mod, other in (("ref", ref_ring, port_ring),
                             ("port", port_ring, ref_ring)):
        ring = mod.ShmRing.create(4096)
        try:
            reader = other.ShmRing.attach(ring.name)
            got = []
            try:
                for data in records:
                    while not ring.write(data):
                        got.append(reader.read())
                segments[side] = bytes(ring._mm[:])
                while True:
                    out = reader.read()
                    if out is None:
                        break
                    got.append(out)
            finally:
                reader.close()
            assert got == records
        finally:
            ring.close()
    assert segments["port"] == segments["ref"]
    assert struct.unpack_from(">4sI", segments["port"])[1] == 4096


@pytest.mark.parametrize("seed", range(3))
def test_phi_equals_the_reference_on_a_seeded_series(seed):
    rng = np.random.default_rng(seed)
    gaps = rng.gamma(4.0, 0.025, 150)  # a jittery ~100 ms cadence
    probes = rng.uniform(0.0, 2.0, 40)
    phis = {}
    for side, mod in (("ref", ref_heartbeat), ("port", port_heartbeat)):
        det = mod.PhiAccrualFailureDetector(threshold=8.0,
                                            acceptable_pause_s=0.2)
        t, out = 0.0, []
        for gap in gaps:
            t += float(gap)
            det.heartbeat(t)
            out.append(det.phi(t + 0.01))
        out += [det.phi(t + float(d)) for d in probes]
        phis[side] = out
    assert phis["port"] == phis["ref"]
    assert max(phis["port"]) > 8.0  # the long silences cross the threshold


def delta_frames(side, msg):
    """What ``control_send`` puts on the wire for ``msg``, read off a
    NodeFabric whose peer link is a stub."""
    s = NODE[side]
    fabric = s.node.NodeFabric("uigc://a")
    sent = []
    fabric._conns["uigc://b"] = object()
    fabric._send_frame = lambda dst, frame, conn=None: sent.append(frame)
    target = types.SimpleNamespace(system=types.SimpleNamespace(
        address="uigc://b"))
    fabric.control_send(None, target, msg)
    return sent


def seeded_graph(side, seed):
    """A seeded DeltaGraph over fake cells (the fold script of
    tests/test_torch_fabric.py)."""
    s = SIDES[side]
    data, _ = fold_script(side, seed)
    ctx = s.state.CrgcContext(delta_graph_size=256, entry_field_size=4)
    return s.delta.DeltaGraph.deserialize(
        data, ctx, lambda raw: FakeCell(*_split(raw)))


def _split(raw):
    address, uid, _path = raw.decode().split("|", 2)
    return address, int(uid)


@pytest.mark.parametrize("seed", range(3))
def test_a_plain_delta_crosses_in_the_reference_bytes(seed):
    ref = delta_frames("ref", ref_collector.DeltaMsg(
        11, seeded_graph("ref", seed)))
    port = delta_frames("port", port_collector.DeltaMsg(
        11, seeded_graph("port", seed)))
    assert port == ref and len(port[0]) == 3
    assert (port_node._frame_bytes(port[0]) == ref_node._frame_bytes(ref[0]))


def receiving_fabric(side):
    """A NodeFabric whose system is a stub: its collector cell records
    what the frame decodes to."""
    s = NODE[side]
    fabric = s.node.NodeFabric("uigc://b")
    got = []
    ctx = SIDES[side].state.CrgcContext(delta_graph_size=256,
                                        entry_field_size=4)
    fabric.system = types.SimpleNamespace(
        address="uigc://b", resolve_cell=lambda uid: None,
        engine=types.SimpleNamespace(
            crgc_context=ctx,
            bookkeeper_cell=types.SimpleNamespace(tell=got.append)))
    return fabric, got


@pytest.mark.parametrize("seed", range(3))
def test_a_stamped_delta_crosses_with_its_fence_and_cut(seed):
    """The stamp (and the delta's index on its link) rides as trailing
    fields of the reference's frame; the
    port's receiver rebuilds a DDelta with the same graph, the
    reference's receiver reads the frame as a plain delta (the tolerant
    unpack), and a malformed stamp falls back to a plain delta."""
    plain = delta_frames("ref", ref_collector.DeltaMsg(
        5, seeded_graph("ref", seed)))[0]
    stamped = delta_frames("port", port_distributed.DDelta(
        5, seeded_graph("port", seed), fence=3, cut=17 + seed, index=seed))[0]
    assert stamped == plain + (3, 17 + seed, seed)

    fabric, got = receiving_fabric("port")
    fabric._on_frame("uigc://a", stamped)
    fabric._on_frame("uigc://a", plain)
    fabric._on_frame("uigc://a", plain + ("x", None))
    stamped_msg, plain_msg, bad_msg = got
    assert type(stamped_msg) is port_distributed.DDelta
    assert (stamped_msg.seqnum, stamped_msg.fence, stamped_msg.cut,
            stamped_msg.index) == (5, 3, 17 + seed, seed)
    assert type(plain_msg) is type(bad_msg) is port_collector.DeltaMsg
    # (re-encoded, the cells carry the receiver's proxy paths)
    port_bytes = stamped_msg.graph.serialize(port_wire.encode_cell)
    assert port_bytes == plain_msg.graph.serialize(port_wire.encode_cell)

    ref_fabric, ref_got = receiving_fabric("ref")
    ref_fabric._on_frame("uigc://a", stamped)
    assert type(ref_got[0]) is ref_collector.DeltaMsg
    assert ref_got[0].graph.serialize(ref_wire.encode_cell) == port_bytes
