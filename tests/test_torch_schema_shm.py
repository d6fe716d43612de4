"""The port's schema codec over a live link, its shared-memory rings
(``uigc_tpu_torch/runtime/shm_ring.py``) and the decode lanes: the
port's counterpart of ``tests/test_schema_shm.py`` from its NodeFabric
tests on (the codec units before them are held against the reference in
``tests/test_torch_fabric.py``; the UL010 lint rule belongs to the
static analyzers, ROADMAP.md Queue 1 item 10b).

- Mixed-version hellos in both directions (schema-capable or not) keep
  links byte-compatible: the side that did not advertise sees only
  pickle.
- A message no schema admits falls back to pickle mid-stream, in order.
- The shm rings keep the socket path's sequence, FaultPlan and
  dead-letter semantics, survive wraparound and full-ring backpressure,
  and a ring renounced mid-traffic recovers to the socket with no
  sequence gap or duplicate.
"""

import collections
import threading
import time

import pytest

from uigc_tpu_torch import ActorSystem
from uigc_tpu_torch.runtime import schema, shm_ring
from uigc_tpu_torch.runtime.behaviors import RawBehavior
from uigc_tpu_torch.runtime.faults import FaultPlan
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.utils import events

#: module-level so pickle (the fallback codec under test) can find it
NT = collections.namedtuple("NT", "lane i")

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.shadow-graph": "array",
    "uigc.crgc.num-nodes": 2,
}


def cfg(**overrides):
    """BASE + overrides given as underscored kwargs: the first two
    underscores become the dots of the dotted key, the rest dashes
    (``uigc_node_shm_transport`` -> ``uigc.node.shm-transport``)."""
    out = dict(BASE)
    for k, v in overrides.items():
        head, section, rest = k.split("_", 2)
        out[f"{head}.{section}.{rest.replace('_', '-')}"] = v
    return out


class Sink(RawBehavior):
    """Records every payload, per-lane order violations included."""

    def __init__(self):
        self.n = 0
        self.got = []
        self.order_violations = 0
        self._last = {}
        self._lock = threading.Lock()

    def on_message(self, msg):
        with self._lock:
            if isinstance(msg, tuple) and msg and msg[0] == "n":
                lane, i = msg[1], msg[2]
                if i <= self._last.get(lane, -1):
                    self.order_violations += 1
                self._last[lane] = i
            self.got.append(msg)
            self.n += 1
        return None


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

    def total(self, name, field):
        return sum(f.get(field, 0) for f in self.of(name))


@pytest.fixture
def event_log():
    log = EventLog()
    events.recorder.enable()
    events.recorder.add_listener(log)
    yield log
    events.recorder.disable()
    events.recorder.remove_listener(log)
    events.recorder.reset()


class Pair:
    def __init__(self, name, cfg_a=BASE, cfg_b=BASE, plan=None):
        self.fa = NodeFabric(fault_plan=plan)
        self.fb = NodeFabric(fault_plan=plan)
        self.a = ActorSystem(None, name=f"{name}-a", config=cfg_a, fabric=self.fa)
        self.b = ActorSystem(None, name=f"{name}-b", config=cfg_b, fabric=self.fb)
        self.sink = Sink()
        sink_cell = self.b.spawn_system_raw(self.sink, "sink")
        self.fb.register_name("sink", sink_cell)
        port = self.fb.listen()
        self.addr_b = self.fa.connect("127.0.0.1", port)
        self.proxy = self.fa.lookup(self.addr_b, "sink")

    def wait_shm(self, timeout_s=5.0):
        deadline = time.monotonic() + timeout_s
        while not self.fa.shm_active(self.addr_b) and time.monotonic() < deadline:
            time.sleep(0.005)
        return self.fa.shm_active(self.addr_b)

    def settle(self, expected, timeout_s=20.0):
        deadline = time.monotonic() + timeout_s
        while self.sink.n < expected and time.monotonic() < deadline:
            time.sleep(0.01)
        return self.sink.n

    def recv_state(self):
        return self.fb._peer_state(self.a.address)

    def close(self):
        for system in (self.a, self.b):
            try:
                system.terminate(timeout_s=5.0)
            except Exception:
                pass


# ------------------------------------------------------------------- #
# Schema codec units
# ------------------------------------------------------------------- #


# ------------------------------------------------------------------- #
# Schema codec over a live link
# ------------------------------------------------------------------- #


def test_schema_codec_on_by_default_and_counted(event_log):
    pair = Pair("sc-default")
    try:
        assert pair.fa.peer_schema_ids(pair.addr_b) == frozenset(
            schema.registry.ids()
        )
        for i in range(500):
            pair.proxy.tell(("n", 0, i))
        assert pair.settle(500) == 500
        assert pair.sink.order_violations == 0
        assert event_log.total(events.CODEC_FRAMES, "schema") >= 500
    finally:
        pair.close()


def test_unencodable_messages_fall_back_to_pickle_mid_stream(event_log):
    """A stream interleaving schema-admitted tuples with class
    instances and oversized ints delivers everything, in order, with
    both codecs observably in play."""
    pair = Pair("sc-mid")
    try:
        expected = []
        for i in range(300):
            if i % 3 == 2:
                msg = NT(0, i) if i % 2 else ("big", 1 << 90, i)
            else:
                msg = ("n", 0, i)
            expected.append(msg)
            pair.proxy.tell(msg)
        assert pair.settle(300) == 300
        assert pair.sink.got == expected
        # namedtuples survive as namedtuples (the exact-type gate)
        assert any(isinstance(m, NT) for m in pair.sink.got)
        assert event_log.total(events.CODEC_FRAMES, "schema") > 0
        assert event_log.total(events.CODEC_FRAMES, "pickle") > 0
        st = pair.recv_state()
        assert (st.gaps, st.dups) == (0, 0)
    finally:
        pair.close()


@pytest.mark.parametrize("capable_side", ["a", "b"])
def test_mixed_version_hello_both_directions(event_log, capable_side):
    """A schema-capable node and a non-advertising one interoperate in
    both directions; the non-negotiated link carries only pickle."""
    plain = cfg(uigc_node_schema_codec=False)
    cfg_a = BASE if capable_side == "a" else plain
    cfg_b = plain if capable_side == "a" else BASE
    pair = Pair(f"sc-mix-{capable_side}", cfg_a=cfg_a, cfg_b=cfg_b)
    try:
        assert pair.fa.peer_schema_ids(pair.addr_b) == frozenset()
        for i in range(200):
            pair.proxy.tell(("n", 0, i))
        assert pair.settle(200) == 200
        assert pair.sink.order_violations == 0
        assert event_log.total(events.CODEC_FRAMES, "schema") == 0
        st = pair.recv_state()
        assert (st.gaps, st.dups) == (0, 0)
    finally:
        pair.close()


def test_schema_run_respects_fault_plan_drops(event_log):
    """Outbound drop verdicts land on schema-run traffic with the same
    observable accounting as the pickle path: dropped frames consume
    sequence numbers, the receiver reports the gap, everything else
    arrives in order."""
    names = ("uigc://sc-drop-a", "uigc://sc-drop-b")
    plan = FaultPlan(7).drop(src=names[0], dst=names[1], kind="app", count=25)
    pair = Pair("sc-drop", plan=plan)
    try:
        for i in range(200):
            pair.proxy.tell(("n", 0, i))
        assert pair.settle(175) == 175
        assert len(event_log.of(events.FRAME_DROPPED)) == 25
        st = pair.recv_state()
        assert st.gaps == 25  # every drop is a visible gap
        assert st.dups == 0
        assert pair.sink.order_violations == 0
    finally:
        pair.close()


# ------------------------------------------------------------------- #
# Shm ring units
# ------------------------------------------------------------------- #


def test_shm_ring_wraparound_fifo():
    ring = shm_ring.ShmRing.create(4096)
    try:
        peer = shm_ring.ShmRing.attach(ring.name)
        try:
            sent = []
            received = []
            for i in range(500):
                data = bytes([i % 251]) * (17 + i % 211)
                while not ring.write(data):
                    got = peer.read()
                    assert got is not None
                    received.append(got)
                sent.append(data)
            while True:
                got = peer.read()
                if got is None:
                    break
                received.append(got)
            assert received == sent
        finally:
            peer.close()
    finally:
        ring.close()


def test_shm_ring_full_refusal_and_poison():
    ring = shm_ring.ShmRing.create(4096)
    try:
        peer = shm_ring.ShmRing.attach(ring.name)
        try:
            n = 0
            while ring.write(b"z" * 100):
                n += 1
            assert n > 0  # filled up, then refused without corruption
            assert not ring.write(b"z" * 100)
            ring.poison()
            assert peer.poisoned
            # data written before the poison still drains
            for _ in range(n):
                assert peer.read() == b"z" * 100
            assert peer.read() is None
        finally:
            peer.close()
    finally:
        ring.close()


def test_shm_ring_selfcheck():
    assert shm_ring.selfcheck()


# ------------------------------------------------------------------- #
# Shm transport end-to-end
# ------------------------------------------------------------------- #


def test_shm_transport_negotiates_and_delivers(event_log):
    pair = Pair("shm-basic", cfg_a=cfg(uigc_node_shm_transport=True),
                cfg_b=cfg(uigc_node_shm_transport=True))
    try:
        assert pair.wait_shm()
        for i in range(2000):
            pair.proxy.tell(("n", 0, i))
        assert pair.settle(2000) == 2000
        assert pair.sink.order_violations == 0
        st = pair.recv_state()
        assert (st.gaps, st.dups) == (0, 0)
        roles = {f.get("role") for f in event_log.of(events.SHM_ESTABLISHED)}
        assert roles == {"producer", "consumer"}
    finally:
        pair.close()


def test_shm_not_negotiated_when_peer_lacks_cap():
    pair = Pair("shm-mixed", cfg_a=cfg(uigc_node_shm_transport=True), cfg_b=BASE)
    try:
        time.sleep(0.3)
        assert not pair.fa.shm_active(pair.addr_b)
        for i in range(200):
            pair.proxy.tell(("n", 0, i))
        assert pair.settle(200) == 200
    finally:
        pair.close()


def test_shm_full_ring_backpressure(event_log):
    """A tiny ring forces the writer into the full-ring stall; traffic
    still delivers completely and in order, and the stall is counted."""
    small = cfg(uigc_node_shm_transport=True, uigc_node_shm_ring_bytes=8192)
    pair = Pair("shm-full", cfg_a=small, cfg_b=small)
    try:
        assert pair.wait_shm()
        for i in range(4000):
            pair.proxy.tell(("n", 0, i, b"pad" * 40))
        assert pair.settle(4000, timeout_s=40.0) == 4000
        assert pair.sink.order_violations == 0
        st = pair.recv_state()
        assert (st.gaps, st.dups) == (0, 0)
        assert len(event_log.of(events.SHM_RING_FULL)) > 0
    finally:
        pair.close()


def test_shm_fault_plan_verdicts_apply(event_log):
    """FaultPlan verdicts run identically on the shm path (they sit
    above the transport): drops surface as receiver gaps."""
    names = ("uigc://shm-fault-a", "uigc://shm-fault-b")
    plan = FaultPlan(11).drop(src=names[0], dst=names[1], kind="app", count=20)
    shm = cfg(uigc_node_shm_transport=True)
    pair = Pair("shm-fault", cfg_a=shm, cfg_b=shm, plan=plan)
    try:
        assert pair.wait_shm()
        for i in range(200):
            pair.proxy.tell(("n", 0, i))
        assert pair.settle(180) == 180
        assert len(event_log.of(events.FRAME_DROPPED)) == 20
        st = pair.recv_state()
        assert st.gaps == 20
        assert st.dups == 0
        assert pair.sink.order_violations == 0
    finally:
        pair.close()


def test_shm_ring_death_recovers_to_socket_without_desync(event_log):
    """Mid-traffic ring renouncement (the peer-crash model: the ring
    becomes unwritable while the process and socket survive) falls the
    link back to the socket path with ZERO sequence gaps or duplicates
    — the receiver drains the ring before its first socket frame."""
    shm = cfg(uigc_node_shm_transport=True)
    pair = Pair("shm-crash", cfg_a=shm, cfg_b=shm)
    try:
        assert pair.wait_shm()
        for i in range(1000):
            pair.proxy.tell(("n", 0, i))
        assert pair.settle(1000) == 1000
        # poison the producing ring mid-stream: the writer's next flush
        # renounces it and resumes the socket
        st_a = pair.fa._peer_state(pair.addr_b)
        st_a.shm_tx.poison()
        for i in range(1000, 2000):
            pair.proxy.tell(("n", 0, i))
        assert pair.settle(2000) == 2000
        assert pair.sink.order_violations == 0
        assert not pair.fa.shm_active(pair.addr_b)
        st = pair.recv_state()
        assert (st.gaps, st.dups) == (0, 0)
        reasons = {f.get("reason") for f in event_log.of(events.SHM_FALLBACK)}
        assert "poisoned" in reasons
        # and the link still works for a third burst
        for i in range(2000, 2500):
            pair.proxy.tell(("n", 0, i))
        assert pair.settle(2500) == 2500
    finally:
        pair.close()


def test_decode_lanes_degrade_gracefully_under_gil(event_log):
    """``decode-workers: on`` forces per-peer decode lanes even under
    the stock GIL — delivery, ordering and seq accounting must be
    byte-identical to the inline path."""
    lanes = cfg(uigc_node_shm_transport=True, uigc_node_decode_workers="on")
    pair = Pair("lanes", cfg_a=lanes, cfg_b=lanes)
    try:
        assert pair.wait_shm()
        n_senders, per = 4, 500
        threads = [
            threading.Thread(
                target=lambda lane=lane: [
                    pair.proxy.tell(("n", lane, i)) for i in range(per)
                ]
            )
            for lane in range(n_senders)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert pair.settle(n_senders * per) == n_senders * per
        assert pair.sink.order_violations == 0
        st = pair.recv_state()
        assert st.decode_lane is not None
        assert (st.gaps, st.dups) == (0, 0)
    finally:
        pair.close()


# ------------------------------------------------------------------- #
# UL010 lint rule
# ------------------------------------------------------------------- #


