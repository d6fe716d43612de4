"""The port's ``runtime/node.py`` batched-frame transport: the port's
counterpart of ``tests/test_fabric_batch.py``, every test run on
``uigc_tpu_torch`` as the reference runs it on ``uigc_tpu``.

The ``"fb"`` multi-frame wire units (the writer's coalescing) crossed
with the FaultPlan, the mixed-version hello negotiation, the
no-reorder-within-a-link property and the bulk teardown cascade:
batching is on by default, keeps every sequence-layer semantic
(gap/duplicate/corrupt accounting, drop injection per inner frame),
degrades to singleton units against a peer that never advertised the
capability, never reorders a burst within a link, and costs one
dispatcher batch per dispatcher on teardown.
"""

import threading
import time

import pytest

from uigc_tpu_torch import ActorSystem
from uigc_tpu_torch.runtime import wire
from uigc_tpu_torch.runtime.behaviors import RawBehavior
from uigc_tpu_torch.runtime.cell import tell_bulk
from uigc_tpu_torch.runtime.dispatcher import TimerService
from uigc_tpu_torch.runtime.faults import FaultPlan
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.utils import events

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.shadow-graph": "array",
    "uigc.crgc.num-nodes": 2,
}
NO_BATCH = dict(BASE)
NO_BATCH["uigc.node.frame-batching"] = False


class Sink(RawBehavior):
    """Counts ("n", lane, i) payloads and records per-lane order."""

    def __init__(self):
        self.n = 0
        self.got = []
        self.order_violations = 0
        self._last = {}
        self._lock = threading.Lock()

    def on_message(self, msg):
        if isinstance(msg, tuple) and msg and msg[0] == "n":
            with self._lock:
                lane, i = msg[1], msg[2]
                if i <= self._last.get(lane, -1):
                    self.order_violations += 1
                self._last[lane] = i
                self.got.append(i)
                self.n += 1
        return None


class EventLog:
    def __init__(self):
        self.entries = []
        self._lock = threading.Lock()

    def __call__(self, name, fields):
        with self._lock:
            self.entries.append((name, fields))

    def count(self, name):
        with self._lock:
            return sum(1 for n, _ in self.entries if n == name)

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

    def drive(self, n, lane=0):
        for i in range(n):
            self.proxy.tell(("n", lane, i))

    def settle(self, expected, timeout_s=20.0):
        deadline = time.monotonic() + timeout_s
        while self.sink.n < expected and time.monotonic() < deadline:
            time.sleep(0.01)
        return self.sink.n

    def close(self):
        for system in (self.a, self.b):
            try:
                system.terminate(timeout_s=5.0)
            except Exception:
                pass


# ------------------------------------------------------------------- #
# Wire codec units
# ------------------------------------------------------------------- #


def test_batch_codec_roundtrip():
    frames = [
        (1, ("app", 7, b"payload-bytes")),
        (2, ("app", 7, b"more", (123, 456))),
        (3, ("marker", 42)),
        (4, ("hb",)),
        (5, ("shard", 3, "uigc://x", {1: "uigc://y"})),
    ]
    body = wire.encode_batch(
        (seq, wire.encode_block(inner)) for seq, inner in frames
    )
    assert body[:4] == wire.FB_MAGIC
    decoded = wire.decode_batch(body)
    assert [(s, f) for s, f in decoded] == frames


def test_batch_codec_truncated_block_is_isolated():
    """A truncated inner block decodes to None; its neighbours and the
    batch framing survive."""
    blocks = [
        (1, wire.encode_block(("app", 1, b"x" * 64))),
        (2, wire.encode_block(("app", 2, b"y" * 64), truncate=True)),
        (3, wire.encode_block(("marker", 9))),
    ]
    decoded = wire.decode_batch(wire.encode_batch(blocks))
    assert decoded[0] == (1, ("app", 1, b"x" * 64))
    assert decoded[1] == (2, None)
    assert decoded[2] == (3, ("marker", 9))


def test_batch_codec_never_confused_with_pickle():
    """A pickled singleton body can never alias the batch magic
    (protocol-2+ pickles start with 0x80)."""
    import pickle

    body = pickle.dumps(("f", 1, ("hb",)), protocol=pickle.HIGHEST_PROTOCOL)
    assert body[:4] != wire.FB_MAGIC


def test_app_block_header_roundtrip_and_tolerance():
    block = wire.encode_block(("app", 5, b"pp", (11, 22)))
    assert wire.decode_block(block) == ("app", 5, b"pp", (11, 22))
    # a mangled trailing header is treated as absent, never an error
    assert wire.decode_block(block[:-1] + b"\xff") in (
        ("app", 5, b"pp"),
        ("app", 5, b"pp", (11, 22)),
    )


# ------------------------------------------------------------------- #
# Live-link batching
# ------------------------------------------------------------------- #


def test_batching_on_by_default_and_fifo(event_log):
    pair = Pair("fbdef")
    try:
        st = pair.fa._peer_state(pair.addr_b)
        assert "fb" in st.caps, "peer did not advertise the fb capability"
        pair.drive(3000)
        assert pair.settle(3000) == 3000
        assert pair.sink.order_violations == 0
        assert pair.sink.got == sorted(pair.sink.got)
        # coalescing visibly happened and no seq accidents occurred
        sizes = [f.get("size", 0) for f in event_log.of(events.FRAME_BATCH)]
        assert sizes and max(sizes) > 1
        assert event_log.count(events.FRAME_GAP) == 0
        assert event_log.count(events.FRAME_DUPLICATE) == 0
    finally:
        pair.close()


def test_raw_bytes_message_roundtrips():
    """A user message that IS a bytes object must be pickled like any
    other payload — sniffing isinstance(payload, bytes) as
    "already-encoded" would ship it raw and break the receiver's
    decode."""

    class Capture(RawBehavior):
        def __init__(self):
            self.got = []

        def on_message(self, msg):
            self.got.append(msg)
            return None

    fa = NodeFabric()
    fb = NodeFabric()
    a = ActorSystem(None, name="fbbytes-a", config=BASE, fabric=fa)
    b = ActorSystem(None, name="fbbytes-b", config=BASE, fabric=fb)
    try:
        cap = Capture()
        cap_cell = b.spawn_system_raw(cap, "cap")
        fb.register_name("cap", cap_cell)  # before the hello exchange
        port = fb.listen()
        addr_b = fa.connect("127.0.0.1", port)
        proxy = fa.lookup(addr_b, "cap")
        proxy.tell(b"raw-bytes-message")
        proxy.tell(("n", 0, 1))
        deadline = time.monotonic() + 10
        while len(cap.got) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert cap.got == [b"raw-bytes-message", ("n", 0, 1)]
    finally:
        for system in (a, b):
            try:
                system.terminate(timeout_s=5.0)
            except Exception:
                pass


@pytest.mark.parametrize(
    "cfg_a,cfg_b,label",
    [(BASE, NO_BATCH, "new-to-old"), (NO_BATCH, BASE, "old-to-new")],
)
def test_mixed_version_hello_degrades_to_singletons(
    cfg_a, cfg_b, label, event_log
):
    """A batching peer linked to a non-batching peer (legacy 5-element
    hello) must fall back to singleton units in the direction the
    capability is missing — and deliver everything, in order."""
    pair = Pair(f"fbmx-{label}", cfg_a=cfg_a, cfg_b=cfg_b)
    try:
        st = pair.fa._peer_state(pair.addr_b)
        if cfg_b is NO_BATCH:
            assert "fb" not in st.caps
        pair.drive(1000)
        assert pair.settle(1000) == 1000
        assert pair.sink.order_violations == 0
        # no direction of this link may have produced a batch unit
        assert event_log.count(events.FRAME_BATCH) == 0
        assert event_log.count(events.FRAME_GAP) == 0
    finally:
        pair.close()


def test_fault_plan_inner_frame_semantics(event_log):
    """Seeded drop/duplicate/truncate of individual frames inside the
    batched stream: exact loss accounting (drop + truncate are the only
    loss modes), duplicates discarded by the seq layer, truncation
    surfacing as frame_corrupt + a later gap — all while batching."""
    pair_names = ("uigc://fbfp-a", "uigc://fbfp-b")
    plan = (
        FaultPlan(11)
        .drop(src=pair_names[0], dst=pair_names[1], kind="app", count=7)
        .duplicate(src=pair_names[0], dst=pair_names[1], kind="app", count=6)
        .truncate(src=pair_names[0], dst=pair_names[1], kind="app", count=5)
    )
    pair = Pair("fbfp", plan=plan)
    try:
        n = 1200
        pair.drive(n)
        expected = n - 7 - 5
        assert pair.settle(expected) == expected
        assert pair.sink.order_violations == 0
        assert event_log.count(events.FRAME_DUPLICATE) >= 6
        assert event_log.count(events.FRAME_CORRUPT) >= 5
        # drops + truncations both register as gaps once later frames land
        missed = sum(f.get("missed", 0) for f in event_log.of(events.FRAME_GAP))
        assert missed >= 7
    finally:
        pair.close()


def test_fault_plan_reorder_and_delay_never_reorder_delivery(event_log):
    """Reorder holds and delay stalls inside the batched stream must
    never surface out-of-order messages: the late frame is discarded by
    the seq layer (the documented reorder loss), delayed frames release
    in order."""
    names = ("uigc://fbro-a", "uigc://fbro-b")
    plan = (
        FaultPlan(5)
        .reorder(src=names[0], dst=names[1], kind="app", count=3)
        .delay(src=names[0], dst=names[1], kind="app", count=2, frames=4)
    )
    pair = Pair("fbro", plan=plan)
    try:
        n = 600
        pair.drive(n)
        # Reordered frames are lost at the seq layer (early frame makes
        # a gap, the late one is discarded): at most 3 losses.
        got = pair.settle(n - 3)
        assert got >= n - 3
        assert pair.sink.order_violations == 0
    finally:
        pair.close()


def test_seq_never_reorders_within_link_under_concurrency():
    """Many sender threads, one link: per-lane FIFO must hold end to end
    (the writer assigns sequence numbers in queue order, the receiver
    delivers in seq order)."""
    pair = Pair("fbcc")
    try:
        lanes, per = 4, 500

        def sender(lane):
            for i in range(per):
                pair.proxy.tell(("n", lane, i))

        threads = [
            threading.Thread(target=sender, args=(lane,)) for lane in range(lanes)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert pair.settle(lanes * per) == lanes * per
        assert pair.sink.order_violations == 0
    finally:
        pair.close()


def test_send_frame_failure_surfaces_event(event_log):
    """A frame accepted for a peer whose link breaks surfaces a
    structured fabric.send_failed event instead of a silent True."""
    pair = Pair("fbsf")
    try:
        # Deterministic break: the live conn's flush path raises, so the
        # frame is accepted (True) but dies between queue and wire.
        conn = pair.fa._conn_for(pair.addr_b)

        class _BoomSock:
            def sendall(self, buf):
                raise OSError("injected link break")

            def recv(self, n):
                return b""

            def close(self):
                pass

        conn.sock = _BoomSock()
        accepted = pair.fa.send_frame(pair.addr_b, ("benchf", b"x"))
        assert accepted, "send_frame should accept a frame for a live link"
        deadline = time.monotonic() + 10
        while not event_log.count(events.SEND_FAILED) and time.monotonic() < deadline:
            time.sleep(0.01)
        failed = event_log.of(events.SEND_FAILED)
        assert failed, "no fabric.send_failed event for the broken link"
        assert any(f.get("kind") == "benchf" for f in failed)
        assert all(f.get("dst") == pair.addr_b for f in failed)
    finally:
        pair.close()


# ------------------------------------------------------------------- #
# Bulk teardown
# ------------------------------------------------------------------- #


class _CountingDispatcher:
    """Wraps a dispatcher, counting execute() submissions."""

    def __init__(self, inner):
        self.inner = inner
        self.submissions = 0
        self._lock = threading.Lock()

    def execute(self, runnable):
        with self._lock:
            self.submissions += 1
        self.inner.execute(runnable)


def test_tell_bulk_one_dispatcher_batch_per_kill_set():
    """K killed actors on one dispatcher must cost ONE dispatcher
    submission, not K (the teardown-cascade contract)."""
    system = ActorSystem(None, name="fbtd", config={"uigc.crgc.wakeup-interval": 50})
    try:
        k = 64
        cells = [
            system.spawn_system_raw(Sink(), f"bulk{i}") for i in range(k)
        ]
        # Let the initial batches drain so every cell is unscheduled.
        deadline = time.monotonic() + 10
        while (
            any(c._scheduled for c in cells) and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        counting = _CountingDispatcher(system.dispatcher)
        for cell in cells:
            cell._dispatcher = counting
        submissions = tell_bulk((cell, ("n", 0, 1)) for cell in cells)
        assert submissions == 1
        assert counting.submissions == 1
        deadline = time.monotonic() + 10
        while (
            any(c.behavior.n < 1 for c in cells) and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        assert all(c.behavior.n == 1 for c in cells)
    finally:
        system.terminate(timeout_s=5.0)


def test_collector_kill_cascade_is_batched_and_complete():
    """End to end: release K actors at once; the collector's sweep must
    stop them all (bulk path) and the system returns to its baseline
    actor count."""
    from uigc_tpu_torch import Behaviors

    class Child:
        def __init__(self, ctx):
            self.context = ctx

        def on_message(self, msg):
            return self

        def on_signal(self, signal):
            return None

    class Root:
        def __init__(self, ctx, k):
            self.context = ctx
            self.children = [
                ctx.spawn(Behaviors.setup(lambda c: Child(c)), f"c{i}")
                for i in range(k)
            ]

        def on_message(self, msg):
            if msg == ("drop",):
                self.context.release(*self.children)
                self.children = []
            return self

        def on_signal(self, signal):
            return None

    system = ActorSystem(
        None,
        name="fbkc",
        config={"uigc.crgc.wakeup-interval": 10, "uigc.crgc.shadow-graph": "array"},
    )
    try:
        k = 120
        root = system.spawn_root(
            Behaviors.setup_root(lambda ctx: Root(ctx, k)), "root"
        )
        deadline = time.monotonic() + 20
        while system.live_actor_count < k and time.monotonic() < deadline:
            time.sleep(0.01)
        base = system.live_actor_count - k
        root.tell(("drop",))
        while system.live_actor_count > base and time.monotonic() < deadline:
            time.sleep(0.01)
        assert system.live_actor_count == base, (
            f"{system.live_actor_count - base} released actors survived"
        )
    finally:
        system.terminate(timeout_s=5.0)


# ------------------------------------------------------------------- #
# TimerService satellite: exact deadlines, no idle polling
# ------------------------------------------------------------------- #


def test_timer_service_fires_at_deadline_without_polling():
    timers = TimerService(name="fbtm")
    try:
        fired = []
        t0 = time.monotonic()
        timers.schedule_once(0.15, lambda: fired.append(time.monotonic() - t0))
        deadline = time.monotonic() + 5
        while not fired and time.monotonic() < deadline:
            time.sleep(0.005)
        assert fired, "timer never fired"
        assert 0.13 <= fired[0] <= 0.6
        # an idle service accepts new work after sleeping unbounded
        fired2 = []
        timers.schedule_once(0.05, lambda: fired2.append(True))
        deadline = time.monotonic() + 5
        while not fired2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert fired2, "timer scheduled onto an idle service never fired"
    finally:
        timers.shutdown()


def test_timer_service_far_deadline_preempted_by_near_one():
    timers = TimerService(name="fbtm2")
    try:
        order = []
        timers.schedule_once(30.0, lambda: order.append("far"))
        timers.schedule_once(0.05, lambda: order.append("near"))
        deadline = time.monotonic() + 5
        while not order and time.monotonic() < deadline:
            time.sleep(0.005)
        assert order == ["near"]
    finally:
        timers.shutdown()
