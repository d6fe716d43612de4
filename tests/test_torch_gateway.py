"""The port's counterpart of ``tests/test_gateway.py``, then the port
held against the reference (``uigc_tpu/gateway``).

The first part is the reference's 20 tests, with their names and
assertions, on ``uigc_tpu_torch.gateway`` over the port's NodeFabrics
and cluster sharding.  The raw-TCP client is the reference bench's
(``tools/ingress_bench.py`` ``BenchClient``), bound to the port's
client framing; it holds bytes only.

The second part holds the two packages to the same answers:

- client frames: seeded client values encoded by each package's
  ``encode_client_value``/``encode_frame``/``encode_error`` decode in
  the other to equal values and re-encode to the same bytes; a seeded
  hostile corpus is refused by both with the same exception class; the
  websocket accept key and a handshake split across reads agree;
- admission: one seeded timeline of connects and message batches
  through both packages' ``TenantQuotas`` and ``OverloadController``,
  with the clock passed in, gives the same verdict at every step;
- reply frames: the ``"gwr"`` frames and the ``gwclient`` tokens a live
  port edge (two data nodes and a proxy-only gateway) sends are decoded
  by the reference's ``wire`` and re-encode to the same bytes;
- backpressure: a port NodeFabric whose peer stops reading reports a
  nonzero writer depth to the port's gateway, which throttles reads.

Ingress gateway: protocol, admission, routing, flow control, chaos.

Covers the front-door subsystem (``uigc_tpu_torch/gateway``) end to end:

- client value codec hostile input: truncation, depth bombs, length
  bombs, unknown tags — every malformed body is a clean
  ``ClientDecodeError``, never an exception escape or a code load;
- framing: raw length-prefixed round trip, ``decode_gateway_reply``
  rejecting malformed reply frames, the minimal websocket upgrade
  (RFC 6455 accept key, masked client frames, server frames);
- admission units: token auth, per-tenant connection caps and msg/s
  buckets, the overload controller's hysteresis band;
- end to end over real sockets: CONNECT -> AUTH_OK -> SEND -> ACK
  through a proxy-only gateway into sharded entities, SUBSCRIBE ->
  PUSH fan-out, clean seq-addressed ERROR frames for auth/quota/proto
  rejections, drain;
- the proxy-only membership contract: the gateway routes by the peer
  table but never owns shards and never re-enters its own member view
  (the fabric's subscribe replay includes ourselves);
- flow control one hop further: egress backlog maps to per-connection
  read throttling with ``fabric.backpressure{site=gateway}`` events;
- client-socket fault units (slowloris / half-open / truncate / flood)
  and the chaos acceptance: faulted clients plus one entity-node death
  mid-run, and still every admitted command is acked or cleanly
  errored with zero acked-then-lost state.
"""

import importlib.util
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

import uigc_tpu.gateway.admission as ref_admission
import uigc_tpu.gateway.protocol as ref_protocol
import uigc_tpu.gateway.session as ref_session
import uigc_tpu.runtime.node as ref_node
import uigc_tpu.runtime.schema as ref_schema
import uigc_tpu.runtime.wire as ref_wire
from uigc_tpu_torch import ActorSystem, ClusterSharding, Entity
from uigc_tpu_torch.gateway import IngressGateway, protocol
from uigc_tpu_torch.gateway.admission import (
    OverloadController,
    TenantQuotas,
    TokenAuth,
)
from uigc_tpu_torch.gateway.session import ClientRef
from uigc_tpu_torch.runtime import faults, schema, wire
from uigc_tpu_torch.runtime import node as port_node
from uigc_tpu_torch.runtime.faults import FaultPlan
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.utils import events
from uigc_tpu_torch.utils.validation import require

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, "tools", f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_ib = _load_tool("ingress_bench")
# The bench client speaks bytes through its module's ``protocol``; bind
# it to the port's framing so no reference code runs on the port's path.
_ib.protocol = protocol
_ib.require = require
BenchClient = _ib.BenchClient
_read_one_frame = _ib._read_one_frame

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


class GwCounter(Entity):
    """Counts gateway commands; pushes every increment to subscribers."""

    def __init__(self, ctx, key, state):
        super().__init__(ctx, key)
        state = state or {}
        self.count = state.get("count", 0)
        self.subscribers = []

    def receive(self, msg):
        if not (isinstance(msg, tuple) and msg):
            return self
        if msg[0] == "gw-cmd":
            _kind, ref, seq, cmd = msg
            if not (isinstance(cmd, dict) and cmd.get("probe")):
                self.count += 1
                for sub in self.subscribers:
                    sub.tell(("push", {"key": self.key, "count": self.count}))
            ref.tell(("ack", seq, self.count))
        elif msg[0] == "gw-sub":
            if msg[1] not in self.subscribers:
                self.subscribers.append(msg[1])
        return self

    def snapshot_state(self):
        return {"count": self.count}


def counter_factory(ctx, key, state):
    return GwCounter(ctx, key, state)


class DataNode:
    __slots__ = ("fabric", "system", "cluster", "region", "port", "address")

    def __init__(self, name, config, plan=None):
        self.fabric = NodeFabric(fault_plan=plan)
        self.system = ActorSystem(
            None, name=name, config=config, fabric=self.fabric
        )
        self.port = self.fabric.listen()
        self.address = self.system.address
        self.cluster = ClusterSharding.attach(self.system)
        self.region = self.cluster.start("counter", counter_factory)


class GatewayNode:
    """Proxy-only member + IngressGateway, the bench topology."""

    __slots__ = (
        "fabric", "system", "cluster", "gateway", "port", "address",
        "client_port",
    )

    def __init__(self, name, config, plan=None):
        self.fabric = NodeFabric(fault_plan=plan)
        self.system = ActorSystem(
            None, name=name, config=config, fabric=self.fabric
        )
        self.port = self.fabric.listen()
        self.address = self.system.address
        self.cluster = ClusterSharding.attach(self.system, proxy_only=True)
        self.gateway = IngressGateway(self.system)
        self.client_port = None

    def listen(self):
        self.client_port = self.gateway.listen()
        return self.client_port


def build_edge(n_data, overrides=None, plan=None, gw_plan=None,
               journal_dir=None):
    config = dict(BASE)
    config["uigc.crgc.num-nodes"] = n_data + 1
    if journal_dir is not None:
        config["uigc.cluster.journal-dir"] = str(journal_dir)
    if overrides:
        config.update(overrides)
    nodes = [DataNode(f"gwt-d{i}", config, plan) for i in range(n_data)]
    gw = GatewayNode("gwt-gw", config, gw_plan)
    for i, a in enumerate(nodes):
        for b in nodes[i + 1:]:
            a.fabric.connect("127.0.0.1", b.port)
    for n in nodes:
        gw.fabric.connect("127.0.0.1", n.port)
    assert settle(
        lambda: len(gw.cluster.members()) == n_data
        and all(len(n.cluster.members()) == n_data for n in nodes)
        and gw.cluster.home_of("k-0") is not None
    ), "edge topology never settled"
    gw.listen()
    return nodes, gw


def teardown_edge(nodes, gw):
    try:
        gw.gateway.close()
    except Exception:
        pass
    for n in [gw] + list(nodes):
        try:
            n.system.terminate(timeout_s=5.0)
        except Exception:
            pass


def raw_connect(port, tenant="public", token=None, timeout=10.0):
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    body = {"tenant": tenant}
    if token is not None:
        body["token"] = token
    sock.sendall(protocol.encode_frame(protocol.OP_CONNECT, body))
    return sock


def expect_eof(sock, timeout_s=10.0):
    """Drain until the peer closes (any reset counts as closed)."""
    sock.settimeout(timeout_s)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if not sock.recv(4096):
                return True
        except socket.timeout:
            return False
        except OSError:
            return True
    return False


# ------------------------------------------------------------------- #
# Client value codec: the closed decoder under hostile bytes
# ------------------------------------------------------------------- #


def test_client_value_codec_round_trip():
    samples = [
        None,
        True,
        False,
        0,
        -1,
        2 ** 60,
        -(2 ** 60),
        3.5,
        "tenant-a",
        "ünïcode",
        b"\x00\xffbytes",
        [1, "two", [3.0, None]],
        {"seq": 7, "cmd": {"op": "inc", "args": [1, 2]}},
    ]
    for value in samples:
        assert schema.decode_client_value(
            schema.encode_client_value(value)
        ) == value
    # Tuples are a server-side convenience: they encode as lists.
    assert schema.decode_client_value(
        schema.encode_client_value((1, 2))
    ) == [1, 2]


def test_client_value_codec_rejects_hostile_input():
    good = schema.encode_client_value({"k": [1, 2, 3], "s": "x" * 50})
    hostile = [
        b"",  # empty body
        good[:-1],  # truncated tail
        good[: len(good) // 2],  # truncated middle
        b"Z",  # unknown tag
        good + b"\x00",  # trailing bytes
        b"i" + b"\xff" * 11,  # varint longer than the int bound
        b"s\xff\xff\xff\xff\x0f",  # string length >> body
        b"l\xff\xff\xff\xff\x0f",  # list count >> body
        b"d\xff\xff\xff\xff\x0f",  # dict count >> body
        b"d\x01l\x00N",  # unhashable dict key (a list)
        b"f\x00",  # truncated double
    ]
    deep = b"l\x01" * (schema.CLIENT_MAX_DEPTH + 2) + b"N"  # depth bomb
    hostile.append(deep)
    for body in hostile:
        with pytest.raises(schema.ClientDecodeError):
            schema.decode_client_value(body)
    # And hostile bytes through the frame layer are a ProtocolError,
    # never an escape.
    with pytest.raises(protocol.ProtocolError):
        protocol.decode_frame_body(bytes([protocol.OP_SEND]) + b"Z")
    with pytest.raises(protocol.ProtocolError):
        protocol.decode_frame_body(b"")


def test_client_value_codec_refuses_server_types_on_encode():
    with pytest.raises(TypeError):
        schema.encode_client_value(object())
    with pytest.raises(TypeError):
        schema.encode_client_value({"ref": ClientRef("uigc://gw", 1)})


# ------------------------------------------------------------------- #
# Framing: raw frames, gateway reply frames, websocket upgrade
# ------------------------------------------------------------------- #


def test_protocol_frame_round_trip_and_error_bodies():
    raw = protocol.encode_frame(protocol.OP_SEND, {"seq": 1, "key": "k"})
    (length,) = struct.unpack_from(">I", raw, 0)
    assert length == len(raw) - 4
    op, value = protocol.decode_frame_body(raw[4:])
    assert (op, value) == (protocol.OP_SEND, {"seq": 1, "key": "k"})

    eop, ebody = protocol.encode_error(
        protocol.ERR_MSG_RATE, "slow down", retry_after_ms=250, seq=9
    )
    assert eop == protocol.OP_ERROR
    assert ebody["code"] == protocol.ERR_MSG_RATE
    assert ebody["retry_after_ms"] == 250
    assert ebody["seq"] == 9


def test_decode_gateway_reply_rejects_malformed_frames():
    frame = wire.encode_gateway_reply(7, b"payload")
    assert frame[0] == wire.GATEWAY_FRAME_KIND
    assert wire.decode_gateway_reply(frame) == (7, b"payload")
    # Malformed reply frames decode to None — the gateway drops them
    # without killing the link's receive loop.  (Kind dispatch is the
    # fabric's job; the decoder checks shape, not the tag.)
    assert wire.decode_gateway_reply(("gwr",)) is None
    assert wire.decode_gateway_reply(("gwr", "not-an-int", b"x")) is None
    assert wire.decode_gateway_reply(("gwr", 1, "not-bytes")) is None
    # The tolerance contract accepts trailing elements from newer peers.
    assert wire.decode_gateway_reply(("gwr", 1, b"x", "extra")) == (1, b"x")


def test_websocket_accept_key_and_decoder_upgrade():
    # The RFC 6455 worked example.
    assert (
        protocol.ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==")
        == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    )
    dec = protocol.TransportDecoder(1 << 20)
    request = (
        b"GET /chat HTTP/1.1\r\n"
        b"Host: gw\r\n"
        b"Upgrade: websocket\r\n"
        b"Connection: Upgrade\r\n"
        b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
        b"Sec-WebSocket-Version: 13\r\n\r\n"
    )
    frames, out, closed = dec.feed(request)
    assert frames == [] and not closed
    assert b"101 Switching Protocols" in out
    assert b"s3pPLMBiTxaQ9kYGzzhZRbK+xOo=" in out

    # A masked client frame carrying one protocol body.
    body = protocol.encode_frame_body(
        protocol.OP_CONNECT, {"tenant": "ws"}
    )
    mask = b"\x01\x02\x03\x04"
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(body))
    header = bytes([0x82, 0x80 | len(body)]) + mask  # FIN+binary, masked
    frames, out, closed = dec.feed(header + masked)
    assert frames == [(protocol.OP_CONNECT, {"tenant": "ws"})] and not closed
    # Replies come back ws-framed.
    reply = dec.encode(protocol.OP_AUTH_OK, {"conn": 1})
    assert reply[0] == 0x82


def test_websocket_handshake_split_across_reads():
    dec = protocol.TransportDecoder(1 << 20)
    request = (
        b"GET / HTTP/1.1\r\n"
        b"Upgrade: websocket\r\n"
        b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n\r\n"
    )
    out_all = b""
    for i in range(len(request)):
        frames, out, closed = dec.feed(request[i : i + 1])
        assert frames == [] and not closed
        out_all += out
    assert b"101 Switching Protocols" in out_all


# ------------------------------------------------------------------- #
# Admission units: pure bookkeeping, no sockets
# ------------------------------------------------------------------- #


def test_token_auth_open_and_spec_modes():
    open_auth = TokenAuth("")
    assert open_auth.authenticate(None, "t1") == "t1"
    assert open_auth.authenticate("anything", None) == "public"
    closed = TokenAuth("tok-a=alpha,tok-b=beta")
    assert closed.authenticate("tok-a", None) == "alpha"
    assert closed.authenticate("tok-b", "ignored") == "beta"
    assert closed.authenticate("nope", None) is None
    assert closed.authenticate(None, "alpha") is None
    assert closed.authenticate(123, None) is None


def test_tenant_quotas_connections_and_msg_bucket():
    q = TenantQuotas(max_conns=2, msgs_per_sec=10)
    assert q.try_connect("t") and q.try_connect("t")
    assert not q.try_connect("t")
    q.disconnect("t")
    assert q.try_connect("t")
    # Bucket: burst == rate, prefix admission, refill by elapsed time.
    assert q.admit_msgs("t", 25, now=100.0) == 10
    assert q.admit_msgs("t", 5, now=100.0) == 0
    assert q.admit_msgs("t", 8, now=100.5) == 5  # 0.5s -> 5 tokens
    # Disabled rate limiting admits everything.
    assert TenantQuotas(0, 0).admit_msgs("t", 1000, now=0.0) == 1000


def test_overload_controller_hysteresis_and_dwell():
    ctl = OverloadController(p99_band_ms=100.0, depth_band=50)
    now = 0.0
    assert not ctl.shedding(now)
    for _ in range(200):
        ctl.observe(500.0)
    now += 1.0
    assert ctl.shedding(now)
    assert ctl.shed_entered_total == 1
    # Within the dwell window the verdict is frozen even if signals
    # recover instantly.
    ctl._ring.clear()
    for _ in range(200):
        ctl.observe(1.0)
    assert ctl.shedding(now + 0.1)
    # Past the dwell, recovery needs BOTH signals under the exit band.
    ctl.note_depth(49)  # < band but >= exit fraction (25)
    assert ctl.shedding(now + 1.0)
    ctl.note_depth(10)
    assert not ctl.shedding(now + 2.0)


# ------------------------------------------------------------------- #
# End to end: real sockets through a proxy-only gateway
# ------------------------------------------------------------------- #


def test_gateway_end_to_end_ack_push_and_ping(event_log):
    nodes, gw = build_edge(2)
    try:
        client = BenchClient("127.0.0.1", gw.client_port, tenant="t-e2e")
        client.send_cmd(1, "k-0", {"op": "inc"})
        client.send_cmd(2, "k-0", {"op": "inc"})
        client.send_cmd(3, "k-17", {"op": "inc"})
        assert settle(lambda: len(client.acked) == 3, 15.0)
        assert client.acked[2][0] == 2  # counted in order on one key
        assert client.acked[3][0] == 1
        assert not client.errors

        # SUBSCRIBE: a second client's increments push to this one.
        sub = raw_connect(gw.client_port, tenant="t-sub")
        op, _ = _read_one_frame(sub, 10.0)
        assert op == protocol.OP_AUTH_OK
        sub.sendall(
            protocol.encode_frame(
                protocol.OP_SUBSCRIBE, {"type": "counter", "key": "k-0"}
            )
        )
        time.sleep(0.3)  # let the subscription land on the entity
        client.send_cmd(4, "k-0", {"op": "inc"})
        op, value = _read_one_frame(sub, 10.0)
        assert op == protocol.OP_PUSH
        assert value == {"data": {"key": "k-0", "count": 3}}

        # PING keeps the connection honest.
        sub.sendall(protocol.encode_frame(protocol.OP_PING, None))
        op, _ = _read_one_frame(sub, 10.0)
        assert op == protocol.OP_PONG
        sub.close()
        client.close()
        assert settle(lambda: gw.gateway.connection_count() == 0, 10.0)
        opens = [
            f for f in event_log.of(events.GATEWAY_CONNECTION)
            if f.get("action") == "open"
        ]
        assert len(opens) == 2
        assert sum(
            f.get("count", 0) for f in event_log.of(events.GATEWAY_MSG)
        ) == 4
    finally:
        teardown_edge(nodes, gw)


def test_gateway_auth_conn_limit_and_msg_rate_shed(event_log):
    nodes, gw = build_edge(
        1,
        overrides={
            "uigc.gateway.auth-tokens": "tok-a=alpha",
            "uigc.gateway.tenant-max-connections": 1,
            "uigc.gateway.tenant-msgs-per-sec": 5,
        },
    )
    try:
        # Bad token: clean ERR_AUTH, then close.
        bad = raw_connect(gw.client_port, token="wrong")
        op, value = _read_one_frame(bad, 10.0)
        assert (op, value["code"]) == (protocol.OP_ERROR, protocol.ERR_AUTH)
        assert expect_eof(bad)
        bad.close()

        # First tenant connection admitted, second over the cap.
        first = raw_connect(gw.client_port, token="tok-a")
        op, _ = _read_one_frame(first, 10.0)
        assert op == protocol.OP_AUTH_OK
        second = raw_connect(gw.client_port, token="tok-a")
        op, value = _read_one_frame(second, 10.0)
        assert (op, value["code"]) == (
            protocol.OP_ERROR,
            protocol.ERR_CONN_LIMIT,
        )
        assert value["retry_after_ms"] > 0
        second.close()

        # A 20-send burst against a 5/s bucket: the prefix is acked,
        # the excess is seq-addressed ERR_MSG_RATE — nothing silent.
        for seq in range(1, 21):
            first.sendall(
                protocol.encode_frame(
                    protocol.OP_SEND,
                    {"seq": seq, "type": "counter", "key": "k-b",
                     "cmd": {"op": "inc"}},
                )
            )
        acked, errored = {}, {}
        first.settimeout(15.0)
        while len(acked) + len(errored) < 20:
            op, value = _read_one_frame(first, 15.0)
            if op == protocol.OP_ACK:
                acked[value["seq"]] = value["result"]
            elif op == protocol.OP_ERROR:
                assert value["code"] == protocol.ERR_MSG_RATE
                assert value["retry_after_ms"] > 0
                errored[value["seq"]] = value["code"]
        assert len(acked) == 5
        assert sorted(acked) == [1, 2, 3, 4, 5]  # prefix admission
        assert len(errored) == 15
        first.close()
        shed_reasons = {
            f["reason"] for f in event_log.of(events.GATEWAY_SHED)
        }
        assert {"auth", "conn-limit", "msg-rate"} <= shed_reasons
    finally:
        teardown_edge(nodes, gw)


def test_gateway_proto_violation_and_oversize_close_cleanly():
    nodes, gw = build_edge(
        1, overrides={"uigc.gateway.max-frame-bytes": 4096}
    )
    try:
        # Garbage that parses as a frame but not as a client value.
        sock = raw_connect(gw.client_port)
        op, _ = _read_one_frame(sock, 10.0)
        assert op == protocol.OP_AUTH_OK
        sock.sendall(struct.pack(">I", 3) + b"\x7fZZ")
        op, value = _read_one_frame(sock, 10.0)
        assert (op, value["code"]) == (protocol.OP_ERROR, protocol.ERR_PROTO)
        assert expect_eof(sock)
        sock.close()

        # A frame header past max-frame-bytes drops the connection
        # without reading the body.
        big = raw_connect(gw.client_port)
        op, _ = _read_one_frame(big, 10.0)
        assert op == protocol.OP_AUTH_OK
        big.sendall(struct.pack(">I", 1 << 30))
        assert expect_eof(big)
        big.close()
        # The gateway itself is unharmed.
        ok = raw_connect(gw.client_port)
        op, _ = _read_one_frame(ok, 10.0)
        assert op == protocol.OP_AUTH_OK
        ok.close()
    finally:
        teardown_edge(nodes, gw)


def test_gateway_drain_is_clean_and_refuses_new_connects():
    nodes, gw = build_edge(1)
    try:
        sock = raw_connect(gw.client_port)
        op, _ = _read_one_frame(sock, 10.0)
        assert op == protocol.OP_AUTH_OK
        gw.gateway.drain()
        op, value = _read_one_frame(sock, 10.0)
        assert (op, value["code"]) == (
            protocol.OP_ERROR,
            protocol.ERR_DRAINING,
        )
        assert value["retry_after_ms"] > 0
        assert expect_eof(sock)
        sock.close()
        assert settle(lambda: gw.gateway.connection_count() == 0, 10.0)
        # The listener is closed: a late connect is refused — or, on
        # loopback, may "succeed" as a kernel self-connect (ephemeral
        # source port == destination port) with no server behind it.
        # Either way the gateway admits no new session.
        try:
            late = socket.create_connection(
                ("127.0.0.1", gw.client_port), timeout=2.0
            )
        except OSError:
            pass
        else:
            assert late.getpeername() == late.getsockname()
            late.close()
        assert gw.gateway.connection_count() == 0
    finally:
        teardown_edge(nodes, gw)


def test_gateway_proxy_member_owns_no_shards_and_excludes_self():
    """Regression: the fabric's subscribe replay includes the node's
    own address; a proxy-only member must not re-enter its own
    placement view (a table claiming the whole keyspace for a node
    with no regions would blackhole every route)."""
    nodes, gw = build_edge(2)
    try:
        data_addrs = {n.address for n in nodes}
        assert set(gw.cluster.members()) == data_addrs
        assert gw.address not in gw.cluster.members()
        for n in nodes:
            assert gw.address not in n.cluster.members()
        homes = {gw.cluster.home_of(f"k-{i}") for i in range(64)}
        assert homes <= data_addrs
        assert gw.address not in homes
    finally:
        teardown_edge(nodes, gw)


def test_gateway_egress_backlog_throttles_reads(event_log):
    """Flow control one hop past the writer queues: a client that stops draining
    its replies gets its READS throttled (kernel TCP backpressure does
    the rest), accounted as fabric.backpressure{site=gateway}, and
    resumes once the egress queue drains."""
    nodes, gw = build_edge(
        1, overrides={"uigc.gateway.egress-queue-limit": 120}
    )
    try:
        sock = raw_connect(gw.client_port, tenant="t-slow")
        op, _ = _read_one_frame(sock, 10.0)
        assert op == protocol.OP_AUTH_OK
        # 100 PINGs, replies unread: the egress queue passes half its
        # bound (60) and the read path must throttle this connection.
        ping = protocol.encode_frame(protocol.OP_PING, None)
        sock.sendall(ping * 100)
        assert settle(lambda: gw.gateway.stats["throttle"] >= 1, 15.0)
        throttles = [
            f for f in event_log.of(events.BACKPRESSURE)
            if f.get("site") == "gateway" and f.get("action") == "throttle"
        ]
        assert throttles and throttles[0]["dst"] == "t-slow"
        # Drain the replies: every PONG arrives (throttling reads never
        # drops queued egress), then the reader resumes the connection.
        for _ in range(100):
            op, _ = _read_one_frame(sock, 15.0)
            assert op == protocol.OP_PONG
        assert settle(lambda: gw.gateway.stats["resume"] >= 1, 15.0)
        resumed = [
            f for f in event_log.of(events.BACKPRESSURE)
            if f.get("site") == "gateway" and f.get("action") == "resume"
        ]
        assert resumed
        sock.close()
    finally:
        teardown_edge(nodes, gw)


def test_gateway_slow_consumer_past_egress_bound_is_shed(event_log):
    nodes, gw = build_edge(
        1, overrides={"uigc.gateway.egress-queue-limit": 16}
    )
    try:
        sock = raw_connect(gw.client_port)
        op, _ = _read_one_frame(sock, 10.0)
        assert op == protocol.OP_AUTH_OK
        ping = protocol.encode_frame(protocol.OP_PING, None)
        # Far past the bound in one burst: enqueue fails, the gateway
        # closes the connection rather than buffer without limit.
        sock.sendall(ping * 200)
        assert settle(
            lambda: gw.gateway.stats["shed:slow-consumer"] >= 1, 15.0
        )
        sock.close()
    finally:
        teardown_edge(nodes, gw)


# ------------------------------------------------------------------- #
# Client-socket fault units
# ------------------------------------------------------------------- #


def test_client_fault_flood_and_slowloris(event_log):
    plan = FaultPlan(seed=11).client_fault(faults.FLOOD, count=2)
    nodes, gw = build_edge(1, gw_plan=plan)
    try:
        # The first two accepts are slammed shut before admission.
        for _ in range(2):
            sock = socket.create_connection(
                ("127.0.0.1", gw.client_port), timeout=5.0
            )
            sock.settimeout(5.0)
            assert expect_eof(sock)
            sock.close()
        assert gw.gateway.stats["shed:flood"] == 2
        # The budget is spent: the third connection admits normally.
        ok = raw_connect(gw.client_port)
        op, _ = _read_one_frame(ok, 10.0)
        assert op == protocol.OP_AUTH_OK
        ok.close()
    finally:
        teardown_edge(nodes, gw)

    # Slowloris: the CONNECT trickles in at ~1 byte per select round.
    # A selector reader must complete the handshake anyway, without a
    # worker thread held hostage.
    plan = FaultPlan(seed=12).client_fault(faults.SLOWLORIS)
    nodes, gw = build_edge(1, gw_plan=plan)
    try:
        sock = raw_connect(gw.client_port)
        op, _ = _read_one_frame(sock, 30.0)
        assert op == protocol.OP_AUTH_OK
        sock.close()
    finally:
        teardown_edge(nodes, gw)


def test_client_fault_half_open_and_truncate():
    plan = FaultPlan(seed=13).client_fault(faults.HALF_OPEN, count=1)
    nodes, gw = build_edge(1, gw_plan=plan)
    try:
        # The half-open victim's bytes vanish: no AUTH_OK ever comes,
        # but the gateway holds the session without crashing and keeps
        # serving everyone else.
        ghost = raw_connect(gw.client_port)
        ghost.settimeout(1.0)
        with pytest.raises(TimeoutError):
            _read_one_frame(ghost, 1.0)
        ok = raw_connect(gw.client_port)
        op, _ = _read_one_frame(ok, 10.0)
        assert op == protocol.OP_AUTH_OK
        ok.close()
        ghost.close()
    finally:
        teardown_edge(nodes, gw)

    plan = FaultPlan(seed=14).client_fault(faults.TRUNCATE, count=1)
    nodes, gw = build_edge(1, gw_plan=plan)
    try:
        # The truncated connection dies mid-frame; the gateway reaps it
        # and the next connection is unaffected.
        torn = raw_connect(gw.client_port)
        assert expect_eof(torn, 15.0)
        torn.close()
        ok = raw_connect(gw.client_port)
        op, _ = _read_one_frame(ok, 10.0)
        assert op == protocol.OP_AUTH_OK
        ok.close()
    finally:
        teardown_edge(nodes, gw)


# ------------------------------------------------------------------- #
# Chaos acceptance
# ------------------------------------------------------------------- #


def test_chaos_faulted_clients_and_node_death_lose_nothing(
    tmp_path, event_log
):
    """3 entity nodes + 1 gateway under client-socket faults and one
    abrupt entity-node death mid-run: every command an un-faulted
    client sent resolves to an ACK or a clean seq-addressed ERROR, and
    after rehoming no acked increment has vanished."""
    gw_plan = FaultPlan(seed=21).client_fault(faults.FLOOD, count=1)
    nodes, gw = build_edge(
        3,
        journal_dir=tmp_path,
        gw_plan=gw_plan,
        overrides={"uigc.gateway.tenant-msgs-per-sec": 0},
    )
    try:
        # The flood budget burns on the first accept so the real
        # clients below admit deterministically.
        burn = socket.create_connection(
            ("127.0.0.1", gw.client_port), timeout=5.0
        )
        assert expect_eof(burn)
        burn.close()
        assert gw.gateway.stats["shed:flood"] == 1

        keys = [f"c-{i}" for i in range(16)]
        clients = [
            BenchClient("127.0.0.1", gw.client_port, tenant=f"t{i}")
            for i in range(3)
        ]
        seq = 0
        stop = threading.Event()
        lock = threading.Lock()
        key_of = {}  # seq -> key, the senders' ledger

        def pump(client, offset):
            nonlocal seq
            i = offset
            while not stop.is_set():
                key = keys[i % len(keys)]
                with lock:
                    seq += 1
                    s = seq
                    key_of[s] = key
                try:
                    client.send_cmd(s, key, {"op": "inc"})
                except OSError:
                    return
                i += 1
                time.sleep(0.01)

        threads = [
            threading.Thread(target=pump, args=(c, i), daemon=True)
            for i, c in enumerate(clients)
        ]
        for t in threads:
            t.start()
        time.sleep(2.0)
        # One entity node dies abruptly mid-traffic.
        victim = nodes[2]
        victim.fabric.die()
        survivors = nodes[:2]
        assert settle(
            lambda: all(
                len(n.cluster.members()) == 2 for n in survivors
            ) and len(gw.cluster.members()) == 2,
            30.0,
        ), "survivors never converged after die()"
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join(timeout=5.0)

        # Drain with bounded retries: an abrupt death can orphan an
        # in-flight command (applied-but-unacked on the victim, or
        # dropped from a bounded re-route buffer).  A real client
        # retries through the front door; retries are at-least-once,
        # which the ledger check below tolerates (it is a >=).
        def unresolved(c):
            with c.lock:
                return [
                    s for s in c.sent_at
                    if s not in c.acked and s not in c.errors
                ]

        for _round in range(4):
            if settle(
                lambda: all(c.outstanding() == 0 for c in clients), 20.0
            ):
                break
            for c in clients:
                for s in unresolved(c):
                    try:
                        c.send_cmd(s, key_of[s], {"op": "inc"})
                    except OSError:
                        pass
        assert all(c.outstanding() == 0 for c in clients), [
            c.outstanding() for c in clients
        ]

        acked = sum(len(c.acked) for c in clients)
        errored = sum(len(c.errors) for c in clients)
        assert acked > 0
        assert acked + errored == sum(len(c.sent_at) for c in clients)

        # acked-then-lost must be zero: every ACK result is the
        # post-apply count, so each key's final count (probed through
        # the same front door, after rehoming) must cover the highest
        # result any client was acked for that key.
        max_acked = {}
        for c in clients:
            with c.lock:
                entries = list(c.acked.items())
            for s, (result, _lat) in entries:
                key = key_of.get(s)
                if (
                    key is not None
                    and isinstance(result, int)
                    and result > max_acked.get(key, 0)
                ):
                    max_acked[key] = result
        prober = clients[0]
        probe_base = 10_000_000
        for i, key in enumerate(keys):
            prober.send_cmd(probe_base + i, key, {"probe": True})
        assert settle(lambda: prober.outstanding() == 0, 30.0)
        finals = {
            key: prober.acked.get(probe_base + i, (None,))[0]
            for i, key in enumerate(keys)
        }
        lost = {
            key: (high, finals.get(key))
            for key, high in max_acked.items()
            if not isinstance(finals.get(key), int) or finals[key] < high
        }
        assert not lost, lost
        for c in clients:
            c.close()
    finally:
        teardown_edge(nodes, gw)


# ------------------------------------------------------------------- #
# Parity with the reference: client frames, admission, reply frames
# ------------------------------------------------------------------- #

def _client_value(rng, depth=0):
    """A random value of the client codec's closed type set."""
    kind = int(rng.integers(0, 9 if depth < 4 else 6))
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        return int(rng.integers(-(1 << 62), 1 << 62))
    if kind == 3:
        return float(rng.standard_normal() * 10.0 ** int(rng.integers(-5, 6)))
    if kind == 4:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x3000, size=rng.integers(0, 12)))
    if kind == 5:
        return rng.bytes(int(rng.integers(0, 16)))
    if kind in (6, 7):
        return [_client_value(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]
    return {f"k{int(k)}": _client_value(rng, depth + 1)
            for k in rng.integers(0, 50, size=rng.integers(0, 4))}


@pytest.mark.parametrize("seed", range(4))
def test_client_frames_equal_the_reference(seed):
    """Seeded client values: each package's encoding of a value, a frame
    and an error frame decodes in the other package to an equal value
    and re-encodes there to the same bytes."""
    rng = np.random.default_rng(seed)
    ops = sorted(protocol._KNOWN_OPS)
    assert ops == sorted(ref_protocol._KNOWN_OPS)
    for _ in range(200):
        value = _client_value(rng)
        mine = schema.encode_client_value(value)
        theirs = ref_schema.encode_client_value(value)
        assert mine == theirs
        assert ref_schema.decode_client_value(mine) == value
        assert schema.decode_client_value(theirs) == value
        assert schema.encode_client_value(ref_schema.decode_client_value(mine)) == mine

        op = ops[int(rng.integers(0, len(ops)))]
        frame = protocol.encode_frame(op, value)
        assert frame == ref_protocol.encode_frame(op, value)
        assert ref_protocol.decode_frame_body(frame[4:]) == (op, value)
        assert protocol.decode_frame_body(frame[4:]) == (op, value)

        code = int(rng.integers(1, 10))
        kw = {"retry_after_ms": int(rng.integers(0, 5000))}
        if rng.integers(0, 2):
            kw["seq"] = int(rng.integers(0, 1 << 40))
        err = protocol.encode_error(code, f"reason {code}", **kw)
        assert err == ref_protocol.encode_error(code, f"reason {code}", **kw)
        body = protocol.encode_frame_body(*err)
        assert body == ref_protocol.encode_frame_body(*err)
        assert ref_protocol.decode_frame_body(body) == err


def _hostile_corpus(rng, good):
    corpus = [b"", b"Z", good + b"\x00", b"f\x00", b"d\x01l\x00N",
              b"l\x01" * (schema.CLIENT_MAX_DEPTH + 2) + b"N"]
    for _ in range(150):
        how = int(rng.integers(0, 4))
        if how == 0:  # truncation
            corpus.append(good[: int(rng.integers(0, len(good)))])
        elif how == 1:  # one flipped byte
            pos = int(rng.integers(0, len(good)))
            flip = bytes([good[pos] ^ int(rng.integers(1, 256))])
            corpus.append(good[:pos] + flip + good[pos + 1:])
        elif how == 2:  # a tag followed by noise
            corpus.append(bytes([int(rng.choice(list(b"NTFifsbld")))]) + rng.bytes(int(rng.integers(0, 12))))
        else:  # pure noise
            corpus.append(rng.bytes(int(rng.integers(1, 24))))
    return corpus


def _outcome(fn, body):
    try:
        return ("ok", fn(body))
    except Exception as exc:  # the class is the verdict
        return ("raise", type(exc).__name__, type(exc).__mro__[1].__name__)


@pytest.mark.parametrize("seed", range(3))
def test_hostile_client_bytes_rejected_alike(seed):
    """A seeded hostile corpus gets the same verdict from both decoders:
    the same value, or the same exception class (``ClientDecodeError``
    for a value body, ``ProtocolError`` through the frame layer)."""
    rng = np.random.default_rng(100 + seed)
    good = schema.encode_client_value(
        {"seq": 7, "cmd": {"op": "inc", "args": [1, 2.5, "x" * 20, b"\x00"]}})
    raised = 0
    for body in _hostile_corpus(rng, good):
        mine = _outcome(schema.decode_client_value, body)
        theirs = _outcome(ref_schema.decode_client_value, body)
        assert mine == theirs, body
        raised += mine[0] == "raise"
        assert mine[0] == "ok" or mine[1] == "ClientDecodeError"
        op = bytes([int(rng.choice(sorted(protocol._KNOWN_OPS)))])
        mine = _outcome(protocol.decode_frame_body, op + body)
        theirs = _outcome(ref_protocol.decode_frame_body, op + body)
        assert mine == theirs, body
        assert mine[0] == "ok" or mine[1] == "ProtocolError"
    assert raised > 100


def test_websocket_handshake_equals_the_reference():
    """The accept key over seeded client keys, and a handshake plus a
    masked frame fed in seeded splits, give the same bytes and frames in
    both packages' TransportDecoders."""
    import base64

    rng = np.random.default_rng(7)
    for _ in range(50):
        key = base64.b64encode(rng.bytes(16)).decode()
        assert protocol.ws_accept_key(key) == ref_protocol.ws_accept_key(key)
    key = base64.b64encode(rng.bytes(16))
    request = (b"GET / HTTP/1.1\r\nHost: gw\r\nUpgrade: websocket\r\n"
               b"Connection: Upgrade\r\nSec-WebSocket-Key: " + key
               + b"\r\nSec-WebSocket-Version: 13\r\n\r\n")
    body = protocol.encode_frame_body(protocol.OP_SEND, {"seq": 3, "key": "k"})
    mask = rng.bytes(4)
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(body))
    stream = request + bytes([0x82, 0x80 | len(body)]) + mask + masked
    cuts = sorted(set(rng.integers(1, len(stream), size=12).tolist()))
    pieces = [stream[a:b] for a, b in zip([0] + cuts, cuts + [len(stream)])]
    results = []
    for mod in (protocol, ref_protocol):
        dec = mod.TransportDecoder(1 << 20)
        frames_all, out_all = [], b""
        for piece in pieces:
            frames, out, closed = dec.feed(piece)
            assert not closed
            frames_all += frames
            out_all += out
        results.append((frames_all, out_all, dec.encode(protocol.OP_ACK, {"seq": 3})))
    assert results[0] == results[1]
    assert results[0][0] == [(protocol.OP_SEND, {"seq": 3, "key": "k"})]


def test_admission_timeline_equals_the_reference():
    """One seeded timeline of connects, disconnects, message batches,
    latency and depth observations, with the clock passed in, through
    both packages' TokenAuth, TenantQuotas and OverloadController: the
    same verdict at every step.  The one deliberate difference (ROADMAP
    Queue 3 item 14) is applied to the reference's controller by hand:
    its latency window is emptied where it begins to shed, as the
    port's empties its own."""
    rng = np.random.default_rng(11)
    spec = "tok-a=alpha,tok-b=beta,tok-c="
    auth = (TokenAuth(spec), ref_admission.TokenAuth(spec))
    quotas = (TenantQuotas(3, 40), ref_admission.TenantQuotas(3, 40))
    ctl = (OverloadController(50.0, 64), ref_admission.OverloadController(50.0, 64))
    tenants = ["alpha", "beta", "public", "gamma"]
    now = 0.0
    flips = 0
    for step in range(3000):
        now += float(rng.exponential(0.01))
        event = int(rng.integers(0, 6))
        if event == 0:
            token = ["tok-a", "tok-b", "tok-c", "nope", None, 5][int(rng.integers(0, 6))]
            tenant = tenants[int(rng.integers(0, 4))]
            got = [a.authenticate(token, tenant) for a in auth]
        elif event == 1:
            tenant = tenants[int(rng.integers(0, 4))]
            got = [q.try_connect(tenant) for q in quotas]
        elif event == 2:
            tenant = tenants[int(rng.integers(0, 4))]
            for q in quotas:
                q.disconnect(tenant)
            got = [q.connections(tenant) for q in quotas]
        elif event == 3:
            tenant = tenants[int(rng.integers(0, 4))]
            count = int(rng.integers(0, 30))
            got = [q.admit_msgs(tenant, count, now) for q in quotas]
        elif event == 4:
            scale = 3.0 if (step // 500) % 2 else 40.0
            for ms in rng.gamma(2.0, scale, size=20).tolist():
                for c in ctl:
                    c.observe(ms)
            got = [c.admitted_p99_ms() for c in ctl]
        else:
            depth = int(rng.integers(0, 120 if (step // 700) % 2 else 30))
            for c in ctl:
                c.note_depth(depth)
            entered = ctl[1].shed_entered_total
            got = [(c.shedding(now), c.shed_entered_total) for c in ctl]
            if ctl[1].shed_entered_total > entered:
                ctl[1]._ring.clear()
            flips = max(flips, got[0][1])
        assert got[0] == got[1], f"step {step} event {event}"
    assert flips > 1  # the timeline crosses the band more than once


def test_overload_controller_leaves_shedding_once_admission_stops():
    """ROADMAP Queue 3 item 14.  A burst of admitted commands over the
    p99 band closes the door; from then on the gateway admits nothing,
    so no latency sample arrives.  The reference keeps judging the
    samples that closed the door and sheds for good; the port leaves
    after the dwell once the writer depth is under its exit band, and
    closes again only on fresh samples over the band."""
    rng = np.random.default_rng(14)
    burst = (300.0 + 200.0 * rng.random(64)).tolist()
    ref = ref_admission.OverloadController(250.0, 4096)
    port = OverloadController(250.0, 4096)
    for ctl in (ref, port):
        for ms in burst:
            ctl.observe(ms)
        ctl.note_depth(0)
        assert ctl.shedding(1.0) and ctl.shed_entered_total == 1
    # nothing is admitted while shedding: only the clock and the depth
    for t in np.arange(1.1, 30.0, 0.1):
        assert ref.shedding(float(t)), "the reference left shedding"
    assert not port.shedding(1.0 + port._DWELL_S)
    assert port.shed_entered_total == 1
    # fresh admitted samples decide again, both ways
    for ms in (10.0 + 5.0 * rng.random(32)).tolist():
        port.observe(ms)
    assert not port.shedding(2.0)
    for ms in burst:
        port.observe(ms)
    assert port.shedding(3.0) and port.shed_entered_total == 2
    assert not port.shedding(3.0 + port._DWELL_S)


def test_reply_frames_and_client_tokens_equal_the_reference(monkeypatch):
    """A live port edge (two data nodes, a proxy-only gateway): every
    ``"gwr"`` frame a data node sent and every entity frame the gateway
    sent (each carrying a ``gwclient`` token) decodes with the
    reference's ``wire`` and re-encodes there to the same bytes; the
    port decodes the reference's bytes back to its own ClientRef."""
    sent = []
    lock = threading.Lock()
    orig = NodeFabric.send_frame

    def recording_send(self, dst, frame):
        with lock:
            sent.append((self.address, dst, frame))
        return orig(self, dst, frame)

    monkeypatch.setattr(NodeFabric, "send_frame", recording_send)
    nodes, gw = build_edge(2)
    try:
        client = BenchClient("127.0.0.1", gw.client_port, tenant="t-par")
        keys = [f"k-{i}" for i in range(12)]
        for seq, key in enumerate(keys * 2, start=1):
            client.send_cmd(seq, key, {"op": "inc", "n": seq})
        assert settle(lambda: len(client.acked) == 24, 20.0)
        sub = raw_connect(gw.client_port, tenant="t-sub")
        assert _read_one_frame(sub, 10.0)[0] == protocol.OP_AUTH_OK
        sub.sendall(protocol.encode_frame(
            protocol.OP_SUBSCRIBE, {"type": "counter", "key": "k-0"}))
        time.sleep(0.3)
        client.send_cmd(100, "k-0", {"op": "inc"})
        op, value = _read_one_frame(sub, 10.0)
        assert (op, value) == (protocol.OP_PUSH, {"data": {"key": "k-0", "count": 3}})
        with lock:
            frames = list(sent)
        replies = [(src, f) for src, dst, f in frames
                   if dst == gw.address and f and f[0] == wire.GATEWAY_FRAME_KIND]
        commands = [f for src, dst, f in frames
                    if src == gw.address and f and f[0] == "ent"]
        assert len(replies) >= 25 and len(commands) >= 25
        for _src, frame in replies:
            assert ref_node._frame_bytes(("f", 7, frame)) == (
                port_node._frame_bytes(("f", 7, frame)))
            got = ref_wire.decode_gateway_reply(frame)
            assert got == wire.decode_gateway_reply(frame)
            conn_id, payload = got
            msg = ref_wire.decode_message(None, payload)
            assert msg == wire.decode_message(None, payload)
            assert ref_wire.encode_message(msg) == payload
        tokens = set()
        for frame in commands:
            decoded = ref_wire.decode_entity_frame(frame)
            assert decoded == wire.decode_entity_frame(frame)
            payload = decoded[3]
            theirs = ref_wire.decode_message(None, payload)
            mine = wire.decode_message(None, payload)
            assert type(theirs[1]) is ref_session.ClientRef
            assert type(mine[1]) is ClientRef
            assert type(mine[1]) is wire._client_ref_class()
            assert theirs[0] == mine[0] and theirs[2:] == mine[2:]
            assert (theirs[1].gateway_address, theirs[1].conn_id) == (
                mine[1].gateway_address, mine[1].conn_id)
            assert ref_wire.encode_message(theirs) == payload
            assert wire.encode_message(theirs) == payload
            tokens.add((mine[1].gateway_address, mine[1].conn_id))
        assert {a for a, _ in tokens} == {gw.address}
        assert len(tokens) == 2  # the client and the subscriber
        sub.close()
        client.close()
    finally:
        teardown_edge(nodes, gw)


class _GatedSock:
    """A socket whose ``recv`` waits for a gate: the peer stops reading,
    so the sender's kernel buffer fills and its writer queue backs up."""

    def __init__(self, sock, gate):
        self._sock = sock
        self._gate = gate

    def recv(self, n):
        self._gate.wait()
        return self._sock.recv(n)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def test_gateway_reads_throttle_under_a_blocked_peer(event_log):
    """A data node that stops reading its link: the gateway node's
    NodeFabric reports a nonzero writer depth (``writer_queue_depths``,
    the name the gateway probes), the gateway throttles its clients'
    reads past ``uigc.gateway.overload-queue-depth``, and resumes once
    the peer reads again; every queued reply still arrives."""
    band = 8
    nodes, gw = build_edge(
        1, overrides={"uigc.gateway.overload-queue-depth": band})
    gate = threading.Event()
    try:
        sock = raw_connect(gw.client_port, tenant="t-bp")
        assert _read_one_frame(sock, 10.0)[0] == protocol.OP_AUTH_OK
        assert settle(lambda: gw.gateway._writer_depth() == 0, 15.0)
        data = nodes[0]
        conn = data.fabric._conns[gw.address]
        conn.sock = _GatedSock(conn.sock, gate)
        blob = b"x" * (1 << 20)
        for _ in range(400):
            gw.fabric.send_frame(data.address, ("bp-fill", blob))
            if gw.fabric.writer_queue_depths().get(data.address, 0) > 4 * band:
                break
            time.sleep(0.005)
        depth = gw.gateway._writer_depth()
        assert depth > band, gw.fabric.writer_queue_depths()
        ping = protocol.encode_frame(protocol.OP_PING, None)
        sock.sendall(ping * 5)
        assert settle(lambda: gw.gateway.stats["throttle"] >= 1, 15.0)
        throttles = [
            f for f in event_log.of(events.BACKPRESSURE)
            if f.get("site") == "gateway" and f.get("action") == "throttle"
        ]
        assert throttles and throttles[0]["dst"] == "t-bp"
        assert throttles[0]["depth"] > band
        gate.set()
        assert settle(lambda: gw.gateway._writer_depth() == 0, 30.0)
        assert settle(lambda: gw.gateway.stats["resume"] >= 1, 15.0)
        sock.sendall(ping)
        for _ in range(6):
            assert _read_one_frame(sock, 15.0)[0] == protocol.OP_PONG
        sock.close()
    finally:
        gate.set()
        teardown_edge(nodes, gw)
