"""Copy of ``uigc_tpu/gateway/gateway.py``, over the port's
``runtime/{faults,wire}.py`` and ``utils/``.

The IngressGateway node: accept thread, selector reader loops, and
the backpressure hop from entity mailboxes out to client sockets.

One gateway terminates many thousands of client connections on a FIXED
number of threads: an accept thread plus ``uigc.gateway.reader-threads``
selector loops, each owning a share of the sockets (``conn_id`` modulo).
Thread-per-connection would cap the connection-scale bench at the
thread budget; a selector loop is indifferent to idle connections.

The routing hot path is propagation blocking one layer up: each read
round decodes EVERY complete frame a connection has buffered, admits
the batch through the quota/overload gates, bins the admitted commands
by destination home node, and flushes bin by bin — consecutive
``cluster.route()`` calls to one node ride the per-peer writer's fb
coalescing, so the cluster sees dense per-node bursts.

Flow control is the writer-queue backpressure plane (runtime/node.py)
extended one hop: when the fabric's writer queues back up past
``uigc.gateway.overload-queue-depth`` (or a connection's own egress
queue passes half its bound), the gateway stops
READING that client's socket — kernel TCP backpressure does the rest —
and accounts it as ``fabric.backpressure{site=gateway}``.  Admission
shedding (clean ERROR frames with retry-after) is the overload
controller's job; read throttling protects memory, shedding protects
latency.

A gateway is a full cluster member (heartbeats, membership, drain) that
owns no shards: it attaches ``ClusterSharding`` with ``proxy_only=True``
so peer tables resolve ``home_of`` while rendezvous assignment never
places a shard here.
"""

from __future__ import annotations

import itertools
import os
import selectors
import socket
import threading
import time
from collections import Counter, deque
from typing import Any, Dict, List, Optional, Tuple

from ..runtime import faults, wire
from ..utils import events
from ..utils.validation import require
from . import protocol
from .admission import OverloadController, TenantQuotas, TokenAuth
from .session import ClientRef, Session, bin_by_home


class IngressGateway:
    """The front door for one node.  Construct against an ActorSystem
    whose cluster was attached ``proxy_only=True``, then ``listen()``.
    """

    def __init__(self, system: Any):
        config = system.config
        self.system = system
        self.address = system.address
        self.cluster = getattr(system, "cluster", None)
        require(
            self.cluster is not None,
            "gateway.cluster",
            "IngressGateway needs ClusterSharding attached (proxy_only)",
        )
        self.fabric = system.fabric
        self.max_connections = config.get_int("uigc.gateway.max-connections")
        self.max_frame = config.get_int("uigc.gateway.max-frame-bytes")
        self.egress_limit = config.get_int("uigc.gateway.egress-queue-limit")
        self.reader_threads = max(
            1, config.get_int("uigc.gateway.reader-threads")
        )
        self.retry_after_ms = config.get_int("uigc.gateway.shed-retry-after-ms")
        self.auth = TokenAuth(config.get_string("uigc.gateway.auth-tokens"))
        self.quotas = TenantQuotas(
            config.get_int("uigc.gateway.tenant-max-connections"),
            config.get_int("uigc.gateway.tenant-msgs-per-sec"),
        )
        self.overload = OverloadController(
            config.get_float("uigc.gateway.overload-p99-ms"),
            config.get_int("uigc.gateway.overload-queue-depth"),
        )
        self._sessions: Dict[int, Session] = {}
        self._lock = threading.Lock()
        self._conn_seq = itertools.count(1)
        self._accept_seq = itertools.count(1)
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._readers: List[_Reader] = []
        self._draining = False
        self._closed = False
        #: verdict tallies for tests/benches, keyed by short names
        #: ("admitted", "shed:overload", "acked", ...)
        self.stats: Counter = Counter()
        self._wire_frames = self.fabric is not None and hasattr(
            self.fabric, "send_frame"
        )
        if self._wire_frames:
            self.fabric.register_frame_handler(
                wire.GATEWAY_FRAME_KIND, self._on_reply_frame
            )
        system.gateway = self

    # -- lifecycle --------------------------------------------------- #

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Open the client listener; returns the bound port."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1024)
        self._listener = srv
        for idx in range(self.reader_threads):
            reader = _Reader(self, idx)
            self._readers.append(reader)
            reader.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="gw-accept", daemon=True
        )
        self._accept_thread.start()
        return srv.getsockname()[1]

    def drain(self) -> None:
        """Rolling-restart drain: stop accepting, tell every connected
        client to go away cleanly (ERROR draining + retry-after), close
        once their egress flushes.  The cluster side needs nothing — a
        proxy-only member was born drained."""
        self._draining = True
        self._close_listener()
        op, body = protocol.encode_error(
            protocol.ERR_DRAINING,
            "gateway draining",
            retry_after_ms=self.retry_after_ms,
        )
        with self._lock:
            sessions = list(self._sessions.values())
        for session in sessions:
            self._shed(session, "draining", op, body, close=True)

    def _close_listener(self) -> None:
        listener, self._listener = self._listener, None
        if listener is None:
            return
        # shutdown() before close(): the accept thread blocks in
        # accept() holding a reference to the fd, so a bare close()
        # defers the real close until accept returns -- leaving the
        # port listening and admitting connects mid-drain.  Shutdown
        # kicks the accept thread out immediately.
        try:
            listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            listener.close()
        except OSError:  # pragma: no cover - already closed
            pass

    def close(self) -> None:
        self._closed = True
        self._draining = True
        self._close_listener()
        for reader in self._readers:
            reader.wake()
        for reader in self._readers:
            reader.join(timeout=2.0)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for session in sessions:
            try:
                session.sock.close()
            except OSError:  # pragma: no cover
                pass
        if self._wire_frames:
            self.fabric.register_frame_handler(wire.GATEWAY_FRAME_KIND, None)
        if getattr(self.system, "gateway", None) is self:
            self.system.gateway = None

    # -- telemetry taps ---------------------------------------------- #

    def connection_count(self) -> int:
        return len(self._sessions)

    def gauge_value(self, field: str) -> Optional[float]:
        """The ``install_system_gauges`` tap (telemetry/metrics.py)."""
        if field == "connections":
            return float(len(self._sessions))
        if field == "egress_depth":
            with self._lock:
                return float(
                    sum(s.egress_depth() for s in self._sessions.values())
                )
        return None

    # -- accept path ------------------------------------------------- #

    def _fault_plan(self):
        return getattr(self.fabric, "fault_plan", None)

    def _accept_loop(self) -> None:
        events.set_thread_origin(self.address or None)
        listener = self._listener
        while not self._closed and listener is not None:
            try:
                sock, _peer = listener.accept()
            except OSError:
                return  # listener closed: drain or shutdown
            if self._draining:
                # Raced the drain: the connect completed before the
                # listener went away.  No session, just hang up.
                try:
                    sock.close()
                except OSError:  # pragma: no cover
                    pass
                continue
            plan = self._fault_plan()
            if plan is not None and self.address is not None:
                if plan.client_accept(self.address, next(self._accept_seq)) == faults.DROP:
                    # Connect flood: slam the door before admission —
                    # no session, no fd held, one counter.
                    self._account_shed("flood")
                    try:
                        sock.close()
                    except OSError:  # pragma: no cover
                        pass
                    continue
            if len(self._sessions) >= self.max_connections:
                self._account_shed("conn-limit")
                try:
                    sock.close()
                except OSError:  # pragma: no cover
                    pass
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:  # pragma: no cover - platform-dependent
                pass
            conn_id = next(self._conn_seq)
            reader = self._readers[conn_id % len(self._readers)]
            session = Session(
                conn_id, sock, self.max_frame, self.egress_limit, reader.idx
            )
            with self._lock:
                self._sessions[conn_id] = session
            reader.adopt(session)

    # -- frame processing (reader threads) --------------------------- #

    def _process_frames(
        self,
        session: Session,
        frames: List[Tuple[int, Any]],
        reader: "_Reader",
    ) -> None:
        t0 = time.monotonic()
        sends: List[Tuple[int, str, str, Any]] = []
        for op, value in frames:
            if session.closing:
                return
            if not session.authenticated:
                self._admit_connection(session, op, value, reader)
                continue
            if op == protocol.OP_PING:
                self._reply(session, protocol.OP_PONG, None, reader)
            elif op == protocol.OP_PONG:
                pass
            elif op == protocol.OP_SEND:
                parsed = self._parse_send(value)
                if parsed is None:
                    self._shed_proto(session, value, reader)
                else:
                    sends.append(parsed)
            elif op == protocol.OP_SUBSCRIBE:
                if (
                    isinstance(value, dict)
                    and isinstance(value.get("type"), str)
                    and isinstance(value.get("key"), str)
                ):
                    self.cluster.route(
                        value["type"], value["key"], ("gw-sub", session.ref)
                    )
                else:
                    self._shed_proto(session, value, reader)
            else:
                self._shed_proto(session, value, reader)
        if sends and not session.closing:
            self._route_batch(session, sends, reader, t0)

    def _parse_send(self, value: Any) -> Optional[Tuple[int, str, str, Any]]:
        if not isinstance(value, dict):
            return None
        seq, type_name, key = value.get("seq"), value.get("type"), value.get("key")
        if (
            isinstance(seq, int)
            and isinstance(type_name, str)
            and isinstance(key, str)
        ):
            return (seq, type_name, key, value.get("cmd"))
        return None

    def _admit_connection(
        self, session: Session, op: int, value: Any, reader: "_Reader"
    ) -> None:
        """The CONNECT gauntlet — every rejection is a CLEAN structured
        ERROR frame (code + reason + retry hint), then close."""
        conn_value = value if isinstance(value, dict) else {}
        if op != protocol.OP_CONNECT:
            self._shed_proto(session, value, reader)
            return
        if self._draining:
            eop, ebody = protocol.encode_error(
                protocol.ERR_DRAINING,
                "gateway draining",
                retry_after_ms=self.retry_after_ms,
            )
            self._shed(session, "draining", eop, ebody, close=True)
            return
        if self.overload.shedding(time.monotonic()):
            eop, ebody = protocol.encode_error(
                protocol.ERR_OVERLOAD,
                "gateway overloaded",
                retry_after_ms=self.retry_after_ms,
            )
            self._shed(session, "overload", eop, ebody, close=True)
            return
        tenant = self.auth.authenticate(
            conn_value.get("token"), conn_value.get("tenant")
        )
        if tenant is None:
            eop, ebody = protocol.encode_error(protocol.ERR_AUTH, "bad token")
            self._shed(session, "auth", eop, ebody, close=True)
            return
        if not self.quotas.try_connect(tenant):
            eop, ebody = protocol.encode_error(
                protocol.ERR_CONN_LIMIT,
                f"tenant {tenant} connection quota",
                retry_after_ms=self.retry_after_ms,
            )
            self._shed(session, "conn-limit", eop, ebody, close=True)
            return
        session.tenant = tenant
        session.authenticated = True
        session.ref = ClientRef(self.address, session.conn_id, self.fabric)
        self._reply(
            session,
            protocol.OP_AUTH_OK,
            {"conn": session.conn_id, "proto": 1},
            reader,
        )
        self.stats["connections"] += 1
        if events.recorder.enabled:
            events.recorder.commit(
                events.GATEWAY_CONNECTION, action="open", tenant=tenant
            )

    def _route_batch(
        self,
        session: Session,
        sends: List[Tuple[int, str, str, Any]],
        reader: "_Reader",
        t0: float,
    ) -> None:
        now = time.monotonic()
        tenant = session.tenant or "public"
        if self.overload.shedding(now):
            for seq, _t, _k, _c in sends:
                op, body = protocol.encode_error(
                    protocol.ERR_OVERLOAD,
                    "gateway overloaded",
                    retry_after_ms=self.retry_after_ms,
                    seq=seq,
                )
                self._shed(session, "overload", op, body)
            return
        admitted_n = self.quotas.admit_msgs(tenant, len(sends), now)
        for seq, _t, _k, _c in sends[admitted_n:]:
            op, body = protocol.encode_error(
                protocol.ERR_MSG_RATE,
                f"tenant {tenant} msg rate",
                retry_after_ms=self.retry_after_ms,
                seq=seq,
            )
            self._shed(session, "msg-rate", op, body)
        admitted = sends[:admitted_n]
        if not admitted:
            return
        ref = session.ref
        bins = bin_by_home(
            self.cluster,
            [
                (type_name, key, ("gw-cmd", ref, seq, cmd))
                for seq, type_name, key, cmd in admitted
            ],
        )
        # Flush one home node at a time: consecutive route() calls to
        # the same destination coalesce in its writer's fb batches.
        for home in sorted(bins, key=str):
            for type_name, key, payload in bins[home]:
                self.cluster.route(type_name, key, payload)
        session.msgs_in += len(admitted)
        self.stats["admitted"] += len(admitted)
        if events.recorder.enabled:
            events.recorder.commit(
                events.GATEWAY_MSG, tenant=tenant, count=len(admitted)
            )
        self.overload.observe((time.monotonic() - t0) * 1000.0)
        self.overload.note_depth(self._writer_depth())

    # -- shedding / replies ------------------------------------------ #

    def _account_shed(self, reason: str, count: int = 1) -> None:
        self.stats["shed:" + reason] += count
        if events.recorder.enabled:
            events.recorder.commit(
                events.GATEWAY_SHED, reason=reason, count=count
            )

    def _shed(
        self,
        session: Session,
        reason: str,
        op: int,
        body: dict,
        close: bool = False,
    ) -> None:
        """Refuse work CLEANLY: account it, send the structured ERROR
        frame, optionally close once the error flushes."""
        self._account_shed(reason)
        self._reply(session, op, body, self._readers[session.reader_idx])
        if close:
            session.closing = True
            self._readers[session.reader_idx].notify(session.conn_id)

    def _shed_proto(self, session: Session, value: Any, reader: "_Reader") -> None:
        op, body = protocol.encode_error(
            protocol.ERR_PROTO, "protocol violation"
        )
        self._shed(session, "proto", op, body, close=True)

    def _reply(
        self, session: Session, op: int, value: Any, reader: "_Reader"
    ) -> None:
        try:
            data = session.encode(op, value)
        except TypeError:
            self._account_shed("encode")
            return
        if not session.enqueue(data):
            self._slow_consumer(session)
            return
        reader.notify(session.conn_id)

    def _slow_consumer(self, session: Session) -> None:
        """Egress bound hit: this client is not draining its replies.
        Close it — holding its queue open is exactly the unbounded
        memory growth the bound exists to prevent."""
        self._account_shed("slow-consumer")
        session.closing = True
        self._readers[session.reader_idx].notify(session.conn_id)

    # -- reply path (entity -> client) ------------------------------- #

    def _on_reply_frame(self, from_address: str, frame: tuple) -> None:
        decoded = wire.decode_gateway_reply(frame)
        if decoded is None:
            return
        conn_id, payload = decoded
        try:
            msg = wire.decode_message(self.fabric, payload)
        except Exception:
            # Peer bytes are trusted; a decode failure here is a
            # version skew bug, not an attack — account, never crash
            # the link's receive loop.
            self._account_shed("proto")
            return
        self.deliver_reply(conn_id, msg)

    def deliver_reply(self, conn_id: int, msg: Any) -> None:
        """Translate one entity reply into a client frame and enqueue
        it on the connection's bounded egress queue.  Message shapes:
        ``("ack", seq, result)`` -> ACK; ``("push", data)`` -> PUSH;
        anything else -> PUSH {data: repr-able value}."""
        session = self._sessions.get(conn_id)
        if session is None or session.closing:
            self._account_shed("gone")
            return
        if (
            isinstance(msg, tuple)
            and len(msg) >= 3
            and msg[0] == "ack"
            and isinstance(msg[1], int)
        ):
            op, body = protocol.OP_ACK, {"seq": msg[1], "result": msg[2]}
        elif isinstance(msg, tuple) and len(msg) >= 2 and msg[0] == "push":
            op, body = protocol.OP_PUSH, {"data": msg[1]}
        else:
            op, body = protocol.OP_PUSH, {"data": msg}
        try:
            data = session.encode(op, body)
        except TypeError:
            # The entity replied with a non-client-encodable object.
            # An ACK must still reach the client (acked-then-lost is
            # the one hard-zero invariant), so degrade the result to
            # its repr rather than dropping the frame.
            if op == protocol.OP_ACK:
                body = {"seq": body["seq"], "result": repr(body["result"])}
            else:
                body = {"data": repr(body.get("data"))}
            data = session.encode(op, body)
        if not session.enqueue(data):
            self._slow_consumer(session)
            return
        session.replies_out += 1
        if op == protocol.OP_ACK:
            self.stats["acked"] += 1
        self._readers[session.reader_idx].notify(session.conn_id)

    # -- backpressure ------------------------------------------------ #

    def _writer_depth(self) -> int:
        depths_fn = getattr(self.fabric, "writer_queue_depths", None)
        if depths_fn is None:
            return 0
        try:
            depths = depths_fn()
        except Exception:  # pragma: no cover - fabric closing
            return 0
        return max(depths.values()) if depths else 0

    def _should_throttle(self, session: Session, writer_depth: int) -> bool:
        if session.egress_limit and session.egress_depth() > session.egress_limit // 2:
            return True
        band = self.overload.depth_band
        return bool(band) and writer_depth > band

    def _may_resume(self, session: Session, writer_depth: int) -> bool:
        egress_ok = (
            not session.egress_limit
            or session.egress_depth() <= session.egress_limit // 4
        )
        band = self.overload.depth_band
        depth_ok = not band or writer_depth < band // 2
        return egress_ok and depth_ok

    def _account_throttle(self, session: Session, action: str, depth: int) -> None:
        self.stats["throttle" if action == "throttle" else "resume"] += 1
        if events.recorder.enabled:
            events.recorder.commit(
                events.BACKPRESSURE,
                site="gateway",
                action=action,
                depth=depth,
                dst=session.tenant or "?",
                count=1,
            )

    # -- session teardown -------------------------------------------- #

    def _closed_session(self, session: Session) -> None:
        """Bookkeeping after a reader dropped a connection."""
        with self._lock:
            live = self._sessions.pop(session.conn_id, None)
        if live is None:
            return
        if session.tenant is not None:
            self.quotas.disconnect(session.tenant)
        if events.recorder.enabled:
            events.recorder.commit(
                events.GATEWAY_CONNECTION,
                action="close",
                tenant=session.tenant or "?",
            )


class _Reader(threading.Thread):
    """One selector loop owning ``conn_id % readers == idx`` sockets.

    Cross-thread work (new sockets from the accept thread, egress
    notifications from link receive threads) arrives on lock-free
    deques plus a self-pipe wakeup, and is adopted at the top of each
    loop round — the selector thread is the only one that touches the
    selector or a session's socket."""

    _SELECT_S = 0.05

    def __init__(self, gateway: IngressGateway, idx: int):
        super().__init__(name=f"gw-reader-{idx}", daemon=True)
        self.gw = gateway
        self.idx = idx
        self.sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self.sel.register(self._wake_r, selectors.EVENT_READ, data=None)
        self._pending: deque = deque()  # unbounded: accept-thread handoff, drained every round
        self._notify: deque = deque()  # unbounded: drained every round
        self._woken = False
        #: conn_id -> registered interest mask (0 = not registered)
        self._mask: Dict[int, int] = {}
        #: sessions parked by read throttling (mask may still hold WRITE)
        self._throttled: Dict[int, Session] = {}
        #: sessions with fault-stashed inbound bytes (slowloris): the
        #: kernel buffer is already drained, so the selector will never
        #: fire for them again -- _tick re-drives the trickle.
        self._stashed: Dict[int, Session] = {}

    # -- cross-thread API -------------------------------------------- #

    def adopt(self, session: Session) -> None:
        self._pending.append(session)
        self.wake()

    def notify(self, conn_id: int) -> None:
        self._notify.append(conn_id)
        self.wake()

    def wake(self) -> None:
        if self._woken:
            return
        self._woken = True
        try:
            os.write(self._wake_w, b"\x00")
        except OSError:  # pragma: no cover - closing
            pass

    # -- selector-thread internals ----------------------------------- #

    def _set_interest(self, session: Session) -> None:
        want = 0
        if not session.throttled and not session.closing:
            want |= selectors.EVENT_READ
        if session.outbuf or session.egress:
            want |= selectors.EVENT_WRITE
        have = self._mask.get(session.conn_id, 0)
        if want == have:
            return
        try:
            if have == 0:
                self.sel.register(session.sock, want, data=session)
            elif want == 0:
                self.sel.unregister(session.sock)
            else:
                self.sel.modify(session.sock, want, data=session)
        except (KeyError, ValueError, OSError):  # pragma: no cover
            want = 0
        self._mask[session.conn_id] = want

    def _drop(self, session: Session) -> None:
        if self._mask.pop(session.conn_id, 0):
            try:
                self.sel.unregister(session.sock)
            except (KeyError, ValueError, OSError):  # pragma: no cover
                pass
        self._throttled.pop(session.conn_id, None)
        self._stashed.pop(session.conn_id, None)
        try:
            session.sock.close()
        except OSError:  # pragma: no cover
            pass
        session.closing = True
        self.gw._closed_session(session)

    def run(self) -> None:
        events.set_thread_origin(self.gw.address or None)
        gw = self.gw
        while not gw._closed:
            ready = self.sel.select(timeout=self._SELECT_S)
            self._woken = False
            try:
                os.read(self._wake_r, 4096)
            except (BlockingIOError, OSError):
                pass
            while self._pending:
                session = self._pending.popleft()
                self._set_interest(session)
            notified = set()
            while self._notify:
                notified.add(self._notify.popleft())
            for conn_id in notified:
                session = gw._sessions.get(conn_id)
                if session is None:
                    continue
                if session.closing and not session.egress and not session.outbuf:
                    self._drop(session)
                else:
                    self._set_interest(session)
            for key, mask in ready:
                if key.data is None:
                    continue
                session: Session = key.data
                if mask & selectors.EVENT_WRITE:
                    self._flush(session)
                if mask & selectors.EVENT_READ and not session.closing:
                    self._read(session)
            self._tick()
        # shutdown: release the selector and pipe
        try:
            self.sel.close()
            os.close(self._wake_r)
            os.close(self._wake_w)
        except OSError:  # pragma: no cover
            pass

    def _tick(self) -> None:
        """Periodic (every select round): throttle/resume decisions and
        closing-session reaping for this reader's share."""
        gw = self.gw
        depth = gw._writer_depth()
        gw.overload.note_depth(depth)
        if self._stashed:
            for conn_id, session in list(self._stashed.items()):
                if session.closing:
                    del self._stashed[conn_id]
                elif not session.throttled:
                    self._read(session)
        if self._throttled:
            for conn_id, session in list(self._throttled.items()):
                if session.closing or gw._may_resume(session, depth):
                    del self._throttled[conn_id]
                    if not session.closing:
                        session.throttled = False
                        gw._account_throttle(session, "resume", depth)
                    self._set_interest(session)

    def _throttle(self, session: Session, depth: int) -> None:
        if session.throttled or session.closing:
            return
        session.throttled = True
        self._throttled[session.conn_id] = session
        self.gw._account_throttle(session, "throttle", depth)
        self._set_interest(session)

    def _read(self, session: Session) -> None:
        gw = self.gw
        plan = gw._fault_plan()
        verdict = faults.DELIVER
        if plan is not None and gw.address is not None:
            verdict = plan.client_inbound(gw.address, session.conn_id)
        eof = False
        try:
            data = session.sock.recv(65536)
            if not data:
                eof = True
        except (BlockingIOError, InterruptedError):
            data = b""
        except OSError:
            self._drop(session)
            return
        if eof and not session.instash:
            self._drop(session)
            return
        if verdict == faults.HALF_OPEN:
            # Bytes vanish; the socket never EOFs.  The connection sits
            # until idle accounting (or drain/close) reclaims it.
            return
        if verdict == faults.TRUNCATE:
            data = data[: len(data) // 2]
            session.closing = True
        if verdict == faults.SLOWLORIS:
            session.instash += data
            data, session.instash = (
                session.instash[:1],
                session.instash[1:],
            )
            if session.instash and not session.closing:
                self._stashed[session.conn_id] = session
            else:
                self._stashed.pop(session.conn_id, None)
        if not data and not eof:
            if session.closing:
                self.notify(session.conn_id)
            return
        try:
            frames, out, closed = session.decoder.feed(data)
        except protocol.ProtocolError:
            gw._shed_proto(session, None, self)
            self._set_interest(session)
            return
        if out:
            session.outbuf += out
        if frames:
            gw._process_frames(session, frames, self)
        if closed or (eof and not session.instash):
            session.closing = True
        depth = gw._writer_depth()
        if gw._should_throttle(session, depth):
            self._throttle(session, depth)
        self._set_interest(session)
        if session.closing:
            self.notify(session.conn_id)

    def _flush(self, session: Session) -> None:
        try:
            while session.outbuf or session.egress:
                if not session.outbuf:
                    session.outbuf = session.egress.popleft()
                sent = session.sock.send(session.outbuf)
                if sent == 0:  # pragma: no cover - kernel said no
                    break
                session.outbuf = session.outbuf[sent:]
                if session.outbuf:
                    break  # short write: wait for the next EVENT_WRITE
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._drop(session)
            return
        if session.closing and not session.outbuf and not session.egress:
            self._drop(session)
            return
        self._set_interest(session)
