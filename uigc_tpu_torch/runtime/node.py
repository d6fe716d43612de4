"""Copy of ``uigc_tpu/runtime/node.py`` (pure Python).  What differs:

- **A routed delta keeps its wave stamp on the wire.**  The partitioned
  collector sends each routed delta as a ``DDelta(seqnum, graph, fence,
  cut)`` (``engines/crgc/distributed.py``), and the receiver folds it into
  the running wave when its cut is below it.  The reference's
  ``control_send`` turns every ``DeltaMsg`` into ``("delta", seqnum,
  graph)`` and its ``_on_frame`` rebuilds a plain ``DeltaMsg``
  (``uigc_tpu/runtime/node.py:2187-2188``, ``:2423-2432``), so across
  processes every routed delta would arrive unstamped and wait out the
  running wave.  Here a ``DDelta`` crosses as ``("delta", seqnum, graph,
  fence, cut, index)``: the stamp rides as optional trailing fields,
  which a peer that reads only ``frame[1:3]`` ignores (it gets the
  reference's plain delta), and ``_on_frame`` rebuilds a ``DDelta`` when
  all three are present and well-formed.  A plain ``DeltaMsg`` keeps the
  reference's three-element frame, byte for byte.
- The lazy imports resolve to the port's modules; ``drain()`` reaches
  the cluster (``cluster/sharding.py``) through ``getattr(system,
  "cluster", None)``, as in the reference.

Cross-process node transport: one ActorSystem per OS process, linked
over TCP sockets.

The in-process ``Fabric`` (fabric.py) models the reference's cluster as
thread groups sharing one interpreter; this module is the real process
boundary — the analogue of the reference's Artery-over-TCP remoting
(reference: reference.conf:2-10 registers the remoting stages;
LocalGC.scala:201 gossips collector state across the network).  Each
process hosts exactly one system plus a ``NodeFabric``; peers are reached
through length-prefixed frames on one TCP connection per node pair, and
every cross-boundary object is re-materialized from wire tokens — object
identity cannot survive, because there is no shared heap to leak it
through.

What maps where:

- app messages:   egress stamp -> wire bytes -> TCP -> ingress tally ->
                  local mailbox (per-link FIFO = TCP order)
- window markers: ``finalize_egress`` sends the marker id in-stream; the
                  receiving ingress closes the matching window
                  (reference: Gateways.scala:83-94,168-171)
- collector gossip: delta graphs and ingress-entry rebroadcasts cross in
                  their own wire formats (DeltaGraph.java:189-232,
                  IngressEntry.java:103-144)
- membership:     two failure signals feed the same verdict.  EOF (e.g.
                  ``kill -9`` tears the socket) marks the member removed
                  after everything the dead node sent was delivered in
                  order; a phi-accrual heartbeat monitor
                  (runtime/heartbeat.py, ``uigc.node.heartbeat-interval``)
                  additionally detects *silent* death — a wedged peer or
                  a partition produces no EOF — and drives the identical
                  ``MemberRemoved`` -> ``finalize_dead_link`` recovery.
                  With ``uigc.node.reconnect-retries`` > 0 a torn socket
                  is first re-dialed with exponential backoff; per-link
                  frame sequence numbers let the receiving side discard
                  duplicates and *detect* gaps across the reconnect
                  instead of silently double-tallying ingress windows.
- fault injection: a seeded ``FaultPlan`` (runtime/faults.py) is
                  consulted on every frame edge — drop / duplicate /
                  reorder / delay / truncate / partition / crash-at-frame
                  — so node death is a deterministic, testable input
                  rather than an untested EOF edge case.
- dead letters:   a frame whose target uid no longer resolves still
                  tallies on the ingress (keyed by the cached proxy for
                  that uid) and releases the refs the decoded message
                  carries, mirroring ``CRGC.on_dead_letter`` — the
                  sender's egress already stamped the send, so dropping
                  it silently would leave the link's recv balance
                  permanently nonzero and leak every carried ref.
- remote cells:   ``ProxyCell`` stands in for a cell of another process:
                  same (address, uid) token the wire codec uses, cached
                  per fabric so one remote actor folds to one shadow slot
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
import traceback
from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

from ..utils import events
from ..utils.validation import InvariantViolation
from . import faults, shm_ring, wire
from . import schema as wire_schema
from .dispatcher import DecodeLane, free_threading_active

#: the bare value-plane schema id (runtime/schema.py SCHEMA_VAL) — the
#: writer's fast drain branches on it to skip provably-no-op egress
#: stamps for plain-value messages.
_SCHEMA_VAL_ID = 1

if TYPE_CHECKING:  # pragma: no cover
    from .cell import ActorCell
    from .system import ActorSystem

from .fabric import MemberRemoved, MemberUp


class DuplicateNameError(InvariantViolation):
    """A well-known name was registered twice for different cells.  The
    old behavior silently overwrote the first registration, so peers
    that looked the name up before and after the overwrite resolved two
    different actors under one name — a split-brain address."""


class NameLookupError(InvariantViolation, KeyError):
    """A well-known name could not be resolved from a peer's hello.
    Subclasses ``KeyError`` so existing wait-for-hello retry loops keep
    working; carries the structured (address, name) evidence and is
    preceded by a ``fabric.lookup_miss`` event."""


class ProxySystem:
    """Address-only stand-in for a remote process's system (enough for
    `target.system is not self.system` routing and address reads)."""

    __slots__ = ("address",)

    def __init__(self, address: str):
        self.address = address


class ProxyCell:
    """Local handle for a cell living in another process.  Hash/eq by
    (address, uid) so re-decoded handles fold to the same shadow slot;
    the fabric additionally caches instances for identity stability."""

    __slots__ = ("system", "uid", "path", "_fabric")

    def __init__(self, fabric: "NodeFabric", address: str, uid: int, path: str = ""):
        self.system = ProxySystem(address)
        self.uid = uid
        self.path = path or f"remote://{address}/{uid}"
        self._fabric = fabric

    def tell(self, msg: Any) -> None:
        self._fabric.deliver(self._fabric.system, self, msg)

    def __hash__(self) -> int:
        return hash((self.system.address, self.uid))

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, ProxyCell)
            and other.uid == self.uid
            and other.system.address == self.system.address
        )

    def __repr__(self) -> str:
        return f"ProxyCell({self.system.address}, uid={self.uid})"


class _StubEngine:
    __slots__ = ("bookkeeper_cell",)

    def __init__(self, bookkeeper_cell: ProxyCell):
        self.bookkeeper_cell = bookkeeper_cell


class RemoteSystemStub:
    """What ``fabric.systems[peer]`` yields for a connected peer: just
    enough surface for the collector's membership path
    (``peer_system.engine.bookkeeper_cell``, ``fabric.link(...)``)."""

    __slots__ = ("address", "engine")

    def __init__(self, address: str, bookkeeper_cell: ProxyCell):
        self.address = address
        self.engine = _StubEngine(bookkeeper_cell)


class _HalfLink:
    """One direction of a node pair as seen from this process: the
    outbound half owns the egress, the inbound half owns the ingress
    (the other half lives in the peer process)."""

    __slots__ = ("src", "dst", "egress", "ingress", "send_lock", "recv_lock", "drop_filter")

    def __init__(self, src, dst):
        self.src = src
        self.dst = dst
        self.egress = None
        self.ingress = None
        self.send_lock = threading.Lock()
        self.recv_lock = threading.Lock()
        self.drop_filter: Optional[Callable[[Any], bool]] = None


class _PeerState:
    """Per-peer transport state that must survive reconnects: sequence
    counters (a fresh socket continues the old stream's numbering, which
    is what lets the receiver discard retransmitted duplicates and
    *detect* lost frames as gaps), fault-injection hold queues, the
    outbound writer queue, and the dial info used to re-establish a torn
    link."""

    __slots__ = (
        "lock",
        "rlock",
        "seq_out",
        "seq_in",
        "gaps",
        "dups",
        "held",
        "stall",
        "stall_q",
        "dial",
        "reconnecting",
        "pending_break",
        "nonce",
        "retired",
        "outq",
        "out_ev",
        "out_cv",
        "writer",
        "caps",
        "schema_ids",
        "schema_table",
        "decode_lane",
        "shm_started",
        "shm_tx",
        "shm_rx",
        "shm_tx_on",
        "shm_rx_on",
        "shm_rx_lock",
        "shm_rx_ev",
        "shm_reader",
        "shm_peer_pid",
    )

    def __init__(self) -> None:
        #: serializes seq assignment + outbound-queue admission (sender
        #: side).  Socket writes happen on the peer's writer thread,
        #: OFF this lock — a sender never blocks on socket I/O.
        self.lock = threading.Lock()
        #: serializes seq acceptance (receiver side; separate from the
        #: send lock so socket backpressure on the outbound half can
        #: never deadlock against frame intake on the inbound half)
        self.rlock = threading.Lock()
        self.seq_out = 0
        self.seq_in = 0
        self.gaps = 0
        self.dups = 0
        self.held: Optional[tuple] = None  # (seq, frame, truncate) reorder hold
        self.stall = 0  # frames still to absorb into the stall queue
        self.stall_q: list = []  # unbounded: holds at most the DELAY rule's `frames` budget
        self.dial: Optional[Tuple[str, int]] = None
        self.reconnecting = False
        #: a conn that broke WHILE a reconnect was in flight; replayed
        #: once the reconnect loop finishes so a failure of the
        #: replacement link is never silently swallowed
        self.pending_break: Optional["_Conn"] = None
        #: the peer incarnation this stream state belongs to
        self.nonce: Optional[int] = None
        #: superseded by a rejoining NEW incarnation of the address: the
        #: old writer must exit even though the address is live again
        self.retired = False
        #: bounded outbound job queue drained by the writer thread.
        #: CPython deque appends are atomic, so senders enqueue
        #: LOCK-FREE; the writer (single consumer) assigns sequence
        #: numbers, stamps egress windows and runs fault verdicts in
        #: pop order, which IS the stream order.
        self.outq: deque = deque()  # unbounded: capped by the writer high-water admission in _enqueue_job
        #: writer wake-up: set by senders on the empty->nonempty
        #: transition (Event.set is thread-safe and needs no lock),
        #: cleared by the writer before it sleeps
        self.out_ev = threading.Event()
        #: space-available signal for backpressured senders (rare path;
        #: the only remaining use of ``lock`` on the send side)
        self.out_cv = threading.Condition(self.lock)
        self.writer: Optional[threading.Thread] = None
        #: transport capabilities the peer's hello advertised ("fb" =
        #: understands multi-frame batch units)
        self.caps: frozenset = frozenset()
        #: schema ids negotiated with this peer (runtime/schema.py);
        #: empty = pickle-only link
        self.schema_ids: frozenset = frozenset()
        #: exact-type -> Schema dispatch for those ids (one dict hit
        #: per message on the writer's encode loop)
        self.schema_table: dict = {}
        #: per-peer decode worker (uigc.node.decode-workers); None =
        #: decode inline on the link's receive thread
        self.decode_lane: Optional[DecodeLane] = None
        #: --- co-located shm transport (runtime/shm_ring.py) ---
        #: negotiation attempted (one shot per peer)
        self.shm_started = False
        #: our producing ring (this node -> peer); writes by the
        #: writer thread only, and only once shm_tx_on flipped
        self.shm_tx: Optional[shm_ring.ShmRing] = None
        #: our consuming ring (peer -> this node); reads serialized by
        #: shm_rx_lock (ring reader thread, or the recovery drain)
        self.shm_rx: Optional[shm_ring.ShmRing] = None
        #: writer-thread-owned transport flip: True = flush via ring.
        #: Set by the writer when it processes the in-stream "g" job
        #: (so the flip point IS a stream position); cleared by the
        #: writer on fallback.
        self.shm_tx_on = False
        #: consumer-side gate: the ring reader delivers nothing until
        #: the peer's in-stream "shmgo" marker arrived on the socket —
        #: the barrier that makes ring and socket frames unmixable.
        self.shm_rx_on = False
        self.shm_rx_lock = threading.Lock()
        self.shm_rx_ev = threading.Event()
        self.shm_reader: Optional[threading.Thread] = None
        #: the peer process id (ring liveness probe)
        self.shm_peer_pid = 0


class _Corrupt:
    """Sentinel for a frame whose body failed to decode (truncated by
    fault injection, or garbage on the wire)."""

    __slots__ = ()


_CORRUPT = _Corrupt()


def _frame_bytes(frame: tuple, truncate: bool = False) -> bytes:
    """The one length-prefixed framing implementation.  ``truncate``
    (fault injection) cuts the body but keeps the prefix consistent, so
    the stream survives and only this frame fails to decode."""
    body = pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL)
    if truncate:
        body = body[: max(8, len(body) // 2)]
    return struct.pack(">I", len(body)) + body


class _Conn:
    __slots__ = ("sock", "lock", "address")

    def __init__(self, sock: socket.socket, address: str = ""):
        self.sock = sock
        self.lock = threading.Lock()
        self.address = address

    def send(self, frame: tuple) -> None:
        self.send_bytes(_frame_bytes(frame))

    def send_bytes(self, buf: bytes) -> None:
        with self.lock:
            self.sock.sendall(buf)

    def recv(self):
        header = self._read_exact(4)
        if header is None:
            return None
        (n,) = struct.unpack(">I", header)
        body = self._read_exact(n)
        if body is None:
            return None
        if body[:4] == wire.FB_MAGIC:
            # Multi-frame batch unit (only ever sent to peers that
            # advertised the "fb" capability, i.e. this code).  Per-block
            # corruption surfaces as (seq, None) entries, never as a
            # stream error.
            return ("fb", wire.decode_batch(body))
        try:
            return pickle.loads(body)
        except Exception:
            # The framing is intact (we read exactly n bytes), only the
            # body is damaged — drop the frame, keep the stream.
            return _CORRUPT

    def _read_exact(self, n: int) -> Optional[bytes]:
        chunks = []
        while n:
            try:
                chunk = self.sock.recv(n)
            except OSError:
                return None
            if not chunk:
                return None
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class NodeFabric:
    """Fabric implementation for one process of a multi-process cluster.

    Create it, build the ActorSystem against it, optionally
    ``register_name`` well-known cells, then ``listen()`` and
    ``connect()`` to peers.  Serialization is not optional here — there
    is no object path across a process boundary."""

    serialize = True  # read by engines that branch on the fabric mode

    def __init__(self, address: str = "", fault_plan: Optional[faults.FaultPlan] = None):
        #: canonical cluster address — MUST equal the hosted system's
        #: address (undo-log quorums compare ingress-entry addresses
        #: against membership addresses; one namespace, or quorums never
        #: match).  Normally left empty and adopted at register_system.
        self.address = address
        self.system: Optional["ActorSystem"] = None
        self.systems: Dict[str, Any] = {}
        self.crashed: set = set()
        self.fault_plan = fault_plan
        self._subscribers: List["ActorCell"] = []
        self._lock = threading.Lock()
        self._names: Dict[str, Any] = {}
        self._peer_names: Dict[str, Dict[str, int]] = {}
        self._conns: Dict[str, _Conn] = {}
        self._proxies: Dict[Tuple[str, int], ProxyCell] = {}
        #: subsystem frame dispatch (kind -> fn(from_address, frame)):
        #: how layers above the transport (cluster sharding) receive
        #: their own frame kinds without the transport knowing them.
        #: Unregistered kinds are ignored after seq accounting — the
        #: version-tolerance contract old peers rely on.
        self._frame_handlers: Dict[str, Callable[[str, tuple], None]] = {}
        self._out: Dict[str, _HalfLink] = {}
        self._in: Dict[str, _HalfLink] = {}
        self._peers: Dict[str, _PeerState] = {}
        self._listener: Optional[socket.socket] = None
        self._closing = False
        self._hb = None  # HeartbeatMonitor when enabled by config
        self._reconnect_retries = 0
        self._reconnect_backoff_s = 0.05
        #: advertise + use multi-frame batch units ("fb" capability).
        #: Off, this node sends classic singleton units (still through
        #: the writer thread, one flush per frame) and its hello stays
        #: at the legacy 5-element shape.
        self._batching = True
        #: writer-queue high-water mark (frames); senders to one peer
        #: block briefly once its queue is this deep (backpressure)
        self._writer_high_water = 8192
        #: max frames coalesced into one batch flush
        self._max_batch_frames = 256
        #: advertise + use the schema-native wire codec ("sc..." cap)
        self._schema_codec = True
        #: negotiate shm rings with co-located peers ("shm" cap)
        self._shm_enabled = False
        self._shm_ring_bytes = 1 << 20
        #: inbound decode placement: "off" | "on" | "auto"
        self._decode_mode = "auto"
        #: re-admit a SAME-incarnation peer that reconnects after its
        #: MemberRemoved verdict (a healed partition).  The rejoin gets
        #: a completely fresh stream — old transport state retires
        #: wholesale, exactly like the rolling-restart rejoin — and the
        #: cluster/collector layers run their own reconciliation
        #: (uigc_tpu/cluster/membership.py).  Off = the legacy refusal.
        self._heal_rejoin = True
        #: this process-incarnation's identity, exchanged in the hello:
        #: a reconnect that reaches a RESTARTED peer (same address, new
        #: process) must not resume the old frame stream — its sequence
        #: numbers restart and every frame would be discarded as a
        #: duplicate.  A nonce mismatch on reinstall means the old
        #: incarnation died.
        self._nonce = int.from_bytes(os.urandom(8), "big")

    # ------------------------------------------------------------- #
    # System + name registry
    # ------------------------------------------------------------- #

    def register_system(self, system: "ActorSystem") -> None:
        assert self.system is None, "one system per NodeFabric (one per process)"
        assert not self.address or self.address == system.address, (
            f"fabric address {self.address!r} != system address "
            f"{system.address!r} — quorum bookkeeping needs one namespace"
        )
        self.system = system
        self.address = system.address
        self.systems[system.address] = system
        config = system.config
        self._reconnect_retries = config.get_int("uigc.node.reconnect-retries")
        self._reconnect_backoff_s = (
            config.get_int("uigc.node.reconnect-backoff") / 1000.0
        )
        self._batching = config.get_bool("uigc.node.frame-batching")
        self._writer_high_water = config.get_int("uigc.node.writer-queue-limit")
        self._max_batch_frames = config.get_int("uigc.node.max-batch-frames")
        self._schema_codec = config.get_bool("uigc.node.schema-codec")
        self._shm_enabled = config.get_bool("uigc.node.shm-transport")
        self._shm_ring_bytes = config.get_int("uigc.node.shm-ring-bytes")
        self._decode_mode = config.get_string("uigc.node.decode-workers")
        self._heal_rejoin = config.get_bool("uigc.node.heal-rejoin")
        hb_ms = config.get_int("uigc.node.heartbeat-interval")
        if hb_ms > 0:
            from .heartbeat import HeartbeatMonitor

            self._hb = HeartbeatMonitor(
                hb_ms / 1000.0,
                peers=self._live_peers,
                ping=lambda address: self._send_frame(address, ("hb",)),
                on_down=self._on_phi_down,
                threshold=config.get_float("uigc.node.phi-threshold"),
                acceptable_pause_s=config.get_int("uigc.node.heartbeat-pause")
                / 1000.0,
                origin=self.address,
            )
            self._hb.start()

    def unregister_system(self, system: "ActorSystem") -> None:
        self.close()

    def set_fault_plan(self, plan: Optional[faults.FaultPlan]) -> None:
        """Attach (or clear) the fault-injection policy consulted on
        every frame edge of this node."""
        self.fault_plan = plan

    def register_name(self, name: str, cell: Any) -> None:
        """Advertise a well-known local cell (exchanged in the hello
        frame, the analogue of an actor selection path).  Registering a
        DIFFERENT cell under an existing name raises — a silent
        overwrite would hand peers two actors for one name.
        Re-registering the same cell is an idempotent no-op."""
        with self._lock:
            existing = self._names.get(name)
            if existing is not None and existing is not cell:
                raise DuplicateNameError(
                    "fabric.name_duplicate",
                    "well-known name registered twice for different cells",
                    name=name,
                    existing=getattr(existing, "path", repr(existing)),
                    requested=getattr(cell, "path", repr(cell)),
                )
            self._names[name] = cell

    def lookup(self, address: str, name: str) -> ProxyCell:
        """Resolve a peer's well-known name to its cached proxy.  A name
        the peer's hello never advertised (or an address we have no
        hello from) does NOT fabricate a proxy for a nonexistent uid —
        it emits ``fabric.lookup_miss`` and raises, so the caller can
        retry once the hello lands instead of silently sending into a
        permanent dead-letter sink."""
        with self._lock:
            uid = self._peer_names.get(address, {}).get(name)
        if uid is None:
            events.recorder.commit(events.LOOKUP_MISS, address=address, lookup=name)
            raise NameLookupError(
                "fabric.lookup_miss",
                "well-known name not resolved by the peer",
                address=address,
                name=name,
            )
        return self._proxy(address, uid)

    def _proxy(self, address: str, uid: int) -> ProxyCell:
        key = (address, uid)
        p = self._proxies.get(key)
        if p is None:
            p = self._proxies[key] = ProxyCell(self, address, uid)
        return p

    def resolve_cell_token(self, address: str, uid: int):
        """wire.py resolution hook: local uids resolve to real cells,
        remote uids to cached proxies.  A LOCAL uid that no longer
        resolves (the actor terminated and was reclaimed) yields the
        cached proxy as a *tombstone* instead of raising: every decoder
        on this node (app frames, delta graphs, ingress-entry
        rebroadcasts) then folds facts about the dead actor under one
        stable key, which is what lets post-mortem claims and the
        dead-letter tally cancel instead of stranding the frame."""
        if address == self.address:
            cell = self.system.resolve_cell(uid)
            if cell is not None:
                return cell
        return self._proxy(address, uid)

    # ------------------------------------------------------------- #
    # Wire-up
    # ------------------------------------------------------------- #

    def _hello(self) -> tuple:
        bk = self.system.engine.bookkeeper_cell
        names = {n: c.uid for n, c in self._names.items()}
        caps: List[str] = []
        if self._batching:
            # Capability negotiation: the trailing caps element tells the
            # peer it may send us multi-frame batch units.  Each further
            # capability rides the same element ("sc..." = schema codec,
            # "shm" = co-located ring transport); receivers ignore cap
            # strings they do not understand.  A node with everything
            # off keeps the legacy 5-element shape — the exact hello an
            # older build emits.
            caps.append("fb")
        if self._schema_codec:
            caps.append(wire_schema.capability())
        if self._shm_enabled:
            caps.append("shm")
        if caps:
            return ("hello", self.address, names, bk.uid, self._nonce, tuple(caps))
        return ("hello", self.address, names, bk.uid, self._nonce)

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start accepting peer connections; returns the bound port."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(8)
        self._listener = srv
        threading.Thread(
            target=self._accept_loop, name="node-accept", daemon=True
        ).start()
        return srv.getsockname()[1]

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn,
                args=(_Conn(sock),),
                name="node-conn",
                daemon=True,
            ).start()

    def connect(self, host: str, port: int) -> str:
        """Dial a peer; blocks until its hello arrives.  Returns the
        peer's address.  With ``uigc.node.reconnect-retries`` > 0 the
        initial dial retries with exponential backoff too."""
        attempts = 1 + self._reconnect_retries
        for attempt in range(attempts):
            try:
                sock = socket.create_connection((host, port), timeout=30)
                break
            except OSError:
                if attempt + 1 >= attempts:
                    raise
                time.sleep(self._reconnect_backoff_s * (2**attempt))
        # The dial timeout must not outlive the dial: a lingering socket
        # timeout would make recv() on an idle-but-healthy link raise
        # after 30s and be mistaken for EOF.
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(sock)
        conn.send(self._hello())
        hello = conn.recv()
        if hello is None or hello is _CORRUPT or hello[0] != "hello":
            raise ConnectionError("peer handshake failed")
        if not self._install_peer(conn, hello):
            raise ConnectionError(f"peer {hello[1]!r} was already declared dead")
        self._peer_state(conn.address).dial = (host, port)
        threading.Thread(
            target=self._recv_loop, args=(conn,), name="node-conn", daemon=True
        ).start()
        self._maybe_init_shm(conn.address, host)
        return conn.address

    def _serve_conn(self, conn: _Conn) -> None:
        hello = conn.recv()
        if hello is None or hello is _CORRUPT or hello[0] != "hello":
            conn.close()
            return
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.send(self._hello())
        if not self._install_peer(conn, hello):
            conn.close()
            return
        self._recv_loop(conn)

    def _install_peer(self, conn: _Conn, hello: tuple) -> bool:
        """Adopt a handshaken connection.  Returns False when the peer
        is the SAME incarnation of an address already declared dead (a
        removed member cannot silently rejoin — recovery already
        reverted its effects).  A NEW incarnation (restart nonce) of a
        dead address IS admitted: the rolling-restart rejoin — the old
        incarnation's death verdict ran (or runs now), its transport
        state retires, and the newcomer joins with a completely fresh
        stream (fresh sequence numbers, fresh egress/ingress windows).

        Tolerant unpack: the hello is ``(kind, address, names, bk_uid,
        nonce)`` with an optional trailing capabilities element — never
        destructure to a fixed arity, so hellos from peers with or
        without batching (or with future extra elements) all parse."""
        address, names, bk_uid, nonce = hello[1], hello[2], hello[3], hello[4]
        try:
            caps = frozenset(hello[5]) if len(hello) > 5 else frozenset()
        except TypeError:
            caps = frozenset()
        conn.address = address
        # Restart detection BEFORE adopting state: a known address
        # presenting a new nonce means the incarnation we were linked
        # to is gone — run its death verdict, then fall through to the
        # rejoin admission below (one dial, not a refuse-then-retry).
        with self._lock:
            old = self._peers.get(address)
            stale = (
                address in self._conns
                and address not in self.crashed
                and old is not None
                and old.nonce is not None
                and old.nonce != nonce
            )
        if stale:
            self._declare_dead(address, "restart")
        retired = None
        healed = False
        with self._lock:
            if address in self.crashed:
                old = self._peers.get(address)
                if old is not None and old.nonce == nonce:
                    if not self._heal_rejoin:
                        return False  # the SAME dead incarnation: refuse
                    # Heal rejoin: the SAME incarnation reconnecting
                    # after a partition verdict.  Its old frame stream
                    # is unsound to resume (both sides finalized the
                    # dead link and reverted its effects), so it gets
                    # the restart treatment — fresh stream, fresh
                    # links — and the layers above reconcile through
                    # the membership handshake.
                    healed = True
                # Rolling-restart rejoin: retire the dead incarnation's
                # transport state wholesale — stream numbering, links,
                # cached proxies — so the newcomer starts from zero on
                # both sides (its fabric is fresh-built anyway).
                self.crashed.discard(address)
                if old is not None:
                    old.retired = True
                    old.out_ev.set()
                    retired = old
                self._peers.pop(address, None)
                self._conns.pop(address, None)
                self._peer_names.pop(address, None)
                self._out.pop(address, None)
                self._in.pop(address, None)
                for key in [k for k in self._proxies if k[0] == address]:
                    del self._proxies[key]
        if retired is not None:
            # Off-lock teardown of the dead incarnation's accessories.
            if retired.shm_rx is not None:
                retired.shm_rx.poison()
                retired.shm_rx.close()
            if retired.shm_tx is not None:
                retired.shm_tx.poison()
                retired.shm_tx.close()
            retired.shm_rx_ev.set()
            if retired.decode_lane is not None:
                retired.decode_lane.close()
        st = self._peer_state(address)
        st.caps = caps
        st.schema_ids = (
            wire_schema.peer_schema_ids(caps)
            if self._schema_codec
            else frozenset()
        )
        st.schema_table = (
            wire_schema.encoder_table(st.schema_ids) if st.schema_ids else {}
        )
        if st.decode_lane is None and self._decode_lanes_on():
            st.decode_lane = DecodeLane(
                f"node-decode-{address}", origin=self.address or None
            )
        with self._lock:
            if address in self.crashed:
                return False
            known = address in self._conns
            if known and st.nonce is not None and st.nonce != nonce:
                restarted = True
            else:
                restarted = False
                st.nonce = nonce
                self._conns[address] = conn
                self._peer_names[address] = names
                self.systems[address] = RemoteSystemStub(
                    address, self._proxy(address, bk_uid)
                )
            subscribers = list(self._subscribers) if not known else []
        if restarted:
            # The incarnation we were linked to is gone: run the death
            # verdict for it, and refuse the newcomer like any rejoin.
            self._declare_dead(address, "restart")
            return False
        if self._hb is not None:
            if healed or retired is not None:
                # Rejoin of a previously-downed address (heal or fresh
                # incarnation): clear the one-shot down latch so the
                # monitor watches the peer again.
                self._hb.revive(address)
            self._hb.record(address)
        if healed:
            events.recorder.commit(events.LINK_HEALED, address=address)
        if known:
            events.recorder.commit(
                events.LINK_RECONNECT, address=address, side="accept"
            )
        for s in subscribers:
            s.tell(MemberUp(address))
        return True

    def _decode_lanes_on(self) -> bool:
        """Resolve ``uigc.node.decode-workers``: "on" forces per-peer
        lanes (the graceful-degradation mode tests exercise under the
        stock GIL), "off" pins decode to the receive thread, "auto"
        follows the interpreter's actual parallelism."""
        mode = (self._decode_mode or "auto").lower()
        if mode in ("on", "true", "1", "yes"):
            return True
        if mode in ("off", "false", "0", "no"):
            return False
        return free_threading_active()

    def peer_schema_ids(self, address: str) -> frozenset:
        """Schema ids negotiated with a peer — what layers that
        pre-encode payload bytes (cluster sharding) pass to
        ``wire.encode_message_schema`` so schema bytes never reach a
        peer that cannot decode them."""
        st = self._peers.get(address)
        return st.schema_ids if st is not None else frozenset()

    def shm_active(self, address: str) -> bool:
        """True when outbound traffic to ``address`` currently rides
        the shared-memory ring (bench/test introspection)."""
        st = self._peers.get(address)
        return st is not None and st.shm_tx_on

    def peer_nonce(self, address: str) -> Optional[int]:
        """The process-incarnation nonce ``address`` presented in its
        hello, or None before any hello.  Ingress windows stamp it so
        crash-quorum accounting can tell two incarnations of the same
        address apart with an identity no per-observer counter can
        alias (engines/crgc/undo.py)."""
        st = self._peers.get(address)
        return st.nonce if st is not None else None

    def _peer_state(self, address: str) -> _PeerState:
        # Lock-free fast path: dict reads are atomic under the GIL and
        # peer states are never removed, only created — the send path
        # hits this per frame.
        st = self._peers.get(address)
        if st is not None:
            return st
        with self._lock:
            st = self._peers.get(address)
            if st is None:
                st = self._peers[address] = _PeerState()
            return st

    def _live_peers(self) -> List[str]:
        with self._lock:
            return [a for a in self._conns if a not in self.crashed]

    # ------------------------------------------------------------- #
    # Subsystem frames (cluster sharding and future layers)
    # ------------------------------------------------------------- #

    def register_frame_handler(
        self, kind: str, handler: Optional[Callable[[str, tuple], None]]
    ) -> None:
        """Install (or with ``None`` remove) the receiver for a custom
        frame kind.  The handler runs on the link's receive thread with
        the full frame tuple; it must tolerate trailing elements it does
        not understand (the same contract as the app-frame trace
        header)."""
        with self._lock:
            if handler is None:
                self._frame_handlers.pop(kind, None)
            else:
                self._frame_handlers[kind] = handler

    def send_frame(self, dst_address: str, inner: tuple) -> bool:
        """Hand one subsystem frame to a live peer's writer; it rides
        the sequence layer and the fault plan in stream order (the same
        path app frames take).  Returns False when there is no live
        link; True means *accepted for transmission* — the writer
        flushes asynchronously, and a link that breaks mid-flush
        surfaces as a structured ``fabric.send_failed`` event (with the
        peer and frame kind) rather than a silent bool."""
        return self._send_frame(dst_address, inner)

    # ------------------------------------------------------------- #
    # Frame transmission (writer thread: seq layer + fault injection)
    #
    # Senders never lock: a send is one atomic deque append plus (on
    # the empty->nonempty transition) an Event.set.  The per-peer
    # writer is the queue's single consumer; it stamps egress windows,
    # claims sequence numbers and runs fault-plan verdicts in pop
    # order — which therefore IS the stream order — then coalesces
    # everything drained into one sendall.
    # ------------------------------------------------------------- #

    def _send_frame(self, dst_address: str, inner: tuple, conn: Optional[_Conn] = None) -> bool:
        """Queue one pre-built frame for ``dst_address``."""
        if conn is None:
            conn = self._conn_for(dst_address)
        if conn is None:
            return False
        self._enqueue_job(dst_address, self._peer_state(dst_address), ("f", inner))
        return True

    def _enqueue_job(self, address: str, st: _PeerState, job: tuple) -> None:
        if len(st.outq) >= self._writer_high_water:
            # Backpressure (rare path): a peer whose writer cannot keep
            # up stalls its senders instead of growing the queue
            # unboundedly.  The writer notifies after each drain.
            # Surfaced structurally: this is where a saturated REMOTE
            # mailbox (whose blocked receive thread stalled the TCP
            # stream) finally reaches the sending application.
            if events.recorder.enabled:
                events.recorder.commit(
                    events.BACKPRESSURE,
                    site="writer-queue",
                    action="wait",
                    dst=address,
                    depth=len(st.outq),
                )
            with st.out_cv:
                while (
                    len(st.outq) >= self._writer_high_water and not self._closing
                ):
                    st.out_cv.wait(0.1)
        st.outq.append(job)
        if not st.out_ev.is_set():
            st.out_ev.set()
        if st.writer is None:
            self._start_writer(address, st)

    def _start_writer(self, address: str, st: _PeerState) -> None:
        with st.lock:
            if st.writer is not None:
                return
            st.writer = threading.Thread(
                target=self._writer_loop,
                args=(address, st),
                name=f"node-writer-{address}",
                daemon=True,
            )
            st.writer.start()

    def _writer_loop(self, address: str, st: _PeerState) -> None:
        """Per-peer outbound writer: drains the job queue, stamps and
        sequences in pop order, encodes off every sender path, and
        flushes each drain in ONE sendall — a multi-frame ``"fb"``
        batch when the peer advertised the capability, a concatenation
        of classic singleton units otherwise (old peers still parse
        unit-by-unit; only the syscalls coalesce)."""
        events.set_thread_origin(self.address or None)
        max_batch = self._max_batch_frames
        outq = st.outq
        while True:
            if not outq:
                st.out_ev.clear()
                if outq:
                    # An append raced the clear: keep the event set so a
                    # concurrent sender's skipped set() cannot be lost.
                    st.out_ev.set()
                elif self._closing or st.retired or address in self.crashed:
                    # Node closing, this state superseded by a rejoined
                    # incarnation, or the peer is terminally dead (no
                    # send path can enqueue for it anymore): exit.
                    return
                else:
                    # Unbounded wait — zero wakeups on an idle link.
                    # Every transition out of idle sets the event:
                    # senders on enqueue, close() on teardown,
                    # _declare_dead on the peer's death verdict.
                    st.out_ev.wait()
                    continue
            was_backpressured = len(outq) >= self._writer_high_water
            plan = self.fault_plan
            crash = False
            try:
                if (
                    plan is None
                    and st.held is None
                    and st.stall <= 0
                    and self._batching
                    and "fb" in st.caps
                ):
                    # Fault-free fb drain (the overwhelmingly common
                    # case): one fused pop -> stamp -> sequence ->
                    # encode pass with no per-frame verdict calls or
                    # transmit tuples.
                    self._drain_fast(address, st, outq, max_batch)
                else:
                    crash = self._drain_slow(address, st, outq, max_batch, plan)
            except Exception:  # pragma: no cover - defensive
                # The writer is the link's single pump: it must survive
                # any raising hook (the affected drain's frames are
                # lost and account as a receiver gap, like any
                # lost-in-flight frame — never a wedged link).
                traceback.print_exc()
            if was_backpressured:
                with st.out_cv:
                    st.out_cv.notify_all()
            if crash:
                self.die(reason="fault-plan")
                return

    def _drain_slow(
        self,
        address: str,
        st: _PeerState,
        outq: deque,
        max_batch: int,
        plan: Optional[faults.FaultPlan],
    ) -> bool:
        """The fully-general drain: fault-plan verdicts, reorder holds,
        stall queues, crash points, singleton-unit peers.  Returns True
        when a scheduled crash point fired."""
        jobs: list = []
        try:
            while len(jobs) < max_batch:
                jobs.append(outq.popleft())
        except IndexError:
            pass
        transmit: list = []
        crash = False
        for job in jobs:
            if job[0] == "g":
                # Transport flip (shm negotiation): flush everything
                # queued so far — plus the in-stream "shmgo" marker —
                # via the socket, then route later flushes through
                # the ring.  The marker claims a sequence number but
                # bypasses the fault plan: it is transport
                # negotiation, not traffic, and dropping it would
                # wedge the consumer barrier, not model a lost frame.
                st.seq_out += 1
                transmit.append((st.seq_out, ("shmgo",), False))
                self._flush_items(address, st, transmit)
                transmit = []
                if st.shm_tx is not None:
                    st.shm_tx_on = True
                    events.recorder.commit(
                        events.SHM_ESTABLISHED, dst=address, role="producer"
                    )
                continue
            try:
                inner = self._job_inner(job)
            except Exception:  # pragma: no cover - defensive
                traceback.print_exc()
                continue
            if inner is None:
                continue
            kind = inner[0]
            self._apply_verdict(st, address, inner, kind, plan, transmit)
            if plan is not None and plan.record_sent(self.address, kind):
                # Scheduled crash point: everything up to and
                # including this frame flushes, the rest is lost —
                # kill -9 at a deterministic stream position.
                crash = True
                break
        self._flush_items(address, st, transmit)
        return crash

    def _drain_fast(
        self, address: str, st: _PeerState, outq: deque, max_batch: int
    ) -> None:
        """Fused drain for a fault-free ``"fb"`` link: pop each job and
        stamp / sequence / encode it in the same pass, accumulating the
        wire body directly.  Consecutive schema-admitted app messages to
        one uid collapse into run blocks exactly as in
        ``_encode_fb_parts``; everything else becomes a per-frame pickle
        block in stream position.  This is the path the 250k+ frames/s
        bar is measured on — per frame it costs one deque pop, one
        type-dispatch dict hit, one safety walk and one list append,
        with the marshal/pickle C calls amortized per run/flush."""
        parts: list = [wire.FB_MAGIC]
        pack_hdr = wire._FB_HDR.pack
        table = st.schema_table
        seq = st.seq_out
        counters = [0, 0, 0]  # schema_n, pickle_n, nframes
        failed: list = []
        kinds: list = []  # (frame kind, count) for transmit-failure events
        run_msgs: list = []
        run_uid = -1
        run_seq0 = 0
        run_sch = None
        pending_flip = False

        def flush_run() -> None:
            nonlocal run_sch
            if not run_msgs:
                return
            body = None
            if len(run_msgs) <= 0xFFFF:  # the run header's count field
                try:
                    body = run_sch.vec_encode(run_msgs)
                except Exception:  # pragma: no cover - probe admitted it
                    traceback.print_exc()
            if body is not None and len(body) <= 0xFFFFFFFF:
                block = wire.encode_run_block(
                    run_uid, run_sch.schema_id, len(run_msgs), body
                )
                parts.append(pack_hdr(run_seq0, len(block)))
                parts.append(block)
                counters[0] += len(run_msgs)
                counters[2] += len(run_msgs)
                kinds.append(("app", len(run_msgs)))
            else:
                s = run_seq0
                for msg in run_msgs:
                    emit_frame(s, ("app", run_uid, msg))
                    s += 1
            run_msgs.clear()

        def emit_frame(frame_seq: int, inner: tuple) -> None:
            try:
                frame = self._materialize_frame(inner)
            except Exception:
                # Unencodable payload: the sequence number is already
                # claimed, so the receiver accounts a gap — same fate
                # as the old per-item materialize failure.
                traceback.print_exc()
                failed.append((frame_seq, inner, False))
                return
            block = wire.encode_block(frame, False)
            parts.append(pack_hdr(frame_seq, len(block)))
            parts.append(block)
            counters[2] += 1
            kinds.append((inner[0], 1))
            if inner[0] == "app":
                counters[1] += 1

        n = 0
        while n < max_batch:
            try:
                job = outq.popleft()
            except IndexError:
                break
            n += 1
            tag = job[0]
            try:
                # Per-job isolation, matching the _job_inner guard the
                # old drain had: a raising engine hook loses THIS job
                # (its claimed sequence number surfaces as a receiver
                # gap), never the drain or the writer thread.
                if tag == "a":
                    _tag, link, target, msg, header = job
                    seq += 1
                    if header is None:
                        sch = table.get(type(msg))
                        if sch is not None:
                            if sch.schema_id != _SCHEMA_VAL_ID:
                                # Envelope message: the egress stamp is
                                # live (CRGC writes the window id the
                                # codec serializes) and must land
                                # before encode.
                                egress = link.egress
                                if egress is not None:
                                    egress.on_message(target, msg)
                            # else: a VAL-admitted message is
                            # exactly-typed plain data — every engine's
                            # egress hook is envelope-keyed (CRGC
                            # stamps AppMsg only; engines without
                            # remote bookkeeping spawn no egress), so
                            # the stamp is a no-op by construction and
                            # the call is skipped.
                            if sch.probe(msg):
                                uid = target.uid
                                if run_msgs and (
                                    uid != run_uid or sch is not run_sch
                                ):
                                    flush_run()
                                if not run_msgs:
                                    run_uid, run_seq0, run_sch = uid, seq, sch
                                run_msgs.append(msg)
                                continue
                            inner = ("app", target.uid, msg)
                        else:
                            egress = link.egress
                            if egress is not None:
                                egress.on_message(target, msg)
                            inner = ("app", target.uid, msg)
                    else:
                        egress = link.egress
                        if egress is not None:
                            egress.on_message(target, msg)
                        inner = ("app", target.uid, msg, header)
                elif tag == "m":
                    link = job[1]
                    if link.egress is None:
                        continue
                    seq += 1
                    inner = ("marker", link.egress.finalize_entry().id)
                elif tag == "g":
                    # Flip point: everything encoded so far (plus the
                    # go marker) must leave via the PRE-flip transport;
                    # stop the drain here and flip after the flush.
                    seq += 1
                    flush_run()
                    emit_frame(seq, ("shmgo",))
                    pending_flip = st.shm_tx is not None
                    break
                else:  # "f": a pre-built frame
                    seq += 1
                    inner = job[1]
            except Exception:  # pragma: no cover - defensive
                traceback.print_exc()
                continue
            flush_run()
            emit_frame(seq, inner)
        flush_run()
        st.seq_out = seq
        for item in failed:
            self._report_send_failed(address, [item])
        if counters[2]:
            body = b"".join(parts)
            buf = struct.pack(">I", len(body)) + body
            self._transmit_buf(
                address,
                st,
                buf,
                lambda: self._report_failed_kinds(address, kinds),
            )
            if events.recorder.enabled:
                events.recorder.commit(
                    events.FRAME_BATCH,
                    dst=address,
                    size=counters[2],
                    bytes=len(buf),
                )
                if counters[0] or counters[1]:
                    events.recorder.commit(
                        events.CODEC_FRAMES,
                        dst=address,
                        schema=counters[0],
                        pickle=counters[1],
                    )
        if pending_flip:
            st.shm_tx_on = True
            events.recorder.commit(
                events.SHM_ESTABLISHED, dst=address, role="producer"
            )

    def _job_inner(self, job: tuple) -> Optional[tuple]:
        """Turn a queued job into its inner frame tuple, running the
        stateful egress steps (window stamp / window roll) that must
        happen in stream order.  Writer-thread only."""
        tag = job[0]
        if tag == "f":
            return job[1]
        if tag == "a":
            _tag, link, target, msg, header = job
            if link.egress is not None:
                link.egress.on_message(target, msg)
            if header is not None:
                return ("app", target.uid, msg, header)
            return ("app", target.uid, msg)
        # "m": roll the egress window and emit its boundary marker.
        link = job[1]
        if link.egress is None:
            return None
        return ("marker", link.egress.finalize_entry().id)

    def _apply_verdict(
        self,
        st: _PeerState,
        dst_address: str,
        inner: tuple,
        kind: str,
        plan: Optional[faults.FaultPlan],
        transmit: list,
    ) -> None:
        """Sequence claim + fault-plan verdict for one frame, appending
        what should hit the wire to ``transmit`` as (seq, inner,
        truncate) triples.  Every verdict — including a drop — consumes
        a sequence number, so the receiver can tell "lost in flight"
        (gap) from "never sent".  Writer-thread only: st.seq_out,
        st.held and the stall queue have a single mutator."""
        if plan is None:
            action, frames = faults.DELIVER, 0
        else:
            action, frames = plan.outbound(self.address, dst_address, kind)
        st.seq_out += 1
        seq = st.seq_out
        out: list = []
        if action == faults.DROP:
            events.recorder.commit(
                events.FRAME_DROPPED,
                src=self.address,
                dst=dst_address,
                kind=kind,
            )
        elif action == faults.DUPLICATE:
            out = [(seq, inner, False), (seq, inner, False)]
        elif action == faults.TRUNCATE:
            out = [(seq, inner, True)]
        elif action == faults.REORDER and st.held is None:
            st.held = (seq, inner, False)
        elif action == faults.DELAY:
            st.stall = max(st.stall, frames)
            st.stall_q.append((seq, inner, False))
        else:
            out = [(seq, inner, False)]

        if out and st.stall > 0:
            # Link stalled: absorb in order, release when drained.
            st.stall_q.extend(out)
            st.stall -= 1
            out = []
            if st.stall <= 0:
                out = st.stall_q
                st.stall_q = []
        if out and st.held is not None:
            # Release the reordered frame AFTER the newer one(s) —
            # including a stall-queue drain, so combining delay and
            # reorder rules cannot strand the held frame while
            # traffic continues.  (A held or stalled frame on a link
            # that goes PERMANENTLY quiet is never transmitted; that
            # is the documented fault model — it becomes a drop.)
            out = out + [st.held]
            st.held = None
        transmit.extend(out)

    def _flush_items(self, address: str, st: _PeerState, items: list) -> None:
        """Encode and flush one drained batch in a single transmit:
        one ``sendall`` on the socket path, one ring record on the shm
        path (same bytes either way — the ring replaces the syscall,
        never the framing)."""
        if not items:
            return
        use_fb = self._batching and "fb" in st.caps
        schema_n = pickle_n = nframes = 0
        if use_fb:
            parts, schema_n, pickle_n, nframes, failed = self._encode_fb_parts(
                st, items
            )
            for item in failed:
                self._report_send_failed(address, [item])
            if nframes == 0:
                return
            if failed:
                # Encode failures are already reported above; a
                # transmit failure must account only the frames that
                # actually made it into the buffer.
                failed_ids = {id(f) for f in failed}
                ok_items = [i for i in items if id(i) not in failed_ids]
            else:
                ok_items = items
            body = b"".join(parts)
            buf = struct.pack(">I", len(body)) + body
        else:
            # Pickle app payloads here, off every sender path: an
            # unencodable one is dropped (gap at the receiver, like any
            # lost-in-flight frame) with a send_failed event, never a
            # wedged link.
            encoded = []
            ok_items = []
            for item in items:
                try:
                    encoded.append(
                        (item[0], self._materialize_frame(item[1]), item[2])
                    )
                    ok_items.append(item)
                    if item[1][0] == "app":
                        pickle_n += 1
                except Exception:
                    traceback.print_exc()
                    self._report_send_failed(address, [item])
            if not encoded:
                return
            nframes = len(encoded)
            buf = b"".join(
                _frame_bytes(("f", sq, fr), trunc) for sq, fr, trunc in encoded
            )
        self._transmit_buf(
            address, st, buf, lambda: self._report_send_failed(address, ok_items)
        )
        if events.recorder.enabled:
            if use_fb:
                events.recorder.commit(
                    events.FRAME_BATCH,
                    dst=address,
                    size=nframes,
                    bytes=len(buf),
                )
            if schema_n or pickle_n:
                events.recorder.commit(
                    events.CODEC_FRAMES,
                    dst=address,
                    schema=schema_n,
                    pickle=pickle_n,
                )

    def _encode_fb_parts(
        self, st: _PeerState, items: list
    ) -> Tuple[list, int, int, int, list]:
        """One pass over a drain's (seq, inner, truncate) triples,
        producing the ``"fb"`` body parts.  Consecutive app frames to
        ONE uid whose messages a peer-negotiated schema admits collapse
        into a single run block — the whole run is batch-encoded in one
        call (runtime/schema.py) instead of pickled per message.
        Everything else (refs-bearing envelopes, traced frames,
        unknown payload types, fault-truncated frames, non-app frames)
        takes the classic per-frame pickle block, mid-stream — that IS
        the fallback contract.  Returns (parts, schema_frames,
        pickle_app_frames, total_frames, failed_items)."""
        parts: list = [wire.FB_MAGIC]
        failed: list = []
        counters = [0, 0, 0]  # schema_n, pickle_n, nframes
        pack_hdr = wire._FB_HDR.pack
        run_msgs: list = []
        run_items: list = []
        run_uid = -1
        run_seq0 = 0
        run_next_seq = 0
        run_schema = None

        def emit_pickle(item: tuple) -> None:
            seq, inner, trunc = item
            try:
                frame = self._materialize_frame(inner)
            except Exception:
                traceback.print_exc()
                failed.append(item)
                return
            block = wire.encode_block(frame, trunc)
            parts.append(pack_hdr(seq, len(block)))
            parts.append(block)
            counters[2] += 1
            if inner[0] == "app":
                counters[1] += 1

        def flush_run() -> None:
            nonlocal run_schema
            if not run_msgs:
                return
            body = None
            if len(run_msgs) <= 0xFFFF:
                try:
                    body = run_schema.vec_encode(run_msgs)
                except Exception:  # pragma: no cover - probe admitted it
                    traceback.print_exc()
                    body = None
            if body is not None and len(body) <= 0xFFFFFFFF:
                block = wire.encode_run_block(
                    run_uid, run_schema.schema_id, len(run_msgs), body
                )
                parts.append(pack_hdr(run_seq0, len(block)))
                parts.append(block)
                counters[0] += len(run_msgs)
                counters[2] += len(run_msgs)
            else:
                for item in run_items:
                    emit_pickle(item)
            run_msgs.clear()
            run_items.clear()

        table = st.schema_table
        for item in items:
            seq, inner, trunc = item
            if not trunc and inner[0] == "app" and len(inner) == 3:
                msg = inner[2]
                sch = table.get(type(msg))
                if sch is not None and sch.probe(msg):
                    uid = inner[1]
                    if run_msgs and (
                        uid != run_uid
                        or sch is not run_schema
                        or seq != run_next_seq
                    ):
                        flush_run()
                    if not run_msgs:
                        run_uid, run_seq0, run_schema = uid, seq, sch
                    run_msgs.append(msg)
                    run_items.append(item)
                    run_next_seq = seq + 1
                    continue
            flush_run()
            emit_pickle(item)
        flush_run()
        return parts, counters[0], counters[1], counters[2], failed

    def _transmit_buf(
        self, address: str, st: _PeerState, buf: bytes, on_fail
    ) -> None:
        """Put one encoded flush on the wire: the shm ring when the
        link flipped (falling back to the socket if the ring is
        renounced mid-flight — the receiver's recovery drain keeps
        stream order), the socket otherwise.  ``on_fail`` reports the
        lost frames when no transport can take them (peer dead, link
        torn mid-flush) — never a silent loss."""
        if st.shm_tx_on and st.shm_tx is not None:
            if self._ring_send(address, st, buf):
                return
        conn = self._conn_for(address)
        if conn is None:
            on_fail()
            return
        try:
            conn.send_bytes(buf)
        except OSError:
            on_fail()
            self._on_conn_broken(address, conn)

    def _report_failed_kinds(self, address: str, kinds: list) -> None:
        """send_failed events from (kind, count) pairs (the fast
        drain's failure bookkeeping; heartbeats excluded as in
        _report_send_failed)."""
        if self._closing:
            return
        for kind, count in kinds:
            if kind == "hb":
                continue
            events.recorder.commit(
                events.SEND_FAILED, dst=address, kind=kind, count=count
            )

    def _ring_send(self, address: str, st: _PeerState, buf: bytes) -> bool:
        """Write one flush to the peer's shm ring.  A full ring
        backpressures the writer (``fabric.shm_ring_full``); a ring
        that is poisoned, too small for the record, or whose consuming
        process died is renounced — False flips the link back to the
        socket path permanently."""
        ring = st.shm_tx
        reason = None
        stalled = False
        checks = 0
        stall_head = -1
        stall_deadline = 0.0
        while reason is None:
            if self._closing or address in self.crashed:
                reason = "closing"
                break
            if ring.poisoned:
                reason = "poisoned"
                break
            if ring.write(buf):
                return True
            if len(buf) + 4 > ring.capacity:
                reason = "write-failed"
                break
            if not stalled:
                stalled = True
                events.recorder.commit(events.SHM_RING_FULL, dst=address)
            checks += 1
            if checks % 250 == 0:
                if st.shm_peer_pid and not shm_ring.pid_alive(st.shm_peer_pid):
                    reason = "peer-dead"
                    break
                # A consumer that makes NO progress for several seconds
                # while its process lives (a lost shma/shmgo control
                # frame, a wedged reader) must not wedge this writer —
                # and through the backpressured senders, the whole link
                # — forever: renounce and resume the socket.  The
                # undrained records are accounted as a gap by the
                # receiver, the documented lost-frame model.
                head = ring._head()
                now = time.monotonic()
                if head != stall_head:
                    stall_head = head
                    stall_deadline = now + 5.0
                elif now >= stall_deadline:
                    reason = "stalled"
                    break
            time.sleep(0.0002)
        st.shm_tx_on = False
        ring.poison()
        if not self._closing:
            events.recorder.commit(
                events.SHM_FALLBACK, dst=address, reason=reason
            )
        return False

    @staticmethod
    def _materialize_frame(frame: tuple) -> tuple:
        """Late payload serialization: an app frame queued by deliver()
        carries the message object; replace it with its pickled bytes
        (``wire.encode_message``) just before the wire.  Every app
        payload is encoded — sniffing ``isinstance(payload, bytes)``
        would misread a user message that IS a bytes object as already
        encoded and ship it raw.  Non-app frames (subsystem frames,
        control gossip) pass through untouched; nothing re-enters this
        step, so double-encoding cannot occur."""
        if frame[0] == "app":
            return (frame[0], frame[1], wire.encode_message(frame[2])) + tuple(
                frame[3:]
            )
        return frame

    def _report_send_failed(self, address: str, items: list) -> None:
        """A flush could not reach the peer: emit one structured
        ``fabric.send_failed`` event per lost protocol frame (heartbeats
        excluded — they are timer-driven noise on a dying link), unless
        this whole node is going down anyway."""
        if self._closing:
            return
        for _sq, inner, _trunc in items:
            kind = inner[0]
            if kind == "hb":
                continue
            events.recorder.commit(
                events.SEND_FAILED, dst=address, kind=kind
            )

    def writer_queue_depths(self) -> Dict[str, int]:
        """Frames queued per peer writer — the telemetry gauge tap
        (``uigc_writer_queue_depth``; approximate by nature)."""
        with self._lock:
            peers = list(self._peers.items())
        return {address: len(st.outq) for address, st in peers}

    def flush_writers(self, timeout_s: float = 5.0) -> bool:
        """Wait until every peer writer queue is drained (tests, the
        pre-crash drain in ``die()``, graceful teardown).  When called
        FROM a writer thread (a fault-plan crash point), that writer's
        own queue is excluded — it cannot drain itself while waiting."""
        me = threading.current_thread()
        with self._lock:
            peers = list(self._peers.items())
        waiting = [st for _a, st in peers if st.writer is not me]

        def drained() -> bool:
            return all(not st.outq for st in waiting)

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if drained():
                return True
            time.sleep(0.002)
        return drained()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Zero-downtime shutdown, step one of a rolling restart:

        1. stop accepting entity placements — the attached cluster (if
           any) broadcasts its departure and hands every hosted shard
           off through the grant protocol, journal-checkpointing on
           the way (``ClusterSharding.drain``);
        2. flush the per-peer writer queues so every accepted frame
           reaches the wire.

        After a True return the caller may ``system.terminate()`` and
        exit; peers lose nothing, and a fresh process on the same
        address rejoins by simply reconnecting.  False means the
        timeout expired with residue — the journal (when configured)
        still covers whatever stayed behind."""
        drained = True
        system = self.system
        cluster = getattr(system, "cluster", None) if system is not None else None
        if cluster is not None:
            drained = cluster.drain(timeout_s=timeout_s)
        flushed = self.flush_writers(timeout_s=min(5.0, timeout_s))
        return drained and flushed

    # ------------------------------------------------------------- #
    # Receive path
    # ------------------------------------------------------------- #

    def _recv_loop(self, conn: _Conn) -> None:
        # Transport threads belong to this node: tag their events so
        # per-node telemetry consumers can scope the shared recorder.
        events.set_thread_origin(self.address or None)
        while True:
            frame = conn.recv()
            if frame is None:
                break
            if self._hb is not None and conn.address:
                self._hb.record(conn.address)
            self._dispatch_unit(conn.address, frame, from_socket=True)
        self._on_conn_broken(conn.address, conn)

    def _dispatch_unit(
        self, address: str, frame: Any, from_socket: bool = False
    ) -> None:
        """Route one received wire unit to decode + delivery: inline on
        the calling transport thread, or onto the peer's decode lane
        (``uigc.node.decode-workers``) so decode and mailbox delivery
        leave the transport thread.  One lane per peer = per-peer FIFO
        preserved.  ``from_socket`` tags units from the TCP stream so
        the shm recovery drain runs on the SAME serialized path as
        frame processing (the lane, when lanes are on) — the
        ring-before-socket ordering barrier must be evaluated in
        processing order, not arrival order."""
        if frame is _CORRUPT:
            events.recorder.commit(events.FRAME_CORRUPT, src=address)
            return
        lane = self._peer_state(address).decode_lane if address else None
        if lane is not None:
            lane.submit(self._process_unit_job, (address, frame, from_socket))
        else:
            self._process_unit(address, frame, from_socket)

    def _process_unit_job(self, args: tuple) -> None:
        self._process_unit(*args)

    def _process_unit(
        self, address: str, frame: Any, from_socket: bool = False
    ) -> None:
        """Sequence-account and deliver one wire unit (an ``"fb"``
        batch or a classic singleton) — shared by the socket receive
        loop, the shm ring reader and the decode lanes."""
        if from_socket and address:
            st0 = self._peer_state(address)
            if st0.shm_rx_on:
                # A socket frame while the ring is live means the
                # producer reverted to the socket path: everything it
                # wrote to the ring precedes this frame, so drain the
                # ring first — stream order survives the fallback with
                # no seq desync.  Running here (on the decode lane when
                # lanes are on) keeps the check in processing order.
                self._drain_shm_rx(address, st0)
        if frame[0] == "fb":
            try:
                self._on_batch(address, frame[1])
            except Exception:  # pragma: no cover - keep the link alive
                traceback.print_exc()
            return
        if frame[0] != "f":  # pre-seq-layer frame (a stray hello): ignore
            return
        _, seq, inner = frame
        st = self._peer_state(address)
        with st.rlock:
            if seq <= st.seq_in:
                st.dups += 1
                dup = True
            else:
                dup = False
                if seq > st.seq_in + 1:
                    st.gaps += seq - st.seq_in - 1
                    events.recorder.commit(
                        events.FRAME_GAP,
                        src=address,
                        missed=seq - st.seq_in - 1,
                    )
                st.seq_in = seq
        if dup:
            events.recorder.commit(
                events.FRAME_DUPLICATE, src=address, seq=seq
            )
            return
        if inner[0] == "hb":
            return
        try:
            self._on_frame(address, inner)
        except Exception:  # pragma: no cover - keep the link alive
            traceback.print_exc()

    # ------------------------------------------------------------- #
    # Co-located shm transport (runtime/shm_ring.py)
    #
    # Negotiated per link when both hellos advertise "shm" and the
    # dial is loopback: the DIALER creates one SPSC ring per
    # direction and ships their names in-stream ("shmr"); each side
    # flips its producer AFTER flushing an in-stream "shmgo" marker
    # through the socket, and opens its consumer only when the peer's
    # marker arrives — so ring frames and socket frames can never
    # interleave out of stream order, in either direction, during
    # establishment OR fallback.  The socket stays open underneath as
    # the EOF detector and the recovery path.
    # ------------------------------------------------------------- #

    def _maybe_init_shm(self, address: str, host: str) -> None:
        if not self._shm_enabled:
            return
        st = self._peer_state(address)
        if st.shm_started or "shm" not in st.caps:
            return
        if host not in ("127.0.0.1", "localhost", "::1", "ip6-localhost"):
            return  # only co-located peers can map the same segments
        st.shm_started = True
        try:
            tx = shm_ring.ShmRing.create(self._shm_ring_bytes)
            rx = shm_ring.ShmRing.create(self._shm_ring_bytes)
        except OSError:  # pragma: no cover - no usable shm dir
            return
        st.shm_tx, st.shm_rx = tx, rx
        self._send_frame(address, ("shmr", tx.name, rx.name, os.getpid()))

    def _on_shm_request(self, from_address: str, frame: tuple) -> None:
        """Acceptor side of the negotiation: attach the dialer's rings
        (its tx is our rx), reply with our pid, and flip our own
        producer via the in-stream "g" job.  Any failure to attach is
        silently tolerated — the link simply stays on the socket."""
        if not self._shm_enabled:
            return
        st = self._peer_state(from_address)
        if st.shm_started:
            return
        try:
            peer_tx, peer_rx, peer_pid = frame[1], frame[2], int(frame[3])
            rx = shm_ring.ShmRing.attach(peer_tx)
        except (shm_ring.RingError, OSError, IndexError, TypeError, ValueError):
            return
        try:
            tx = shm_ring.ShmRing.attach(peer_rx)
        except (shm_ring.RingError, OSError):
            rx.close()
            return
        st.shm_started = True
        st.shm_rx, st.shm_tx = rx, tx
        st.shm_peer_pid = peer_pid
        self._start_shm_reader(from_address, st)
        self._send_frame(from_address, ("shma", os.getpid()))
        self._enqueue_job(from_address, st, ("g",))

    def _on_shm_ack(self, from_address: str, frame: tuple) -> None:
        """Dialer side: the peer attached our rings — flip our
        producer (in-stream, via the "g" job) and start our reader."""
        st = self._peer_state(from_address)
        if st.shm_tx is None or st.shm_reader is not None:
            return
        try:
            st.shm_peer_pid = int(frame[1])
        except (IndexError, TypeError, ValueError):
            st.shm_peer_pid = 0
        self._start_shm_reader(from_address, st)
        self._enqueue_job(from_address, st, ("g",))

    def _start_shm_reader(self, address: str, st: _PeerState) -> None:
        if st.shm_reader is not None:
            return
        st.shm_reader = threading.Thread(
            target=self._shm_reader_loop,
            args=(address, st),
            name=f"node-shm-{address}",
            daemon=True,
        )
        st.shm_reader.start()

    def _shm_reader_loop(self, address: str, st: _PeerState) -> None:
        """Per-peer ring consumer.  Delivers NOTHING until the peer's
        in-stream "shmgo" marker arrived on the socket (the barrier
        that proves every pre-flip socket frame was already processed);
        exits when the recovery drain or teardown closes the rx."""
        events.set_thread_origin(self.address or None)
        while not st.shm_rx_on:
            if self._closing or address in self.crashed:
                return
            st.shm_rx_ev.wait(0.25)
            st.shm_rx_ev.clear()
        ring = st.shm_rx
        idle_sleep = 0.0
        while True:
            if self._closing or address in self.crashed:
                return
            got = 0
            with st.shm_rx_lock:
                if not st.shm_rx_on:
                    return  # recovery drain (or teardown) took over
                # Drain everything available under ONE lock hold — the
                # lock is uncontended (the recovery drain is a rare
                # event), so per-record acquire/release was pure
                # overhead on the hot path.
                while True:
                    try:
                        record = ring.read()
                    except ValueError:  # pragma: no cover - closed under us
                        return
                    if record is None:
                        break
                    got += 1
                    try:
                        self._process_wire_bytes(address, record)
                    except Exception:  # pragma: no cover - keep reading
                        traceback.print_exc()
            if got:
                idle_sleep = 0.0
                continue
            if ring.poisoned and ring.used() == 0:
                # Producer renounced the ring and we drained every
                # record it managed to write: close the consumer so
                # later socket frames need no drain.
                with st.shm_rx_lock:
                    st.shm_rx_on = False
                return
            # Multiplicative backoff: a briefly-quiet link re-polls
            # fast, a quiet one converges to the 2ms cap — bounding
            # both the wake latency and the idle poll burn.
            idle_sleep = min(0.002, (idle_sleep + 0.00005) * 2)
            time.sleep(idle_sleep)

    def _drain_shm_rx(self, address: str, st: _PeerState) -> None:
        """Recovery drain: the producer reverted to the socket, so the
        ring holds only frames OLDER than the socket frame that
        triggered us.  Consume them all, then retire the consumer —
        the reader thread observes ``shm_rx_on`` drop and exits."""
        with st.shm_rx_lock:
            if not st.shm_rx_on:
                return
            while True:
                try:
                    record = st.shm_rx.read()
                except ValueError:  # pragma: no cover - closed under us
                    break
                if record is None:
                    break
                try:
                    self._process_wire_bytes(address, record)
                except Exception:  # pragma: no cover - keep draining
                    traceback.print_exc()
            st.shm_rx_on = False
            st.shm_rx_ev.set()

    def _process_wire_bytes(self, address: str, record: bytes) -> None:
        """Parse one ring record — the exact bytes a socket flush would
        have carried: one or more length-prefixed units — and dispatch
        each through the shared unit path."""
        if self._hb is not None and address:
            self._hb.record(address)
        off = 0
        n = len(record)
        while off + 4 <= n:
            (blen,) = struct.unpack_from(">I", record, off)
            off += 4
            body = record[off : off + blen]
            off += blen
            if len(body) != blen:
                events.recorder.commit(events.FRAME_CORRUPT, src=address)
                break
            if body[:4] == wire.FB_MAGIC:
                unit: Any = ("fb", wire.decode_batch(body))
            else:
                try:
                    unit = pickle.loads(body)  # uigc-lint: disable=UL010
                except Exception:
                    unit = _CORRUPT
            # Always processed DIRECTLY on the calling thread (the ring
            # reader, or the recovery drain), never re-dispatched
            # through the decode lane: the reader already IS a
            # dedicated per-peer thread (decode off the socket thread
            # is inherent to the shm path), and lane re-submission
            # would let a fallback socket frame — in flight on the
            # lane — overtake drained ring records, dup-discarding
            # them.  Ring-record processing is serialized by
            # shm_rx_lock, so order is airtight either way.
            if unit is _CORRUPT:
                events.recorder.commit(events.FRAME_CORRUPT, src=address)
            else:
                self._process_unit(address, unit)

    def _on_conn_broken(self, address: str, conn: Optional[_Conn]) -> None:
        """A connection died (EOF or send failure).  With reconnects
        enabled, try to heal the link before declaring the member dead;
        the dialer side re-dials, the acceptor side waits out the same
        window for a fresh hello."""
        if self._closing or not address:
            return
        with self._lock:
            if address in self.crashed or address not in self._conns:
                return
            if conn is not None and self._conns.get(address) is not conn:
                return  # already replaced by a reconnect
        st = self._peer_state(address)
        if self._reconnect_retries > 0:
            with st.rlock:
                if st.reconnecting:
                    # A break during an in-flight reconnect (e.g. the
                    # replacement conn died): remember it and let the
                    # running loop's epilogue replay it.
                    st.pending_break = conn
                    return
                st.reconnecting = True
            threading.Thread(
                target=self._reconnect_loop,
                args=(address, st, conn),
                name="node-reconnect",
                daemon=True,
            ).start()
            return
        self._declare_dead(address, "eof")

    def _reconnect_loop(self, address: str, st: _PeerState, old_conn: Optional[_Conn]) -> None:
        events.set_thread_origin(self.address or None)
        try:
            for attempt in range(self._reconnect_retries):
                time.sleep(self._reconnect_backoff_s * (2**attempt))
                if self._closing:
                    return
                with self._lock:
                    if address in self.crashed:
                        return
                    if self._conns.get(address) is not old_conn:
                        return  # the peer re-dialed us meanwhile
                if st.dial is None:
                    continue  # acceptor side: keep waiting the window out
                try:
                    sock = socket.create_connection(st.dial, timeout=5)
                    sock.settimeout(None)  # dial timeout only, see connect()
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    conn = _Conn(sock)
                    conn.send(self._hello())
                    hello = conn.recv()
                except OSError:
                    continue
                if hello is None or hello is _CORRUPT or hello[0] != "hello":
                    conn.close()
                    continue
                if not self._install_peer(conn, hello):
                    conn.close()
                    return
                events.recorder.commit(
                    events.LINK_RECONNECT,
                    address=address,
                    attempts=attempt + 1,
                    side="dial",
                )
                threading.Thread(
                    target=self._recv_loop,
                    args=(conn,),
                    name="node-conn",
                    daemon=True,
                ).start()
                return
            with self._lock:
                if self._conns.get(address) is not old_conn:
                    return
            self._declare_dead(address, "eof")
        finally:
            with st.rlock:
                st.reconnecting = False
                pending = st.pending_break
                st.pending_break = None
            if pending is not None and pending is not old_conn:
                # The replacement link broke while we were busy: handle
                # that break now (fresh reconnect round or death verdict).
                self._on_conn_broken(address, pending)

    def _on_phi_down(self, address: str, phi: float) -> None:
        self._declare_dead(address, "heartbeat", phi=phi)

    def _declare_dead(self, address: str, reason: str, **fields: Any) -> None:
        """Terminal failure verdict for a peer: close its link, notify
        subscribers (``kill -9`` of the peer process lands here through
        EOF; a silent peer through the heartbeat monitor — after
        everything it managed to send was delivered in order)."""
        if self._closing or not address:
            return
        with self._lock:
            if address in self.crashed or address not in self._conns:
                return
            self.crashed.add(address)
            conn = self._conns.get(address)
            subscribers = list(self._subscribers)
        events.recorder.commit(
            events.NODE_DOWN, address=address, reason=reason, **fields
        )
        # Wake the peer's writer so it observes the verdict and exits
        # (it may be in its unbounded idle wait).
        st = self._peers.get(address)
        if st is not None:
            st.out_ev.set()
        if self._hb is not None:
            self._hb.forget(address)
        if conn is not None:
            conn.close()
        for s in subscribers:
            s.tell(MemberRemoved(address))

    # ------------------------------------------------------------- #
    # Membership surface (collector-facing)
    # ------------------------------------------------------------- #

    def subscribe(self, cell: "ActorCell") -> None:
        with self._lock:
            self._subscribers.append(cell)
            current = [self.address] + [
                a for a in self._conns if a not in self.crashed
            ]
        for address in current:
            cell.tell(MemberUp(address))

    def members(self) -> List[str]:
        with self._lock:
            return [self.address] + [a for a in self._conns if a not in self.crashed]

    # ------------------------------------------------------------- #
    # Links
    # ------------------------------------------------------------- #

    def link(self, src: Any, dst: Any) -> _HalfLink:
        """The collector's eager link establishment: outbound halves get
        the local egress, inbound halves the local ingress."""
        if src is self.system:
            return self._out_link(dst.address)
        return self._in_link(src.address)

    def _out_link(self, dst_address: str) -> _HalfLink:
        l = self._out.get(dst_address)  # lock-free fast path (GIL-atomic)
        if l is not None:
            return l
        with self._lock:
            l = self._out.get(dst_address)
            if l is None:
                l = _HalfLink(self.system, self.systems.get(dst_address))
                l.egress = self.system.engine.spawn_egress(
                    _LinkFacade(self.system, ProxySystem(dst_address))
                )
                # NOTE: the egress is only ever touched by the peer's
                # writer thread (stamps and window rolls run in queue
                # order there), so l.send_lock is unused on this fabric.
                self._out[dst_address] = l
            return l

    def _in_link(self, src_address: str) -> _HalfLink:
        l = self._in.get(src_address)  # lock-free fast path (GIL-atomic)
        if l is not None:
            return l
        with self._lock:
            l = self._in.get(src_address)
            if l is None:
                l = _HalfLink(self.systems.get(src_address), self.system)
                l.ingress = self.system.engine.spawn_ingress(
                    _LinkFacade(ProxySystem(src_address), self.system)
                )
                self._in[src_address] = l
            return l

    def set_inbound_drop_filter(
        self, src_address: str, fn: Optional[Callable[[Any], bool]]
    ) -> None:
        """Fault injection at the receiving edge: fn(msg) -> True drops
        the message after decode, before the ingress tally (the same
        observable semantics as the in-process fabric's drop filter —
        the bytes 'arrived' but were never admitted).  Prefer a
        ``FaultPlan`` with ``drop_messages`` for new code; this remains
        as the minimal single-link hook."""
        self._in_link(src_address).drop_filter = fn

    # ------------------------------------------------------------- #
    # Delivery
    # ------------------------------------------------------------- #

    def _conn_for(self, address: str) -> Optional[_Conn]:
        # Lock-free: set/dict reads are atomic under the GIL, and the
        # worst stale read (a conn replaced or a crash verdict landing
        # concurrently) is indistinguishable from the frame having been
        # queued a moment earlier — the writer re-reads at flush time.
        if address in self.crashed:
            return None
        return self._conns.get(address)

    def deliver(self, src: "ActorSystem", target: ProxyCell, msg: Any) -> None:
        dst_address = target.system.address
        # Lock-free hot path (every lookup GIL-atomic, same reasoning
        # as _conn_for): this runs on EVERY remote send, so the
        # _conn_for/_out_link/_peer_state/_enqueue_job call chain is
        # inlined — a send is a handful of dict hits plus one deque
        # append.
        if dst_address in self.crashed:
            return
        st = self._peers.get(dst_address)
        link = self._out.get(dst_address)
        if st is None or link is None or dst_address not in self._conns:
            if self._conn_for(dst_address) is None:
                return
            link = self._out_link(dst_address)
            st = self._peer_state(dst_address)
        # Causal-tracing header (telemetry/tracing.py, the inline form
        # of wire.encode_trace_header): the context the engine stamped
        # on the envelope also rides the frame, OUTSIDE the payload
        # bytes, so the receiver can adopt it before (and regardless
        # of) payload decode.  Peers without tracing ignore the extra
        # element — see _deliver_app_run's tolerant unpack.
        header = getattr(msg, "trace_ctx", None)
        # The job carries the message OBJECT; the writer thread stamps
        # the egress window, claims the sequence number AND encodes the
        # payload at flush time, in queue order — senders pay one
        # lock-free deque append.  The stamp is part of the encoded
        # envelope, so the message must not be mutated after tell(),
        # the same snapshot discipline every serializing transport
        # imposes.
        outq = st.outq
        if len(outq) >= self._writer_high_water:
            self._enqueue_job(dst_address, st, ("a", link, target, msg, header))
            return
        outq.append(("a", link, target, msg, header))
        ev = st.out_ev
        if not ev.is_set():
            ev.set()
        if st.writer is None:
            self._start_writer(dst_address, st)

    def finalize_egress(self, src: "ActorSystem", dst_address: str) -> None:
        conn = self._conn_for(dst_address)
        if conn is None:
            return
        link = self._out_link(dst_address)
        if link.egress is None:
            return
        # The window roll happens ON the writer, in queue order: every
        # app message appended before this job is stamped with the
        # closing window, everything after it with the next one — the
        # same atomicity the old send-lock provided, without a lock.
        self._enqueue_job(
            dst_address, self._peer_state(dst_address), ("m", link)
        )

    def finalize_dead_link(self, src_address: str, dst: "ActorSystem") -> None:
        with self._lock:
            link = self._in.get(src_address)
        if link is None or link.ingress is None:
            return
        with link.recv_lock:
            link.ingress.finalize_all(is_final=True)
        events.recorder.commit(
            events.DEAD_LINK_FINALIZED, src=src_address, dst=self.address
        )

    def control_send(self, src: "ActorSystem", target_cell: Any, msg: Any) -> None:
        """Collector gossip: reliable, typed wire formats
        (reference: LocalGC.scala:201)."""
        from ..engines.crgc.collector import DeltaMsg, RemoteIngressEntry

        dst_address = target_cell.system.address
        if dst_address == self.address:
            target_cell.tell(msg)
            return
        conn = self._conn_for(dst_address)
        if conn is None:
            return
        if isinstance(msg, DeltaMsg):
            frame = ("delta", msg.seqnum, msg.graph.serialize(wire.encode_cell))
            cut = getattr(msg, "cut", None)
            if cut is not None:
                # A partitioned collector's stamped delta (DDelta): the
                # wave cut rides as trailing fields (see the module note).
                frame += (int(msg.fence), int(cut), int(msg.index))
        elif isinstance(msg, RemoteIngressEntry):
            frame = ("ringress", msg.entry.serialize(wire.encode_cell))
        else:
            frame = ("ctrl", wire.encode_message(msg))
        self._send_frame(dst_address, frame, conn)

    # ------------------------------------------------------------- #
    # Frame dispatch (receiver side)
    # ------------------------------------------------------------- #

    def _on_batch(self, from_address: str, entries: list) -> None:
        """Decode one ``"fb"`` unit: sequence accounting runs per inner
        frame in ONE pass under the receive lock (gap/duplicate
        semantics identical to the singleton path), then app frames are
        delivered to local cells in per-cell runs — a burst to one actor
        schedules one dispatcher batch instead of N."""
        st = self._peer_state(from_address)
        accepted: list = []
        corrupt = 0
        dup_seqs: list = []
        gap_counts: list = []
        with st.rlock:
            for seq, inner in entries:
                if inner is None:
                    # Pre-seq loss, exactly like a truncated singleton
                    # unit: the frame never reaches the seq layer, so a
                    # later frame raises the gap.
                    corrupt += 1
                    continue
                if inner[0] == "appr":
                    # Schema run: ONE frame slot consuming ``count``
                    # contiguous sequence numbers starting at ``seq``.
                    count = inner[3]
                    last = seq + count - 1
                    if last <= st.seq_in:
                        st.dups += count
                        dup_seqs.append((seq, count))
                        continue
                    if seq > st.seq_in + 1:
                        missed = seq - st.seq_in - 1
                        st.gaps += missed
                        gap_counts.append(missed)
                        skip = 0
                    else:
                        # Partial-overlap retransmit: the prefix up to
                        # seq_in was already delivered — discard it.
                        skip = st.seq_in + 1 - seq
                        if skip > 0:
                            st.dups += skip
                            dup_seqs.append((seq, skip))
                    st.seq_in = last
                    accepted.append(inner + (skip,))
                    continue
                if seq <= st.seq_in:
                    st.dups += 1
                    dup_seqs.append((seq, 1))
                    continue
                if seq > st.seq_in + 1:
                    missed = seq - st.seq_in - 1
                    st.gaps += missed
                    gap_counts.append(missed)
                st.seq_in = seq
                if inner[0] == "hb":
                    continue
                accepted.append(inner)
        for _ in range(corrupt):
            events.recorder.commit(events.FRAME_CORRUPT, src=from_address)
        for seq, count in dup_seqs:
            events.recorder.commit(
                events.FRAME_DUPLICATE, src=from_address, seq=seq, count=count
            )
        for missed in gap_counts:
            events.recorder.commit(
                events.FRAME_GAP, src=from_address, missed=missed
            )
        i = 0
        n = len(accepted)
        while i < n:
            inner = accepted[i]
            if inner[0] == "appr":
                try:
                    self._deliver_schema_run(from_address, inner)
                except Exception:  # pragma: no cover - keep the link alive
                    traceback.print_exc()
                i += 1
                continue
            if inner[0] != "app":
                try:
                    self._on_frame(from_address, inner)
                except Exception:  # pragma: no cover - keep the link alive
                    traceback.print_exc()
                i += 1
                continue
            uid = inner[1]
            j = i + 1
            while j < n and accepted[j][0] == "app" and accepted[j][1] == uid:
                j += 1
            try:
                self._deliver_app_run(from_address, uid, accepted[i:j])
            except Exception:  # pragma: no cover - keep the link alive
                traceback.print_exc()
            i = j

    def _deliver_app_run(
        self, from_address: str, uid: int, frames: List[tuple]
    ) -> None:
        """Deliver a run of app frames addressed to one uid: decode and
        filter each message, then tally and enqueue the surviving run
        under ONE ``recv_lock`` hold and one mailbox/scheduling pass.

        Each frame is (kind, uid, payload) with an optional trailing
        trace header — tolerant unpack, so frames from peers with or
        without tracing (or with future extra elements) all decode."""
        tel = self.system.telemetry
        tracing = tel is not None and tel.tracer.enabled
        msgs: list = []
        for frame in frames:
            try:
                msg = wire.decode_message(self, frame[2])
            except Exception:
                # One undecodable payload must not void the rest of the
                # run (the singleton path lost exactly one frame too).
                traceback.print_exc()
                continue
            if tracing:
                wire.apply_trace_header(
                    msg,
                    wire.decode_trace_header(frame[3] if len(frame) > 3 else None),
                )
            msgs.append(msg)
        self._admit_app_run(from_address, uid, msgs)

    def _deliver_schema_run(self, from_address: str, entry: tuple) -> None:
        """Decode one accepted schema-run entry — ``("appr", uid,
        schema_id, count, body, skip)`` — and deliver it.  The whole
        run decodes in ONE registry call; an unknown schema id or a
        mangled body is post-seq loss (the sequence numbers were
        already consumed, so the stream stays in step and exactly
        these messages are gone, like any truncated frame)."""
        _tag, uid, schema_id, count, body, skip = entry
        sch = wire_schema.registry.get(schema_id)
        msgs = None
        if sch is not None:
            try:
                msgs = sch.vec_decode(self, body)
            except Exception:
                traceback.print_exc()
                msgs = None
        if msgs is None or len(msgs) != count:
            events.recorder.commit(
                events.FRAME_CORRUPT, src=from_address, count=count
            )
            return
        if skip:
            msgs = msgs[skip:]
        self._admit_app_run(from_address, uid, msgs)

    def _admit_app_run(self, from_address: str, uid: int, msgs: list) -> None:
        """Filter, tally and enqueue a decoded run of app messages for
        one uid — the shared back half of the pickle and schema paths
        (drop filters, FaultPlan inbound drops, ingress accounting,
        dead-letter handling, batch mailbox delivery)."""
        link = self._in_link(from_address)
        plan = self.fault_plan
        if msgs and (link.drop_filter is not None or plan is not None):
            kept: list = []
            for msg in msgs:
                if link.drop_filter is not None and link.drop_filter(msg):
                    continue
                if plan is not None and plan.drop_inbound(
                    from_address, self.address, msg
                ):
                    events.recorder.commit(
                        events.FRAME_DROPPED,
                        src=from_address,
                        dst=self.address,
                        kind="app",
                    )
                    continue
                kept.append(msg)
            msgs = kept
        if not msgs:
            return
        cell = self.system.resolve_cell(uid)
        if cell is None:
            # Post-mortem frames: the recipient terminated and was
            # reclaimed.  The sender's egress already stamped these
            # sends into a window, so they MUST still tally on the
            # ingress (keyed by the stable tombstone proxy) or the
            # link's recv balance never returns to zero after the
            # sender dies; and the refs each message carries must be
            # released or their targets leak across processes.
            # record_dead_letter routes through the engine's
            # dead-letter accounting (CRGC.on_dead_letter).
            tombstone = self._proxy(self.address, uid)
            with link.recv_lock:
                if link.ingress is not None:
                    for msg in msgs:
                        link.ingress.on_message(tombstone, msg)
            # record_dead_letter emits the fabric.dead_letter event
            # (the tombstone's path carries the origin uid).
            for msg in msgs:
                self.system.record_dead_letter(tombstone, msg)
            return
        with link.recv_lock:
            ingress = link.ingress
            if ingress is not None:
                # Bulk tally when the gateway supports it: one call per
                # run, same per-message admission semantics.
                bulk = getattr(ingress, "on_messages", None)
                if bulk is not None:
                    bulk(cell, msgs)
                else:
                    for msg in msgs:
                        ingress.on_message(cell, msg)
            # enqueue under recv_lock keeps mailbox order consistent
            # with the ingress tally order (per-link FIFO all the way
            # down); tell_batch appends the whole run with one lock
            # acquisition and at most one dispatcher submission.
            if len(msgs) == 1 or not hasattr(cell, "tell_batch"):
                for msg in msgs:
                    cell.tell(msg)
            else:
                cell.tell_batch(msgs)

    def _on_frame(self, from_address: str, frame: tuple) -> None:
        kind = frame[0]
        if kind == "app":
            self._deliver_app_run(from_address, frame[1], [frame])
        elif kind == "marker":
            link = self._in_link(from_address)
            with link.recv_lock:
                if link.ingress is not None:
                    link.ingress.finalize_window(frame[1])
        elif kind == "delta":
            from ..engines.crgc.collector import DeltaMsg
            from ..engines.crgc.delta import DeltaGraph

            graph = DeltaGraph.deserialize(
                frame[2],
                self.system.engine.crgc_context,
                wire.make_decode_cell(self),
            )
            msg = DeltaMsg(frame[1], graph)
            if len(frame) >= 6:
                try:
                    fence, cut, index = (int(x) for x in frame[3:6])
                except (TypeError, ValueError):
                    pass  # malformed stamp: the plain delta's rule applies
                else:
                    from ..engines.crgc.distributed import DDelta

                    msg = DDelta(frame[1], graph, fence, cut, index)
            self.system.engine.bookkeeper_cell.tell(msg)
        elif kind == "ringress":
            from ..engines.crgc.collector import RemoteIngressEntry
            from ..engines.crgc.gateways import IngressEntry

            entry = IngressEntry.deserialize(frame[1], wire.make_decode_cell(self))
            self.system.engine.bookkeeper_cell.tell(RemoteIngressEntry(entry))
        elif kind == "ctrl":
            self.system.engine.bookkeeper_cell.tell(
                wire.decode_message(self, frame[1])
            )
        elif kind == "shmr":
            self._on_shm_request(from_address, frame)
        elif kind == "shma":
            self._on_shm_ack(from_address, frame)
        elif kind == "shmgo":
            # The peer's producer flipped to its ring: every socket
            # frame it sent before the flip has now been processed (we
            # are processing the marker in stream order), so the ring
            # consumer may open.
            st = self._peer_state(from_address)
            if st.shm_rx is not None:
                st.shm_rx_on = True
                st.shm_rx_ev.set()
                # Defensive: normally the reader was started by the
                # shmr/shma leg, but if that control frame was lost
                # (the transport's designed loss model applies to it)
                # the marker itself must be enough to get the ring
                # consumed — otherwise the peer's producer would fill
                # the ring and stall.
                self._start_shm_reader(from_address, st)
                events.recorder.commit(
                    events.SHM_ESTABLISHED, dst=from_address, role="consumer"
                )
        else:
            handler = self._frame_handlers.get(kind)
            if handler is not None:
                handler(from_address, frame)
            # else: unknown kind from a newer peer — ignored by design
            # (the seq layer already accounted the frame, so sequence
            # numbers stay in step with the sender).

    # ------------------------------------------------------------- #

    def die(self, reason: str = "injected") -> None:
        """Abrupt self-crash (fault injection): the engine stops acting
        immediately and every socket closes with only what the kernel
        already accepted — ``kill -9`` semantics without losing the
        process, so a test can still inspect the corpse.  Peers observe
        EOF (or heartbeat silence, if the plan muted the links first)."""
        if self._closing:
            return
        # Best-effort drain BEFORE the closing flag: frames that were
        # accepted before the crash point should reach the wire (the
        # pre-writer transport had already sendall()'d them), while
        # anything enqueued after this instant is lost — kill -9 loses
        # exactly the unflushed tail.
        self.flush_writers(timeout_s=1.0)
        self._closing = True  # suppress break handling during teardown
        events.recorder.commit(
            events.NODE_CRASHED, address=self.address, reason=reason
        )
        try:
            if self.system is not None:
                self.system.engine.on_crash()
        except Exception:  # pragma: no cover - death must not raise
            traceback.print_exc()
        self.close()

    def close(self) -> None:
        if not self._closing:
            # Graceful close drains what was already accepted: a frame
            # deliver() queued must not silently vanish on a healthy
            # link just because terminate ran first (the pre-writer
            # transport had sendall()'d it by now).  Dead links drain
            # fast — their writer pops and drops.  die() performs its
            # own (shorter) drain before setting the flag.
            self.flush_writers(timeout_s=2.0)
        self._closing = True
        with self._lock:
            peers = list(self._peers.values())
        for st in peers:  # wake writers + backpressured senders
            st.out_ev.set()
            with st.lock:
                st.out_cv.notify_all()
        if self._hb is not None:
            self._hb.stop()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            c.close()
        for st in peers:
            # Shm teardown: poison first (the peer's producer/consumer
            # observes it and falls back or exits), then close — the
            # creator side unlinks the segments; attached mappings
            # survive the unlink until their own close.
            if st.shm_rx is not None:
                with st.shm_rx_lock:
                    st.shm_rx_on = False
                st.shm_rx.poison()
                st.shm_rx.close()
            if st.shm_tx is not None:
                st.shm_tx.poison()
                st.shm_tx.close()
            st.shm_rx_ev.set()
            if st.decode_lane is not None:
                st.decode_lane.close()


class _LinkFacade:
    """The (src, dst) pair shape Egress/Ingress constructors read."""

    __slots__ = ("src", "dst")

    def __init__(self, src, dst):
        self.src = src
        self.dst = dst
