"""Copy of ``uigc_tpu/gateway/session.py``, over the port's
``runtime/wire.py``.

Per-connection session state and the reply path back to clients.

A :class:`Session` is everything the gateway holds for one admitted
connection: the transport decoder, the tenant it authenticated as, the
bounded egress queue entity replies drain through, and the throttle
flag the backpressure plane flips.

A :class:`ClientRef` is the cluster-side handle for a connection — the
``reply_to`` the gateway embeds in every routed command.  It crosses
node boundaries as a tiny ``("gwclient", gateway_address, conn_id)``
persistent id (runtime/wire.py) and re-binds to the receiving node's
fabric, so an entity three hops away replies with one ``tell`` and the
frame rides the ordinary node fabric back to the gateway that owns the
socket.  Entities never see sockets; gateways never see entity state.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..runtime import wire
from .protocol import TransportDecoder


class ClientRef:
    """Location-transparent reply handle for one client connection.

    ``tell(msg)`` encodes the message on the node plane (trusted
    pickle/schema — this is fabric traffic between cluster members, not
    client bytes) and ships it to the owning gateway as a ``"gwr"``
    frame; the gateway translates it into an ACK or PUSH client frame
    and enqueues it on the connection's bounded egress queue."""

    __slots__ = ("gateway_address", "conn_id", "_fabric")

    def __init__(self, gateway_address: str, conn_id: int, fabric: Any = None):
        self.gateway_address = gateway_address
        self.conn_id = int(conn_id)
        self._fabric = fabric

    def bind(self, fabric: Any) -> "ClientRef":
        self._fabric = fabric
        return self

    def tell(self, msg: Any) -> bool:
        fabric = self._fabric
        if fabric is None:
            return False
        send = getattr(fabric, "send_frame", None)
        if send is not None and getattr(fabric, "address", None) != self.gateway_address:
            return bool(
                send(
                    self.gateway_address,
                    wire.encode_gateway_reply(
                        self.conn_id, wire.encode_message(msg)
                    ),
                )
            )
        # In-memory fabric (tests) or a reply born on the gateway's own
        # node: hand the decoded message straight to the gateway.
        systems = getattr(fabric, "systems", None)
        system = systems.get(self.gateway_address) if systems else None
        gateway = getattr(system, "gateway", None)
        if gateway is None:
            return False
        gateway.deliver_reply(self.conn_id, msg)
        return True

    def __eq__(self, other: Any) -> bool:
        return (
            type(other) is ClientRef
            and other.gateway_address == self.gateway_address
            and other.conn_id == self.conn_id
        )

    def __hash__(self) -> int:
        return hash((self.gateway_address, self.conn_id))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ClientRef({self.gateway_address!r}, {self.conn_id})"


class Session:
    """One admitted client connection's gateway-side state."""

    __slots__ = (
        "conn_id",
        "sock",
        "decoder",
        "tenant",
        "authenticated",
        "ref",
        "egress",
        "egress_limit",
        "outbuf",
        "instash",
        "throttled",
        "closing",
        "reader_idx",
        "msgs_in",
        "replies_out",
        "opened_at",
    )

    def __init__(
        self,
        conn_id: int,
        sock: Any,
        max_frame: int,
        egress_limit: int,
        reader_idx: int,
    ) -> None:
        self.conn_id = conn_id
        self.sock = sock
        self.decoder = TransportDecoder(max_frame)
        self.tenant: Optional[str] = None
        self.authenticated = False
        #: the ClientRef embedded in every routed command; bound by the
        #: gateway once the connection authenticates
        self.ref: Optional[ClientRef] = None
        # unbounded: explicitly bounded by ``egress_limit`` in
        # enqueue() — overflow must surface as a slow-consumer shed
        # (accounted, connection closed), never a silent maxlen drop
        # of an already-acked reply.
        self.egress: deque = deque()
        self.egress_limit = egress_limit
        self.outbuf = b""
        #: inbound bytes parked by the slowloris fault unit (the reader
        #: re-feeds them one byte per round)
        self.instash = b""
        self.throttled = False
        self.closing = False
        self.reader_idx = reader_idx
        self.msgs_in = 0
        self.replies_out = 0
        self.opened_at = time.monotonic()

    def enqueue(self, frame_bytes: bytes) -> bool:
        """Queue server->client bytes; False when the egress bound is
        hit (slow consumer — the caller sheds and closes)."""
        if self.egress_limit and len(self.egress) >= self.egress_limit:
            return False
        self.egress.append(frame_bytes)
        return True

    def egress_depth(self) -> int:
        return len(self.egress)

    def encode(self, op: int, value: Any) -> bytes:
        return self.decoder.encode(op, value)


def bin_by_home(cluster: Any, sends: List[Tuple[str, str, Any]]) -> Dict[Optional[str], List[Tuple[str, str, Any]]]:
    """Propagation blocking one layer up: bin decoded commands by the
    destination key's CURRENT home node, so the flush walks one node at
    a time and consecutive ``route()`` calls coalesce into the per-peer
    writer's fb batches — dense per-node bursts instead of scattered
    singles (the HAPB binning idea applied at the edge).

    ``None`` bins commands whose key has no resolvable home yet (table
    still converging); ``route()`` defers those internally."""
    bins: Dict[Optional[str], List[Tuple[str, str, Any]]] = {}
    for type_name, key, payload in sends:
        try:
            home = cluster.home_of(key)
        except Exception:
            home = None
        bins.setdefault(home, []).append((type_name, key, payload))
    return bins
