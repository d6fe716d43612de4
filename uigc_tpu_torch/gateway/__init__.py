"""Copy of ``uigc_tpu/gateway/__init__.py`` (the same ``__all__``).
Nothing else of the port imports this package at load time:
``import uigc_tpu_torch`` leaves it unloaded.

Ingress gateway: the client-facing edge of the sharded entity plane.

Every other plane in this repo is node-to-node fabric between mutually
trusted cluster members.  This package is the front door: a node type
that terminates client connections (plain TCP framing or a minimal
websocket upgrade), admits them through token auth / tenant quotas /
an overload controller, and routes decoded commands into the sharded
entity plane — propagation-block binned per destination shard so the
edge feeds the cluster dense per-node bursts, not scattered singles.

Layer map:

- :mod:`.protocol` — length-prefixed client framing over the
  hostile-input-safe client value codec (``runtime/schema.py``);
  untrusted bytes NEVER reach pickle or marshal (uigc-check UC401
  proves it statically).
- :mod:`.admission` — token auth, per-tenant connection and msg/s
  quotas, and the overload controller that load-sheds with clean
  ERROR(retry-after) frames.
- :mod:`.session` — per-connection state: the :class:`ClientRef`
  reply handle entities tell, the bounded egress queue, per-shard
  command bins.
- :mod:`.gateway` — the :class:`IngressGateway` node: accept thread,
  selector-based reader loops, backpressure-to-socket read throttling,
  drain for rolling restarts.
"""

from .admission import OverloadController, TenantQuotas, TokenAuth
from .gateway import IngressGateway
from .protocol import (
    OP_ACK,
    OP_AUTH_OK,
    OP_CONNECT,
    OP_ERROR,
    OP_PING,
    OP_PONG,
    OP_PUSH,
    OP_SEND,
    OP_SUBSCRIBE,
    ProtocolError,
    TransportDecoder,
    encode_error,
    encode_frame,
)
from .session import ClientRef, Session

__all__ = [
    "ClientRef",
    "IngressGateway",
    "OP_ACK",
    "OP_AUTH_OK",
    "OP_CONNECT",
    "OP_ERROR",
    "OP_PING",
    "OP_PONG",
    "OP_PUSH",
    "OP_SEND",
    "OP_SUBSCRIBE",
    "OverloadController",
    "ProtocolError",
    "Session",
    "TenantQuotas",
    "TokenAuth",
    "TransportDecoder",
    "encode_error",
    "encode_frame",
]
