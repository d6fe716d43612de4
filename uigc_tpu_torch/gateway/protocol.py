"""Copy of ``uigc_tpu/gateway/protocol.py``, over the port's
``runtime/schema.py`` client value codec.

Client wire protocol: length-prefixed frames over the client value
codec, with a minimal websocket upgrade path.

A raw-TCP client frame is::

    u32 big-endian body length | op byte | client-value body

where the body rides :func:`uigc_tpu_torch.runtime.schema.decode_client_value`
— the hand-written tagged codec whose decoder can only ever raise
``ClientDecodeError`` on arbitrary input.  Untrusted client bytes NEVER
reach pickle or marshal on this plane (uigc-check UC401 verifies the
whole call graph statically).

A websocket client speaks the same ``op byte | body`` payload inside
RFC 6455 binary frames — the websocket layer supplies the length
framing, so the u32 prefix is dropped.  The upgrade is sniffed from the
first bytes of the connection (``GET `` starts an HTTP handshake; a
binary length prefix cannot), handled by :class:`TransportDecoder` so
the gateway's reader loop is transport-blind.

Ops (client->server unless noted)::

    CONNECT   {token, tenant, proto}    first frame on every connection
    AUTH_OK   {conn, proto}             server->client, admission passed
    SEND      {seq, type, key, cmd}     route cmd to entity (type, key)
    ACK       {seq, result}             server->client, entity replied
    SUBSCRIBE {type, key}               register for entity pushes
    PUSH      {data}                    server->client, unsolicited
    ERROR     {code, reason, retry_after_ms, seq}   server->client
    PING/PONG {}                        liveness, either direction
"""

from __future__ import annotations

import base64
import hashlib
import struct
from typing import Any, List, Optional, Tuple

from ..runtime import schema

# -- op codes -------------------------------------------------------- #

OP_CONNECT = 1
OP_AUTH_OK = 2
OP_SEND = 3
OP_ACK = 4
OP_SUBSCRIBE = 5
OP_PUSH = 6
OP_ERROR = 7
OP_PING = 8
OP_PONG = 9

_KNOWN_OPS = frozenset(
    (
        OP_CONNECT,
        OP_AUTH_OK,
        OP_SEND,
        OP_ACK,
        OP_SUBSCRIBE,
        OP_PUSH,
        OP_ERROR,
        OP_PING,
        OP_PONG,
    )
)

# -- ERROR codes (the ``code`` field of an ERROR frame) -------------- #

ERR_AUTH = 1  # bad/missing token
ERR_CONN_LIMIT = 2  # tenant or gateway connection cap
ERR_MSG_RATE = 3  # tenant msgs/s quota
ERR_OVERLOAD = 4  # overload controller is shedding
ERR_PROTO = 5  # malformed frame / protocol violation
ERR_TOO_LARGE = 6  # frame exceeded uigc.gateway.max-frame-bytes
ERR_DRAINING = 7  # gateway is draining for a rolling restart
ERR_UNAVAILABLE = 8  # no route to the entity plane
ERR_SLOW_CONSUMER = 9  # egress queue overflowed; connection closing

_LEN = struct.Struct(">I")

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class ProtocolError(ValueError):
    """A client violated the framing or value contract.  The only
    exception the decode path raises on arbitrary bytes — the reader
    turns it into an ERROR frame and a close, never a thread crash."""


# -- encode (server side; trees the gateway built itself) ------------ #


def encode_frame(op: int, value: Any) -> bytes:
    """One raw-TCP client frame: u32 length | op | client-value body."""
    body = encode_frame_body(op, value)
    return _LEN.pack(len(body)) + body


def encode_frame_body(op: int, value: Any) -> bytes:
    """The transport-independent part (op byte + body) — what rides
    inside a websocket binary frame."""
    return bytes((op,)) + schema.encode_client_value(value)


def encode_error(
    code: int,
    reason: str,
    retry_after_ms: int = 0,
    seq: Optional[int] = None,
) -> Tuple[int, dict]:
    """The structured ERROR frame every shed path emits: machine code,
    human reason, and a retry hint so well-behaved clients back off
    instead of hammering an overloaded edge."""
    body = {"code": int(code), "reason": str(reason)}
    if retry_after_ms:
        body["retry_after_ms"] = int(retry_after_ms)
    if seq is not None:
        body["seq"] = int(seq)
    return (OP_ERROR, body)


# -- decode (untrusted client bytes) --------------------------------- #


def decode_frame_body(body: bytes) -> Tuple[int, Any]:
    """op + client-value body -> (op, value); :class:`ProtocolError`
    on anything malformed."""
    if not body:
        raise ProtocolError("empty frame")
    op = body[0]
    if op not in _KNOWN_OPS:
        raise ProtocolError(f"unknown op {op}")
    try:
        value = schema.decode_client_value(body[1:]) if len(body) > 1 else None
    except schema.ClientDecodeError as exc:
        raise ProtocolError(str(exc)) from None
    return op, value


class _RawFraming:
    """Streaming u32-length-prefixed framing over a byte buffer."""

    __slots__ = ("buf", "max_frame")

    def __init__(self, max_frame: int) -> None:
        self.buf = bytearray()
        self.max_frame = max_frame

    def feed(self, data: bytes) -> List[bytes]:
        self.buf += data
        bodies: List[bytes] = []
        while len(self.buf) >= 4:
            (n,) = _LEN.unpack_from(self.buf, 0)
            if n > self.max_frame:
                raise ProtocolError(f"frame of {n} bytes exceeds limit")
            if len(self.buf) < 4 + n:
                break
            bodies.append(bytes(self.buf[4 : 4 + n]))
            del self.buf[: 4 + n]
        return bodies


class _WsFraming:
    """RFC 6455 server-side framing: masked client frames only, binary
    data, ping answered, no fragmentation (a fragmented client frame is
    a protocol error — the op/value payloads here are tiny)."""

    __slots__ = ("buf", "max_frame")

    def __init__(self, max_frame: int) -> None:
        self.buf = bytearray()
        self.max_frame = max_frame

    def feed(self, data: bytes) -> Tuple[List[bytes], bytes, bool]:
        """-> (protocol bodies, bytes to write back, peer closed)."""
        self.buf += data
        bodies: List[bytes] = []
        out = b""
        while True:
            if len(self.buf) < 2:
                return bodies, out, False
            b0, b1 = self.buf[0], self.buf[1]
            fin, opcode = b0 & 0x80, b0 & 0x0F
            masked, length = b1 & 0x80, b1 & 0x7F
            off = 2
            if length == 126:
                if len(self.buf) < 4:
                    return bodies, out, False
                length = int.from_bytes(self.buf[2:4], "big")
                off = 4
            elif length == 127:
                if len(self.buf) < 10:
                    return bodies, out, False
                length = int.from_bytes(self.buf[2:10], "big")
                off = 10
            if length > self.max_frame:
                raise ProtocolError(f"ws frame of {length} bytes exceeds limit")
            if not masked:
                raise ProtocolError("unmasked client ws frame")
            if len(self.buf) < off + 4 + length:
                return bodies, out, False
            mask = self.buf[off : off + 4]
            off += 4
            payload = bytes(
                c ^ mask[i & 3]
                for i, c in enumerate(self.buf[off : off + length])
            )
            del self.buf[: off + length]
            if opcode in (0x1, 0x2):
                if not fin:
                    raise ProtocolError("fragmented ws frame")
                bodies.append(payload)
            elif opcode == 0x8:  # close
                out += ws_server_frame(0x8, payload[:2])
                return bodies, out, True
            elif opcode == 0x9:  # ping -> pong
                out += ws_server_frame(0xA, payload)
            elif opcode == 0xA:  # pong: liveness only
                pass
            else:
                raise ProtocolError(f"unsupported ws opcode {opcode}")


def ws_server_frame(opcode: int, payload: bytes) -> bytes:
    """One unmasked (server->client) websocket frame."""
    header = bytearray((0x80 | opcode,))
    n = len(payload)
    if n < 126:
        header.append(n)
    elif n < 1 << 16:
        header.append(126)
        header += n.to_bytes(2, "big")
    else:
        header.append(127)
        header += n.to_bytes(8, "big")
    return bytes(header) + payload


def ws_accept_key(client_key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    digest = hashlib.sha1(client_key.strip().encode() + _WS_GUID).digest()
    return base64.b64encode(digest).decode()


def ws_handshake_response(request: bytes) -> bytes:
    """Parse a client's HTTP upgrade request; return the 101 response
    bytes or raise :class:`ProtocolError` when it is not a well-formed
    websocket upgrade."""
    try:
        head = request.decode("latin-1")
    except UnicodeDecodeError:  # pragma: no cover - latin-1 is total
        raise ProtocolError("undecodable handshake") from None
    headers = {}
    for line in head.split("\r\n")[1:]:
        name, sep, val = line.partition(":")
        if sep:
            headers[name.strip().lower()] = val.strip()
    if "websocket" not in headers.get("upgrade", "").lower():
        raise ProtocolError("not a websocket upgrade")
    key = headers.get("sec-websocket-key")
    if not key:
        raise ProtocolError("missing Sec-WebSocket-Key")
    return (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {ws_accept_key(key)}\r\n"
        "\r\n"
    ).encode("latin-1")


class TransportDecoder:
    """Per-connection transport sniffing + framing + frame decode.

    The reader loop feeds raw socket bytes and gets back decoded
    ``(op, value)`` frames plus any bytes the transport owes the client
    (websocket handshake response, pong replies).  The first bytes pick
    the mode: an HTTP ``GET `` starts the websocket upgrade; anything
    else is the native u32-prefixed framing (a binary length prefix can
    never collide with ASCII ``GET ``).
    """

    __slots__ = ("max_frame", "mode", "_framing", "_hsbuf", "websocket")

    #: Upgrade requests longer than this are a slowloris, not a client.
    _MAX_HANDSHAKE = 8192

    def __init__(self, max_frame: int) -> None:
        self.max_frame = max_frame
        self.mode = "sniff"
        self._framing: Any = None
        self._hsbuf = bytearray()
        self.websocket = False

    def feed(self, data: bytes) -> Tuple[List[Tuple[int, Any]], bytes, bool]:
        """-> (decoded frames, bytes to write back, peer closed).
        Raises :class:`ProtocolError`; the caller sheds and closes."""
        out = b""
        if self.mode in ("sniff", "ws-handshake"):
            self._hsbuf += data
        if self.mode == "sniff":
            if len(self._hsbuf) < 4:
                return [], b"", False
            if bytes(self._hsbuf[:4]) == b"GET ":
                self.mode = "ws-handshake"
            else:
                self.mode = "raw"
                self._framing = _RawFraming(self.max_frame)
                data, self._hsbuf = bytes(self._hsbuf), bytearray()
        if self.mode == "ws-handshake":
            if len(self._hsbuf) > self._MAX_HANDSHAKE:
                raise ProtocolError("oversized websocket handshake")
            end = self._hsbuf.find(b"\r\n\r\n")
            if end < 0:
                return [], b"", False
            out += ws_handshake_response(bytes(self._hsbuf[:end]))
            rest = bytes(self._hsbuf[end + 4 :])
            self._hsbuf = bytearray()
            self.mode = "ws"
            self.websocket = True
            self._framing = _WsFraming(self.max_frame)
            data = rest
        if self.mode == "ws":
            bodies, extra, closed = self._framing.feed(data)
            out += extra
        else:
            bodies, closed = self._framing.feed(data), False
        return [decode_frame_body(b) for b in bodies], out, closed

    def encode(self, op: int, value: Any) -> bytes:
        """Server->client frame bytes in this connection's transport."""
        body = encode_frame_body(op, value)
        if self.websocket:
            return ws_server_frame(0x2, body)
        return _LEN.pack(len(body)) + body
