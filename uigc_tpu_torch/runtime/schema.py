"""Copy of ``uigc_tpu/runtime/schema.py`` (pure Python); its lazy
envelope imports resolve to the port's engines.

Schema-native wire codec: fixed binary envelopes for known message
schemas, negotiated per link, with pickle as the universal fallback.

The transport moved payload encoding off every sender thread onto the per-peer
writer, but the encoding itself stayed pickle: a full protocol dispatch
through ``persistent_id`` per object, per message.  This module replaces
that on the hot path for *known* message shapes:

- the **envelope** (CRGC ``AppMsg`` / MAC ``MacAppMsg`` bookkeeping:
  window id, external flag, carried refs) is struct-packed into a fixed
  binary layout — no protocol machinery at all;
- the **payload** rides the *value plane*: ``marshal`` (CPython's C
  serializer for code objects) over a payload tree that a cheap
  exact-type walk has proven to contain only plain scalar/container
  types.  The walk is the safety gate: ``marshal`` would silently
  flatten a namedtuple (or any tuple/list/dict subclass) into its base
  container, so anything that is not *exactly* a builtin value type
  falls back to pickle, which preserves classes;
- a **run** form batch-encodes K consecutive messages to one recipient
  as ONE marshal call (the propagation-blocking idea from the trace
  plane applied to the codec: bin by destination, then vectorize) —
  the per-message Python cost collapses to the safety walk.

Negotiation follows the ``"fb"`` discipline exactly: the hello's caps
tuple grows one element (:func:`capability`), tolerant in both
directions.  The element pins the schema-table version AND the
interpreter version, because the value plane is marshal: a peer whose
cap does not match ours byte-for-byte simply gets pickle, so
mixed-version links keep working and a schema this build does not know
can never reach the wire.  Schema ids the peer did not advertise are
never used toward it (:func:`peer_schema_ids`).

Security note: the value plane is only ever decoded on frames from a
handshaken peer — the same trust domain as the pickle fallback (which
is strictly more powerful), so this narrows, never widens, what a peer
can make us execute.
"""

from __future__ import annotations

import marshal
import struct
import sys
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, List, Optional, Tuple

if TYPE_CHECKING:  # pragma: no cover
    from .fabric import Fabric

# ------------------------------------------------------------------- #
# The value plane: exact-type-gated marshal
# ------------------------------------------------------------------- #

#: Types the value plane accepts as-is.  EXACT types only — subclasses
#: (namedtuples, IntEnum, bool-like flags, dict subclasses) would lose
#: their class through marshal, so they are rejected by the walk and
#: travel by pickle instead.
_SCALARS = (type(None), bool, int, float, str, bytes)
_SCALAR_SET = frozenset(_SCALARS)

#: marshal ints are bounded on some builds; anything outside int64
#: falls back to pickle so the bound never matters on the wire.
_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1


def value_safe(value: Any, _depth: int = 0) -> bool:
    """True when ``value`` is a tree of *exactly* builtin value types
    (the marshal-safe closed set).  This is the schema codec's
    admission gate; everything else pickles.

    The scalar checks for container CHILDREN are inlined rather than
    recursive: this walk runs once per message on the writer's hot
    loop, and a flat tuple — the dominant message shape — must cost
    one call, not one per element."""
    t = type(value)
    if t in _SCALAR_SET:
        return t is not int or (_I64_MIN <= value <= _I64_MAX)
    if _depth > 16:
        return False
    scalars = _SCALAR_SET
    if t is tuple or t is list:
        for item in value:
            ti = type(item)
            if ti in scalars:
                if ti is int and not (_I64_MIN <= item <= _I64_MAX):
                    return False
            elif not value_safe(item, _depth + 1):
                return False
        return True
    if t is dict:
        for k, v in value.items():
            tk = type(k)
            if tk in scalars:
                if tk is int and not (_I64_MIN <= k <= _I64_MAX):
                    return False
            elif not value_safe(k, _depth + 1):
                return False
            tv = type(v)
            if tv in scalars:
                if tv is int and not (_I64_MIN <= v <= _I64_MAX):
                    return False
            elif not value_safe(v, _depth + 1):
                return False
        return True
    return False


def encode_value(value: Any) -> bytes:
    """marshal the (pre-gated) value.  Callers must have passed
    :func:`value_safe` first."""
    return marshal.dumps(value, 4)


def decode_value(data: bytes) -> Any:
    return marshal.loads(data)


# ------------------------------------------------------------------- #
# Ref tokens (the envelope plane's cross-heap handles)
# ------------------------------------------------------------------- #

_TOKEN_HDR = struct.Struct(">HQ")  # (len(address), uid)


def _pack_cell_token(parts: List[bytes], cell: Any) -> None:
    address = cell.system.address.encode()
    parts.append(_TOKEN_HDR.pack(len(address), cell.uid))
    parts.append(address)


def _unpack_cell_token(body: bytes, off: int) -> Tuple[str, int, int]:
    alen, uid = _TOKEN_HDR.unpack_from(body, off)
    off += _TOKEN_HDR.size
    address = body[off : off + alen].decode()
    return address, uid, off + alen


def _resolve_cell(fabric: "Fabric", address: str, uid: int):
    hook = getattr(fabric, "resolve_cell_token", None)
    if hook is not None:
        return hook(address, uid)
    system = fabric.systems.get(address)
    if system is None:
        raise LookupError(f"unknown system {address!r} on this fabric")
    cell = system.resolve_cell(uid)
    if cell is None:
        raise LookupError(f"no cell uid={uid} in {address!r}")
    return cell


# ------------------------------------------------------------------- #
# Schema registry
# ------------------------------------------------------------------- #


class Schema:
    """One registered message schema: an exact envelope type, a probe/
    encode pair and the matching decode, plus the vectorized run forms.

    ``probe(msg)`` is the cheap run-admission gate: True means the
    instance WILL encode under the vectorized form, so ``vec_encode``
    may trust its inputs and skip per-message re-validation (one
    safety walk per message, not two).  ``encode`` is the standalone
    single-message form and carries its own checks."""

    __slots__ = (
        "schema_id",
        "type_name",
        "probe",
        "encode",
        "decode",
        "vec_encode",
        "vec_decode",
    )

    def __init__(
        self,
        schema_id: int,
        type_name: str,
        probe: Callable[[Any], bool],
        encode: Callable[[Any], Optional[bytes]],
        decode: Callable[["Fabric", bytes], Any],
        vec_encode: Callable[[List[Any]], Optional[bytes]],
        vec_decode: Callable[["Fabric", bytes], List[Any]],
    ):
        self.schema_id = schema_id
        self.type_name = type_name
        self.probe = probe
        self.encode = encode
        self.decode = decode
        self.vec_encode = vec_encode
        self.vec_decode = vec_decode


class SchemaRegistry:
    """schema_id -> Schema, plus the exact-envelope-type dispatch used
    on the encode side.  ``register`` is open for future message shapes;
    ids < 64 are reserved for the built-ins below."""

    def __init__(self) -> None:
        self._by_id: Dict[int, Schema] = {}
        self._by_type: Dict[type, Schema] = {}

    def register(self, schema: Schema, envelope_type: Optional[type] = None) -> Schema:
        self._by_id[schema.schema_id] = schema
        if envelope_type is not None:
            self._by_type[envelope_type] = schema
        return schema

    def ids(self) -> Tuple[int, ...]:
        return tuple(sorted(self._by_id))

    def get(self, schema_id: int) -> Optional[Schema]:
        return self._by_id.get(schema_id)

    def for_message(self, msg: Any) -> Optional[Schema]:
        """The schema that *may* encode ``msg`` (by exact envelope
        type); the schema's own encode still returns None when the
        instance does not fit (e.g. an unencodable payload)."""
        return self._by_type.get(type(msg))


# ------------------------------------------------------------------- #
# Built-in schemas
# ------------------------------------------------------------------- #

SCHEMA_VAL = 1  # a bare value-plane message (unmanaged/raw sends)
SCHEMA_CRGC_APP = 2  # CRGC AppMsg envelope
SCHEMA_MAC_APP = 3  # MAC MacAppMsg envelope
SCHEMA_DIST_KEYS = 4  # distributed-collector boundary-mark key sets


# ------------------------------------------------------------------- #
# Key-set codec (the distributed collector's dmark payload plane)
#
# A boundary-mark set is a set of (address, uid) actor coordinates.
# Legacy peers ship them as JSON ``[[address, uid], ...]`` lists — ~29
# bytes per key on the wire.  This codec groups keys per address and
# encodes each group's uid set density-switched:
#
#   payload := 0x01 varint(n_groups) group*
#   group   := varint(len(addr)) addr 'B' varint(base) varint(span)
#              varint(len(bits)) bits                        (bitmap)
#            | varint(len(addr)) addr 'V' varint(n)
#              varint(first) varint(delta)*                  (varint)
#
# The bitmap form wins for dense uid ranges (one BIT per key); the
# delta-varint form wins for sparse sets (~1-2 bytes per key).  The
# switch is deterministic: bitmap iff its byte size is smaller than
# the group's key count (the varint form's lower bound).  The leading
# 0x01 byte can never begin a JSON list (b"["), so a decoder can
# dispatch legacy JSON and this format from the first byte
# (:func:`decode_keyset_any`) — the mixed-version story: a legacy peer's
# JSON payload still decodes, and this format is only ever SENT to a
# peer whose hello advertised :data:`SCHEMA_DIST_KEYS`.
# ------------------------------------------------------------------- #

KEYSET_MAGIC = 0x01


def _put_varint(parts: List[bytes], value: int) -> None:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    parts.append(bytes(out))


def _get_varint(data: bytes, off: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def encode_keyset(keys: Iterable[Tuple[str, int]]) -> bytes:
    """Binary key-set payload (see the format block above)."""
    groups: Dict[str, List[int]] = {}
    for address, uid in keys:
        groups.setdefault(address, []).append(int(uid))
    parts: List[bytes] = [bytes([KEYSET_MAGIC])]
    _put_varint(parts, len(groups))
    for address in sorted(groups):
        uids = sorted(set(groups[address]))
        addr = address.encode()
        _put_varint(parts, len(addr))
        parts.append(addr)
        base, last = uids[0], uids[-1]
        span = last - base + 1
        bitmap_bytes = (span + 7) // 8
        if bitmap_bytes < len(uids):
            bits = 0
            for uid in uids:
                bits |= 1 << (uid - base)
            raw = bits.to_bytes(bitmap_bytes, "little")
            parts.append(b"B")
            _put_varint(parts, base)
            _put_varint(parts, span)
            _put_varint(parts, len(raw))
            parts.append(raw)
        else:
            parts.append(b"V")
            _put_varint(parts, len(uids))
            prev = 0
            for uid in uids:
                _put_varint(parts, uid - prev)
                prev = uid
    return b"".join(parts)


def decode_keyset(data: bytes) -> Optional[List[Tuple[str, int]]]:
    """-> [(address, uid), ...] or None when malformed."""
    try:
        if not data or data[0] != KEYSET_MAGIC:
            return None
        keys: List[Tuple[str, int]] = []
        n_groups, off = _get_varint(data, 1)
        for _ in range(n_groups):
            alen, off = _get_varint(data, off)
            address = data[off : off + alen].decode()
            if len(address.encode()) != alen:
                return None
            off += alen
            mode = data[off : off + 1]
            off += 1
            if mode == b"B":
                base, off = _get_varint(data, off)
                span, off = _get_varint(data, off)
                blen, off = _get_varint(data, off)
                raw = data[off : off + blen]
                if len(raw) != blen:
                    return None
                off += blen
                bits = int.from_bytes(raw, "little")
                if bits >> span:
                    return None
                while bits:
                    low = bits & -bits
                    keys.append((address, base + low.bit_length() - 1))
                    bits ^= low
            elif mode == b"V":
                count, off = _get_varint(data, off)
                uid = 0
                for _ in range(count):
                    delta, off = _get_varint(data, off)
                    uid += delta
                    keys.append((address, uid))
            else:
                return None
        return keys
    except (IndexError, UnicodeDecodeError, OverflowError):
        return None


def encode_keyset_json(keys: Iterable[Tuple[str, int]]) -> bytes:
    """The legacy wire shape, kept as the legacy-peer fallback: only a
    peer whose hello advertised :data:`SCHEMA_DIST_KEYS` receives the
    binary form."""
    import json

    return json.dumps([[a, int(u)] for a, u in keys]).encode()


def decode_keyset_any(data: bytes) -> Optional[List[Tuple[str, int]]]:
    """Dispatch on the first byte: binary key-set or legacy JSON
    coordinate list — tolerant both directions, None when neither."""
    if not isinstance(data, bytes) or not data:
        return None
    if data[0] == KEYSET_MAGIC:
        return decode_keyset(data)
    import json

    try:
        raw = json.loads(data)
    except ValueError:
        return None
    if not isinstance(raw, list):
        return None
    keys = []
    for item in raw:
        try:
            keys.append((str(item[0]), int(item[1])))
        except (IndexError, TypeError, ValueError):
            return None
    return keys

# ------------------------------------------------------------------- #
# Client value codec (the gateway's untrusted-byte value plane)
#
# The node-plane value codec above is marshal — fine between handshaken
# peers, never acceptable on bytes from a client socket: marshal.loads
# on attacker input can crash the interpreter.  Client frame bodies
# therefore ride this hand-written tagged encoding instead, decoded by
# pure Python index arithmetic that can only ever raise
# :class:`ClientDecodeError`:
#
#   value := 'N' | 'T' | 'F'                      (None / True / False)
#          | 'i' varint(zigzag(v))                (int, arbitrary size)
#          | 'f' 8-byte big-endian IEEE double    (float)
#          | 's' varint(len) utf8-bytes           (str)
#          | 'b' varint(len) raw-bytes            (bytes)
#          | 'l' varint(count) value*             (list)
#          | 'd' varint(count) (value value)*     (dict)
#
# Depth is capped at 16 (mirroring :func:`value_safe`), container
# counts are sanity-bounded by the remaining byte budget (each element
# costs >= 1 byte, so a count larger than what is left is malformed by
# construction — no attacker-controlled giant preallocation), and int
# varints are capped at 10 bytes.  Tuples encode as lists: the client
# plane has no tuple/list distinction.
# ------------------------------------------------------------------- #

#: Client frames above this decoded-container depth are malformed.
CLIENT_MAX_DEPTH = 16

#: Longest accepted int varint (70 bits pre-zigzag: covers int64 with
#: headroom; anything longer is a resource-exhaustion probe).
_CLIENT_MAX_INT_BYTES = 10


class ClientDecodeError(ValueError):
    """A client frame body failed to decode.  The ONLY exception the
    client value plane raises on arbitrary input — callers turn it into
    a protocol ERROR frame, never a connection-thread crash."""


def encode_client_value(value: Any, _depth: int = 0) -> bytes:
    """Encode a tree of plain values for the client wire (format block
    above).  Raises ``TypeError`` on non-value types — the gateway only
    ever encodes trees it built itself."""
    parts: List[bytes] = []
    _put_client_value(parts, value, _depth)
    return b"".join(parts)


def _put_client_value(parts: List[bytes], value: Any, depth: int) -> None:
    if value is None:
        parts.append(b"N")
        return
    t = type(value)
    if t is bool:
        parts.append(b"T" if value else b"F")
    elif t is int:
        zz = _zigzag(value)
        if zz.bit_length() > 7 * _CLIENT_MAX_INT_BYTES:
            raise TypeError("client value int out of range")
        parts.append(b"i")
        _put_varint(parts, zz)
    elif t is float:
        parts.append(b"f")
        parts.append(struct.pack(">d", value))
    elif t is str:
        raw = value.encode()
        parts.append(b"s")
        _put_varint(parts, len(raw))
        parts.append(raw)
    elif t is bytes:
        parts.append(b"b")
        _put_varint(parts, len(value))
        parts.append(value)
    elif t is list or t is tuple:
        if depth >= CLIENT_MAX_DEPTH:
            raise TypeError("client value tree too deep")
        parts.append(b"l")
        _put_varint(parts, len(value))
        for item in value:
            _put_client_value(parts, item, depth + 1)
    elif t is dict:
        if depth >= CLIENT_MAX_DEPTH:
            raise TypeError("client value tree too deep")
        parts.append(b"d")
        _put_varint(parts, len(value))
        for k, v in value.items():
            _put_client_value(parts, k, depth + 1)
            _put_client_value(parts, v, depth + 1)
    else:
        raise TypeError(f"client value plane cannot encode {t.__name__}")


def _zigzag(value: int) -> int:
    return -2 * value - 1 if value < 0 else value << 1


def decode_client_value(data: bytes) -> Any:
    """Decode one client value; raises :class:`ClientDecodeError` on
    any malformation, including trailing bytes."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise ClientDecodeError("client body is not bytes")
    data = bytes(data)
    try:
        value, off = _get_client_value(data, 0, 0)
    except (IndexError, struct.error, UnicodeDecodeError) as exc:
        raise ClientDecodeError(f"malformed client value: {exc}") from None
    if off != len(data):
        raise ClientDecodeError("trailing bytes after client value")
    return value


def _get_client_varint(data: bytes, off: int) -> Tuple[int, int]:
    # _get_varint with a length cap: unbounded continuation bytes are
    # an attacker-controlled big-int allocation.
    result = shift = n = 0
    while True:
        b = data[off]
        off += 1
        n += 1
        if n > _CLIENT_MAX_INT_BYTES:
            raise ClientDecodeError("client varint too long")
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _get_client_value(data: bytes, off: int, depth: int) -> Tuple[Any, int]:
    if depth > CLIENT_MAX_DEPTH:
        raise ClientDecodeError("client value tree too deep")
    tag = data[off : off + 1]
    if not tag:
        raise ClientDecodeError("truncated client value")
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"i":
        zz, off = _get_client_varint(data, off)
        return (zz >> 1) ^ -(zz & 1), off
    if tag == b"f":
        (value,) = struct.unpack_from(">d", data, off)
        return value, off + 8
    if tag == b"s":
        n, off = _get_client_varint(data, off)
        raw = data[off : off + n]
        if len(raw) != n:
            raise ClientDecodeError("truncated client string")
        return raw.decode(), off + n
    if tag == b"b":
        n, off = _get_client_varint(data, off)
        raw = data[off : off + n]
        if len(raw) != n:
            raise ClientDecodeError("truncated client bytes")
        return raw, off + n
    if tag == b"l":
        count, off = _get_client_varint(data, off)
        if count > len(data) - off:
            raise ClientDecodeError("client list count exceeds body")
        items = []
        for _ in range(count):
            item, off = _get_client_value(data, off, depth + 1)
            items.append(item)
        return items, off
    if tag == b"d":
        count, off = _get_client_varint(data, off)
        if count * 2 > len(data) - off:
            raise ClientDecodeError("client dict count exceeds body")
        out = {}
        for _ in range(count):
            k, off = _get_client_value(data, off, depth + 1)
            if not isinstance(k, (str, int, bool, float, bytes, type(None))):
                raise ClientDecodeError("unhashable client dict key")
            v, off = _get_client_value(data, off, depth + 1)
            out[k] = v
        return out, off
    raise ClientDecodeError(f"unknown client value tag {tag!r}")


_APP_HDR = struct.Struct(">qBH")  # (window_id, flags, n_refs)

_CRGC_CLASSES: Optional[tuple] = None


def _crgc_classes() -> tuple:
    global _CRGC_CLASSES
    if _CRGC_CLASSES is None:
        from ..engines.crgc.messages import AppMsg
        from ..engines.crgc.refob import CrgcRefob

        _CRGC_CLASSES = (AppMsg, CrgcRefob)
    return _CRGC_CLASSES


_MAC_CLASSES: Optional[tuple] = None


def _mac_classes() -> tuple:
    global _MAC_CLASSES
    if _MAC_CLASSES is None:
        from ..engines.mac.engine import MacAppMsg, MacRefob

        _MAC_CLASSES = (MacAppMsg, MacRefob)
    return _MAC_CLASSES


def _encode_val(msg: Any) -> Optional[bytes]:
    if not value_safe(msg):
        return None
    return encode_value(msg)


def _decode_val(fabric: "Fabric", body: bytes) -> Any:
    return decode_value(body)


def _vec_encode_val(msgs: List[Any]) -> Optional[bytes]:
    # Inputs pre-gated by probe (= value_safe) on the run-admission path.
    return encode_value(msgs)


def _vec_decode_val(fabric: "Fabric", body: bytes) -> List[Any]:
    out = decode_value(body)
    if type(out) is not list:
        raise ValueError("schema run body did not decode to a list")
    return out


def _refs_tokens(refs: tuple, refob_type: type) -> Optional[List[Any]]:
    """The ref targets of an app envelope, or None when any ref is not
    the engine's own refob over a token-able cell."""
    cells = []
    for ref in refs:
        if type(ref) is not refob_type:
            return None
        target = getattr(ref, "target", None)
        system = getattr(target, "system", None)
        if target is None or system is None:
            return None
        cells.append(target)
    return cells


def _encode_app(msg: Any, window_id: int, flags: int, refs: tuple, refob_type: type) -> Optional[bytes]:
    payload = msg.payload
    if not value_safe(payload):
        return None
    cells = _refs_tokens(refs, refob_type)
    if cells is None or len(cells) > 0xFFFF:
        return None
    if not (_I64_MIN <= window_id <= _I64_MAX):
        return None
    parts: List[bytes] = [_APP_HDR.pack(window_id, flags, len(cells))]
    for cell in cells:
        _pack_cell_token(parts, cell)
    parts.append(encode_value(payload))
    return b"".join(parts)


def _decode_app_header(fabric: "Fabric", body: bytes):
    window_id, flags, n_refs = _APP_HDR.unpack_from(body, 0)
    off = _APP_HDR.size
    cells = []
    for _ in range(n_refs):
        address, uid, off = _unpack_cell_token(body, off)
        cells.append(_resolve_cell(fabric, address, uid))
    return window_id, flags, cells, off


def _encode_crgc_app(msg: Any) -> Optional[bytes]:
    AppMsg, CrgcRefob = _crgc_classes()
    return _encode_app(
        msg, msg.window_id, 1 if msg.external else 0, msg._refs, CrgcRefob
    )


def _decode_crgc_app(fabric: "Fabric", body: bytes) -> Any:
    AppMsg, CrgcRefob = _crgc_classes()
    window_id, flags, cells, off = _decode_app_header(fabric, body)
    msg = AppMsg(
        decode_value(body[off:]),
        [CrgcRefob(cell) for cell in cells],
        external=bool(flags & 1),
    )
    msg.window_id = window_id
    return msg


def _probe_crgc_app(msg: Any) -> bool:
    return (
        not msg._refs
        and _I64_MIN <= msg.window_id <= _I64_MAX
        and value_safe(msg.payload)
    )


def _vec_encode_crgc_app(msgs: List[Any]) -> Optional[bytes]:
    """Run form: only the all-refs-empty case vectorizes (refs force
    per-message token work anyway); body is ONE marshal call over
    [(window_id, external, payload), ...].  Inputs pre-gated by probe."""
    return encode_value([(m.window_id, m.external, m.payload) for m in msgs])


def _vec_decode_crgc_app(fabric: "Fabric", body: bytes) -> List[Any]:
    AppMsg, _CrgcRefob = _crgc_classes()
    rows = decode_value(body)
    if type(rows) is not list:
        raise ValueError("schema run body did not decode to a list")
    out = []
    for wid, external, payload in rows:
        msg = AppMsg(payload, (), external=bool(external))
        msg.window_id = wid
        out.append(msg)
    return out


def _encode_mac_app(msg: Any) -> Optional[bytes]:
    MacAppMsg, MacRefob = _mac_classes()
    flags = (1 if msg.external else 0) | (2 if msg.is_self_msg else 0)
    return _encode_app(msg, 0, flags, msg._refs, MacRefob)


def _decode_mac_app(fabric: "Fabric", body: bytes) -> Any:
    MacAppMsg, MacRefob = _mac_classes()
    _window_id, flags, cells, off = _decode_app_header(fabric, body)
    return MacAppMsg(
        decode_value(body[off:]),
        [MacRefob(cell) for cell in cells],
        is_self_msg=bool(flags & 2),
        external=bool(flags & 1),
    )


def _probe_mac_app(msg: Any) -> bool:
    return not msg._refs and value_safe(msg.payload)


def _vec_encode_mac_app(msgs: List[Any]) -> Optional[bytes]:
    # Inputs pre-gated by probe.
    return encode_value([(m.is_self_msg, m.external, m.payload) for m in msgs])


def _vec_decode_mac_app(fabric: "Fabric", body: bytes) -> List[Any]:
    MacAppMsg, _MacRefob = _mac_classes()
    rows = decode_value(body)
    if type(rows) is not list:
        raise ValueError("schema run body did not decode to a list")
    return [
        MacAppMsg(payload, (), is_self_msg=bool(s), external=bool(e))
        for s, e, payload in rows
    ]


def _probe_keyset(msg: Any) -> bool:
    return type(msg) is list


def _encode_keyset_msg(msg: Any) -> Optional[bytes]:
    try:
        return encode_keyset(msg)
    except (TypeError, ValueError, AttributeError):
        return None


def _decode_keyset_msg(fabric: "Fabric", body: bytes) -> Any:
    keys = decode_keyset(body)
    if keys is None:
        raise ValueError("malformed key-set body")
    return keys


def _build_default_registry() -> SchemaRegistry:
    registry = SchemaRegistry()
    registry.register(
        Schema(
            SCHEMA_VAL,
            "val",
            value_safe,
            _encode_val,
            _decode_val,
            _vec_encode_val,
            _vec_decode_val,
        )
    )
    # The key-set codec has no envelope type (it is a frame PAYLOAD
    # codec, not a message schema): registering it by id makes the
    # hello caps advertise it, which is how the distributed collector
    # learns a peer can decode binary dmark payloads (wire.py).
    registry.register(
        Schema(
            SCHEMA_DIST_KEYS,
            "dist-keys",
            _probe_keyset,
            _encode_keyset_msg,
            _decode_keyset_msg,
            _encode_keyset_msg,
            _decode_keyset_msg,
        )
    )
    registry.register(
        Schema(
            SCHEMA_CRGC_APP,
            "crgc-app",
            _probe_crgc_app,
            _encode_crgc_app,
            _decode_crgc_app,
            _vec_encode_crgc_app,
            _vec_decode_crgc_app,
        )
    )
    registry.register(
        Schema(
            SCHEMA_MAC_APP,
            "mac-app",
            _probe_mac_app,
            _encode_mac_app,
            _decode_mac_app,
            _vec_encode_mac_app,
            _vec_decode_mac_app,
        )
    )
    return registry


#: The process-wide registry every NodeFabric shares.  Envelope-type
#: dispatch is lazy (``classify``) so importing this module never pulls
#: the engines in.
registry = _build_default_registry()


def classify(msg: Any) -> Optional[Schema]:
    """The schema that may encode ``msg``: exact-type envelope match,
    else the bare value plane for plain values."""
    t = type(msg)
    schema = registry._by_type.get(t)
    if schema is not None:
        return schema
    if not registry._by_type:
        _warm_envelope_types()
        schema = registry._by_type.get(t)
        if schema is not None:
            return schema
    if t in _SCALAR_SET or t is tuple or t is list or t is dict:
        return registry.get(SCHEMA_VAL)
    return None


_VALUE_TYPES = _SCALARS + (tuple, list, dict)


def encoder_table(schema_ids) -> Dict[type, Schema]:
    """Exact-type -> Schema dispatch restricted to a negotiated id set
    — built once per link at hello time so the writer's hot loop pays
    ONE dict hit per message instead of classify + id-set checks."""
    if not registry._by_type:
        _warm_envelope_types()
    table: Dict[type, Schema] = {}
    val = registry.get(SCHEMA_VAL)
    if val is not None and SCHEMA_VAL in schema_ids:
        for t in _VALUE_TYPES:
            table[t] = val
    for t, sch in registry._by_type.items():
        if sch.schema_id in schema_ids:
            table[t] = sch
    return table


def _warm_envelope_types() -> None:
    """Bind the built-in schemas to their (lazily imported) envelope
    classes.  Called once, on the first classify of a non-value type or
    at fabric setup — never at module import."""
    AppMsg, _ = _crgc_classes()
    registry._by_type.setdefault(AppMsg, registry.get(SCHEMA_CRGC_APP))
    try:
        MacAppMsg, _ = _mac_classes()
        registry._by_type.setdefault(MacAppMsg, registry.get(SCHEMA_MAC_APP))
    except Exception:  # pragma: no cover - MAC engine optional
        pass


# ------------------------------------------------------------------- #
# Capability negotiation (the hello caps element)
# ------------------------------------------------------------------- #

#: Schema-table epoch: bump when a built-in schema's LAYOUT changes
#: incompatibly (ids are additive and never need a bump).
TABLE_VERSION = 1


def capability() -> str:
    """The hello caps element advertising this node's decodable schema
    ids.  Pins the interpreter version because the value plane is
    marshal: ``sc<table>:<py-major>.<py-minor>.<marshal-version>:<ids>``."""
    ids = ",".join(str(i) for i in registry.ids())
    return (
        f"sc{TABLE_VERSION}:"
        f"{sys.version_info[0]}.{sys.version_info[1]}.{marshal.version}:{ids}"
    )


def peer_schema_ids(caps: Iterable[str]) -> frozenset:
    """The schema ids a peer's hello advertised AND this build can
    encode — empty when the peer is not schema-capable or its value
    plane is not byte-compatible with ours (different interpreter or
    table version: pickle fallback, never a guess)."""
    ours = capability()
    prefix, _, _ = ours.rpartition(":")
    for cap in caps:
        if not isinstance(cap, str) or not cap.startswith("sc"):
            continue
        theirs_prefix, _, ids_part = cap.rpartition(":")
        if theirs_prefix != prefix:
            return frozenset()
        try:
            theirs = {int(x) for x in ids_part.split(",") if x}
        except ValueError:
            return frozenset()
        return frozenset(theirs & set(registry.ids()))
    return frozenset()
