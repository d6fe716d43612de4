"""Copy of ``uigc_tpu/runtime/wire.py`` (pure Python).  What differs:

- The lazy ref-type resolvers return the port's classes
  (``_proxy_cell_class``: ``runtime/node.py`` ``ProxyCell``;
  ``_entity_ref_class``: ``cluster/sharding.py`` ``EntityRef``;
  ``_client_ref_class``: ``gateway/session.py`` ``ClientRef``), and an
  ``entity`` token decodes through the receiving system's cluster, as in
  the reference.
- The in-process fabric's ``Tombstone`` crosses as the ``cell`` token it
  stands for.
- One more distributed-collector frame, ``dcut`` (``encode_dcut``): the
  per-link wave marker of ``engines/crgc/distributed.py``.

Nothing imports this module at load time: a single node never loads it.

Cross-node message serialization: the byte boundary between systems.

Stands in for Artery's serialization layer (reference: reference.conf:2-10
routes every cross-node envelope through Akka serialization;
streams/Egress.scala:9-21 intercepts the serialized stream).  A fabric in
``serialize`` mode pushes every application message through this codec, so
nothing object-identical crosses a link: refobs and actor references are
reduced to (system address, uid) tokens and re-materialized against the
destination's registry — exactly the discipline a real two-process
deployment forces, and the one an in-process fabric silently skips.

Messages are pickled; GC-managed reference types are intercepted with
``persistent_id`` so user payloads need no special support beyond being
picklable.  A refob arrives as a *fresh* instance: its mutable sender-side
bookkeeping (send counts, recorded flag) stays at the sender, which is the
protocol's intent — counts travel in entries, never inside refs
(reference: crgc/Refob.scala:12-17 marks the shadow cache transient).
"""

from __future__ import annotations

import io
import json
import pickle
import struct
from collections import deque
from typing import TYPE_CHECKING, Any, Iterable, List, Optional, Tuple

if TYPE_CHECKING:  # pragma: no cover
    from .fabric import Fabric


def encode_cell(cell) -> bytes:
    """Stable wire token for an actor cell: address + uid + path."""
    return f"{cell.system.address}|{cell.uid}|{cell.path}".encode()


def make_decode_cell(fabric: "Fabric"):
    def decode_cell(data: bytes):
        address, uid, _path = data.decode().split("|", 2)
        return _resolve(fabric, address, int(uid))

    return decode_cell


def _resolve(fabric: "Fabric", address: str, uid: int):
    # Cross-process fabrics (runtime/node.py) resolve remote tokens to
    # proxy handles instead of reaching into another system's heap.
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


_PROXY_CELL = None


def _proxy_cell_class():
    """Lazy, cached ProxyCell class (avoids a circular import at module
    load and an import-machinery hit per pickled object)."""
    global _PROXY_CELL
    if _PROXY_CELL is None:
        from .node import ProxyCell

        _PROXY_CELL = ProxyCell
    return _PROXY_CELL


_ENTITY_REF = None


def _entity_ref_class():
    global _ENTITY_REF
    if _ENTITY_REF is None:
        from ..cluster.sharding import EntityRef

        _ENTITY_REF = EntityRef
    return _ENTITY_REF


_CLIENT_REF = None


def _client_ref_class():
    global _CLIENT_REF
    if _CLIENT_REF is None:
        from ..gateway.session import ClientRef

        _CLIENT_REF = ClientRef
    return _CLIENT_REF


_TOMBSTONE = None


def _tombstone_class():
    """The in-process fabric's ``Tombstone`` (runtime/fabric.py), bound at
    first use."""
    global _TOMBSTONE
    if _TOMBSTONE is None:
        from .fabric import Tombstone

        _TOMBSTONE = Tombstone
    return _TOMBSTONE


_REF_CLASSES = None


def _ref_classes():
    """Lazy, cached (CrgcRefob, Refob, ActorCell, RawRef) tuple — these
    imports sat inside ``persistent_id`` and were re-resolved through the
    import machinery for every object pickled on the hot send path."""
    global _REF_CLASSES
    if _REF_CLASSES is None:
        from ..engines.crgc.refob import CrgcRefob
        from ..interfaces import Refob
        from .cell import ActorCell
        from .system import RawRef

        _REF_CLASSES = (CrgcRefob, Refob, ActorCell, RawRef)
    return _REF_CLASSES


#: Memoized persistent-id tokens for long-lived handle objects whose wire
#: token never changes: ProxyCell and EntityRef (both cached per fabric /
#: region) and ActorCell.  Keyed by ``id(obj)`` WITH the object pinned in
#: the entry, so a reused id can never alias a dead object's token.
#: Bounded: cleared wholesale at the cap (cheap; it re-warms in one burst).
_PID_CACHE: dict = {}
_PID_CACHE_MAX = 4096


class _Pickler(pickle.Pickler):
    def persistent_id(self, obj: Any):
        cached = _PID_CACHE.get(id(obj))
        if cached is not None and cached[0] is obj:
            return cached[1]
        CrgcRefob, Refob, ActorCell, RawRef = _ref_classes()

        if isinstance(obj, _entity_ref_class()):
            # Location-transparent: an entity ref crosses as its
            # (type, key) coordinates and re-binds to the DESTINATION
            # node's shard region — never to a concrete cell, which may
            # passivate or migrate while the message is in flight.
            pid = ("entity", obj.type_name, obj.key)
        elif (
            type(obj).__name__ == "ClientRef"
            and hasattr(obj, "gateway_address")
            and hasattr(obj, "conn_id")
        ):
            # Duck-typed so pickling ordinary traffic never imports the
            # gateway package: a client reply handle crosses as its
            # (gateway, connection) coordinates and re-binds to the
            # receiving node's fabric — the reply frame finds its way
            # back to the one gateway that owns the socket.
            pid = ("gwclient", obj.gateway_address, obj.conn_id)
        elif isinstance(obj, CrgcRefob):
            t = obj._target
            return ("refob", t.system.address, t.uid)
        elif isinstance(obj, Refob):
            # engine-agnostic fallback: re-materialize through the
            # destination engine's root conversion
            t = obj.target
            return ("ref", t.system.address, t.uid)
        elif isinstance(obj, _proxy_cell_class()):
            # A remote handle crossing another link re-encodes to the
            # same (address, uid) token it was decoded from.  Cached:
            # proxies are pinned by the fabric's identity cache anyway.
            pid = ("cell", obj.system.address, obj.uid)
        elif isinstance(obj, _tombstone_class()):
            # A tombstone (runtime/fabric.py) crosses as the token it
            # was decoded from; the receiving fabric maps it back to
            # its own one tombstone for that token.
            return ("cell", obj.system.address, obj.uid)
        elif isinstance(obj, ActorCell):
            # NOT cached: pinning a cell here would keep a terminated
            # actor alive past its weak-registry reclamation and mask
            # the tombstone/dead-letter path.
            return ("cell", obj.system.address, obj.uid)
        elif isinstance(obj, RawRef):
            return ("rawref", obj.cell.system.address, obj.cell.uid)
        else:
            return None
        if len(_PID_CACHE) >= _PID_CACHE_MAX:
            _PID_CACHE.clear()
        _PID_CACHE[id(obj)] = (obj, pid)
        return pid


class _Unpickler(pickle.Unpickler):
    def __init__(self, buf, fabric: "Fabric"):
        super().__init__(buf)
        self._fabric = fabric

    def persistent_load(self, pid):
        if pid[0] == "entity":
            _, type_name, key = pid
            system = getattr(self._fabric, "system", None)
            cluster = getattr(system, "cluster", None)
            if cluster is None:
                raise LookupError(
                    f"entity ref {type_name}/{key}: no cluster sharding "
                    "attached to the receiving system"
                )
            return cluster.entity_ref(type_name, key)
        if pid[0] == "gwclient":
            _, address, conn_id = pid
            return _client_ref_class()(address, conn_id, self._fabric)
        kind, address, uid = pid
        cell = _resolve(self._fabric, address, uid)
        if kind == "refob":
            from ..engines.crgc.refob import CrgcRefob

            return CrgcRefob(cell)
        if kind == "ref":
            # Engine-agnostic refs re-materialize through an engine's
            # root conversion.  On a cross-process fabric the resolved
            # cell can be a ProxyCell whose ProxySystem has no engine —
            # wrap through the LOCAL system's engine instead (it is the
            # one that will manage the ref from here on).
            engine = getattr(cell.system, "engine", None)
            if engine is None or not hasattr(engine, "to_root_refob"):
                local = getattr(self._fabric, "system", None)
                if local is None:
                    raise LookupError(
                        f"cannot materialize generic ref to {address}/{uid}: "
                        "no local engine on this fabric"
                    )
                engine = local.engine
            return engine.to_root_refob(cell)
        if kind == "rawref":
            from .system import RawRef

            return RawRef(cell)
        return cell


#: Pooled (BytesIO, _Pickler) pairs: a ``tell()`` to a remote proxy used
#: to pay a fresh pickler allocation per message; the pool amortizes it
#: to a deque pop + memo clear.  CPython deque append/popleft are atomic,
#: so the pool is thread-safe without a lock.
_PICKLER_POOL: deque = deque()
_PICKLER_POOL_MAX = 16


def encode_message(msg: Any) -> bytes:
    try:
        buf, pickler = _PICKLER_POOL.popleft()
    except IndexError:
        buf = io.BytesIO()
        pickler = _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL)
    try:
        pickler.dump(msg)
        data = buf.getvalue()
    finally:
        # Reusable even after a failed dump: the memo is cleared and the
        # buffer rewound, so partial output never leaks into the next use.
        pickler.clear_memo()
        buf.seek(0)
        buf.truncate()
        if len(_PICKLER_POOL) < _PICKLER_POOL_MAX:
            _PICKLER_POOL.append((buf, pickler))
    return data


#: Prefix of a schema-encoded message body (runtime/schema.py).  A
#: protocol-2+ pickle always starts with b"\x80", so the leading NUL
#: is unambiguous: decode_message dispatches on it, which is what lets
#: pre-encoded payload BYTES (entity frames, migration blobs) carry
#: either codec without the frame knowing.
SCHEMA_MAGIC = b"\x00SV"
_SCHEMA_ID = struct.Struct(">H")

_SCHEMA_MOD = None


def _schema_mod():
    """Lazily bound schema module (a module-load import would be fine
    for cycles — schema imports nothing from wire — but the codec is
    hot-path: resolve once, not through the import machinery per
    message)."""
    global _SCHEMA_MOD
    if _SCHEMA_MOD is None:
        from . import schema

        _SCHEMA_MOD = schema
    return _SCHEMA_MOD


def encode_message_schema(msg: Any, schema_ids) -> bytes:
    """Message bytes for a peer that advertised ``schema_ids``
    (``NodeFabric.peer_schema_ids``): schema-native when a negotiated
    schema fits the message, pickle otherwise.  NEVER emit schema bytes
    toward a peer that did not advertise the id — an old build's
    decode_message would reject the magic as garbage."""
    if schema_ids:
        sch = _schema_mod().classify(msg)
        if sch is not None and sch.schema_id in schema_ids:
            body = sch.encode(msg)
            if body is not None:
                return SCHEMA_MAGIC + _SCHEMA_ID.pack(sch.schema_id) + body
    return encode_message(msg)


def decode_message(fabric: "Fabric", data: bytes) -> Any:
    if data[:3] == SCHEMA_MAGIC:
        (schema_id,) = _SCHEMA_ID.unpack_from(data, 3)
        sch = _schema_mod().registry.get(schema_id)
        if sch is None:
            raise LookupError(f"unknown wire schema id {schema_id}")
        return sch.decode(fabric, data[5:])
    return _Unpickler(io.BytesIO(data), fabric).load()


# ------------------------------------------------------------------- #
# Frame-batch wire units (the node transport's ``"fb"`` kind)
#
# The per-peer writer thread (runtime/node.py) coalesces every frame
# queued for one peer into a single length-prefixed multi-frame batch,
# flushed in ONE sendall.  The capability is negotiated in the hello
# tuple (a trailing ``("fb",)`` caps element); peers that never
# advertised it receive classic singleton units, so mixed-version links
# keep working.
#
# A batch body is distinguished from a pickled singleton by a magic
# prefix that can never begin a protocol-2+ pickle (those start with
# b"\x80").  Inside the batch each frame carries its own sequence number
# and an inner block whose first byte selects the block codec:
#
#   body  := MAGIC  frame*
#   frame := ">QI"(seq, len(block))  block
#   block := b"A" ">QI"(uid, len(payload)) payload header-pickle?   (app)
#          | b"P" pickle(inner-frame-tuple)                     (generic)
#
# The ``A`` block is the zero-realloc app envelope: the payload is the
# already-pickled message bytes, framed with struct instead of being
# re-pickled wholesale the way the singleton path's frame tuple was.
# Truncation (fault injection) cuts one BLOCK while keeping its recorded
# length consistent, so exactly that inner frame fails to decode and the
# rest of the batch — and the stream — survive.
# ------------------------------------------------------------------- #

FB_MAGIC = b"\x00FB1"
_FB_HDR = struct.Struct(">QI")


def encode_block(inner: tuple, truncate: bool = False) -> bytes:
    """Encode one inner frame tuple as a batch block.  ``truncate``
    (fault injection) must make exactly this block undecodable: for app
    blocks the cut is taken over the headerless envelope+payload span —
    cutting only a trailing trace header would deliver the message
    intact (headers are decode-tolerant by design)."""
    if inner[0] == "app":
        payload = inner[2]
        header = inner[3] if len(inner) > 3 else None
        envelope = b"A" + _FB_HDR.pack(inner[1], len(payload)) + payload
        if truncate:
            return envelope[: max(4, len(envelope) // 2)]
        if header is None:
            return envelope
        return envelope + pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    block = b"P" + pickle.dumps(inner, protocol=pickle.HIGHEST_PROTOCOL)
    if truncate:
        block = block[: max(4, len(block) // 2)]
    return block


#: Schema-run block (runtime/schema.py): K consecutive app frames to
#: ONE uid, batch-encoded under one negotiated schema id.  The frame
#: slot's sequence number is the FIRST message's; the run consumes
#: ``count`` contiguous sequence numbers (receiver: _on_batch).
#:
#:   block := b"R" ">QIHH"(uid, len(body), schema_id, count) body
_RUN_HDR = struct.Struct(">QIHH")


def encode_run_block(uid: int, schema_id: int, count: int, body: bytes) -> bytes:
    return b"R" + _RUN_HDR.pack(uid, len(body), schema_id, count) + body


def decode_block(block: bytes):
    """-> the inner frame tuple, or None when the block is corrupt."""
    if not block:
        return None
    kind = block[0:1]
    if kind == b"R":
        if len(block) < 1 + _RUN_HDR.size:
            return None
        uid, blen, schema_id, count = _RUN_HDR.unpack_from(block, 1)
        body = block[1 + _RUN_HDR.size : 1 + _RUN_HDR.size + blen]
        if len(body) != blen or count < 1:
            return None
        return ("appr", uid, schema_id, count, body)
    if kind == b"A":
        if len(block) < 13:
            return None
        uid, plen = _FB_HDR.unpack_from(block, 1)
        payload = block[13 : 13 + plen]
        if len(payload) != plen:
            return None
        rest = block[13 + plen :]
        if rest:
            try:
                header = pickle.loads(rest)
            except Exception:
                header = None  # tolerant: an unreadable header is absent
            if header is not None:
                return ("app", uid, payload, header)
        return ("app", uid, payload)
    if kind == b"P":
        try:
            return pickle.loads(block[1:])
        except Exception:
            return None
    return None


def encode_batch(items: Iterable[Tuple[int, bytes]]) -> bytes:
    """Join (seq, block) pairs into one batch body (magic included)."""
    parts: List[bytes] = [FB_MAGIC]
    for seq, block in items:
        parts.append(_FB_HDR.pack(seq, len(block)))
        parts.append(block)
    return b"".join(parts)


def decode_batch(body: bytes) -> List[Tuple[int, Optional[tuple]]]:
    """-> [(seq, inner-frame-or-None)], in stream order.  A mangled tail
    yields what decoded cleanly; per-block corruption yields (seq, None)
    so the receiver can account the loss without desyncing the stream."""
    out: List[Tuple[int, Optional[tuple]]] = []
    off = len(FB_MAGIC)
    n = len(body)
    while off < n:
        if off + 12 > n:
            break  # mangled tail: no recoverable frame header
        seq, blen = _FB_HDR.unpack_from(body, off)
        off += 12
        block = body[off : off + blen]
        off += blen
        if len(block) != blen:
            out.append((seq, None))
            break
        out.append((seq, decode_block(block)))
    return out


# ------------------------------------------------------------------- #
# Trace-context headers (uigc_tpu/telemetry/tracing.py)
#
# A traced message carries its causal context OUTSIDE the payload
# bytes, as an optional trailing element of the transport's app frame:
# ``("app", uid, payload)`` becomes ``("app", uid, payload, header)``.
# Keeping it out of the pickled body means the header survives payload
# corruption, costs nothing when tracing is off, and — critically — is
# version-tolerant: a receiver ignores headers it does not understand
# and tolerates frames that do not carry one (a peer with tracing off,
# or an older frame layout).
# ------------------------------------------------------------------- #


def encode_trace_header(msg: Any) -> Any:
    """The wire header for a message's trace context, or None.  The
    envelope convention is a ``trace_ctx`` attribute holding a
    ``(trace_id, span_id)`` int pair (all three engines' app envelopes
    carry the slot)."""
    return getattr(msg, "trace_ctx", None)


def decode_trace_header(obj: Any) -> Any:
    """Validate a received header; anything unrecognizable is treated
    as absent, never an error."""
    if obj is None:
        return None
    from ..telemetry.tracing import decode_header

    return decode_header(obj)


def apply_trace_header(msg: Any, header: Any) -> None:
    """Stamp a validated header onto a decoded message (best effort —
    envelopes without the slot simply stay untraced)."""
    if header is None:
        return
    try:
        msg.trace_ctx = header
    except AttributeError:
        pass


# ------------------------------------------------------------------- #
# Cluster-sharding frames (uigc_tpu/cluster)
#
# Four frame kinds ride the node transport's sequence layer next to the
# app/marker/delta frames.  All of them follow the trace-header
# discipline: decoders accept trailing elements they do not understand
# (a newer peer may append fields), return None for anything malformed
# (the frame is then dropped, never an exception on the link thread),
# and a peer that does not know these kinds at all ignores them without
# desyncing sequence numbers (runtime/node.py _on_frame else-branch).
# ------------------------------------------------------------------- #

#: Frame kinds owned by the cluster layer.
SHARD_FRAME_KINDS = ("shard", "ent", "mig", "miga", "sgrant", "sleave", "mship")


def _frame_fence(frame: tuple, index: int) -> int:
    """Tolerant read of the trailing fence element the epoch-
    fencing plane appended to the shard/mig/sgrant/ent frames: absent
    (an older peer) or unreadable decodes as fence 0 — the pre-fencing
    era, which every fenced site treats as 'no evidence of staleness'."""
    try:
        return int(frame[index])
    except (IndexError, TypeError, ValueError):
        return 0


def encode_shard_frame(
    version: int, origin: str, assignments: dict, fence: int = 0
) -> tuple:
    """Shard-table gossip: ``(kind, version, origin, {shard: address},
    fence)`` — the fence epoch orders tables across partition eras
    BEFORE the (version, origin) lamport pair."""
    return ("shard", int(version), origin, dict(assignments), int(fence))


def decode_shard_frame(frame: tuple):
    """-> (version, origin, assignments, fence) or None."""
    try:
        version, origin, assignments = frame[1], frame[2], frame[3]
        if not isinstance(version, int) or not isinstance(assignments, dict):
            return None
        return (
            version,
            str(origin),
            {int(s): str(a) for s, a in assignments.items()},
            _frame_fence(frame, 4),
        )
    except (IndexError, TypeError, ValueError):
        return None


def encode_entity_frame(
    type_name: str, key: str, hops: int, payload: bytes, fence: int = 0
) -> tuple:
    """Entity-routed message: the payload bytes come from
    :func:`encode_message` on the sender.  The trailing fence stamps
    the SENDER's partition era so a receiver can tell a frame routed by
    a stale membership view from current traffic."""
    return ("ent", type_name, key, int(hops), payload, int(fence))


def decode_entity_frame(frame: tuple):
    """-> (type_name, key, hops, payload, fence) or None."""
    try:
        type_name, key, hops, payload = frame[1], frame[2], frame[3], frame[4]
        if not isinstance(payload, bytes):
            return None
        return (
            str(type_name),
            str(key),
            int(hops),
            payload,
            _frame_fence(frame, 5),
        )
    except (IndexError, TypeError, ValueError):
        return None


def encode_migration_frame(
    type_name: str,
    key: str,
    mig_id: tuple,
    blob: bytes,
    fence: int = 0,
    epoch: int = 0,
) -> tuple:
    """Handoff state transfer: ``blob`` is the encode_message bytes of a
    ``(snapshot, pending_payloads)`` pair.  Fence-stamped at SEND time:
    a receiver refuses state shipped under a superseded partition era
    (a stale owner's post-partition copy) instead of merging it.
    ``epoch`` (trailing, tolerant) is the SOURCE's journal epoch for the
    shipped state: the destination's activation opens strictly past it,
    so a same-millisecond handoff with a stale destination scan can
    never let the source's capture record supersede the destination's
    later acked commands in a recovery merge."""
    return ("mig", type_name, key, tuple(mig_id), blob, int(fence), int(epoch))


def decode_migration_frame(frame: tuple):
    """-> (type_name, key, mig_id, blob, fence, epoch) or None."""
    try:
        type_name, key, mig_id, blob = frame[1], frame[2], frame[3], frame[4]
        if not isinstance(blob, bytes) or not isinstance(mig_id, tuple):
            return None
        return (
            str(type_name), str(key), mig_id, blob,
            _frame_fence(frame, 5), _frame_fence(frame, 6),
        )
    except (IndexError, TypeError, ValueError):
        return None


def encode_shard_grant(shard: int, origin: str, fence: int = 0) -> tuple:
    """Shard-ownership grant: the PREVIOUS owner of ``shard`` tells the
    new owner that every entity it hosted for that shard has been
    handed off — the new owner may stop holding the shard's traffic.
    Fence-stamped: a grant minted under a superseded era must not
    release a hold in the current one."""
    return ("sgrant", int(shard), origin, int(fence))


def decode_shard_grant(frame: tuple):
    """-> (shard, origin, fence) or None."""
    try:
        shard, origin = frame[1], frame[2]
        return int(shard), str(origin), _frame_fence(frame, 3)
    except (IndexError, TypeError, ValueError):
        return None


def encode_mship(
    origin: str,
    fence: int,
    members: list,
    stamps: dict,
    quarantined: bool,
    table_version: int,
) -> tuple:
    """Membership handshake / anti-entropy gossip
    (uigc_tpu/cluster/membership.py): the sender's partition era
    (fence), live-member view, join-seniority stamps and quarantine
    flag.  JSON payload, never pickle — the same data-not-code
    discipline as the snap/tsq frames: a malformed or malicious peer
    document can at worst fail ``json.loads``."""
    doc = {
        "origin": origin,
        "fence": int(fence),
        "members": sorted(members),
        "stamps": {str(a): int(s) for a, s in stamps.items()},
        "quarantined": bool(quarantined),
        "table_version": int(table_version),
    }
    return ("mship", origin, json.dumps(doc).encode())


def decode_mship(frame: tuple):
    """-> the handshake document (dict) or None.  Unknown keys are
    preserved (a newer peer may gossip more); missing keys default."""
    try:
        origin, payload = frame[1], frame[2]
        if not isinstance(payload, bytes):
            return None
        doc = json.loads(payload)
        if not isinstance(doc, dict):
            return None
        doc.setdefault("origin", str(origin))
        doc["fence"] = int(doc.get("fence", 0))
        doc["members"] = [str(m) for m in doc.get("members", [])]
        doc["stamps"] = {
            str(a): int(s) for a, s in dict(doc.get("stamps", {})).items()
        }
        doc["quarantined"] = bool(doc.get("quarantined", False))
        return doc
    except (IndexError, TypeError, ValueError):
        return None


def encode_shard_leave(origin: str) -> tuple:
    """Voluntary departure (the drain lifecycle): ``origin`` asks peers
    to stop PLACING on it while its links stay up for the handoffs.
    Unlike a death verdict, holds waiting on the leaver's grants stay
    armed — the leaver is alive and WILL grant once its handoffs ack."""
    return ("sleave", origin)


def decode_shard_leave(frame: tuple):
    """-> origin or None."""
    try:
        origin = frame[1]
        if not isinstance(origin, str):
            return None
        return origin
    except (IndexError, TypeError):
        return None


# ------------------------------------------------------------------- #
# Liveness-inspector snapshot frames (uigc_tpu/telemetry/inspect.py)
#
# One frame kind, two shapes, same tolerance contract as the cluster
# frames above (trailing elements accepted, malformed -> None, unknown
# kind ignored by old peers after seq accounting):
#
#   ("snap", "req", req_id, origin)           ask a peer for its snapshot
#   ("snap", "rsp", req_id, origin, payload)  the JSON-encoded snapshot
#
# ``payload`` is UTF-8 JSON bytes of one telemetry.inspect snapshot
# document; JSON (not pickle) deliberately — the receiver treats it as
# data, so a malformed or malicious peer snapshot can at worst fail
# json.loads, never execute.
# ------------------------------------------------------------------- #

SNAP_FRAME_KIND = "snap"


def encode_snap_request(req_id: int, origin: str) -> tuple:
    return ("snap", "req", int(req_id), origin)


def encode_snap_response(req_id: int, origin: str, payload: bytes) -> tuple:
    return ("snap", "rsp", int(req_id), origin, payload)


def decode_snap_frame(frame: tuple):
    """-> ("req", req_id, origin, None) | ("rsp", req_id, origin,
    payload) | None."""
    try:
        kind = frame[1]
        if kind == "req":
            return "req", int(frame[2]), str(frame[3]), None
        if kind == "rsp":
            payload = frame[4]
            if not isinstance(payload, bytes):
                return None
            return "rsp", int(frame[2]), str(frame[3]), payload
        return None
    except (IndexError, TypeError, ValueError):
        return None


# ------------------------------------------------------------------- #
# Telemetry time-plane frames (uigc_tpu/telemetry/timeseries.py)
#
# A query/response pair for coordinator-free cluster aggregation of the
# per-node time-series stores: any node fans a ``tsq`` out to its peers
# and folds the ``tsr`` responses, degrading to ``missing_nodes`` for
# peers that never answer — the same tolerance contract as the ``snap``
# frames above (trailing elements accepted, malformed -> None, unknown
# kinds ignored by old peers after seq accounting).
#
#   ("tsq", req_id, origin, query_json)     pull a peer's series
#   ("tsr", req_id, origin, payload_json)   the series document
#
# Both payloads are UTF-8 JSON bytes — data, never pickle, so a
# malformed or malicious peer document can at worst fail json.loads.
# Unknown query keys are ignored by the responder (a newer peer may ask
# for filters an older one does not know).
# ------------------------------------------------------------------- #

TSQ_FRAME_KIND = "tsq"
TSR_FRAME_KIND = "tsr"


def encode_ts_query(req_id: int, origin: str, query: dict) -> tuple:
    return ("tsq", int(req_id), origin, json.dumps(query, default=repr).encode())


def decode_ts_query(frame: tuple):
    """-> (req_id, origin, query_dict) or None.  An unreadable query
    body degrades to ``{}`` (answer with everything) rather than
    dropping the frame — version tolerance over strictness."""
    try:
        req_id, origin, payload = frame[1], frame[2], frame[3]
        if not isinstance(payload, bytes):
            return None
        try:
            query = json.loads(payload)
        except ValueError:
            query = {}
        if not isinstance(query, dict):
            query = {}
        return int(req_id), str(origin), query
    except (IndexError, TypeError, ValueError):
        return None


def encode_ts_response(req_id: int, origin: str, payload: bytes) -> tuple:
    return ("tsr", int(req_id), origin, payload)


def decode_ts_response(frame: tuple):
    """-> (req_id, origin, payload_bytes) or None."""
    try:
        req_id, origin, payload = frame[1], frame[2], frame[3]
        if not isinstance(payload, bytes):
            return None
        return int(req_id), str(origin), payload
    except (IndexError, TypeError, ValueError):
        return None


# ------------------------------------------------------------------- #
# Ingress-gateway reply frames (uigc_tpu/gateway)
#
# The return hop of the client plane: an entity anywhere in the cluster
# tells a ClientRef, and the message crosses the node fabric back to
# the gateway that owns the socket as ONE frame kind:
#
#   ("gwr", conn_id, payload)   deliver to connection conn_id
#
# ``payload`` is node-plane message bytes (encode_message — trusted
# pickle/schema between handshaken cluster members, the SAME trust
# domain as every frame above; client-plane re-encoding to the
# untrusted socket happens inside the gateway over the client value
# codec).  Tolerance contract as above: trailing elements accepted,
# malformed -> None, unknown kind ignored by old peers after seq
# accounting — a gateway-less build simply never registers the handler.
# ------------------------------------------------------------------- #

GATEWAY_FRAME_KIND = "gwr"


def encode_gateway_reply(conn_id: int, payload: bytes) -> tuple:
    return ("gwr", int(conn_id), payload)


def decode_gateway_reply(frame: tuple):
    """-> (conn_id, payload_bytes) or None."""
    try:
        payload = frame[2]
        if not isinstance(payload, bytes):
            return None
        return int(frame[1]), payload
    except (IndexError, TypeError, ValueError):
        return None


# ------------------------------------------------------------------- #
# Distributed-collector frames (engines/crgc/distributed.py)
#
# The cross-node trace-wave protocol: boundary marks ("dmark") routed
# point-to-point to the partition owner, watermark acks ("dmack"),
# wave control ("dwave"/"dfin"), Safra-style termination rounds over
# the reduction tree ("dprobe"/"dstat" — the explicit fallback; the
# round stamp and leaf reports normally PIGGYBACK on dwave/dmark/dmack
# trailing elements), the remote supervisor kill gate ("dgate"/
# "dgack"), and the root dirty hint ("ddirty").  Same tolerance
# contract as every subsystem frame family above: trailing elements
# accepted, malformed -> None, unknown kinds ignored by old peers
# after seq accounting.  Mark payloads are density-switched binary
# key sets (runtime/schema.py encode_keyset, negotiated via the
# schema-codec hello caps) with the legacy JSON coordinate list as the
# legacy fallback — data, never pickle; coordinates re-bind through
# ``resolve_cell_token`` at the receiver, so a frame from a newer peer
# can at worst fail the payload decode.
# ------------------------------------------------------------------- #

DIST_FRAME_KINDS = (
    "dwave", "dmark", "dmack", "dprobe", "dstat", "dfin",
    "dgate", "dgack", "ddirty", "djnl", "dcut",
)


def encode_djournal(fence: int, partition: int, graph_bytes: bytes) -> tuple:
    """A retained partition journal re-shipped to the partition's new
    owner after a membership change (the absorb path); the payload is
    the DeltaGraph wire format (DeltaGraph.java:189-232)."""
    return ("djnl", int(fence), int(partition), graph_bytes)


def decode_djournal(frame: tuple):
    """-> (fence, partition, graph_bytes) or None."""
    try:
        payload = frame[3]
        if not isinstance(payload, bytes):
            return None
        return int(frame[1]), int(frame[2]), payload
    except (IndexError, TypeError, ValueError):
        return None


def _keys_payload(keys, binary: bool) -> bytes:
    # Payload construction delegates to the schema-codec helpers (the
    # UL015 contract): binary toward peers whose hello advertised
    # SCHEMA_DIST_KEYS, the legacy JSON coordinate list otherwise.
    schema = _schema_mod()
    if binary:
        return schema.encode_keyset(keys)
    return schema.encode_keyset_json(keys)


def _decode_keys(payload):
    if not isinstance(payload, bytes):
        return None
    return _schema_mod().decode_keyset_any(payload)


def _frame_report(frame: tuple, index: int):
    """Tolerant read of a piggybacked termination report: a 5-sequence
    of ints ``(settled, changed, sent, recv, nodes)`` or None.
    Anything unrecognizable decodes as absent, never an error."""
    try:
        raw = frame[index]
    except IndexError:
        return None
    if not isinstance(raw, (tuple, list)) or len(raw) < 5:
        return None
    try:
        return tuple(int(v) for v in raw[:5])
    except (TypeError, ValueError):
        return None


def encode_dwave(wave: int, fence: int, origin: str, round_id: int = 0) -> tuple:
    """Wave announcement; the trailing round stamp is the root's
    current termination round riding the data plane (a legacy peer
    ignores it; absent decodes as round 0 = 'none disseminated')."""
    return ("dwave", int(wave), int(fence), origin, int(round_id))


def decode_dwave(frame: tuple):
    """-> (wave, fence, origin, round_id) or None."""
    try:
        return (
            int(frame[1]), int(frame[2]), str(frame[3]),
            _frame_fence(frame, 4),
        )
    except (IndexError, TypeError, ValueError):
        return None


def encode_dmark(
    wave: int,
    fence: int,
    origin: str,
    keys,
    start: int = 0,
    binary: bool = True,
    round_id: int = 0,
) -> tuple:
    """Boundary marks.  ``start`` is the position of ``keys[0]`` in the
    sender's cumulative per-peer mark list — the suffix-flush protocol:
    each flush carries only keys past the receiver's acked watermark
    (a legacy frame has no element 5 and decodes as start 0, i.e. the
    old full-cumulative shape).  ``round_id`` disseminates the
    termination round epidemic-style."""
    return (
        "dmark", int(wave), int(fence), origin,
        _keys_payload(keys, binary), int(start), int(round_id),
    )


def decode_dmark(frame: tuple):
    """-> (wave, fence, origin, [(address, uid), ...], start, round_id)
    or None."""
    try:
        keys = _decode_keys(frame[4])
        if keys is None:
            return None
        return (
            int(frame[1]), int(frame[2]), str(frame[3]), keys,
            _frame_fence(frame, 5), _frame_fence(frame, 6),
        )
    except (IndexError, TypeError, ValueError):
        return None


def _frame_fence(frame: tuple, index: int) -> int:
    """Trailing fence element shared by the wave-keyed frames: wave ids
    restart per partition era, so era-less frames could alias across a
    membership change.  Absent (an older peer) decodes as era 0 —
    tolerant both directions."""
    try:
        return int(frame[index])
    except (IndexError, TypeError, ValueError):
        return 0


def encode_dmack(
    wave: int,
    origin: str,
    count: int,
    fence: int = 0,
    round_id: int = 0,
    report=None,
) -> tuple:
    """Mark ack.  ``count`` is the receiver's CONTIGUOUS coverage
    watermark over the sender's mark list (identical to the old
    cumulative distinct count under full-list sends, so legacy senders
    read it unchanged).  ``round_id`` disseminates the termination
    round; ``report`` optionally piggybacks the acker's settled
    termination report ``(settled, changed, sent, recv, nodes)`` for
    that round — how leaf reports ride the data plane instead of
    explicit dstat frames."""
    return (
        "dmack", int(wave), origin, int(count), int(fence),
        int(round_id),
        tuple(int(v) for v in report) if report is not None else None,
    )


def decode_dmack(frame: tuple):
    """-> (wave, origin, count, fence, round_id, report) or None."""
    try:
        return (
            int(frame[1]), str(frame[2]), int(frame[3]),
            _frame_fence(frame, 4), _frame_fence(frame, 5),
            _frame_report(frame, 6),
        )
    except (IndexError, TypeError, ValueError):
        return None


def encode_dprobe(wave: int, round_id: int, origin: str, fence: int = 0) -> tuple:
    return ("dprobe", int(wave), int(round_id), origin, int(fence))


def decode_dprobe(frame: tuple):
    """-> (wave, round, origin, fence) or None."""
    try:
        return (
            int(frame[1]), int(frame[2]), str(frame[3]),
            _frame_fence(frame, 4),
        )
    except (IndexError, TypeError, ValueError):
        return None


def encode_dstat(
    wave: int, round_id: int, origin: str, stats: dict, fence: int = 0
) -> tuple:
    return (
        "dstat", int(wave), int(round_id), origin,
        json.dumps(stats, default=repr).encode(), int(fence),
    )


def decode_dstat(frame: tuple):
    """-> (wave, round, origin, stats_dict, fence) or None.  Unknown
    stat keys pass through untouched (a newer peer may report more)."""
    try:
        payload = frame[4]
        if not isinstance(payload, bytes):
            return None
        try:
            stats = json.loads(payload)
        except ValueError:
            return None
        if not isinstance(stats, dict):
            return None
        return (
            int(frame[1]), int(frame[2]), str(frame[3]), stats,
            _frame_fence(frame, 5),
        )
    except (IndexError, TypeError, ValueError):
        return None


def encode_dfin(wave: int, fence: int, origin: str) -> tuple:
    return ("dfin", int(wave), int(fence), origin)


def decode_dfin(frame: tuple):
    """-> (wave, fence, origin) or None."""
    try:
        return int(frame[1]), int(frame[2]), str(frame[3])
    except (IndexError, TypeError, ValueError):
        return None


def encode_dgate(wave: int, fence: int, origin: str, pairs) -> tuple:
    """``pairs`` is [(sup_key, child_key), ...] with each key an
    (address, uid) tuple."""
    body = json.dumps(
        [[s[0], int(s[1]), c[0], int(c[1])] for s, c in pairs]
    ).encode()
    return ("dgate", int(wave), int(fence), origin, body)


def decode_dgate(frame: tuple):
    """-> (wave, fence, origin, [((sup_addr, sup_uid), (child_addr,
    child_uid)), ...]) or None."""
    try:
        payload = frame[4]
        if not isinstance(payload, bytes):
            return None
        try:
            raw = json.loads(payload)
        except ValueError:
            return None
        pairs = []
        for item in raw:
            pairs.append(
                ((str(item[0]), int(item[1])), (str(item[2]), int(item[3])))
            )
        return int(frame[1]), int(frame[2]), str(frame[3]), pairs
    except (IndexError, TypeError, ValueError):
        return None


def encode_dgack(wave: int, origin: str, count: int, fence: int = 0) -> tuple:
    return ("dgack", int(wave), origin, int(count), int(fence))


def decode_dgack(frame: tuple):
    """-> (wave, origin, count, fence) or None."""
    try:
        return (
            int(frame[1]), str(frame[2]), int(frame[3]),
            _frame_fence(frame, 4),
        )
    except (IndexError, TypeError, ValueError):
        return None


def encode_ddirty(origin: str) -> tuple:
    return ("ddirty", origin)


def decode_ddirty(frame: tuple):
    """-> origin or None."""
    try:
        return str(frame[1])
    except (IndexError, TypeError):
        return None


def encode_dcut(
    wave: int, fence: int, origin: str, count: int, entry: int
) -> tuple:
    """The per-link wave marker (port only): ``origin`` entered ``wave``
    of era ``fence`` after routing ``count`` stamped deltas of that era
    to the frame's destination; ``entry`` numbers the sender's wave
    states, so a wave it restarted in place is told from a retransmit
    (engines/crgc/distributed.py)."""
    return ("dcut", int(wave), int(fence), origin, int(count), int(entry))


def decode_dcut(frame: tuple):
    """-> (wave, fence, origin, count, entry) or None."""
    try:
        return (int(frame[1]), int(frame[2]), str(frame[3]), int(frame[4]),
                int(frame[5]))
    except (IndexError, TypeError, ValueError):
        return None


def encode_migration_ack(type_name: str, key: str, mig_id: tuple) -> tuple:
    return ("miga", type_name, key, tuple(mig_id))


def decode_migration_ack(frame: tuple):
    """-> (type_name, key, mig_id) or None."""
    try:
        type_name, key, mig_id = frame[1], frame[2], frame[3]
        if not isinstance(mig_id, tuple):
            return None
        return str(type_name), str(key), mig_id
    except (IndexError, TypeError, ValueError):
        return None
