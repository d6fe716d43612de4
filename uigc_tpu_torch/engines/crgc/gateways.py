"""Copy of ``uigc_tpu/engines/crgc/gateways.py`` (pure Python).

Per-link gateways: admitted-message/ref accounting at node boundaries.

Mirrors the reference's Artery stream-stage interceptors (reference:
crgc/Gateways.scala:15-191, crgc/IngressEntry.java:12-158): the egress of
each link stamps outbound AppMsgs with its current window and tallies
them; the ingress tallies what was actually admitted.  When the egress's
window-boundary marker arrives (pushed in-stream, so FIFO with app
messages), the ingress finalizes its own entry and hands it to the local
collector.  These admitted-counts are what make node-crash recovery
possible: the undo log reverts exactly the dead node's *unadmitted*
claims (reference: UndoLog.java:39-93).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Iterable, Optional

from ...utils import events
from .messages import AppMsg

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell
    from ...runtime.fabric import Link
    from .engine import CRGC


class IngressEntryField:
    """(reference: IngressEntry.java:32-42)"""

    __slots__ = ("message_count", "created_refs")

    def __init__(self) -> None:
        self.message_count = 0
        self.created_refs: Dict["ActorCell", int] = {}

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, IngressEntryField)
            and self.message_count == other.message_count
            and self.created_refs == other.created_refs
        )


class IngressEntry:
    """Per-link tally of admitted messages and refs
    (reference: IngressEntry.java:12-100).

    ``fence`` is the *incarnation era* of the egress peer as counted by
    the tallying node (bumped once per observed death of that address,
    engine ``bump_link_fence``): windows are keyed by (peer, fence), so
    a rejoined incarnation's window ids — which restart from zero —
    can never merge with stragglers of its pre-death stream.

    ``nonce`` is the egress peer's process-incarnation identity (the
    NodeFabric hello nonce) as known to the tallying node when the
    window opened — unlike the fence it is the SAME value at every
    observer, so an undo log can refuse another node's stragglers about
    a previous incarnation outright instead of inferring staleness from
    that node's own (incomparable) era counter.  0 = unknown (an
    in-process fabric, or a frame from a peer that predates the
    field)."""

    __slots__ = (
        "id", "admitted", "egress_address", "ingress_address", "is_final",
        "fence", "nonce",
    )

    def __init__(self) -> None:
        self.id = 0
        self.admitted: Dict["ActorCell", IngressEntryField] = {}
        self.egress_address: Optional[str] = None
        self.ingress_address: Optional[str] = None
        self.is_final = False
        self.fence = 0
        self.nonce = 0

    def on_message(self, recipient: "ActorCell", refs: Iterable[Any]) -> None:
        """(reference: IngressEntry.java:91-100)"""
        field = self.admitted.get(recipient)
        if field is None:
            field = IngressEntryField()
            self.admitted[recipient] = field
        field.message_count += 1
        for refob in refs:
            target = refob.target
            field.created_refs[target] = field.created_refs.get(target, 0) + 1

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, IngressEntry)
            and self.id == other.id
            and self.fence == other.fence
            and self.nonce == other.nonce
            and self.is_final == other.is_final
            and self.egress_address == other.egress_address
            and self.ingress_address == other.ingress_address
            and self.admitted == other.admitted
        )

    # Wire format (reference: IngressEntry.java:103-144 field order).

    def serialize(self, encode_cell) -> bytes:
        import struct

        def pack_str(s):
            b = (s or "").encode()
            return struct.pack(">h", len(b)) + b

        parts = [
            struct.pack(">i?", self.id, self.is_final),
            pack_str(self.ingress_address),
            pack_str(self.egress_address),
            struct.pack(">i", len(self.admitted)),
        ]
        for cell, field in self.admitted.items():
            ref = encode_cell(cell)
            parts.append(struct.pack(">h", len(ref)))
            parts.append(ref)
            parts.append(struct.pack(">ii", field.message_count, len(field.created_refs)))
            for target, count in field.created_refs.items():
                tref = encode_cell(target)
                parts.append(struct.pack(">h", len(tref)))
                parts.append(tref)
                parts.append(struct.pack(">i", count))
        # Fence era + incarnation nonce as trailing fields: decoders
        # that predate them stop at the admitted map (tolerant both
        # directions; a fence-only peer reads the fence and ignores
        # the nonce bytes).
        parts.append(struct.pack(">iQ", self.fence, self.nonce))
        data = b"".join(parts)
        if events.recorder.enabled:
            events.recorder.commit(events.INGRESS_ENTRY_SERIALIZATION, size=len(data))
        return data

    @staticmethod
    def deserialize(buf: bytes, decode_cell) -> "IngressEntry":
        import struct

        offset = 0

        def unpack_str():
            nonlocal offset
            (n,) = struct.unpack_from(">h", buf, offset)
            offset += 2
            s = buf[offset : offset + n].decode()
            offset += n
            return s or None

        entry = IngressEntry()
        entry.id, entry.is_final = struct.unpack_from(">i?", buf, offset)
        offset += 5
        entry.ingress_address = unpack_str()
        entry.egress_address = unpack_str()
        (n_actors,) = struct.unpack_from(">i", buf, offset)
        offset += 4
        for _ in range(n_actors):
            (rlen,) = struct.unpack_from(">h", buf, offset)
            offset += 2
            cell = decode_cell(buf[offset : offset + rlen])
            offset += rlen
            field = IngressEntryField()
            field.message_count, n_refs = struct.unpack_from(">ii", buf, offset)
            offset += 8
            for _ in range(n_refs):
                (tlen,) = struct.unpack_from(">h", buf, offset)
                offset += 2
                target = decode_cell(buf[offset : offset + tlen])
                offset += tlen
                (count,) = struct.unpack_from(">i", buf, offset)
                offset += 4
                field.created_refs[target] = count
            entry.admitted[cell] = field
        if offset + 4 <= len(buf):
            (entry.fence,) = struct.unpack_from(">i", buf, offset)
        if offset + 12 <= len(buf):
            (entry.nonce,) = struct.unpack_from(">Q", buf, offset + 4)
        return entry


class Gateway:
    """(reference: Gateways.scala:25-48)"""

    def __init__(self, egress_address: str, ingress_address: str):
        self.egress_address = egress_address
        self.ingress_address = ingress_address
        self._seqnum = 0
        self.current_entry = self._create_entry()

    def _create_entry(self) -> IngressEntry:
        entry = IngressEntry()
        entry.id = self._seqnum
        entry.egress_address = self.egress_address
        entry.ingress_address = self.ingress_address
        self._seqnum += 1
        return entry

    def finalize_entry(self) -> IngressEntry:
        entry = self.current_entry
        self.current_entry = self._create_entry()
        return entry


class Egress(Gateway):
    """Sender-side interceptor (reference: Gateways.scala:55-115).

    Only stamps the window id and rolls the window on finalize; the
    admitted-count tally lives exclusively at the ingress.  (The
    reference's egress also tallies into its own entry, but that entry's
    content is discarded at the ingress — Gateways.scala:168-171 uses it
    purely as a window-boundary marker — so the duplicate per-message
    bookkeeping is skipped here.)  The fence era a window belongs to is
    stamped by the *ingress* (the tallying side counts the egress
    peer's deaths); the egress needs none."""

    def __init__(self, link: "Link"):
        super().__init__(link.src.address, link.dst.address)

    def on_message(self, recipient: "ActorCell", msg: Any) -> None:
        if isinstance(msg, AppMsg):
            msg.window_id = self.current_entry.id


class Ingress:
    """Receiver-side interceptor; finalized entries go to the local
    collector (reference: Gateways.scala:121-141).

    Admitted tallies are bucketed *by the window id stamped on each
    message*, and a window closes when the egress's boundary marker for
    that id arrives (reference: Gateways.scala:83-94,168-171 finalizes
    the entry matching the in-stream marker).  Next-window messages that
    overtake a marker's processing therefore land in their own entry
    instead of corrupting the closing one — the property that makes the
    async link mode sound."""

    def __init__(self, link: "Link", engine: "CRGC"):
        self.egress_address = link.src.address
        self.ingress_address = link.dst.address
        self.engine = engine
        #: (fence, window_id) -> tally: a rejoined incarnation restarts
        #: its window numbering from zero, and only the fence era keeps
        #: its stream apart from pre-death stragglers of the same ids
        self.entries: Dict[tuple, IngressEntry] = {}
        #: highest window id seen per fence era (the final entry that
        #: joins the crash quorum must outnumber every era window)
        self._max_window: Dict[int, int] = {}

    def _fence(self) -> int:
        """The egress peer's incarnation era, as this node counts it."""
        return self.engine.link_fence(self.egress_address)

    def _nonce(self) -> int:
        """The egress peer's process-incarnation nonce (0 when the
        fabric has none — in-process, or pre-hello)."""
        system = getattr(self.engine, "system", None)
        fabric = getattr(system, "fabric", None)
        if fabric is None:
            return 0
        return fabric.peer_nonce(self.egress_address) or 0

    def _make_entry(self, window_id: int, fence: int) -> IngressEntry:
        entry = IngressEntry()
        entry.id = window_id
        entry.fence = fence
        entry.nonce = self._nonce()
        entry.egress_address = self.egress_address
        entry.ingress_address = self.ingress_address
        return entry

    def on_message(self, recipient: "ActorCell", msg: Any) -> None:
        if isinstance(msg, AppMsg):
            wid = msg.window_id
            fence = self._fence()
            if wid > self._max_window.get(fence, -1):
                self._max_window[fence] = wid
            entry = self.entries.get((fence, wid))
            if entry is None:
                entry = self.entries[(fence, wid)] = self._make_entry(wid, fence)
            entry.on_message(recipient, msg.refs)

    def on_messages(self, recipient: "ActorCell", msgs: list) -> None:
        """Bulk admission tally for a delivered run (runtime/node.py
        ``_admit_app_run``): one gateway call per burst instead of one
        per message — same per-message semantics, the loop just lives
        inside the gateway."""
        entries = self.entries
        fence = self._fence()
        max_w = self._max_window.get(fence, -1)
        for msg in msgs:
            if isinstance(msg, AppMsg):
                wid = msg.window_id
                if wid > max_w:
                    max_w = wid
                entry = entries.get((fence, wid))
                if entry is None:
                    entry = entries[(fence, wid)] = self._make_entry(wid, fence)
                entry.on_message(recipient, msg.refs)
        self._max_window[fence] = max_w

    def _send(self, entry: IngressEntry) -> None:
        from .collector import LocalIngressEntry

        self.engine.bookkeeper_cell.tell(LocalIngressEntry(entry))

    def finalize_window(self, window_id: int, is_final: bool = False) -> None:
        """Close the window the egress marker names (empty entries are
        emitted too — the collector's undo log needs the window sequence
        even when no traffic was admitted).  Markers ride in-stream, so
        the era they close is the link's current one."""
        fence = self._fence()
        if window_id > self._max_window.get(fence, -1):
            self._max_window[fence] = window_id
        entry = self.entries.pop((fence, window_id), None)
        if entry is None:
            entry = self._make_entry(window_id, fence)
        if is_final:
            entry.is_final = True
        self._send(entry)

    def finalize_all(self, is_final: bool = False) -> None:
        """Link death: flush every open window in order (older eras
        first — their markers are never coming), then emit the final
        (possibly empty) entry that joins the crash quorum under the
        dying era (reference: Gateways.scala:129, LocalGC.scala:251-266)."""
        fence = self._fence()
        for key in sorted(self.entries):
            entry = self.entries.pop(key)
            self._send(entry)
        final_entry = self._make_entry(self._max_window.get(fence, -1) + 1, fence)
        final_entry.is_final = is_final
        self._send(final_entry)

    def open_windows(self) -> list:
        """(fence, window_id) pairs still awaiting their boundary marker
        (chaos-bench diagnostics; a healthy link converges to empty
        between finalizations — windows that never close are admitted
        counts the collector will only see at link death)."""
        return sorted(self.entries)

    # Compatibility shim for the lockstep call shape (single window).
    def finalize_and_send(self, is_final: bool = False) -> None:
        self.finalize_all(is_final=is_final)
