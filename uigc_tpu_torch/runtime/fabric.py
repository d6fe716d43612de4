"""Copy of ``uigc_tpu/runtime/fabric.py`` (pure Python).  What differs:

- ``runtime/wire.py`` is bound at first use (``_wire``), not at import,
  so a single-node system, which imports this module for ``MemberUp`` and
  ``MemberRemoved``, never loads the wire codec.
- **A cell token that no longer resolves does not raise.**  The
  reference's ``wire._resolve`` raises ``LookupError`` for a uid whose
  cell the system no longer holds, and ``control_send`` runs that decode
  inside the sender's collector wake, so one such token in a delta graph
  kills the wake (``uigc_tpu/runtime/wire.py:45-58``, reached from
  ``uigc_tpu/runtime/fabric.py:302``).
  The port's ``Fabric.resolve_cell_token`` (the hook ``wire`` and
  ``schema`` consult first, as on the node transport) returns the live
  cell while it resolves and, once it does not, one ``Tombstone`` per
  ``(address, uid)`` for the life of the fabric: every later mention
  folds onto that one shadow slot, and a message sent to it is a dead
  letter, as on ``NodeFabric`` (``uigc_tpu/runtime/node.py:537-548``).
  The other half of the repair is in ``runtime/system.py``: a cell
  resolves by uid while its setup runs.

The multi-node fabric: membership + intercepted, droppable links.

Stands in for the reference's Akka Cluster + Artery remoting layer
(reference: LocalGC.scala:69-75,198-243 for membership;
streams/Egress.scala, streams/Ingress.scala, reference.conf:2-10 for the
per-link interception stages).  Multiple ActorSystems attach to one
Fabric; application messages between systems flow through per-link
egress/ingress interceptors supplied by each system's engine, with
fault-injection hooks (message drops, node crashes) for testing the
recovery paths — the in-repo multi-node harness the reference lacks
(SURVEY §4: "Multi-node testing: none in-repo").

Link guarantees mirror a single-lane Artery stream: per-link FIFO
(GUIDE.md requires one lane so ingress entries see an ordered stream).
Control-plane traffic between collectors (delta graphs, ingress-entry
broadcasts) is direct cell-to-cell — reliable and not subject to drops,
like the reference's system-actor messaging.

Two optional hardening modes push the simulation to the reference's real
deployment discipline:

- ``serialize=True``: every application message crosses the link as
  *bytes* (runtime/wire.py), so no object identity survives — refobs and
  cell references are re-materialized from (address, uid) tokens at the
  destination, the way Artery's serialization forces
  (reference.conf:2-10).
- ``async_links=True``: delivery is decoupled from the sender — messages
  and window-boundary markers ride a FIFO queue drained by a fabric
  worker thread, and the ingress finalizes the entry whose id matches the
  egress marker traveling in-stream (reference: Gateways.scala:83-94,
  168-171), tolerating in-flight next-window traffic instead of relying
  on lockstep under a synchronous link lock.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

from ..utils import events

if TYPE_CHECKING:  # pragma: no cover
    from .cell import ActorCell
    from .system import ActorSystem


class MemberUp:
    __slots__ = ("address",)

    def __init__(self, address: str):
        self.address = address

    def __repr__(self) -> str:
        return f"MemberUp({self.address})"


class MemberRemoved:
    __slots__ = ("address",)

    def __init__(self, address: str):
        self.address = address

    def __repr__(self) -> str:
        return f"MemberRemoved({self.address})"


_WIRE = None


def _wire():
    """The wire codec (``runtime/wire.py``), imported at first use."""
    global _WIRE
    if _WIRE is None:
        from . import wire

        _WIRE = wire
    return _WIRE


class Tombstone:
    """The stable stand-in for a cell whose uid no longer resolves on its
    system: it carries the token's coordinates, and whatever is told to it
    is a dead letter of its system.  ``Fabric.resolve_cell_token`` keeps
    one per ``(address, uid)``, so decoders fold every later fact about
    the actor under one key."""

    __slots__ = ("system", "uid", "path")

    def __init__(self, system: "ActorSystem", uid: int):
        self.system = system
        self.uid = uid
        self.path = f"tombstone://{system.address}/{uid}"

    def tell(self, msg: Any) -> None:
        self.system.record_dead_letter(self, msg)

    def __repr__(self) -> str:
        return f"Tombstone({self.system.address}, uid={self.uid})"


class Link:
    """One directed link between two systems, with its engine-supplied
    egress (at the sender) and ingress (at the receiver) interceptors.

    ``send_lock`` serializes the egress stage (window stamping must be
    FIFO with enqueue order); ``recv_lock`` serializes the ingress stage
    (tallying and window finalization).  The synchronous delivery path
    holds both in order; the async path splits them between the sender
    and the drain worker."""

    __slots__ = ("src", "dst", "egress", "ingress", "send_lock", "recv_lock", "drop_filter")

    def __init__(self, src: "ActorSystem", dst: "ActorSystem"):
        self.src = src
        self.dst = dst
        # Interceptors (None = pass-through, the default Engine behavior;
        # reference: Engine.scala:225-276).
        self.egress = src.engine.spawn_egress(self)
        self.ingress = dst.engine.spawn_ingress(self)
        self.send_lock = threading.Lock()
        self.recv_lock = threading.Lock()
        self.drop_filter: Optional[Callable[[Any], bool]] = None


class Fabric:
    def __init__(
        self,
        serialize: Optional[bool] = None,
        async_links: Optional[bool] = None,
    ) -> None:
        self._lock = threading.Lock()
        self.systems: Dict[str, "ActorSystem"] = {}
        self.crashed: set = set()
        self._links: Dict[Tuple[str, str], Link] = {}
        self._subscribers: List["ActorCell"] = []
        # None = auto: wire mode (byte serialization + async FIFO links)
        # switches ON as soon as the fabric carries a second system.  A
        # multi-node test written without thinking about link modes must
        # get the discipline a real deployment forces — object identity
        # across "nodes" only survives by explicit opt-out
        # (serialize=False, the perf escape hatch).
        self._serialize_opt = serialize
        self._async_opt = async_links
        self.serialize = bool(serialize)
        self.async_links = bool(async_links)
        #: seeded fault-injection policy (runtime/faults.py) — the same
        #: object the cross-process NodeFabric consults, applied here at
        #: the message admission edge (drop_messages rules + partitions).
        self.fault_plan = None
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()
        #: (address, uid) -> Tombstone, for tokens whose cell is gone
        self._tombstones: Dict[Tuple[str, int], Tombstone] = {}

    # ------------------------------------------------------------- #
    # Membership (reference: LocalGC.scala:69-86,198-243)
    # ------------------------------------------------------------- #

    def register_system(self, system: "ActorSystem") -> None:
        with self._lock:
            self.systems[system.address] = system
            if len(self.systems) >= 2:
                if self._serialize_opt is None:
                    self.serialize = True
                if self._async_opt is None:
                    self.async_links = True
            subscribers = list(self._subscribers)
        for subscriber in subscribers:
            subscriber.tell(MemberUp(system.address))

    def unregister_system(self, system: "ActorSystem") -> None:
        self.remove_system(system.address)

    def subscribe(self, cell: "ActorCell") -> None:
        """Subscribe a (collector) cell to membership events; current
        members are replayed, like Akka's CurrentClusterState."""
        with self._lock:
            self._subscribers.append(cell)
            current = [a for a in self.systems if a not in self.crashed]
        for address in current:
            cell.tell(MemberUp(address))

    def remove_system(self, address: str) -> None:
        """A node leaves (or crashes): stop delivering to it, notify the
        survivors (reference: LocalGC.scala:81-83,228-243)."""
        with self._lock:
            if address not in self.systems or address in self.crashed:
                return
            self.crashed.add(address)
            subscribers = [
                s for s in self._subscribers
                if s.system.address != address
            ]
        for subscriber in subscribers:
            subscriber.tell(MemberRemoved(address))

    def crash(self, system: "ActorSystem") -> None:
        """Simulate an abrupt node failure (fault injection): the node's
        engine stops acting immediately, then survivors are notified."""
        with self._lock:
            already = system.address in self.crashed
        if not already:
            events.recorder.commit(
                events.NODE_CRASHED, address=system.address, reason="injected"
            )
            system.engine.on_crash()
        self.remove_system(system.address)

    def members(self) -> List[str]:
        with self._lock:
            return [a for a in self.systems if a not in self.crashed]

    def resolve_cell_token(self, address: str, uid: int):
        """Resolve a wire token (``runtime/wire.py`` and ``schema.py``
        consult this hook first): the cell while its system resolves the
        uid, else the token's one ``Tombstone``.  An address no system on
        this fabric has still raises ``LookupError``."""
        system = self.systems.get(address)
        if system is None:
            raise LookupError(f"unknown system {address!r} on this fabric")
        cell = system.resolve_cell(uid)
        if cell is not None:
            return cell
        key = (address, uid)
        with self._lock:
            stone = self._tombstones.get(key)
            if stone is None:
                stone = self._tombstones[key] = Tombstone(system, uid)
        return stone

    def peer_nonce(self, address: str) -> Optional[int]:
        """In-process systems have no process-incarnation identity
        (NodeFabric overrides this with the hello nonce); None disables
        the undo log's nonce discipline and leaves the fence era as the
        only incarnation separator."""
        return None

    # ------------------------------------------------------------- #
    # Links and delivery
    # ------------------------------------------------------------- #

    def link(self, src: "ActorSystem", dst: "ActorSystem") -> Link:
        key = (src.address, dst.address)
        with self._lock:
            link = self._links.get(key)
            if link is None:
                link = Link(src, dst)
                self._links[key] = link
            return link

    def set_drop_filter(
        self, src: "ActorSystem", dst: "ActorSystem", fn: Optional[Callable[[Any], bool]]
    ) -> None:
        """Inject message drops on a link: fn(msg) -> True to drop."""
        self.link(src, dst).drop_filter = fn

    def set_fault_plan(self, plan) -> None:
        """Attach (or clear) a seeded ``FaultPlan`` (runtime/faults.py);
        its message-level rules and partitions apply at the admission
        edge of every link on this fabric."""
        self.fault_plan = plan

    def deliver(
        self, src: "ActorSystem", target: "ActorCell", msg: Any
    ) -> None:
        """Send an application message across a link: egress interception,
        (optional) serialization, FIFO transit, (optional) drop, ingress
        interception, then local delivery
        (reference: Gateways.scala:72-115,153-191)."""
        dst = target.system
        if src.address in self.crashed:
            return
        link = self.link(src, dst)
        with link.send_lock:
            if link.egress is not None:
                link.egress.on_message(target, msg)
            payload = _wire().encode_message(msg) if self.serialize else msg
            if self.async_links:
                self._enqueue(("msg", link, target, payload))
                return
            # Synchronous mode: tally under recv_lock *before* releasing
            # send_lock, so a window's marker (finalize_egress, which
            # acquires send_lock first) cannot finalize between this
            # message's stamp and its tally — a stamped-but-untallied
            # message would otherwise land in a window that already
            # closed and strand its admitted counts.
            self._deliver_now(link, target, payload)

    def _deliver_now(self, link: Link, target: "ActorCell", payload: Any) -> None:
        # One admission edge for both shapes: a single message is a
        # run of one (decode, drop filters, crashed gate, ingress tally
        # + enqueue under recv_lock all live in _deliver_run).
        self._deliver_run(link, target, [payload])

    def finalize_egress(self, src: "ActorSystem", dst_address: str) -> None:
        """Ask the egress of link (src -> dst) to close its window and
        push the boundary marker down the link; the ingress finalizes the
        admitted-entry whose id *matches the marker*, so next-window
        traffic already in flight lands in its own entry
        (reference: Gateways.scala:87-94,168-171)."""
        with self._lock:
            dst = self.systems.get(dst_address)
        if dst is None or dst_address in self.crashed or src.address in self.crashed:
            return
        link = self.link(src, dst)
        with link.send_lock:
            if link.egress is None or link.ingress is None:
                return
            marker = link.egress.finalize_entry()
            if self.async_links:
                self._enqueue(("marker", link, marker.id))
                return
            with link.recv_lock:
                link.ingress.finalize_window(marker.id)

    def finalize_dead_link(self, src_address: str, dst: "ActorSystem") -> None:
        """A node died: after any in-flight traffic drains, flush every
        open ingress window of the (dead -> dst) link and emit the final
        entry that joins the crash quorum (reference: Gateways.scala:129,
        LocalGC.scala:228-243).  Queued-but-undelivered messages simply
        never reach the ingress tally — they stay *unadmitted*, which is
        exactly what the undo log reverts (UndoLog.java:39-93)."""
        with self._lock:
            link = self._links.get((src_address, dst.address))
        if link is None or link.ingress is None:
            return
        if self.async_links:
            self._enqueue(("final", link))
            return
        with link.recv_lock:
            link.ingress.finalize_all(is_final=True)
        events.recorder.commit(
            events.DEAD_LINK_FINALIZED, src=src_address, dst=dst.address
        )

    def control_send(self, src: "ActorSystem", target_cell: "ActorCell", msg: Any) -> None:
        """Collector control plane: reliable, ordered cell-to-cell
        delivery (the reference's Bookkeeper ActorSelection gossip,
        LocalGC.scala:201), not subject to drops or the app-message
        queue.  In serialize mode the payload still crosses as bytes —
        delta graphs and ingress entries through their own wire formats
        (DeltaGraph.java:189-232, IngressEntry.java:103-144), everything
        else through the generic codec."""
        if src.address in self.crashed:
            return
        if target_cell.system.address in self.crashed:
            return
        if self.serialize:
            reencode = getattr(msg, "reencode", None)
            if reencode is not None:
                msg = reencode(self, target_cell.system)
            else:
                msg = _wire().decode_message(self, _wire().encode_message(msg))
        target_cell.tell(msg)

    # ------------------------------------------------------------- #
    # Async transit (single drain worker: global FIFO, per-link FIFO)
    # ------------------------------------------------------------- #

    def _enqueue(self, item: tuple) -> None:
        with self._cv:
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._drain_loop, name="fabric-drain", daemon=True
                )
                self._worker.start()
            self._queue.append(item)
            self._idle.clear()
            self._cv.notify()

    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue:
                    self._idle.set()
                    self._cv.wait()
                # Batch-pop: one condition round-trip per burst instead
                # of per item (the transit queue's analogue of the node
                # transport's writer coalescing).
                items = []
                for _ in range(min(len(self._queue), 256)):
                    items.append(self._queue.popleft())
            i = 0
            n = len(items)
            while i < n:
                item = items[i]
                kind, link = item[0], item[1]
                try:
                    if kind == "msg":
                        # Coalesce the run of consecutive messages bound
                        # for the same cell over the same link: one
                        # decode/filter pass each, then a single
                        # recv_lock hold + tell_batch, so a burst
                        # schedules one dispatcher batch instead of N.
                        target = item[2]
                        j = i + 1
                        while (
                            j < n
                            and items[j][0] == "msg"
                            and items[j][1] is link
                            and items[j][2] is target
                        ):
                            j += 1
                        if j - i == 1:
                            self._deliver_now(link, target, item[3])
                        else:
                            self._deliver_run(
                                link, target, [it[3] for it in items[i:j]]
                            )
                        i = j
                        continue
                    elif kind == "marker":
                        with link.recv_lock:
                            link.ingress.finalize_window(item[2])
                    else:  # "final"
                        with link.recv_lock:
                            link.ingress.finalize_all(is_final=True)
                        events.recorder.commit(
                            events.DEAD_LINK_FINALIZED,
                            src=link.src.address,
                            dst=link.dst.address,
                        )
                except Exception:  # pragma: no cover - keep the lane alive
                    import traceback

                    traceback.print_exc()
                i += 1

    def _deliver_run(self, link: Link, target: "ActorCell", payloads: list) -> None:
        """The run-delivery half of the batched drain: decode and filter
        each payload (same admission edge as _deliver_now), then tally
        and enqueue the survivors under one recv_lock hold."""
        msgs = []
        for payload in payloads:
            try:
                msg = (
                    _wire().decode_message(self, payload)
                    if self.serialize
                    else payload
                )
            except Exception:
                # One undecodable payload must not void the rest of the
                # run (the per-item path lost exactly one message too).
                import traceback

                traceback.print_exc()
                continue
            if link.drop_filter is not None and link.drop_filter(msg):
                continue
            if self.fault_plan is not None and self.fault_plan.drop_inbound(
                link.src.address, link.dst.address, msg
            ):
                events.recorder.commit(
                    events.FRAME_DROPPED,
                    src=link.src.address,
                    dst=link.dst.address,
                    kind="app",
                )
                continue
            msgs.append(msg)
        if not msgs or link.dst.address in self.crashed:
            return
        with link.recv_lock:
            if link.ingress is not None:
                for msg in msgs:
                    link.ingress.on_message(target, msg)
            # enqueue under recv_lock keeps mailbox order consistent
            # with the ingress tally order (per-link FIFO all the way
            # down).
            if hasattr(target, "tell_batch"):
                target.tell_batch(msgs)
            else:
                for msg in msgs:
                    target.tell(msg)

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Wait until the transit queue is drained (tests)."""
        return self._idle.wait(timeout_s)

    def queue_depth(self) -> int:
        """Messages currently in async transit — the telemetry gauge
        tap (``uigc_fabric_transit_depth``)."""
        with self._cv:
            return len(self._queue)
