"""Copy of ``uigc_tpu/engines/mac/detector.py`` (pure Python) with four
changes: the detector resolves ``uigc.mac.device`` once, when it is built
(``resolve_device``: a missing card raises then, and the detector's own
thread never picks its current card); ``_device_sccs`` calls
``ops/scc.py:scc_labels_torch`` on that device in place of
``scc_labels_jax``; a ``scans`` counter is bumped at the top of each
``scan()``, which ``models/workloads.py`` reads to hold a topology for a
number of detector scans; and pending probes are indexed by member
(``_token_of``), so an UNB voids its member's probe in O(1).  The
reference walks every pending probe for each UNB, which is quadratic
when a release wave's UNBs meet thousands of pending probes (ROADMAP.md
Queue 3); the decisions are the same.

MAC cycle detector with real SCC-based collection.

The reference's detector only echoes CNF probes at apparently-blocked
actors and "doesn't actually detect garbage" (reference: reference.conf:48,
mac/CycleDetector.scala:42-97).  This detector completes the algorithm:

1. Blocked actors send BLK snapshots carrying their reference count, their
   weight table, and their child count (the protocol channel mirrors
   reference: CycleDetector.scala:16-39, extended with rc/children).
2. The detector finds strongly connected components among blocked,
   childless actors and checks each candidate cycle is *closed*: every
   member's rc is exactly the sum of weights held by members toward it —
   no external actor can ever message the cycle.
3. Closed cycles are probed with CNF(token); members still blocked ACK
   (reference protocol, CycleDetector.scala:63-81).  Because in-process
   enqueue order is causal here (single node, like the reference's
   causal-delivery requirement), an app message racing the probe always
   lands before the CNF and triggers UNB, invalidating the token.
4. Fully ACKed cycles are garbage: members receive KillMsg.

Cycles containing actors with children are left uncollected (killing a
parent cascades to children the detector can't reason about) — sound but
deliberately incomplete, like the reference's supervisor marking
(ShadowGraph.java:242-267).
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Any, Dict, List, Set, Tuple

from ...runtime.behaviors import RawBehavior
from ...utils import events
from ...utils.platform import resolve_device

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell
    from .engine import MAC


class BLK:
    """Actor has blocked (reference: CycleDetector.scala:18-23, extended
    with rc and child count for closedness checking)."""

    __slots__ = ("sender", "rc", "actor_map", "num_children")

    def __init__(self, sender, rc, actor_map, num_children):
        self.sender = sender
        self.rc = rc
        self.actor_map = actor_map  # list of (target_cell, weight)
        self.num_children = num_children


class UNB:
    """Actor unblocked after BLK (reference: CycleDetector.scala:25-29)."""

    __slots__ = ("sender",)

    def __init__(self, sender):
        self.sender = sender


class ACK:
    """Actor confirms it is still blocked (reference:
    CycleDetector.scala:31-38)."""

    __slots__ = ("sender", "token")

    def __init__(self, sender, token):
        self.sender = sender
        self.token = token


class _Wakeup:
    __slots__ = ()


WAKEUP = _Wakeup()


def strongly_connected_components(
    nodes: List[Any], edges: Dict[Any, List[Any]]
) -> List[List[Any]]:
    """Iterative Tarjan SCC over the blocked-actor graph."""
    index_of: Dict[Any, int] = {}
    lowlink: Dict[Any, int] = {}
    on_stack: Set[Any] = set()
    stack: List[Any] = []
    sccs: List[List[Any]] = []
    counter = itertools.count()

    for root in nodes:
        if root in index_of:
            continue
        work = [(root, iter(edges.get(root, ())))]
        index_of[root] = lowlink[root] = next(counter)
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for succ in it:
                if succ not in index_of:
                    index_of[succ] = lowlink[succ] = next(counter)
                    stack.append(succ)
                    on_stack.add(succ)
                    work.append((succ, iter(edges.get(succ, ()))))
                    advanced = True
                    break
                elif succ in on_stack:
                    lowlink[node] = min(lowlink[node], index_of[succ])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == index_of[node]:
                scc = []
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    scc.append(member)
                    if member is node:
                        break
                sccs.append(scc)
    return sccs


class CycleDetector(RawBehavior):
    """(reference: mac/CycleDetector.scala:42-97, completed)"""

    def __init__(self, engine: "MAC"):
        self.engine = engine
        self.cell: Any = None
        #: where the device SCC runs, pinned when the detector is built
        self.device = resolve_device(
            engine.system.config.get_string("uigc.mac.device")
        )
        #: scans started (the one counter this copy adds)
        self.scans = 0
        self.total_entries = 0
        self.total_cycles_collected = 0
        self._timer_keys: list = []
        self.device_scc_threshold = 1 << 30  # set from config in bind()
        #: blocked actors and their latest BLK snapshot
        self.blocked: Dict[Any, BLK] = {}
        #: outstanding confirmation: token -> (members, acks-received)
        self.pending: Dict[int, Tuple[Set[Any], Set[Any]]] = {}
        #: member -> its pending token (probes are disjoint: a new probe
        #: takes only candidates outside every pending one)
        self._token_of: Dict[Any, int] = {}
        self._token_counter = itertools.count(1)

    def bind(self, cell: Any) -> None:
        self.cell = cell
        self.device_scc_threshold = self.engine.system.config.get_int(
            "uigc.mac.device-scc-threshold"
        )
        interval_s = self.engine.system.config.get_int("uigc.mac.wakeup-interval") / 1000.0
        key = ("mac-wakeup", id(self))
        self._timer_keys.append(key)
        self.engine.system.timers.schedule_fixed_delay(
            interval_s, lambda: cell.tell(WAKEUP), key=key
        )

    def stop_timers(self) -> None:
        for key in self._timer_keys:
            self.engine.system.timers.cancel(key)
        self._timer_keys.clear()

    def on_message(self, msg: Any) -> Any:
        if isinstance(msg, _Wakeup):
            self.scan()
        return None

    def scan(self) -> None:
        """Drain the protocol queue, then detect and confirm cycles
        (reference: CycleDetector.scala:51-89, completed)."""
        from .engine import CNF, KillMsg

        self.scans += 1
        with events.recorder.timed(events.PROCESSING_MESSAGES) as ev:
            queue = self.engine.queue
            count = 0
            while True:
                try:
                    msg = queue.popleft()
                except IndexError:
                    break
                count += 1
                if isinstance(msg, BLK):
                    self.blocked[msg.sender] = msg
                elif isinstance(msg, UNB):
                    self.blocked.pop(msg.sender, None)
                    # Invalidate any pending confirmation involving it.
                    token = self._token_of.get(msg.sender)
                    if token is not None:
                        self._drop_pending(token)
                elif isinstance(msg, ACK):
                    entry = self.pending.get(msg.token)
                    if entry is not None:
                        entry[1].add(msg.sender)
            ev.fields["num_messages"] = count
            self.total_entries += count

        # Kill fully-confirmed cycles.
        if self.engine.collect_cycles:
            for token, (members, acks) in list(self.pending.items()):
                if members <= acks and all(m in self.blocked for m in members):
                    for member in members:
                        member.tell(KillMsg)
                        self.blocked.pop(member, None)
                    self._drop_pending(token)
                    self.total_cycles_collected += 1

        # Detect new candidate cycles among blocked, childless actors.
        pending_members = self._token_of
        candidates = {
            cell: blk
            for cell, blk in self.blocked.items()
            if blk.num_children == 0 and cell not in pending_members
        }
        if not candidates:
            return
        edges = {
            cell: [t for t, w in blk.actor_map if t in candidates and w > 0]
            for cell, blk in candidates.items()
        }
        if len(candidates) >= self.device_scc_threshold:
            sccs = self._device_sccs(candidates, edges)
        else:
            sccs = strongly_connected_components(list(candidates), edges)
        for scc in sccs:
            scc_set = set(scc)
            if not self._is_closed(scc_set, candidates):
                continue
            token = next(self._token_counter)
            self.pending[token] = (scc_set, set())
            for member in scc:
                self._token_of[member] = token
            for member in scc:
                member.tell(CNF(token))

    def _drop_pending(self, token: int) -> None:
        members, _ = self.pending.pop(token)
        for member in members:
            del self._token_of[member]

    def _device_sccs(
        self, candidates: Dict[Any, Any], edges: Dict[Any, List[Any]]
    ) -> List[List[Any]]:
        """SCCs via the device SCC (ops/scc.py) for large blocked sets, on
        the detector's device.

        Node and edge counts are padded to powers of two (inactive slots /
        invalid endpoints), as in the reference, where the padding bounds
        its recompiles; torch does not recompile, but the padded inputs
        stay identical to the reference's, so the two can be compared."""
        import numpy as np

        from ...ops import scc as scc_ops

        cells = list(candidates)
        index = {cell: i for i, cell in enumerate(cells)}
        src = []
        dst = []
        for cell, targets in edges.items():
            i = index[cell]
            for t in targets:
                src.append(i)
                dst.append(index[t])

        n = len(cells)
        n_pad = 1 << max(0, (n - 1).bit_length())
        m_pad = 1 << max(0, (max(1, len(src)) - 1).bit_length())
        active = np.zeros(n_pad, dtype=bool)
        active[:n] = True
        src_a = np.full(m_pad, -1, dtype=np.int32)
        dst_a = np.full(m_pad, -1, dtype=np.int32)
        src_a[: len(src)] = src
        dst_a[: len(dst)] = dst

        labels = scc_ops.scc_labels_torch(
            n_pad, src_a, dst_a, active, device=self.device
        )
        groups: Dict[int, List[Any]] = {}
        for i, cell in enumerate(cells):
            groups.setdefault(int(labels[i]), []).append(cell)
        return list(groups.values())

    def _is_closed(self, scc: Set[Any], candidates: Dict[Any, BLK]) -> bool:
        """A cycle is closed iff for every member, rc + RC_INC equals the
        total weight held by members toward it (the initial self-map entry
        carries RC_INC weight that is never counted in rc — reference:
        MAC.scala:118-120).  Equality means no external actor holds a
        reference and no Inc/Dec control messages are in flight, so nothing
        outside the cycle can ever message it."""
        from .engine import RC_INC

        for member in scc:
            inbound = 0
            for owner in scc:
                for target, weight in candidates[owner].actor_map:
                    if target is member:
                        inbound += weight
            if candidates[member].rc + RC_INC != inbound:
                return False
        return True


__all__ = ["ACK", "BLK", "CycleDetector", "UNB", "strongly_connected_components"]
