"""Copy of ``uigc_tpu/analysis/race.py`` (pure Python), held against it
by ``tests/test_torch_sanitizer.py``.

Vector-clock race detector for the cell/dispatcher scheduling layer.

Checks the documented invariants of :mod:`uigc_tpu.runtime.cell` from
the ``sched.*`` event stream alone — no runtime internals are consulted,
so the detector can run against a live recorder listener or a replayed
event log:

1. **Single-threaded cell processing** — a cell is processed by at most
   one dispatcher thread at a time (cell.py: the ``_scheduled`` flag).
   Observed as: no two ``batch_start``/``batch_end`` intervals for the
   same cell may overlap, and every batch pair must be happens-before
   ordered with its predecessor.
2. **System-before-app ordering** — system messages enqueued before a
   batch began must be invoked before that batch's first application
   message (cell.py: the sysbox drains first).
3. **Children-stop-before-PostStop** — a cell's PostStop runs only after
   every child has terminated (cell.py: ``_initiate_stop`` /
   ``_finalize``).

Event ordering: every committed event carries a ``seq`` field stamped
under the recorder lock (utils/events.py), a process-wide total order
consistent with real time.  Happens-before is tracked with genuine
vector clocks indexed by dispatcher thread: program order per thread,
release/acquire edges through each cell's mailbox (enqueue → the batch
that drains it) and through batch hand-off (batch_end → next
batch_start on the same cell).  A violated invariant therefore comes
with both interleaving evidence (the seq window) and causality evidence
(VC-concurrent batches).

In the spirit of the vector-clock race detection literature (PAPERS.md:
Tascade's atomic-free reduction-tree verification concerns), a report
is raised only when the event stream *proves* the violation — the
detector never guesses from timing alone.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..utils import events
from ..utils.validation import InvariantViolation


class RaceViolation(InvariantViolation):
    """A scheduling invariant did not hold in the observed stream."""


class VectorClock:
    """A sparse vector clock over dispatcher-thread ids."""

    __slots__ = ("clock",)

    def __init__(self, clock: Optional[Dict[Any, int]] = None):
        self.clock: Dict[Any, int] = dict(clock) if clock else {}

    def tick(self, tid: Any) -> None:
        self.clock[tid] = self.clock.get(tid, 0) + 1

    def join(self, other: "VectorClock") -> None:
        for tid, t in other.clock.items():
            if t > self.clock.get(tid, 0):
                self.clock[tid] = t

    def copy(self) -> "VectorClock":
        return VectorClock(self.clock)

    def happened_before(self, other: "VectorClock") -> bool:
        """self -> other: every component <=, and the clocks differ."""
        for tid, t in self.clock.items():
            if t > other.clock.get(tid, 0):
                return False
        return self.clock != other.clock

    def concurrent_with(self, other: "VectorClock") -> bool:
        return not self.happened_before(other) and not other.happened_before(
            self
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"VC({self.clock!r})"


class _OpenBatch:
    __slots__ = ("cell", "path", "thread", "start_seq", "start_vc", "app_seen")

    def __init__(self, cell: int, path: str, thread: Any, seq: int, vc: VectorClock):
        self.cell = cell
        self.path = path
        self.thread = thread
        self.start_seq = seq
        self.start_vc = vc
        self.app_seen = False


class RaceDetector:
    """Collects ``sched.*`` events (live via :meth:`attach`, or replayed
    via :meth:`feed`) and reports invariant violations from
    :meth:`analyze`."""

    SCHED_PREFIX = "sched."

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[Tuple[int, str, Dict[str, Any]]] = []
        self._listener = None

    # -- collection --------------------------------------------------- #

    def attach(self) -> "RaceDetector":
        """Subscribe to the process recorder (which must be enabled, and
        the system must run with ``uigc.analysis.sched-events`` on)."""

        def listener(name: str, fields: Dict[str, Any]) -> None:
            if name.startswith(self.SCHED_PREFIX):
                with self._lock:
                    self._events.append((fields.get("seq", 0), name, fields))

        self._listener = listener
        events.recorder.add_listener(listener)
        return self

    def detach(self) -> None:
        if self._listener is not None:
            events.recorder.remove_listener(self._listener)
            self._listener = None

    def feed(self, stream: Any) -> "RaceDetector":
        """Ingest a replayed stream of ``(name, fields)`` pairs; missing
        ``seq`` fields fall back to stream order."""
        with self._lock:
            base = len(self._events)
            for i, (name, fields) in enumerate(stream):
                if name.startswith(self.SCHED_PREFIX):
                    self._events.append(
                        (fields.get("seq", base + i), name, fields)
                    )
        return self

    # -- analysis ------------------------------------------------------ #

    def analyze(self) -> List[RaceViolation]:
        with self._lock:
            stream = sorted(self._events, key=lambda e: e[0])
        violations: List[RaceViolation] = []

        # Vector-clock state.
        thread_vc: Dict[Any, VectorClock] = {}
        mailbox_vc: Dict[int, VectorClock] = {}  # release clock per cell
        handoff_vc: Dict[int, VectorClock] = {}  # clock at last batch_end

        open_batches: Dict[int, _OpenBatch] = {}
        # Per-cell FIFO of pending system enqueue seqs, matched to sys
        # invokes (the runtime's sysbox is a deque).  Enqueue events are
        # committed outside the cell lock, so an invoke's commit can
        # overtake its own enqueue's commit; such an invoke banks a
        # credit that cancels the late-arriving enqueue instead of
        # leaving a ghost pending entry (a false positive otherwise).
        pending_sys: Dict[int, List[int]] = {}
        sys_credit: Dict[int, int] = {}
        children: Dict[int, List[Tuple[int, str]]] = {}
        terminated: Dict[int, int] = {}  # cell -> seq of termination

        def vc_of(tid: Any) -> VectorClock:
            vc = thread_vc.get(tid)
            if vc is None:
                vc = thread_vc[tid] = VectorClock()
            return vc

        for seq, name, fields in stream:
            cell = fields.get("cell")
            # A missing thread id (hand-written replay stream) gets a
            # unique synthetic component per event — one shared fallback
            # clock would fabricate happens-before edges between
            # causally unrelated events.
            tid = fields.get("thread", f"?{seq}")
            vc = vc_of(tid)
            vc.tick(tid)

            if name == events.SCHED_ENQUEUE:
                # Release into the cell's mailbox.
                released = mailbox_vc.get(cell)
                if released is None:
                    released = mailbox_vc[cell] = VectorClock()
                released.join(vc)
                if fields.get("kind") == "sys":
                    if sys_credit.get(cell, 0) > 0:
                        sys_credit[cell] -= 1  # already invoked, commit raced
                    else:
                        pending_sys.setdefault(cell, []).append(seq)

            elif name == events.SCHED_BATCH_START:
                prev = open_batches.get(cell)
                if prev is not None:
                    # Invariant 1: the previous batch never ended.
                    violations.append(
                        RaceViolation(
                            "sched.overlap",
                            "two dispatcher threads processed one cell "
                            "concurrently",
                            cell=fields.get("path", cell),
                            first_thread=prev.thread,
                            second_thread=tid,
                            first_start_seq=prev.start_seq,
                            second_start_seq=seq,
                            vc_concurrent=prev.start_vc.concurrent_with(vc),
                        )
                    )
                # Acquire: mailbox releases + the previous batch's end.
                released = mailbox_vc.get(cell)
                if released is not None:
                    vc.join(released)
                ended = handoff_vc.get(cell)
                if ended is not None:
                    vc.join(ended)
                open_batches[cell] = _OpenBatch(
                    cell, fields.get("path", ""), tid, seq, vc.copy()
                )

            elif name == events.SCHED_INVOKE:
                released = mailbox_vc.get(cell)
                if released is not None:
                    vc.join(released)
                batch = open_batches.get(cell)
                if fields.get("kind") == "sys":
                    queue = pending_sys.get(cell)
                    if queue:
                        queue.pop(0)
                    else:
                        sys_credit[cell] = sys_credit.get(cell, 0) + 1
                elif batch is not None and not batch.app_seen:
                    batch.app_seen = True
                    # Invariant 2: any system message enqueued strictly
                    # before this batch began must already be invoked.
                    stale = [
                        s
                        for s in pending_sys.get(cell, ())
                        if s < batch.start_seq
                    ]
                    if stale:
                        violations.append(
                            RaceViolation(
                                "sched.sys_after_app",
                                "application message invoked while earlier "
                                "system messages were pending",
                                cell=fields.get("path", cell),
                                batch_start_seq=batch.start_seq,
                                app_invoke_seq=seq,
                                pending_sys_seqs=stale,
                            )
                        )

            elif name == events.SCHED_BATCH_END:
                open_batches.pop(cell, None)
                handoff_vc[cell] = vc.copy()

            elif name == events.SCHED_SPAWN:
                parent = fields.get("parent")
                children.setdefault(parent, []).append(
                    (cell, fields.get("path", ""))
                )

            elif name == events.SCHED_POSTSTOP:
                alive = [
                    path
                    for child, path in children.get(cell, ())
                    if child not in terminated or terminated[child] > seq
                ]
                if alive:
                    # Invariant 3.
                    violations.append(
                        RaceViolation(
                            "sched.poststop_before_children",
                            "PostStop ran while children were still alive",
                            cell=fields.get("path", cell),
                            poststop_seq=seq,
                            live_children=alive,
                        )
                    )

            elif name == events.SCHED_TERMINATED:
                terminated[cell] = seq

        return violations

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)
