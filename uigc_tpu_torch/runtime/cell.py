"""Copy of ``uigc_tpu/runtime/cell.py`` (pure Python).

The actor cell: mailbox, scheduling discipline, lifecycle protocol.

This is the runtime's equivalent of Akka's ActorCell plus the forked-Akka
mailbox hook the reference depends on: the engine learns when an actor has
drained its mailbox via ``on_finished_processing`` (reference:
CRGC.scala:84-88 and MAC.scala:122-144 install
``context.queue.onFinishedProcessingHook``).  In this runtime the hook is a
first-class interface instead of a fork.

Invariants:
- A cell is processed by at most one dispatcher thread at a time
  (the ``_scheduled`` flag is only cleared by the thread that owns the
  batch, under ``_lock``).
- System messages (stop protocol, child-termination notices) are processed
  before application messages.
- Stopping a cell stops its children first; PostStop runs after all
  children have terminated, mirroring Akka's semantics that the reference's
  supervisor-marking logic relies on (reference: ShadowGraph.java:242-267).
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

from ..engines.engine import TerminationDecision
from ..interfaces import GCMessage, Message
from ..utils import events
from ..utils.validation import InvariantViolation
from .behaviors import SameBehavior, StoppedBehavior
from .signals import PostStop, Terminated

if TYPE_CHECKING:  # pragma: no cover
    from .system import ActorSystem

# Lifecycle states
_ACTIVE = 0
_STOPPING = 1
_TERMINATED = 2


class MailboxOverflowError(InvariantViolation):
    """A bounded mailbox refused a message under the ``"error"``
    overflow policy (uigc.runtime.mailbox-limit) — raised to the LOCAL
    sender; batch/transport deliveries degrade to shed-oldest instead,
    because a raise there would kill the link's receive loop."""


class _SysStop:
    __slots__ = ()


class _SysChildTerminated:
    __slots__ = ("child",)

    def __init__(self, child: "ActorCell"):
        self.child = child


class _SysWatchedTerminated:
    __slots__ = ("ref",)

    def __init__(self, ref: "ActorCell"):
        self.ref = ref


_SYS_STOP = _SysStop()


class ActorCell:
    """A single actor: identity, mailbox, behavior, children, watchers."""

    __slots__ = (
        "system",
        "uid",
        "name",
        "path",
        "parent",
        "children",
        "is_root",
        "is_managed",
        "behavior",
        "context",
        "_mailbox",
        "_claimed",
        "_sysbox",
        "_lock",
        "_scheduled",
        "_lifecycle",
        "_watchers",
        "_watching",
        "_dispatcher",
        "_needs_block_hook",
        "on_finished_processing",
        "_last_active",
        "_anon_counter",
        "mailbox_limit",
        "overflow_policy",
        "_space_cv",
        "_batch_tid",
        "__weakref__",  # the wire codec's uid registry holds cells weakly
    )

    def __init__(
        self,
        system: "ActorSystem",
        name: str,
        parent: Optional["ActorCell"],
        is_root: bool = False,
        is_managed: bool = True,
        dispatcher: Optional[Any] = None,
    ):
        self.system = system
        self.uid = system.allocate_uid()
        self.name = name
        self.path = (parent.path + "/" + name) if parent is not None else "/" + name
        self.parent = parent
        self.children: Dict[str, ActorCell] = {}
        self.is_root = is_root
        self.is_managed = is_managed
        self.behavior: Any = None
        self.context: Any = None
        self._mailbox: deque = deque()  # unbounded: bounded by the mailbox_limit admission in tell/tell_batch
        #: messages bulk-claimed by the running batch but not yet
        #: invoked — logically the mailbox HEAD.  Touched only by the
        #: thread that owns the batch (the ``_scheduled`` holder), so
        #: its pops are lock-free; drain/finalize fold it back in.
        self._claimed: deque = deque()
        self._sysbox: deque = deque()  # unbounded: the stop protocol must never shed; depth is O(children)
        self._lock = threading.Lock()
        # Pre-claimed: no batch may run until start() releases the cell,
        # so messages sent from the behavior's own constructor can't be
        # processed before the behavior exists.
        self._scheduled = True
        self._lifecycle = _ACTIVE
        self._watchers: List[ActorCell] = []
        self._watching: set = set()
        self._dispatcher = dispatcher or system.dispatcher
        # Fire the finished-processing hook once after start, so on-block
        # engines get an initial entry even from never-messaged actors.
        self._needs_block_hook = True
        self.on_finished_processing: Optional[Callable[[], None]] = None
        #: monotonic stamp of the last mailbox activity (enqueue or a
        #: processed batch) — the idle clock that drives entity
        #: passivation (uigc_tpu/cluster/passivation.py).
        self._last_active = time.monotonic()
        self._anon_counter = 0
        #: application-mailbox bound (0 = unbounded) + the policy a
        #: full mailbox applies to the incoming message; defaults from
        #: uigc.runtime.mailbox-limit / overflow-policy, overridable
        #: per cell (set_mailbox_bound — entity cells get the cluster's
        #: bound).  System messages are never bounded, and neither are
        #: unmanaged cells (Bookkeeper/coordinators: shedding GC
        #: control would corrupt the collector protocol).
        self.mailbox_limit = system.mailbox_limit if is_managed else 0
        self.overflow_policy = system.overflow_policy
        #: space-available signal for blocked senders; allocated lazily
        #: on the first blocking admission
        self._space_cv: Optional[threading.Condition] = None
        #: thread currently running _process_batch — a sender that IS
        #: that thread must never block on its own cell's bound
        self._batch_tid = 0

    # ------------------------------------------------------------------ #
    # Message delivery
    # ------------------------------------------------------------------ #

    def tell(self, msg: Any) -> None:
        """Enqueue an application-level message (a GCMessage envelope from a
        managed sender, or a raw payload destined for a root actor)."""
        shed = None
        with self._lock:
            if self._lifecycle != _ACTIVE:
                dead = True
            else:
                dead = False
                if (
                    self.mailbox_limit
                    and len(self._mailbox) >= self.mailbox_limit
                ):
                    shed = self._admit_locked(1, allow_raise=True)
                    if self._lifecycle != _ACTIVE:
                        # The cell terminated while we were blocked on
                        # admission: its mailbox is already drained —
                        # fall through to dead-letter, never append.
                        dead = True
                if not dead:
                    self._mailbox.append(msg)
                    self._last_active = time.monotonic()
                    dispatch = self._mark_scheduled()
        if shed:
            for old in shed:
                self.system.record_dead_letter(self, old)
        if dead:
            self.system.record_dead_letter(self, msg)
            return
        if self.system.sched_events and events.recorder.enabled:
            events.recorder.commit(
                events.SCHED_ENQUEUE,
                cell=self.uid,
                path=self.path,
                kind="app",
                thread=threading.get_ident(),
            )
        if dispatch:
            self._dispatcher.execute(self._process_batch)

    def tell_batch(self, msgs: List[Any]) -> None:
        """Enqueue a RUN of application messages with one lock
        acquisition and at most one dispatcher submission — the receive
        half of frame batching (runtime/node.py delivers a burst of
        remote messages to one cell as a single run, so a K-message
        burst schedules one dispatcher batch instead of K)."""
        if not msgs:
            return
        dead = None
        dispatch = False
        shed = None
        with self._lock:
            if self._lifecycle != _ACTIVE:
                dead = msgs
            else:
                if (
                    self.mailbox_limit
                    and len(self._mailbox) + len(msgs) > self.mailbox_limit
                ):
                    # Transport deliveries never raise: "error" (like a
                    # block timeout) degrades to shed-oldest here.
                    shed = self._admit_locked(len(msgs), allow_raise=False)
                    if self._lifecycle != _ACTIVE:
                        # Terminated while blocked on admission: the
                        # mailbox is drained — dead-letter the run.
                        dead = msgs
                if dead is None:
                    self._mailbox.extend(msgs)
                    if (
                        self.mailbox_limit
                        and len(self._mailbox) > self.mailbox_limit
                    ):
                        # A run longer than the whole bound sheds from
                        # its own head — FIFO preserved, control
                        # payloads skipped.
                        trimmed = self._shed_from_head_locked(0)
                        if trimmed:
                            shed = (shed or []) + trimmed
                    self._last_active = time.monotonic()
                    dispatch = self._mark_scheduled()
        if shed:
            for old in shed:
                self.system.record_dead_letter(self, old)
        if dead is not None:
            for msg in dead:
                self.system.record_dead_letter(self, msg)
            return
        if self.system.sched_events and events.recorder.enabled:
            tid = threading.get_ident()
            for _ in msgs:
                events.recorder.commit(
                    events.SCHED_ENQUEUE,
                    cell=self.uid,
                    path=self.path,
                    kind="app",
                    thread=tid,
                )
        if dispatch:
            self._dispatcher.execute(self._process_batch)

    def tell_unbounded(self, msg: Any) -> None:
        """Enqueue bypassing the mailbox bound: the channel for control
        payloads (migration/passivation/journal captures) that must
        reach a saturated entity without blocking their sender — which
        may hold region locks."""
        with self._lock:
            if self._lifecycle != _ACTIVE:
                dead = True
            else:
                dead = False
                self._mailbox.append(msg)
                self._last_active = time.monotonic()
                dispatch = self._mark_scheduled()
        if dead:
            self.system.record_dead_letter(self, msg)
            return
        if self.system.sched_events and events.recorder.enabled:
            events.recorder.commit(
                events.SCHED_ENQUEUE,
                cell=self.uid,
                path=self.path,
                kind="app",
                thread=threading.get_ident(),
            )
        if dispatch:
            self._dispatcher.execute(self._process_batch)

    def set_mailbox_bound(self, limit: int, policy: Optional[str] = None) -> None:
        """Bound this cell's application mailbox (0 = unbounded)."""
        self.mailbox_limit = max(0, int(limit))
        if policy is not None:
            self.overflow_policy = policy

    def _admit_locked(self, n: int, allow_raise: bool) -> Optional[list]:
        """Apply the overflow policy for ``n`` incoming messages;
        caller holds ``_lock`` and found the bound exceeded.  Returns
        messages shed from the mailbox head, to be dead-lettered AFTER
        the lock is released (engine accounting must not run under the
        cell lock), or None when the wait made room."""
        policy = self.overflow_policy
        limit = self.mailbox_limit
        if policy == "error":
            if allow_raise:
                if events.recorder.enabled:
                    events.recorder.commit(
                        events.BACKPRESSURE,
                        site="mailbox",
                        action="error",
                        path=self.path,
                        depth=len(self._mailbox),
                        policy=policy,
                    )
                raise MailboxOverflowError(
                    "mailbox.overflow",
                    f"bounded mailbox of {self.path} is full",
                    path=self.path,
                    limit=limit,
                    depth=len(self._mailbox),
                )
            policy = "shed-oldest"
        if policy == "block" and threading.get_ident() != self._batch_tid:
            # The admission wait IS the backpressure: on a transport
            # delivery path this stalls the link's receive thread,
            # which stalls the TCP stream, which surfaces on the peer
            # as writer-queue pushback.
            if self._space_cv is None:
                self._space_cv = threading.Condition(self._lock)
            if events.recorder.enabled:
                events.recorder.commit(
                    events.BACKPRESSURE,
                    site="mailbox",
                    action="wait",
                    path=self.path,
                    depth=len(self._mailbox),
                    policy=policy,
                )
            deadline = time.monotonic() + self.system.mailbox_block_s
            while (
                len(self._mailbox) + n > limit
                and self._lifecycle == _ACTIVE
                # A run larger than the whole bound can never fit: once
                # the mailbox is drained, waiting longer is pure stall
                # — fall through to shedding immediately.
                and self._mailbox
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._space_cv.wait(min(0.05, remaining))
            if len(self._mailbox) + n <= limit or self._lifecycle != _ACTIVE:
                return None
            # Timed out against a wedged consumer: degrade to shedding
            # rather than wedging the sender forever.
        shed = self._shed_from_head_locked(n)
        if events.recorder.enabled:
            events.recorder.commit(
                events.BACKPRESSURE,
                site="mailbox",
                action="shed",
                path=self.path,
                depth=len(self._mailbox),
                policy=self.overflow_policy,
                count=len(shed),
            )
        return shed

    def _shed_from_head_locked(self, n_incoming: int) -> list:
        """Pop sheddable messages from the mailbox head until
        ``n_incoming`` more fit under the bound.  Control payloads
        (``uigc_unsheddable``, enqueued via tell_unbounded — migration/
        passivation/journal captures) are skipped and restored in
        order: shedding a capture would wedge its key's transition
        forever.  The mailbox may therefore stay above the bound by
        the number of control messages present (a small constant)."""
        limit = self.mailbox_limit
        shed: list = []
        kept: list = []
        budget = len(self._mailbox)
        while (
            self._mailbox
            and budget > 0
            and len(self._mailbox) + len(kept) + n_incoming > limit
        ):
            old = self._mailbox.popleft()
            budget -= 1
            if getattr(old, "uigc_unsheddable", False):
                kept.append(old)
            else:
                shed.append(old)
        if kept:
            self._mailbox.extendleft(reversed(kept))
        return shed

    def tell_system(self, msg: Any) -> None:
        with self._lock:
            if self._lifecycle == _TERMINATED:
                return
            self._sysbox.append(msg)
            dispatch = self._mark_scheduled()
        if self.system.sched_events and events.recorder.enabled:
            events.recorder.commit(
                events.SCHED_ENQUEUE,
                cell=self.uid,
                path=self.path,
                kind="sys",
                thread=threading.get_ident(),
            )
        if dispatch:
            self._dispatcher.execute(self._process_batch)

    def _mark_scheduled(self) -> bool:
        """Caller must hold ``_lock``. Returns True if the caller must
        dispatch the cell."""
        if self._scheduled:
            return False
        self._scheduled = True
        return True

    # ------------------------------------------------------------------ #
    # Scheduling / processing
    # ------------------------------------------------------------------ #

    def start(self) -> None:
        """Run the initial (possibly empty) batch after spawn.

        The cell is constructed with ``_scheduled`` pre-claimed; this hands
        it to the dispatcher for the first time.  The initial batch also
        fires the finished-processing hook, so on-block engines flush an
        initial entry even for never-messaged actors.
        """
        self._dispatcher.execute(self._process_batch)

    def _process_batch(self) -> None:
        throughput = self.system.throughput
        processed = 0
        # Blocked-admission guard: a behavior sending to its OWN full
        # mailbox must shed, not deadlock against itself.
        self._batch_tid = threading.get_ident()
        # Scheduling taps for the race detector (analysis/race.py): the
        # batch_start/batch_end pair brackets this thread's exclusive
        # ownership of the cell; batch_end is committed BEFORE the
        # ``_scheduled`` flag is released so the next batch's start event
        # can never be sequenced inside this batch's interval.
        sched = self.system.sched_events and events.recorder.enabled
        if sched:
            events.recorder.commit(
                events.SCHED_BATCH_START,
                cell=self.uid,
                path=self.path,
                thread=threading.get_ident(),
            )
        while True:
            # System messages always drain first.
            while True:
                with self._lock:
                    sysmsg = self._sysbox.popleft() if self._sysbox else None
                if sysmsg is None:
                    break
                if sched:
                    events.recorder.commit(
                        events.SCHED_INVOKE,
                        cell=self.uid,
                        path=self.path,
                        kind="sys",
                        thread=threading.get_ident(),
                    )
                self._invoke_system(sysmsg)
            if self._lifecycle != _ACTIVE or processed >= throughput:
                break
            # Bulk claim: take the whole runnable slice in ONE lock
            # acquisition instead of a lock round-trip per message —
            # under the GIL the per-message acquire/release pair was a
            # measurable share of a hot actor's batch.  The claim is
            # parked on ``self._claimed`` (owned by this batch thread),
            # which ``drain_mailbox`` and ``_finalize`` treat as the
            # mailbox head — a stop mid-run (PostStop runs INSIDE the
            # stopping invoke) still accounts every unprocessed
            # message, exactly as if it had never left the mailbox.
            claimed = self._claimed
            with self._lock:
                mailbox = self._mailbox
                take = throughput - processed
                if len(mailbox) <= take:
                    claimed.extend(mailbox)
                    mailbox.clear()
                else:
                    for _ in range(take):
                        claimed.append(mailbox.popleft())
                if self._space_cv is not None and claimed:
                    # Space opened: release blocked bounded-mailbox
                    # senders (the backpressure valve).
                    self._space_cv.notify_all()
            if not claimed:
                break
            self._needs_block_hook = True
            # Unmanaged fast invoke (system/raw actors, hoisted per
            # claim): no engine sandwich and no span to open, so the
            # _invoke/_invoke_inner call pair per message collapses to
            # one behavior call.
            tel = self.system.telemetry
            fast = not self.is_managed and (
                tel is None or not tel.tracer.enabled
            )
            while claimed:
                if self._sysbox:
                    # System messages keep their between-every-message
                    # priority: return the rest of the run to the
                    # mailbox head and loop back to the sys drain.
                    with self._lock:
                        self._mailbox.extendleft(reversed(claimed))
                    claimed.clear()
                    break
                msg = claimed.popleft()
                processed += 1
                if sched:
                    events.recorder.commit(
                        events.SCHED_INVOKE,
                        cell=self.uid,
                        path=self.path,
                        kind="app",
                        thread=threading.get_ident(),
                    )
                if fast:
                    behavior = self.behavior
                    try:
                        result = behavior.on_message(msg)
                    except Exception:
                        traceback.print_exc()
                        self._initiate_stop()
                    else:
                        if result is not None and result is not behavior:
                            self._apply_behavior_result(result)
                else:
                    try:
                        self._invoke(msg)
                    except Exception:
                        # A failure in an engine hook must not wedge the
                        # cell (leaving _scheduled claimed forever); stop
                        # the actor, like Akka typed's default supervision.
                        traceback.print_exc()
                        self._initiate_stop()
                if self._lifecycle != _ACTIVE:
                    break

        if self._claimed:
            # Interrupted mid-run (a stop with children still alive, or
            # a lifecycle break): unprocessed claims go back to the
            # mailbox head so the eventual finalize/engine drain sees
            # them.  If PostStop already ran, the drain cleared the
            # claim — this is empty.
            with self._lock:
                self._mailbox.extendleft(reversed(self._claimed))
            self._claimed.clear()

        if processed:
            self._last_active = time.monotonic()

        # Mailbox drained while active: fire the finished-processing hook
        # (the forked-Akka ``onFinishedProcessingHook`` analogue) before we
        # give up ownership of the cell, so engine state is never touched
        # by two threads at once.
        if (
            self._lifecycle == _ACTIVE
            and self._needs_block_hook
            and self.on_finished_processing is not None
        ):
            with self._lock:
                empty = not self._mailbox and not self._sysbox
            if empty:
                self._needs_block_hook = False
                try:
                    self.on_finished_processing()
                except Exception:  # pragma: no cover - defensive
                    traceback.print_exc()

        if sched:
            events.recorder.commit(
                events.SCHED_BATCH_END,
                cell=self.uid,
                path=self.path,
                thread=threading.get_ident(),
            )
        with self._lock:
            # Release the self-send guard BEFORE ownership: a pooled
            # worker that later runs a DIFFERENT cell's batch must not
            # inherit this cell's skip-the-wait admission.
            self._batch_tid = 0
            if self._lifecycle != _TERMINATED and (self._mailbox or self._sysbox):
                redispatch = True
            else:
                self._scheduled = False
                redispatch = False
        if redispatch:
            self._dispatcher.execute(self._process_batch)

    # ------------------------------------------------------------------ #
    # Invocation (the engine sandwich)
    # ------------------------------------------------------------------ #

    def _invoke(self, msg: Any) -> None:
        """Deliver one message, wrapped in an ``invoke`` span when the
        message carries a trace context (telemetry/tracing.py) — the
        span brackets the engine sandwich AND sets the thread's current
        context, so sends issued by the behavior chain causally."""
        tel = self.system.telemetry
        if tel is not None and tel.tracer.enabled:
            ctx = tel.tracer.adopt(getattr(msg, "trace_ctx", None))
            if ctx is not None:
                with tel.tracer.span(
                    "invoke",
                    parent=ctx,
                    path=self.path,
                    uid=self.uid,
                    msg=type(getattr(msg, "payload", msg)).__name__,
                ):
                    self._invoke_inner(msg)
                return
        self._invoke_inner(msg)

    def _invoke_inner(self, msg: Any) -> None:
        """The engine sandwich (reference: AbstractBehavior.scala:16-31)."""
        behavior = self.behavior
        if not self.is_managed:
            try:
                result = behavior.on_message(msg)
            except Exception:
                traceback.print_exc()
                self._initiate_stop()
                return
            self._apply_behavior_result(result)
            return

        engine = self.system.engine
        ctx = self.context
        if not isinstance(msg, GCMessage):
            # External message to a root actor: wrap it so the engine can
            # track its refs (reference: Behaviors.scala:20-29 RootAdapter).
            refs = msg.refs if isinstance(msg, Message) else ()
            msg = engine.root_message(msg, refs)

        payload = engine.on_message(msg, ctx.state, ctx)
        result = None
        if payload is not None:
            try:
                result = behavior.on_message(payload)
            except Exception:
                traceback.print_exc()
                # Akka typed's default supervision stops a failing actor.
                self._initiate_stop()
                return

        decision = engine.on_idle(msg, ctx.state, ctx)
        if decision is TerminationDecision.SHOULD_STOP or isinstance(
            result, StoppedBehavior
        ):
            if decision is TerminationDecision.SHOULD_STOP and engine.tap is not None:
                try:
                    engine.tap.on_stop_decision(self, msg)
                except Exception:
                    # A tap must never alter control flow: the stop
                    # proceeds, and on the signal path an escaped raise
                    # would wedge the cell with _scheduled claimed.
                    traceback.print_exc()
            self._initiate_stop()
        else:
            self._apply_behavior_result(result)

    def _invoke_signal(self, signal: Any) -> None:
        """Deliver a lifecycle signal through the engine sandwich
        (reference: AbstractBehavior.scala:33-54)."""
        behavior = self.behavior
        if behavior is None:
            return
        if not self.is_managed:
            try:
                behavior.on_signal(signal)
            except Exception:  # pragma: no cover - defensive
                traceback.print_exc()
            return

        engine = self.system.engine
        ctx = self.context
        engine.pre_signal(signal, ctx.state, ctx)
        result = None
        try:
            result = behavior.on_signal(signal)
        except Exception:
            traceback.print_exc()

        decision = engine.post_signal(signal, ctx.state, ctx)
        if decision is TerminationDecision.SHOULD_STOP or isinstance(
            result, StoppedBehavior
        ):
            if decision is TerminationDecision.SHOULD_STOP and engine.tap is not None:
                try:
                    engine.tap.on_stop_decision(self, signal)
                except Exception:
                    traceback.print_exc()
            self._initiate_stop()
        else:
            self._apply_behavior_result(result)

    def _apply_behavior_result(self, result: Any) -> None:
        if result is None or isinstance(result, SameBehavior) or result is self.behavior:
            return
        if isinstance(result, StoppedBehavior):
            self._initiate_stop()
        else:
            self.behavior = result

    # ------------------------------------------------------------------ #
    # System-message handling (stop protocol, watch)
    # ------------------------------------------------------------------ #

    def _invoke_system(self, msg: Any) -> None:
        if isinstance(msg, _SysStop):
            self._initiate_stop()
        elif isinstance(msg, _SysChildTerminated):
            self.children.pop(msg.child.name, None)
            if self._lifecycle == _STOPPING and not self.children:
                self._finalize()
        elif isinstance(msg, _SysWatchedTerminated):
            self._watching.discard(msg.ref)
            if self._lifecycle != _TERMINATED:
                self._invoke_signal(Terminated(msg.ref))

    def _initiate_stop(self) -> None:
        """Begin termination: stop children first, then finalize."""
        if self._lifecycle != _ACTIVE:
            return
        self._lifecycle = _STOPPING
        if self.children:
            children = list(self.children.values())
            if len(children) == 1:
                children[0].tell_system(_SYS_STOP)
            else:
                # Bulk cascade: one dispatcher submission per dispatcher
                # instead of one per child, so stopping a wide subtree
                # costs O(dispatchers), not O(children), in scheduling.
                tell_bulk(
                    ((child, _SYS_STOP) for child in children),
                    system_channel=True,
                )
        else:
            self._finalize()

    def _finalize(self) -> None:
        """All children are gone: run PostStop, notify watchers and parent."""
        if self._lifecycle == _TERMINATED:
            return
        sched = self.system.sched_events and events.recorder.enabled
        if sched:
            events.recorder.commit(
                events.SCHED_POSTSTOP,
                cell=self.uid,
                path=self.path,
                thread=threading.get_ident(),
            )
        self._invoke_signal(PostStop)
        with self._lock:
            self._lifecycle = _TERMINATED
            dropped = len(self._mailbox) + len(self._claimed)
            self._mailbox.clear()
            self._claimed.clear()
            watchers = list(self._watchers)
            self._watchers.clear()
            if self._space_cv is not None:
                # Terminal state: blocked senders re-check lifecycle
                # and fall through to dead-letter, never wedge.
                self._space_cv.notify_all()
        if sched:
            # Committed before the parent is notified, so a parent's
            # poststop event is always sequenced after every child's
            # terminated event in a correct run.
            events.recorder.commit(
                events.SCHED_TERMINATED,
                cell=self.uid,
                path=self.path,
                thread=threading.get_ident(),
            )
        tel = self.system.telemetry
        if tel is not None and tel.tracer.enabled:
            # Causal parent: the span this stop was processed inside
            # (a traced message whose handler stopped us), else the
            # collector wave whose StopMsg — a singleton that cannot
            # carry per-send context — issued the kill.
            tracer = tel.tracer
            tracer.instant(
                "terminate",
                parent=tracer.current() or tracer.last_wave,
                path=self.path,
                uid=self.uid,
            )
        if dropped:
            self.system.record_dead_letters_dropped(self, dropped)
        for watcher in watchers:
            watcher.tell_system(_SysWatchedTerminated(self))
        if self.parent is not None:
            self.parent.tell_system(_SysChildTerminated(self))
        self.system.unregister_cell(self)

    def stop(self) -> None:
        """Request this actor to stop (external, e.g. system shutdown)."""
        self.tell_system(_SYS_STOP)

    # ------------------------------------------------------------------ #
    # Watch / misc
    # ------------------------------------------------------------------ #

    def idle_seconds(self) -> float:
        """Seconds since the last enqueue or processed batch.  Combined
        with an empty-mailbox check this is the quiescence signal the
        passivation policy reads (uigc_tpu/cluster/passivation.py)."""
        return time.monotonic() - self._last_active

    def mailbox_size(self) -> int:
        with self._lock:
            return len(self._mailbox)

    def drain_mailbox(self) -> list:
        """Atomically remove and return all pending application messages
        — including any batch-claimed-but-not-yet-invoked run, which is
        logically the mailbox head.  Used by engines during PostStop to
        account undelivered messages (the death-accounting path) and by
        the migration capture; both run on the thread that owns the
        claim, so the fold-in is race-free."""
        with self._lock:
            msgs = list(self._claimed) + list(self._mailbox)
            self._claimed.clear()
            self._mailbox.clear()
            if self._space_cv is not None:
                self._space_cv.notify_all()
        return msgs

    def watch(self, other: "ActorCell") -> None:
        """Subscribe to ``other``'s termination (Akka's ``context.watch``;
        the reference's MAC engine watches children, MAC.scala:161)."""
        notify_now = False
        with other._lock:
            if other._lifecycle == _TERMINATED:
                notify_now = True
            else:
                other._watchers.append(self)
        if notify_now:
            self.tell_system(_SysWatchedTerminated(other))
        else:
            self._watching.add(other)

    def next_anonymous_name(self) -> str:
        self._anon_counter += 1
        return f"${self._anon_counter}"

    @property
    def is_terminated(self) -> bool:
        return self._lifecycle == _TERMINATED

    @property
    def is_active(self) -> bool:
        return self._lifecycle == _ACTIVE

    def __repr__(self) -> str:
        return f"ActorCell({self.path}#{self.uid})"


def tell_bulk(pairs, system_channel: bool = False) -> int:
    """Deliver many (cell, message) pairs with dispatcher-level
    coalescing: every cell newly claimed for scheduling is grouped by
    its dispatcher, and each dispatcher receives ONE runnable that
    processes all of its claimed cells back to back.

    This is the propagation-blocking idea applied to teardown and
    release cascades: when a collector wake kills K actors (or an actor
    releases refs to K targets), the per-unit ``tell`` path would
    enqueue K separate dispatcher work items — GIL-serialized scheduling
    overhead proportional to the kill set.  Binning per destination
    dispatcher makes the cascade cost O(dispatchers + messages) instead
    of O(actors) dispatch operations.

    ``system_channel=True`` routes messages to the system mailbox (the
    stop-protocol channel).  Targets without a local mailbox (remote
    proxies) fall back to plain ``tell`` — their batching happens on the
    transport's per-peer writer instead.  Returns the number of
    dispatcher submissions made."""
    by_dispatcher: Dict[int, tuple] = {}
    dead: List[tuple] = []
    delivered: List[tuple] = []
    for cell, msg in pairs:
        lock = getattr(cell, "_lock", None)
        if lock is None:  # remote/proxy handle
            cell.tell(msg)
            continue
        with lock:
            if system_channel:
                if cell._lifecycle == _TERMINATED:
                    continue
                cell._sysbox.append(msg)
                claimed = cell._mark_scheduled()
            else:
                if cell._lifecycle != _ACTIVE:
                    dead.append((cell, msg))
                    continue
                cell._mailbox.append(msg)
                cell._last_active = time.monotonic()
                claimed = cell._mark_scheduled()
        delivered.append((cell, msg))
        if claimed:
            entry = by_dispatcher.get(id(cell._dispatcher))
            if entry is None:
                entry = by_dispatcher[id(cell._dispatcher)] = (
                    cell._dispatcher,
                    [],
                )
            entry[1].append(cell)
    for cell, msg in dead:
        cell.system.record_dead_letter(cell, msg)
    if delivered and events.recorder.enabled:
        kind = "sys" if system_channel else "app"
        tid = threading.get_ident()
        for cell, _msg in delivered:
            if cell.system.sched_events:
                events.recorder.commit(
                    events.SCHED_ENQUEUE,
                    cell=cell.uid,
                    path=cell.path,
                    kind=kind,
                    thread=tid,
                )
    submissions = 0
    for dispatcher, cells in by_dispatcher.values():
        submissions += 1
        if len(cells) == 1:
            dispatcher.execute(cells[0]._process_batch)
        else:

            def _run_claimed(batch=tuple(cells)):
                for claimed_cell in batch:
                    claimed_cell._process_batch()

            dispatcher.execute(_run_claimed)
    return submissions
