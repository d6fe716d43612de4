"""Copy of ``uigc_tpu/runtime/dispatcher.py`` (pure Python).

Thread-pool dispatcher, pinned dispatcher and timer service.

The reference runs mutator actors on Akka's default dispatcher and the GC
collector on a dedicated pinned thread (reference: reference.conf:11-14,
CRGC.scala:54-58).  This module provides both: a shared worker pool that
runs actor message batches, and per-actor pinned threads for system actors
like the Bookkeeper.
"""

from __future__ import annotations

import heapq
import itertools
import queue
import sys
import threading
import traceback
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..utils import events


def free_threading_active() -> bool:
    """True when this interpreter runs threads truly concurrently (a
    free-threaded 3.13t build with the GIL actually disabled).  The
    stock GIL returns False — the signal ``"auto"`` dispatch modes use
    to skip thread hops that could never pay for themselves."""
    probe = getattr(sys, "_is_gil_enabled", None)
    return probe is not None and not probe()


def subinterpreters_available() -> bool:
    """True when the per-interpreter-GIL subinterpreter API exists
    (3.12+ ``_interpreters``/``_xxsubinterpreters``).  Detection only:
    the decode plane stays thread-based until the isolated-heap story
    (no shared cells across interpreters) is worth the copy."""
    for name in ("_interpreters", "_xxsubinterpreters"):
        try:
            __import__(name)
            return True
        except ImportError:
            continue
    return False


class DecodeLane:
    """A bounded SPSC work lane: one dedicated consumer thread draining
    a deque of (fn, arg) jobs in submission order.

    This is the transport's decode offload (``uigc.node.decode-workers``):
    the link receive thread hands each inbound wire unit to its peer's
    lane and returns to the socket immediately, so payload decode and
    mailbox delivery run on a per-peer worker — truly concurrently
    across peers on a free-threaded interpreter, and still correct
    (just serialized) under the stock GIL.  The handoff discipline is
    the writer queue's, mirrored: producers pay one lock-free deque
    append plus an Event.set on the empty->nonempty transition; the
    single consumer pops in order, which therefore IS delivery order."""

    def __init__(self, name: str, origin: Optional[str] = None, high_water: int = 4096):
        self._q: deque = deque()
        self._ev = threading.Event()
        self._closed = False
        self._origin = origin
        self._high_water = high_water
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def submit(self, fn: Callable[[Any], None], arg: Any) -> None:
        if self._closed:
            return
        if len(self._q) >= self._high_water:
            # Backpressure (rare): stall the producing link thread
            # briefly rather than queueing unboundedly — the same
            # policy as the writer queue's high-water mark.
            import time

            while len(self._q) >= self._high_water and not self._closed:
                self._ev.set()
                time.sleep(0.001)
        self._q.append((fn, arg))
        if not self._ev.is_set():
            self._ev.set()

    def depth(self) -> int:
        return len(self._q)

    def _run(self) -> None:
        events.set_thread_origin(self._origin)
        q = self._q
        while True:
            if not q:
                self._ev.clear()
                if q:
                    self._ev.set()
                elif self._closed:
                    return
                else:
                    self._ev.wait()
                    continue
            try:
                fn, arg = q.popleft()
            except IndexError:  # pragma: no cover - defensive
                continue
            try:
                fn(arg)
            except Exception:  # pragma: no cover - keep the lane alive
                traceback.print_exc()

    def close(self, timeout_s: float = 2.0) -> None:
        self._closed = True
        self._ev.set()
        self._thread.join(timeout=timeout_s)


class Dispatcher:
    """Fixed worker pool executing actor batches from a shared run queue.

    ``origin`` (the owning system's address) tags every worker thread's
    committed events so per-node telemetry consumers can scope a shared
    process-wide event stream (utils/events.py set_thread_origin)."""

    _SHUTDOWN = object()

    def __init__(
        self,
        num_workers: int,
        name: str = "uigc-dispatcher",
        origin: Optional[str] = None,
    ):
        self._queue: "queue.SimpleQueue[Any]" = queue.SimpleQueue()
        self._workers = []
        self._shutdown = False
        self._origin = origin
        for i in range(num_workers):
            t = threading.Thread(
                target=self._run, name=f"{name}-{i}", daemon=True
            )
            t.start()
            self._workers.append(t)

    def execute(self, runnable: Callable[[], None]) -> None:
        if not self._shutdown:
            self._queue.put(runnable)

    def queue_depth(self) -> int:
        """Batches waiting for a worker — the scheduling-pressure gauge
        (``uigc_dispatcher_depth``; approximate by nature)."""
        return self._queue.qsize()

    def _run(self) -> None:
        events.set_thread_origin(self._origin)
        while True:
            item = self._queue.get()
            if item is Dispatcher._SHUTDOWN:
                return
            try:
                item()
            except Exception:  # pragma: no cover - defensive
                traceback.print_exc()

    def shutdown(self) -> None:
        self._shutdown = True
        for _ in self._workers:
            self._queue.put(Dispatcher._SHUTDOWN)
        for t in self._workers:
            t.join(timeout=5)


class PinnedDispatcher:
    """A dedicated thread for one actor — the ``my-pinned-dispatcher``
    analogue (reference: reference.conf:11-14)."""

    _SHUTDOWN = object()

    def __init__(self, name: str, origin: Optional[str] = None):
        self._queue: "queue.SimpleQueue[Any]" = queue.SimpleQueue()
        self._shutdown = False
        self._origin = origin
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def execute(self, runnable: Callable[[], None]) -> None:
        if not self._shutdown:
            self._queue.put(runnable)

    def _run(self) -> None:
        events.set_thread_origin(self._origin)
        while True:
            item = self._queue.get()
            if item is PinnedDispatcher._SHUTDOWN:
                return
            try:
                item()
            except Exception:  # pragma: no cover - defensive
                traceback.print_exc()

    def shutdown(self) -> None:
        self._shutdown = True
        self._queue.put(PinnedDispatcher._SHUTDOWN)
        self._thread.join(timeout=5)


class TimerService:
    """Monotonic-clock timer wheel driving collector wakeups and user timers.

    Stands in for Akka's scheduler (reference: LocalGC.scala:211-224 uses
    ``timers.startTimerWithFixedDelay``).
    """

    def __init__(self, name: str = "uigc-timers", origin: Optional[str] = None):
        self._heap: list = []
        self._cond = threading.Condition()
        self._cancelled: Dict[Any, bool] = {}
        self._counter = itertools.count()
        self._shutdown = False
        self._origin = origin
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def schedule_once(self, delay_s: float, fn: Callable[[], None], key: Any = None) -> Any:
        return self._schedule(delay_s, fn, key, repeat_s=None)

    def schedule_fixed_delay(self, interval_s: float, fn: Callable[[], None], key: Any = None) -> Any:
        """Run ``fn`` every ``interval_s`` seconds, measured from completion
        (fixed delay, like ``startTimerWithFixedDelay``)."""
        return self._schedule(interval_s, fn, key, repeat_s=interval_s)

    def _schedule(self, delay_s: float, fn: Callable, key: Any, repeat_s: Optional[float]) -> Any:
        import time

        if key is None:
            key = object()
        with self._cond:
            self._cancelled[key] = False
            heapq.heappush(
                self._heap,
                (time.monotonic() + delay_s, next(self._counter), key, fn, repeat_s),
            )
            self._cond.notify()
        return key

    def cancel(self, key: Any) -> None:
        with self._cond:
            if key in self._cancelled:
                self._cancelled[key] = True

    def cancel_all(self) -> None:
        with self._cond:
            for key in self._cancelled:
                self._cancelled[key] = True

    def _run(self) -> None:
        import time

        events.set_thread_origin(self._origin)
        while True:
            with self._cond:
                if self._shutdown:
                    return
                now = time.monotonic()
                if not self._heap:
                    # Idle: sleep until something is scheduled (or
                    # shutdown) — no heartbeat polling, so an idle
                    # system burns zero timer wakeups.  _schedule and
                    # shutdown both notify under the condition.
                    self._cond.wait()
                    continue
                when, _, key, fn, repeat_s = self._heap[0]
                if when > now:
                    # Sleep exactly until the head's deadline; an
                    # earlier schedule_* notifies and re-evaluates.
                    self._cond.wait(timeout=when - now)
                    continue
                heapq.heappop(self._heap)
                cancelled = self._cancelled.get(key, True)
                if cancelled and repeat_s is None:
                    self._cancelled.pop(key, None)
            if cancelled:
                if repeat_s is not None:
                    with self._cond:
                        self._cancelled.pop(key, None)
                continue
            try:
                fn()
            except Exception:  # pragma: no cover - defensive
                traceback.print_exc()
            if repeat_s is not None:
                with self._cond:
                    if not self._shutdown and not self._cancelled.get(key, True):
                        heapq.heappush(
                            self._heap,
                            (time.monotonic() + repeat_s, next(self._counter), key, fn, repeat_s),
                        )
                        self._cond.notify()

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify()
        self._thread.join(timeout=5)
