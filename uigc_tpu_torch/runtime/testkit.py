"""Copy of ``uigc_tpu/runtime/testkit.py`` (pure Python).

Test harness: an in-process actor system plus probes.

The analogue of Akka's ``ScalaTestWithActorTestKit`` + ``TestProbe`` that
the reference's whole test suite is built on (reference:
src/test/scala/edu/illinois/osl/uigc/*Spec.scala).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Mapping, Optional, Type

from .behaviors import ActorFactory
from .system import ActorSystem, RawRef


class ProbeRef:
    """The unmanaged ref actors use to report to a probe (``probe.ref``)."""

    __slots__ = ("_probe",)

    def __init__(self, probe: "TestProbe"):
        self._probe = probe

    def tell(self, msg: Any) -> None:
        self._probe._offer(msg)


class TestProbe:
    """Thread-safe expectation queue (Akka ``TestProbe`` analogue)."""

    def __init__(self, default_timeout_s: float = 5.0):
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self.default_timeout_s = default_timeout_s
        self.ref = ProbeRef(self)

    def _offer(self, msg: Any) -> None:
        with self._cond:
            self._queue.append(msg)
            self._cond.notify_all()

    def _take(self, timeout_s: float) -> Any:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not self._queue:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise AssertionError("probe timed out waiting for a message")
                self._cond.wait(remaining)
            return self._queue.popleft()

    def expect_message(self, expected: Any, timeout_s: Optional[float] = None) -> Any:
        msg = self._take(timeout_s or self.default_timeout_s)
        assert msg == expected, f"expected {expected!r}, got {msg!r}"
        return msg

    def expect_message_type(self, tpe: Type, timeout_s: Optional[float] = None) -> Any:
        msg = self._take(timeout_s or self.default_timeout_s)
        assert isinstance(msg, tpe), f"expected a {tpe.__name__}, got {msg!r}"
        return msg

    def expect_no_message(self, within_s: float = 0.3) -> None:
        time.sleep(within_s)
        with self._cond:
            assert not self._queue, f"expected no message, got {self._queue[0]!r}"

    def fish_for_message(
        self, predicate: Callable[[Any], bool], timeout_s: Optional[float] = None
    ) -> Any:
        deadline = time.monotonic() + (timeout_s or self.default_timeout_s)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise AssertionError("fish_for_message timed out")
            msg = self._take(remaining)
            if predicate(msg):
                return msg

    def receive_n(self, n: int, timeout_s: Optional[float] = None) -> list:
        deadline = time.monotonic() + (timeout_s or self.default_timeout_s)
        out = []
        for _ in range(n):
            remaining = max(0.0, deadline - time.monotonic())
            out.append(self._take(remaining))
        return out


class ActorTestKit:
    """Spawns root actors into a fresh system; shut down with
    :meth:`shutdown`."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None, name: str = "testkit"):
        self.system = ActorSystem(guardian=None, name=name, config=config)
        self._name_counter = 0

    def spawn(self, factory: ActorFactory, name: Optional[str] = None) -> RawRef:
        if name is None:
            self._name_counter += 1
            name = f"anon-{self._name_counter}"
        return self.system.spawn_root(factory, name)

    def create_test_probe(self, timeout_s: float = 5.0) -> TestProbe:
        return TestProbe(default_timeout_s=timeout_s)

    def shutdown(self, timeout_s: float = 10.0) -> None:
        self.system.terminate(timeout_s)
