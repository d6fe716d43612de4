"""Copy of ``uigc_tpu/runtime/behaviors.py`` (pure Python).

Behavior definitions for managed actors.

Mirrors the reference's user-facing ``Behaviors`` / ``AbstractBehavior``
surface (reference: Behaviors.scala:16-56, AbstractBehavior.scala:16-54):
``Behaviors.setup`` produces an ActorFactory for GC-managed children,
``Behaviors.setup_root`` produces a root-actor recipe whose external
messages are wrapped by the engine, and ``AbstractBehavior`` is the class
users subclass with ``on_message`` / ``on_signal``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Optional

from .signals import Signal

if TYPE_CHECKING:  # pragma: no cover
    from ..interfaces import SpawnInfo
    from .context import ActorContext


class SameBehavior:
    """Sentinel: keep the current behavior."""

    def __repr__(self) -> str:
        return "Behaviors.same"


class StoppedBehavior:
    """Sentinel: stop this actor (reference: Behaviors.scala:53-56)."""

    def __repr__(self) -> str:
        return "Behaviors.stopped"


_SAME = SameBehavior()
_STOPPED = StoppedBehavior()


class AbstractBehavior:
    """Base class for managed actor behaviors
    (reference: AbstractBehavior.scala).

    Subclasses implement :meth:`on_message`; the engine interception
    sandwich itself lives in the runtime (cell._invoke), so this class is
    purely the user-API surface.
    """

    def __init__(self, context: "ActorContext"):
        self.context = context

    def on_message(self, msg: Any) -> Any:
        raise NotImplementedError

    def on_signal(self, signal: Signal) -> Any:
        """Override to handle lifecycle signals. Return None for unhandled."""
        return None


class ActorFactory:
    """A recipe for spawning a managed actor: ``SpawnInfo -> behavior``
    (reference: package.scala:14-17).  Instantiated by the runtime when the
    actor starts."""

    __slots__ = ("setup_fn", "is_root")

    def __init__(self, setup_fn: Callable[["ActorContext"], AbstractBehavior], is_root: bool = False):
        self.setup_fn = setup_fn
        self.is_root = is_root


class Behaviors:
    """Factory namespace, mirroring ``uigc.Behaviors``."""

    same: SameBehavior = _SAME

    @staticmethod
    def setup(factory: Callable[["ActorContext"], AbstractBehavior]) -> ActorFactory:
        """A managed (GC-aware) actor recipe (reference: Behaviors.scala:16-18)."""
        return ActorFactory(factory, is_root=False)

    @staticmethod
    def setup_root(factory: Callable[["ActorContext"], AbstractBehavior]) -> ActorFactory:
        """A root actor recipe: an entry point into the garbage-collected
        world.  Root actors must be stopped manually; external messages are
        wrapped by the engine (reference: Behaviors.scala:36-45)."""
        return ActorFactory(factory, is_root=True)

    @staticmethod
    def with_timers(factory: Callable[["TimerScheduler"], ActorFactory]) -> ActorFactory:
        """Give a root actor a timer scheduler (reference:
        Behaviors.scala:50-51 restricts timers to root actors)."""
        scheduler = TimerScheduler()
        inner = factory(scheduler)

        def setup(ctx: "ActorContext") -> AbstractBehavior:
            scheduler._bind(ctx._cell)
            return inner.setup_fn(ctx)

        return ActorFactory(setup, is_root=inner.is_root)

    @staticmethod
    def stopped(context: Optional["ActorContext"] = None) -> StoppedBehavior:
        """A behavior that stops the actor (reference: Behaviors.scala:53-56)."""
        return _STOPPED


class TimerScheduler:
    """Timer facade for root actors (reference: Behaviors.scala:50-51).

    Messages sent by timers are raw payloads; arriving at a root actor they
    are wrapped by the engine like any external message.
    """

    def __init__(self) -> None:
        self._cell = None
        self._keys: set = set()

    def _bind(self, cell: Any) -> None:
        self._cell = cell

    def start_timer_at_fixed_rate(self, key: Any, msg: Any, interval_s: float) -> None:
        cell = self._cell
        if cell is None:
            raise RuntimeError("TimerScheduler not bound to an actor yet")
        timer_key = ("user-timer", id(self), key)
        self._keys.add(timer_key)
        cell.system.timers.schedule_fixed_delay(
            interval_s, lambda: cell.tell(msg), key=timer_key
        )

    def cancel(self, key: Any) -> None:
        timer_key = ("user-timer", id(self), key)
        self._keys.discard(timer_key)
        if self._cell is not None:
            self._cell.system.timers.cancel(timer_key)

    def cancel_all(self) -> None:
        if self._cell is not None:
            for timer_key in self._keys:
                self._cell.system.timers.cancel(timer_key)
        self._keys.clear()


class RawBehavior:
    """Behavior base for unmanaged (engine-bypassing) actors — the
    ``unmanaged`` escape hatch (reference: package.scala:19-26)."""

    def on_message(self, msg: Any) -> Any:
        raise NotImplementedError

    def on_signal(self, signal: Signal) -> Any:
        return None


class FunctionRawBehavior(RawBehavior):
    """Wrap a plain function as an unmanaged behavior."""

    def __init__(self, fn: Callable[[Any], Any]):
        self._fn = fn

    def on_message(self, msg: Any) -> Any:
        return self._fn(msg)
