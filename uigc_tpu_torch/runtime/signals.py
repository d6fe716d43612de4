"""Copy of ``uigc_tpu/runtime/signals.py`` (pure Python).

Lifecycle signals delivered to actors outside the message channel.

Analogue of ``akka.actor.typed.Signal`` as used by the reference
(reference: AbstractBehavior.scala:33-54, MAC.scala:225-235).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .cell import ActorCell


class Signal:
    """Base class for lifecycle signals."""

    def __repr__(self) -> str:
        return type(self).__name__


class _PostStop(Signal):
    """Delivered once after an actor has stopped (children already stopped)."""


PostStop = _PostStop()


class Terminated(Signal):
    """Delivered to watchers when a watched actor terminates
    (reference: MAC.scala:230-235 handles this for child-tracking)."""

    __slots__ = ("ref",)

    def __init__(self, ref: "ActorCell"):
        self.ref = ref

    def __repr__(self) -> str:
        return f"Terminated({self.ref.path})"
