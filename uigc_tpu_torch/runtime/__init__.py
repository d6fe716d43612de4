"""Copy of ``uigc_tpu/runtime/__init__.py`` (pure Python)."""

from .behaviors import AbstractBehavior, ActorFactory, Behaviors, RawBehavior
from .cell import ActorCell
from .context import ActorContext
from .signals import PostStop, Signal, Terminated
from .system import ActorSystem, RawRef

__all__ = [
    "AbstractBehavior",
    "ActorCell",
    "ActorContext",
    "ActorFactory",
    "ActorSystem",
    "Behaviors",
    "PostStop",
    "RawBehavior",
    "RawRef",
    "Signal",
    "Terminated",
]
