"""Copy of ``uigc_tpu/interfaces.py`` (pure Python).

Engine-agnostic marker interfaces.

These correspond to the reference's ``edu.illinois.osl.uigc.interfaces``
package (reference: src/main/scala/edu/illinois/osl/uigc/interfaces/
GCMessage.scala, Refob.scala, SpawnInfo.scala, State.scala).  Every GC
engine plugs its own concrete message/refob/state types in behind these.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterable, Optional

if TYPE_CHECKING:  # pragma: no cover
    from .runtime.cell import ActorCell
    from .runtime.context import ActorContext


class Message:
    """Base class for application messages.

    Subclasses declare which refobs they carry via :attr:`refs`
    (reference: interfaces/GCMessage.scala:3-6).  The GC uses this to
    track references that flow between actors inside messages.
    """

    @property
    def refs(self) -> Iterable["Refob"]:
        raise NotImplementedError(
            f"{type(self).__name__} must define refs (or mix in NoRefs)"
        )


class NoRefs(Message):
    """Mixin for messages that carry no references
    (reference: interfaces/GCMessage.scala:8-10)."""

    @property
    def refs(self) -> Iterable["Refob"]:
        return ()


class GCMessage(Message):
    """Supertype of engine control messages and wrapped application
    messages (reference: interfaces/GCMessage.scala:12-20)."""


class Refob:
    """A reference object: the GC-aware wrapper around an actor reference
    (reference: interfaces/Refob.scala:17-33).

    Unlike raw actor refs, refobs must not be shared between actors without
    going through ``ActorContext.create_ref``.  Sending routes through the
    owner's engine so that send counts are tracked.
    """

    __slots__ = ()

    @property
    def target(self) -> "ActorCell":
        """The cell this refob points to."""
        raise NotImplementedError

    def tell(self, msg: Message, ctx: "ActorContext", refs: Optional[Iterable["Refob"]] = None) -> None:
        """Send ``msg`` to this refob from the actor owning ``ctx``
        (reference: interfaces/Refob.scala:17-26)."""
        if refs is None:
            refs = msg.refs
        ctx.engine.send_message(self, msg, refs, ctx.state, ctx)

    def unsafe_upcast(self) -> "Refob":
        return self

    def narrow(self) -> "Refob":
        return self


class SpawnInfo:
    """Opaque data a parent passes to a spawned child
    (reference: interfaces/SpawnInfo.scala:3-6)."""


class State:
    """Base for a managed actor's per-engine GC state
    (reference: interfaces/State.scala:3-5)."""
