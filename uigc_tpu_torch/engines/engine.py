"""Copy of ``uigc_tpu/engines/engine.py`` (pure Python).

The pluggable GC-engine SPI.

Mirrors the reference's ``Engine`` trait: 13 hook pairs through which every
GC-relevant action in the user API funnels (reference:
src/main/scala/edu/illinois/osl/uigc/engines/Engine.scala:19-223), plus the
remoting interception hooks (Engine.scala:225-276).  Python's dynamic
typing removes the need for the reference's ``*Impl``/cast bridging, so
each hook appears once.
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Any, Callable, Iterable, Optional

from ..interfaces import GCMessage, Refob, SpawnInfo, State

if TYPE_CHECKING:  # pragma: no cover
    from ..runtime.cell import ActorCell
    from ..runtime.context import ActorContext
    from ..runtime.signals import Signal
    from ..runtime.system import ActorSystem


class TerminationDecision(enum.Enum):
    """Verdicts returned by on_idle / post_signal
    (reference: Engine.scala:11-16)."""

    SHOULD_STOP = "should_stop"
    SHOULD_CONTINUE = "should_continue"
    UNHANDLED = "unhandled"


class EngineTap:
    """Observation points for correctness tooling (uigc_tpu/analysis).

    An engine with a non-None ``tap`` calls these from its hook
    implementations; all calls are cheap no-ops by default.  The taps
    observe, never mutate: ``on_release`` fires *before* the engine
    deactivates the refob so the tap can see prior state, and
    ``on_send`` fires before delivery so a tap-side send count always
    happens-before the matching receive.  No reference analogue — the
    reference debugs with in-source asserts instead."""

    def on_send(self, target: "ActorCell", remote: bool = False) -> None:
        """An application message is about to be delivered to ``target``."""

    def on_recv(self, cell: "ActorCell", crossed: bool = False) -> None:
        """``cell`` is receiving a (non-external) application message;
        ``crossed`` marks messages that crossed a node boundary."""

    def on_create(self, owner: "ActorCell", target: "ActorCell") -> None:
        """A reference to ``target`` was created for ``owner``."""

    def on_release(self, ref: Any, already_released: bool = False) -> None:
        """``ref`` is about to be released; ``already_released`` means the
        engine had already seen a release for it (a protocol violation)."""

    def on_stop_decision(self, cell: "ActorCell", msg: Any) -> None:
        """The engine decided ``cell`` SHOULD_STOP after processing
        ``msg`` (called by the runtime before the stop is initiated)."""

    def on_migrate_out(self, cell: "ActorCell", key: str) -> None:
        """``cell`` (a sharded entity, uigc_tpu/cluster) captured its
        state for a live migration and is about to stop.  Its remaining
        local send/recv balance moves to another node's books, so local
        balance comparisons for it are meaningless from here on — the
        sanitizer taints it, exactly like a message that crossed a node
        boundary."""

    def on_migrate_in(self, cell: "ActorCell", key: str) -> None:
        """``cell`` was reconstructed from a migrated snapshot.  Its
        history (creates/sends recorded under the old incarnation's uid)
        lives on another node; local ground-truth counters must not be
        compared against it."""


class Engine:
    """A GC engine: a collection of hooks and datatypes used by the
    runtime.  One instance per ActorSystem (reference: Engine.scala:19)."""

    def __init__(self, system: "ActorSystem"):
        self.system = system
        #: optional :class:`EngineTap` installed by the sanitizer.
        self.tap: Optional[EngineTap] = None
        #: optional wake profiler (uigc_tpu/telemetry/profile.py),
        #: installed by Telemetry.attach; engines with a periodic
        #: collector consult it per wake.
        self.wake_profiler: Optional[Any] = None
        #: optional liveness inspector (uigc_tpu/telemetry/inspect.py),
        #: installed by Telemetry.attach; the collector feeds it one
        #: read-only callback per wake (flight recorder, leak watchdog)
        #: and consults ``parent_capture`` to gate why-live provenance.
        self.liveness_inspector: Optional[Any] = None
        #: optional device observatory (uigc_tpu/telemetry/device.py),
        #: installed by Telemetry.attach; the collector feeds it one
        #: read-only ledger sample per wake (same isolation discipline
        #: as the inspector).
        self.device_observatory: Optional[Any] = None

    # -- Root-actor support ------------------------------------------- #

    def root_message(self, payload: Any, refs: Iterable[Refob]) -> GCMessage:
        """Wrap an external message for delivery to a root actor
        (reference: Engine.scala:28-31)."""
        raise NotImplementedError

    def root_spawn_info(self) -> SpawnInfo:
        """SpawnInfo marking an actor as a root (reference: Engine.scala:35-38)."""
        raise NotImplementedError

    def to_root_refob(self, cell: "ActorCell") -> Refob:
        """Produce a refob for a root actor's cell (reference: Engine.scala:41-44)."""
        raise NotImplementedError

    # -- Lifecycle ----------------------------------------------------- #

    def init_state(self, cell: "ActorCell", spawn_info: SpawnInfo) -> State:
        """Compute the initial GC state of a managed actor
        (reference: Engine.scala:48-60)."""
        raise NotImplementedError

    def get_self_ref(self, state: State, cell: "ActorCell") -> Refob:
        """This actor's refob to itself (reference: Engine.scala:64-76)."""
        raise NotImplementedError

    def spawn(
        self,
        factory: Callable[[SpawnInfo], "ActorCell"],
        state: State,
        ctx: "ActorContext",
    ) -> Refob:
        """Spawn a managed actor (reference: Engine.scala:79-94)."""
        raise NotImplementedError

    # -- Message path -------------------------------------------------- #

    def send_message(
        self,
        ref: Refob,
        msg: Any,
        refs: Iterable[Refob],
        state: State,
        ctx: "ActorContext",
    ) -> None:
        """Send an application message through a refob
        (reference: Engine.scala:97-118)."""
        raise NotImplementedError

    def on_message(
        self, msg: GCMessage, state: State, ctx: "ActorContext"
    ) -> Optional[Any]:
        """Intercept a delivered message; return the app payload, or None
        for engine-internal control messages (reference: Engine.scala:120-135)."""
        raise NotImplementedError

    def on_idle(
        self, msg: GCMessage, state: State, ctx: "ActorContext"
    ) -> TerminationDecision:
        """Called after the user handler for each message
        (reference: Engine.scala:137-152)."""
        raise NotImplementedError

    # -- Signals ------------------------------------------------------- #

    def pre_signal(self, signal: "Signal", state: State, ctx: "ActorContext") -> None:
        """(reference: Engine.scala:154-169)"""

    def post_signal(
        self, signal: "Signal", state: State, ctx: "ActorContext"
    ) -> TerminationDecision:
        """(reference: Engine.scala:171-186)"""
        return TerminationDecision.UNHANDLED

    # -- Reference management ------------------------------------------ #

    def create_ref(
        self, target: Refob, owner: Refob, state: State, ctx: "ActorContext"
    ) -> Refob:
        """Create a reference to ``target`` destined for ``owner``
        (reference: Engine.scala:188-206)."""
        raise NotImplementedError

    def release(
        self, releasing: Iterable[Refob], state: State, ctx: "ActorContext"
    ) -> None:
        """Release references (reference: Engine.scala:208-223)."""
        raise NotImplementedError

    # -- Remoting interception ----------------------------------------- #
    # The fabric instantiates these per link.  Default: pass-through, like
    # the reference's default GraphStage logic (Engine.scala:225-276).

    def spawn_egress(self, link: Any) -> Any:
        """Return an egress interceptor for an outbound link, or None for
        pass-through."""
        return None

    def spawn_ingress(self, link: Any) -> Any:
        """Return an ingress interceptor for an inbound link, or None for
        pass-through."""
        return None

    # -- Dead letters -------------------------------------------------- #

    def on_dead_letter(self, cell: "ActorCell", msg: Any) -> None:
        """Called when a message is delivered to a terminated actor.

        ``cell`` is the addressee as the runtime can still name it: a
        terminated-but-reachable ``ActorCell``, or — on a cross-process
        fabric — the tombstone proxy for a uid that no longer resolves
        (runtime/node.py routes post-mortem frames here so the sender's
        already-stamped send still balances).  Implementations must not
        assume a live local cell; only its identity key matters.

        No reference analogue as an SPI hook; engines that track message
        balances (CRGC) use this to account undelivered sends the way the
        reference's ingress stages account admitted messages across node
        boundaries (reference: IngressEntry.java:91-100)."""

    # -- Shutdown ------------------------------------------------------ #

    def shutdown(self) -> None:
        """Called on system termination (no reference analogue; ours)."""

    def on_crash(self) -> None:
        """Called by the fabric when this node is crash-injected: the
        engine must stop acting immediately (no further collector
        broadcasts), simulating an abrupt process death."""
        self.shutdown()
