"""Copy of ``uigc_tpu/engines/mac/engine.py`` (pure Python).

The MAC engine: Pony-style weighted reference counting.

Mirrors the reference's MAC engine (reference: mac/MAC.scala:14-304):
acyclic garbage is collected by weighted reference counts (weights split
on ref creation, returned by DecMsg on release, topped up by IncMsg when
a weight can't be split), self-message balances, and child tracking via
watch/Terminated.  Requires causal delivery, hence single-node only —
like the reference (README.md:32-40).

The cycle detector (detector.py) goes beyond the reference's stub
(reference.conf:48 "the cycle detector doesn't actually detect garbage"):
it runs SCC detection over blocked-actor snapshots and collects confirmed
closed cycles.
"""

from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, Optional, Tuple

from ...interfaces import GCMessage, Refob, SpawnInfo
from ..engine import Engine, TerminationDecision

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell
    from ...runtime.context import ActorContext

RC_INC = 255  # (reference: MAC.scala:17)


class MacRefob(Refob):
    """(reference: MAC.scala:19-22)"""

    __slots__ = ("_target",)

    def __init__(self, target: "ActorCell"):
        self._target = target

    @property
    def target(self) -> "ActorCell":
        return self._target

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, MacRefob) and self._target is other._target

    def __hash__(self) -> int:
        return hash(id(self._target))

    def __repr__(self) -> str:
        return f"MacRefob({self._target.path})"


class MacAppMsg(GCMessage):
    """(reference: MAC.scala:30-31)"""

    __slots__ = ("payload", "_refs", "is_self_msg", "external", "trace_ctx")

    def __init__(
        self,
        payload: Any,
        refs: Iterable[Refob],
        is_self_msg: bool,
        external: bool = False,
    ):
        self.payload = payload
        self._refs = tuple(refs)
        self.is_self_msg = is_self_msg
        #: wrapped by the root adapter (sent by unmanaged code): carries
        #: no sender-side accounting, so observation taps skip it.
        self.external = external
        #: causal-tracing context (uigc_tpu/telemetry/tracing.py).
        self.trace_ctx = None

    @property
    def refs(self) -> Tuple[Refob, ...]:
        return self._refs


class DecMsg(GCMessage):
    """(reference: MAC.scala:33-35)"""

    __slots__ = ("weight",)

    def __init__(self, weight: int):
        self.weight = weight

    @property
    def refs(self):
        return ()


class _IncMsg(GCMessage):
    """(reference: MAC.scala:37-39)"""

    __slots__ = ()

    @property
    def refs(self):
        return ()


IncMsg = _IncMsg()


class CNF(GCMessage):
    """Cycle-detector confirmation probe (reference: MAC.scala:41-48)."""

    __slots__ = ("token",)

    def __init__(self, token: int):
        self.token = token

    @property
    def refs(self):
        return ()


class _KillMsg(GCMessage):
    """Kill order for a confirmed garbage cycle (ours; the reference's
    detector never collects — reference.conf:48)."""

    __slots__ = ()

    @property
    def refs(self):
        return ()


KillMsg = _KillMsg()


class Pair:
    """(reference: MAC.scala:65-68)"""

    __slots__ = ("num_refs", "weight")

    def __init__(self, num_refs: int = 0, weight: int = 0):
        self.num_refs = num_refs
        self.weight = weight


class MacSpawnInfo(SpawnInfo):
    __slots__ = ("is_root",)

    def __init__(self, is_root: bool):
        self.is_root = is_root


class MacState:
    """(reference: MAC.scala:54-63)"""

    __slots__ = (
        "self_ref",
        "is_root",
        "actor_map",
        "rc",
        "pending_self_messages",
        "has_sent_blk",
        "app_msg_count",
        "ctrl_msg_count",
    )

    def __init__(self, self_ref: MacRefob, is_root: bool):
        self.self_ref = self_ref
        self.is_root = is_root
        self.actor_map: Dict["ActorCell", Pair] = {}
        self.rc = RC_INC
        self.pending_self_messages = 0
        self.has_sent_blk = False
        self.app_msg_count = 0
        self.ctrl_msg_count = 0


class MAC(Engine):
    """(reference: mac/MAC.scala:76-304)"""

    def __init__(self, system: Any):
        super().__init__(system)
        config = system.config
        self.cycle_detection = config.get_bool("uigc.mac.cycle-detection")
        self.collect_cycles = config.get_bool("uigc.mac.collect-cycles")
        # BLK/UNB/ACK channel to the detector (reference: MAC.scala:89).
        self.queue: deque = deque()
        self.detector = None
        self.detector_cell = None
        if self.cycle_detection:
            from .detector import CycleDetector

            self.detector = CycleDetector(self)
            self.detector_cell = system.spawn_system_raw(
                self.detector, "CycleDetector", pinned=True
            )

    # -- Root support -------------------------------------------------- #

    def root_message(self, payload: Any, refs: Iterable[Refob]) -> GCMessage:
        return MacAppMsg(payload, refs, is_self_msg=False, external=True)

    def root_spawn_info(self) -> SpawnInfo:
        return MacSpawnInfo(is_root=True)

    def to_root_refob(self, cell: "ActorCell") -> Refob:
        return MacRefob(cell)

    # -- Lifecycle ----------------------------------------------------- #

    def init_state(self, cell: "ActorCell", spawn_info: MacSpawnInfo) -> MacState:
        """(reference: MAC.scala:114-147)"""
        state = MacState(MacRefob(cell), spawn_info.is_root)
        state.actor_map[cell] = Pair(num_refs=1, weight=RC_INC)

        if self.cycle_detection:
            from .detector import BLK

            def on_block() -> None:
                if not state.has_sent_blk:
                    snapshot = [
                        (target, pair.weight)
                        for target, pair in state.actor_map.items()
                    ]
                    self.queue.append(
                        BLK(
                            cell,
                            state.rc,
                            snapshot,
                            num_children=len(cell.children),
                        )
                    )
                    state.has_sent_blk = True

            cell.on_finished_processing = on_block
        return state

    def get_self_ref(self, state: MacState, cell: "ActorCell") -> Refob:
        return state.self_ref

    def spawn(
        self, factory: Callable[[SpawnInfo], "ActorCell"], state: MacState, ctx: "ActorContext"
    ) -> Refob:
        """(reference: MAC.scala:155-166)"""
        child = factory(MacSpawnInfo(is_root=False))
        ctx.cell.watch(child)
        state.actor_map[child] = Pair(num_refs=1, weight=RC_INC)
        return MacRefob(child)

    # -- Message path -------------------------------------------------- #

    def _unblocked(self, state: MacState, cell: "ActorCell") -> None:
        """(reference: MAC.scala:168-173)"""
        if self.cycle_detection and state.has_sent_blk:
            from .detector import UNB

            state.has_sent_blk = False
            self.queue.append(UNB(cell))

    def send_message(
        self, ref: MacRefob, msg: Any, refs: Iterable[Refob], state: MacState, ctx: "ActorContext"
    ) -> None:
        """(reference: MAC.scala:290-303)"""
        is_self_msg = ref.target is state.self_ref.target
        if is_self_msg:
            state.pending_self_messages += 1
        if self.tap is not None:
            self.tap.on_send(ref.target)
        app_msg = MacAppMsg(msg, refs, is_self_msg)
        tel = self.system.telemetry
        if tel is not None and tel.tracer.enabled:
            app_msg.trace_ctx = tel.tracer.on_send(
                target=ref.target.path, uid=ref.target.uid
            )
        ref.target.tell(app_msg)

    def on_message(
        self, msg: GCMessage, state: MacState, ctx: "ActorContext"
    ) -> Optional[Any]:
        """(reference: MAC.scala:175-210)"""
        cell = ctx.cell
        if isinstance(msg, MacAppMsg):
            if self.tap is not None and not msg.external:
                self.tap.on_recv(cell)
            self._unblocked(state, cell)
            state.app_msg_count += 1
            if msg.is_self_msg:
                state.pending_self_messages -= 1
            for ref in msg.refs:
                pair = state.actor_map.get(ref.target)
                if pair is None:
                    pair = Pair()
                    state.actor_map[ref.target] = pair
                pair.num_refs += 1
                pair.weight += 1
            return msg.payload
        if isinstance(msg, DecMsg):
            self._unblocked(state, cell)
            state.ctrl_msg_count += 1
            state.rc -= msg.weight
            return None
        if isinstance(msg, _IncMsg):
            self._unblocked(state, cell)
            state.ctrl_msg_count += 1
            state.rc += RC_INC
            return None
        if isinstance(msg, CNF):
            state.ctrl_msg_count += 1
            if self.cycle_detection and state.has_sent_blk:
                from .detector import ACK

                self.queue.append(ACK(cell, msg.token))
            return None
        if isinstance(msg, _KillMsg):
            return None
        return None

    def on_idle(
        self, msg: GCMessage, state: MacState, ctx: "ActorContext"
    ) -> TerminationDecision:
        """(reference: MAC.scala:212-217)"""
        if isinstance(msg, _KillMsg):
            return TerminationDecision.SHOULD_STOP
        return self.try_terminate(state, ctx)

    def post_signal(
        self, signal: Any, state: MacState, ctx: "ActorContext"
    ) -> TerminationDecision:
        """(reference: MAC.scala:225-235)"""
        from ...runtime.signals import Terminated

        if isinstance(signal, Terminated):
            return self.try_terminate(state, ctx)
        return TerminationDecision.UNHANDLED

    def try_terminate(
        self, state: MacState, ctx: "ActorContext"
    ) -> TerminationDecision:
        """(reference: MAC.scala:237-246)"""
        if (
            not state.is_root
            and state.rc == 0
            and state.pending_self_messages == 0
            and not ctx.cell.children
        ):
            return TerminationDecision.SHOULD_STOP
        return TerminationDecision.SHOULD_CONTINUE

    # -- Reference management ------------------------------------------ #

    def create_ref(
        self, target: MacRefob, owner: Refob, state: MacState, ctx: "ActorContext"
    ) -> Refob:
        """Weight splitting (reference: MAC.scala:248-266)."""
        if self.tap is not None:
            self.tap.on_create(owner.target, target.target)
        if target.target is ctx.cell:
            state.rc += 1
            return MacRefob(target.target)
        pair = state.actor_map[target.target]
        if pair.weight <= 1:
            pair.weight += RC_INC - 1
            target.target.tell(IncMsg)
        else:
            pair.weight -= 1
        return MacRefob(target.target)

    def release(
        self, releasing: Iterable[MacRefob], state: MacState, ctx: "ActorContext"
    ) -> None:
        """(reference: MAC.scala:268-288)"""
        tap = self.tap
        dec_sends = []
        for ref in releasing:
            if tap is not None:
                tap.on_release(
                    ref,
                    already_released=(
                        ref.target is not ctx.cell
                        and ref.target not in state.actor_map
                    ),
                )
            if ref.target is ctx.cell:
                state.rc -= 1
            else:
                pair = state.actor_map[ref.target]
                if pair.num_refs <= 1:
                    dec_sends.append((ref.target, DecMsg(pair.weight)))
                    del state.actor_map[ref.target]
                else:
                    pair.num_refs -= 1
        if len(dec_sends) > 1:
            # Bulk decrement fan-out: one dispatcher submission per
            # dispatcher for the whole release set (runtime/cell.py).
            from ...runtime.cell import tell_bulk

            tell_bulk(dec_sends)
        else:
            for target_cell, dec in dec_sends:
                target_cell.tell(dec)

    # -- Shutdown ------------------------------------------------------ #

    def shutdown(self) -> None:
        if self.detector is not None:
            self.detector.stop_timers()
