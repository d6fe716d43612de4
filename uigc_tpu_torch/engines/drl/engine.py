"""Copy of ``uigc_tpu/engines/drl/engine.py`` (pure Python).

The DRL engine: Plyukhin–Agha distributed reference listing.

Mirrors the reference's DRL engine (reference: drl/DRL.scala:17-161,
drl/State.scala:7-284, drl/GCMessage.scala, drl/Refob.scala): every refob
carries a globally unique token; owners maintain active-ref sets, targets
maintain owner sets; releases travel as ReleaseMsg carrying both the
released refs and the refs created using them (two-phase owner
reconciliation); per-token send/receive counts detect in-flight messages;
termination when no children, no nontrivial inverse acquaintances (Chain
Lemma), and no pending self-messages.

Unlike the reference — where DRL exists but is not selectable
(UIGC.scala:14-18 has no "drl" case) — this engine is wired into the
registry under ``uigc.engine = "drl"``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, List, Optional, Tuple

from ...interfaces import GCMessage, Refob, SpawnInfo
from ..engine import Engine, TerminationDecision

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell
    from ...runtime.context import ActorContext


class Token:
    """An opaque, globally unique token (reference: drl/Refob.scala:7-9)."""

    __slots__ = ("ref", "n")

    def __init__(self, ref: "ActorCell", n: int):
        self.ref = ref
        self.n = n

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Token) and self.ref is other.ref and self.n == other.n

    def __hash__(self) -> int:
        return hash((id(self.ref), self.n))

    def __repr__(self) -> str:
        return f"Token({self.ref.path},{self.n})"


class DrlRefob(Refob):
    """(reference: drl/Refob.scala:11-17)"""

    __slots__ = ("token", "owner", "_target")

    def __init__(self, token: Optional[Token], owner: Optional["ActorCell"], target: "ActorCell"):
        self.token = token
        self.owner = owner
        self._target = target

    @property
    def target(self) -> "ActorCell":
        return self._target

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, DrlRefob)
            and self.token == other.token
            and self.owner is other.owner
            and self._target is other._target
        )

    def __hash__(self) -> int:
        return hash((self.token, id(self.owner), id(self._target)))

    def __repr__(self) -> str:
        return f"DrlRefob({self.token},{self._target.path})"


class DrlAppMsg(GCMessage):
    """(reference: drl/GCMessage.scala:7-11)"""

    __slots__ = ("payload", "token", "_refs", "trace_ctx")

    def __init__(self, payload: Any, token: Optional[Token], refs: Iterable[Refob]):
        self.payload = payload
        self.token = token
        self._refs = tuple(refs)
        #: causal-tracing context (uigc_tpu/telemetry/tracing.py).
        self.trace_ctx = None

    @property
    def refs(self) -> Tuple[Refob, ...]:
        return self._refs


class ReleaseMsg(GCMessage):
    """(reference: drl/GCMessage.scala:13-17)"""

    __slots__ = ("releasing", "created")

    def __init__(self, releasing: Iterable[DrlRefob], created: Iterable[DrlRefob]):
        self.releasing = tuple(releasing)
        self.created = tuple(created)

    @property
    def refs(self):
        return ()


class _SelfCheck(GCMessage):
    """(reference: drl/GCMessage.scala:21-24)"""

    __slots__ = ()

    @property
    def refs(self):
        return ()


SelfCheck = _SelfCheck()


class DrlSpawnInfo(SpawnInfo):
    """(reference: drl/DRL.scala:11-14)"""

    __slots__ = ("token", "creator")

    def __init__(self, token: Optional[Token], creator: Optional["ActorCell"]):
        self.token = token
        self.creator = creator


class DrlState:
    """(reference: drl/State.scala:7-284)"""

    __slots__ = (
        "self_cell",
        "count",
        "self_ref",
        "active_refs",
        "created_using",
        "owners",
        "released_owners",
        "sent_count",
        "recv_count",
        "pending_self_releases",
    )

    def __init__(self, cell: "ActorCell", spawn_info: DrlSpawnInfo):
        self.self_cell = cell
        self.count = 1
        self.self_ref = DrlRefob(Token(cell, 0), cell, cell)
        creator_ref = DrlRefob(spawn_info.token, spawn_info.creator, cell)
        self.active_refs: List[DrlRefob] = [self.self_ref]
        self.created_using: Dict[DrlRefob, List[DrlRefob]] = {}
        self.owners: List[DrlRefob] = [self.self_ref, creator_ref]
        self.released_owners: List[DrlRefob] = []
        self.sent_count: Dict[Token, int] = {self.self_ref.token: 0}
        self.recv_count: Dict[Token, int] = {self.self_ref.token: 0}
        self.pending_self_releases = 0

    def new_token(self) -> Token:
        token = Token(self.self_cell, self.count)
        self.count += 1
        return token

    def trivial_active_refs(self) -> List[DrlRefob]:
        return [r for r in self.active_refs if r.target is self.self_cell]

    def nontrivial_active_refs(self) -> List[DrlRefob]:
        return [r for r in self.active_refs if r.target is not self.self_cell]

    def handle_message(self, refs: Iterable[DrlRefob], token: Optional[Token]) -> None:
        """(reference: drl/State.scala:66-69)"""
        self.active_refs.extend(refs)
        self.inc_received(token)

    def handle_release(self, releasing: Tuple[DrlRefob, ...], created: Tuple[DrlRefob, ...]) -> None:
        """Two-phase owner reconciliation (reference: drl/State.scala:75-104)."""
        assert releasing
        sender = releasing[0].owner
        if sender is self.self_cell:
            self.pending_self_releases -= 1
        for ref in releasing:
            self.recv_count.pop(ref.token, None)
            if ref in self.owners:
                self.owners.remove(ref)
            else:
                self.released_owners.append(ref)
        for ref in created:
            if ref in self.released_owners:
                self.released_owners.remove(ref)
            else:
                self.owners.append(ref)

    def handle_self_check(self) -> None:
        self.inc_received(self.self_ref.token)

    def any_pending_self_messages(self) -> bool:
        """(reference: drl/State.scala:118-150)"""
        if self.pending_self_releases > 0:
            return True
        for ref in self.trivial_active_refs():
            token = ref.token
            if token in self.sent_count:
                if token not in self.recv_count:
                    return True
                assert self.sent_count[token] >= self.recv_count[token]
                if self.sent_count[token] > self.recv_count[token]:
                    return True
        return False

    def any_inverse_acquaintances(self) -> bool:
        """Chain Lemma check (reference: drl/State.scala:155-164)."""
        for ref in self.owners:
            if ref.owner is None or ref.owner is not self.self_cell:
                return True
        return False

    def handle_created_ref(self, target: DrlRefob, new_ref: DrlRefob) -> None:
        """(reference: drl/State.scala:166-189)"""
        assert target.target is new_ref.target
        assert target in self.active_refs
        if target.target is self.self_cell:
            self.owners.append(new_ref)
        else:
            self.created_using.setdefault(target, []).append(new_ref)

    def release(self, releasing: Iterable[DrlRefob]):
        """Group releases by target (reference: drl/State.scala:197-239).
        Returns {target_cell: (released refs, created refs)}."""
        targets: Dict["ActorCell", Tuple[List[DrlRefob], List[DrlRefob]]] = {}
        releasing = list(releasing)
        nontrivial = self.nontrivial_active_refs()
        for ref in releasing:
            if ref not in nontrivial:
                continue
            self.sent_count.pop(ref.token, None)
            key = ref.target
            released, created = targets.setdefault(key, ([], []))
            released.append(ref)
            created.extend(self.created_using.pop(ref, []))
            self.active_refs.remove(ref)

        trivial = self.trivial_active_refs()
        refs_to_self: List[DrlRefob] = []
        for ref in releasing:
            if ref in trivial and ref != self.self_ref:
                self.sent_count.pop(ref.token, None)
                self.active_refs.remove(ref)
                refs_to_self.append(ref)
        if refs_to_self:
            targets[self.self_cell] = (refs_to_self, [])
            self.pending_self_releases += 1
        return targets

    def inc_received(self, token: Optional[Token]) -> None:
        if token is not None:
            self.recv_count[token] = self.recv_count.get(token, 0) + 1

    def inc_sent(self, token: Optional[Token]) -> None:
        if token is not None:
            self.sent_count[token] = self.sent_count.get(token, 0) + 1


class DRL(Engine):
    """(reference: drl/DRL.scala:17-161)"""

    def root_message(self, payload: Any, refs: Iterable[Refob]) -> GCMessage:
        return DrlAppMsg(payload, None, refs)

    def root_spawn_info(self) -> SpawnInfo:
        return DrlSpawnInfo(None, None)

    def to_root_refob(self, cell: "ActorCell") -> Refob:
        return DrlRefob(None, None, cell)

    def init_state(self, cell: "ActorCell", spawn_info: DrlSpawnInfo) -> DrlState:
        return DrlState(cell, spawn_info)

    def get_self_ref(self, state: DrlState, cell: "ActorCell") -> Refob:
        return state.self_ref

    def spawn(
        self, factory: Callable[[SpawnInfo], "ActorCell"], state: DrlState, ctx: "ActorContext"
    ) -> Refob:
        """(reference: drl/DRL.scala:48-60)"""
        token = state.new_token()
        child = factory(DrlSpawnInfo(token, state.self_cell))
        ref = DrlRefob(token, state.self_cell, child)
        state.active_refs.append(ref)
        ctx.cell.watch(child)
        return ref

    def send_message(
        self, ref: DrlRefob, msg: Any, refs: Iterable[Refob], state: DrlState, ctx: "ActorContext"
    ) -> None:
        """(reference: drl/DRL.scala:148-160)"""
        if self.tap is not None:
            self.tap.on_send(ref.target)
        app_msg = DrlAppMsg(msg, ref.token, refs)
        tel = self.system.telemetry
        if tel is not None and tel.tracer.enabled:
            app_msg.trace_ctx = tel.tracer.on_send(
                target=ref.target.path, uid=ref.target.uid
            )
        ref.target.tell(app_msg)
        state.inc_sent(ref.token)

    def on_message(
        self, msg: GCMessage, state: DrlState, ctx: "ActorContext"
    ) -> Optional[Any]:
        """(reference: drl/DRL.scala:62-88)"""
        if isinstance(msg, DrlAppMsg):
            # token None marks the root adapter's external wrap: no
            # sender-side accounting exists for it, so the tap skips it.
            if self.tap is not None and msg.token is not None:
                self.tap.on_recv(ctx.cell)
            state.handle_message(msg.refs, msg.token)
            return msg.payload
        if isinstance(msg, ReleaseMsg):
            state.handle_release(msg.releasing, msg.created)
            return None
        if isinstance(msg, _SelfCheck):
            state.handle_self_check()
            return None
        return None

    def on_idle(
        self, msg: GCMessage, state: DrlState, ctx: "ActorContext"
    ) -> TerminationDecision:
        """(reference: drl/DRL.scala:90-106)"""
        return self.try_terminate(state, ctx)

    def try_terminate(self, state: DrlState, ctx: "ActorContext") -> TerminationDecision:
        if (
            ctx.cell.children
            or state.any_inverse_acquaintances()
            or state.any_pending_self_messages()
        ):
            return TerminationDecision.SHOULD_CONTINUE
        return TerminationDecision.SHOULD_STOP

    def post_signal(
        self, signal: Any, state: DrlState, ctx: "ActorContext"
    ) -> TerminationDecision:
        from ...runtime.signals import Terminated

        if isinstance(signal, Terminated):
            return self.try_terminate(state, ctx)
        return TerminationDecision.UNHANDLED

    def create_ref(
        self, target: DrlRefob, owner: DrlRefob, state: DrlState, ctx: "ActorContext"
    ) -> Refob:
        """(reference: drl/DRL.scala:108-118)"""
        if self.tap is not None:
            self.tap.on_create(owner.target, target.target)
        token = state.new_token()
        ref = DrlRefob(token, owner.target, target.target)
        state.handle_created_ref(target, ref)
        return ref

    def release(
        self, releasing: Iterable[DrlRefob], state: DrlState, ctx: "ActorContext"
    ) -> None:
        """(reference: drl/DRL.scala:120-132)"""
        releasing = list(releasing)
        tap = self.tap
        if tap is not None:
            for ref in releasing:
                tap.on_release(
                    ref, already_released=ref not in state.active_refs
                )
        targets = state.release(releasing)
        if len(targets) > 1:
            # Bulk release: one dispatcher submission per dispatcher for
            # the whole target set (runtime/cell.py tell_bulk), so a
            # wide release fan-out costs O(batches), not O(targets).
            from ...runtime.cell import tell_bulk

            tell_bulk(
                (target_cell, ReleaseMsg(released, created))
                for target_cell, (released, created) in targets.items()
            )
        else:
            for target_cell, (released, created) in targets.items():
                target_cell.tell(ReleaseMsg(released, created))
