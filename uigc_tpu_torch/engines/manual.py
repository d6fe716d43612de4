"""Copy of ``uigc_tpu/engines/manual.py`` (pure Python).

The no-op engine: GC off, every hook is the identity.

Mirrors the reference's ``Manual`` engine (reference:
src/main/scala/edu/illinois/osl/uigc/engines/Manual.scala:26-116) — the
SPI's minimal conformance example.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from ..interfaces import GCMessage, Refob, SpawnInfo, State
from .engine import Engine, TerminationDecision


class ManualSpawnInfo(SpawnInfo):
    __slots__ = ()


class ManualGCMessage(GCMessage):
    """(reference: Manual.scala:10-11)"""

    __slots__ = ("payload", "_refs")

    def __init__(self, payload: Any, refs: Iterable[Refob]):
        self.payload = payload
        self._refs = tuple(refs)

    @property
    def refs(self) -> Iterable[Refob]:
        return self._refs


class ManualRefob(Refob):
    """(reference: Manual.scala:13-16)"""

    __slots__ = ("_target",)

    def __init__(self, target: Any):
        self._target = target

    @property
    def target(self) -> Any:
        return self._target

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ManualRefob) and self._target is other._target

    def __hash__(self) -> int:
        return hash(id(self._target))

    def __repr__(self) -> str:
        return f"ManualRefob({self._target.path})"


class ManualState(State):
    __slots__ = ("self_ref",)

    def __init__(self, self_ref: ManualRefob):
        self.self_ref = self_ref


class Manual(Engine):
    """GC disabled; all hooks are identity/ShouldContinue
    (reference: Manual.scala:26-116)."""

    def root_message(self, payload: Any, refs: Iterable[Refob]) -> GCMessage:
        return ManualGCMessage(payload, refs)

    def root_spawn_info(self) -> SpawnInfo:
        return ManualSpawnInfo()

    def to_root_refob(self, cell: Any) -> Refob:
        return ManualRefob(cell)

    def init_state(self, cell: Any, spawn_info: SpawnInfo) -> State:
        return ManualState(ManualRefob(cell))

    def get_self_ref(self, state: ManualState, cell: Any) -> Refob:
        return state.self_ref

    def spawn(self, factory: Callable, state: State, ctx: Any) -> Refob:
        return ManualRefob(factory(ManualSpawnInfo()))

    def send_message(self, ref: ManualRefob, msg: Any, refs: Iterable[Refob], state: State, ctx: Any) -> None:
        ref.target.tell(ManualGCMessage(msg, refs))

    def on_message(self, msg: ManualGCMessage, state: State, ctx: Any) -> Optional[Any]:
        return msg.payload

    def on_idle(self, msg: GCMessage, state: State, ctx: Any) -> TerminationDecision:
        return TerminationDecision.SHOULD_CONTINUE

    def create_ref(self, target: ManualRefob, owner: Refob, state: State, ctx: Any) -> Refob:
        return ManualRefob(target.target)

    def release(self, releasing: Iterable[Refob], state: State, ctx: Any) -> None:
        return None
