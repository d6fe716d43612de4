"""Copy of ``uigc_tpu/runtime/context.py`` (pure Python).

The per-actor context facade: spawn / create_ref / release / self.

Mirrors the reference's ``uigc.ActorContext`` (reference:
ActorContext.scala:20-106): all GC-relevant operations funnel through the
engine; GC state lives here so behaviors can change while retaining it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Iterable, List, Optional

from ..interfaces import Refob, SpawnInfo

if TYPE_CHECKING:  # pragma: no cover
    from .behaviors import ActorFactory
    from .cell import ActorCell
    from .system import ActorSystem


class ActorContext:
    """Context handed to a managed actor's behavior."""

    __slots__ = ("_cell", "spawn_info", "engine", "state", "_self_ref")

    def __init__(self, cell: "ActorCell", spawn_info: SpawnInfo):
        self._cell = cell
        self.spawn_info = spawn_info
        self.engine = cell.system.engine
        # (reference: ActorContext.scala:24-28)
        self.state = self.engine.init_state(cell, spawn_info)
        self._self_ref: Refob = self.engine.get_self_ref(self.state, cell)

    # Identity ---------------------------------------------------------- #

    @property
    def self(self) -> Refob:
        """This actor's refob to itself (reference: ActorContext.scala:28)."""
        return self._self_ref

    # Alias for callers that prefer not to shadow the builtin notion.
    @property
    def self_ref(self) -> Refob:
        return self._self_ref

    @property
    def name(self) -> str:
        return self._cell.path

    @property
    def system(self) -> "ActorSystem":
        return self._cell.system

    @property
    def cell(self) -> "ActorCell":
        return self._cell

    @property
    def children(self) -> List["ActorCell"]:
        return list(self._cell.children.values())

    # Spawning ---------------------------------------------------------- #

    def spawn(self, factory: "ActorFactory", name: str) -> Refob:
        """Spawn a named managed child (reference: ActorContext.scala:45-46)."""
        return self.engine.spawn(
            lambda info: self._cell.system.spawn_cell(factory, name, self._cell, info),
            self.state,
            self,
        )

    def spawn_anonymous(self, factory: "ActorFactory") -> Refob:
        """Spawn an anonymous managed child (reference: ActorContext.scala:76-77)."""
        return self.engine.spawn(
            lambda info: self._cell.system.spawn_cell(
                factory, self._cell.next_anonymous_name(), self._cell, info
            ),
            self.state,
            self,
        )

    def spawn_remote(self, factory_key: str, location: Any) -> Refob:
        """Spawn an actor on another node via its RemoteSpawner service,
        blocking until the remote cell exists (reference:
        ActorContext.scala:48-65 uses a blocking ask)."""
        from .remote import remote_spawn

        return self.engine.spawn(
            lambda info: remote_spawn(location, factory_key, info),
            self.state,
            self,
        )

    # Reference management ---------------------------------------------- #

    def create_ref(self, target: Refob, owner: Refob) -> Refob:
        """Create a reference to ``target`` for ``owner`` to use
        (reference: ActorContext.scala:92-93)."""
        return self.engine.create_ref(target, owner, self.state, self)

    def release(self, *releasing: Any) -> None:
        """Release one or more references, or an iterable of them
        (reference: ActorContext.scala:97-104)."""
        if len(releasing) == 1 and not isinstance(releasing[0], Refob):
            refs: Iterable[Refob] = releasing[0]
        else:
            refs = releasing
        self.engine.release(refs, self.state, self)

    # Watching ---------------------------------------------------------- #

    def watch(self, ref: Any) -> None:
        """Watch a refob or cell for termination."""
        cell = ref.target if isinstance(ref, Refob) else ref
        self._cell.watch(cell)
