"""Copy of ``uigc_tpu/runtime/remote.py`` (pure Python).

Remote spawning: the RemoteSpawner service actor.

Mirrors the reference's keyed-factory spawn service (reference:
package.scala:28-47): a node hosts a ``RemoteSpawner`` registered with
named behavior factories; peers ask it to spawn, passing SpawnInfo, and
block on the reply (reference: ActorContext.scala:48-65).
"""

from __future__ import annotations

import itertools
import threading
from typing import TYPE_CHECKING, Any, Dict

from .behaviors import ActorFactory, RawBehavior

if TYPE_CHECKING:  # pragma: no cover
    from .cell import ActorCell
    from .system import ActorSystem


class _Spawn:
    __slots__ = ("factory_key", "spawn_info", "reply")

    def __init__(self, factory_key: str, spawn_info: Any, reply: "threading.Event"):
        self.factory_key = factory_key
        self.spawn_info = spawn_info
        self.reply = reply
        # The reply event doubles as the result carrier.
        self.reply.result = None  # type: ignore[attr-defined]


class _SpawnWire:
    """Cross-process spawn request: wire-safe (no shared-memory event) —
    the reply travels back as a message to ``reply_to``."""

    __slots__ = ("factory_key", "spawn_info", "reply_to")

    def __init__(self, factory_key: str, spawn_info: Any, reply_to: Any):
        self.factory_key = factory_key
        self.spawn_info = spawn_info
        self.reply_to = reply_to


class _SpawnReply:
    __slots__ = ("cell", "error")

    def __init__(self, cell: Any, error: str = ""):
        self.cell = cell
        self.error = error


class RemoteSpawner(RawBehavior):
    """Unmanaged service actor holding a keyed registry of actor factories
    (reference: package.scala:33-46)."""

    def __init__(self, system: "ActorSystem", factories: Dict[str, ActorFactory]):
        self._system = system
        self._factories = factories
        self._cell: Any = None
        self._anon = 0

    def bind(self, cell: "ActorCell") -> None:
        self._cell = cell

    def _do_spawn(self, factory_key: str, spawn_info: Any):
        factory = self._factories[factory_key]
        self._anon += 1
        return self._system.spawn_cell(
            factory, f"remote-{self._anon}", self._cell, spawn_info
        )

    def on_message(self, msg: Any) -> Any:
        if isinstance(msg, _Spawn):
            child = self._do_spawn(msg.factory_key, msg.spawn_info)
            msg.reply.result = child  # type: ignore[attr-defined]
            msg.reply.set()
        elif isinstance(msg, _SpawnWire):
            # A bad request must answer with an error, not kill the
            # service (an unmanaged cell's unhandled exception stops it
            # AND every previously spawned child under it).
            try:
                child = self._do_spawn(msg.factory_key, msg.spawn_info)
            except Exception as exc:  # noqa: BLE001 - reported to caller
                msg.reply_to.tell(_SpawnReply(None, error=repr(exc)))
            else:
                msg.reply_to.tell(_SpawnReply(child))
        return None

    @staticmethod
    def spawn_service(
        system: "ActorSystem", factories: Dict[str, ActorFactory], name: str = "RemoteSpawner"
    ) -> "ActorCell":
        behavior = RemoteSpawner(system, factories)
        return system.spawn_system_raw(behavior, name)


#: unique reply-cell names (id() reuse after GC could alias two cells
#: in the guardian's children map, orphaning one)
_reply_seq = itertools.count()


def remote_spawn(location: Any, factory_key: str, spawn_info: Any, timeout_s: float = 60.0):
    """Blocking ask to a RemoteSpawner cell; returns the spawned cell
    (reference: ActorContext.scala:48-65).

    Same-process spawners get the shared-memory event ask; a spawner in
    ANOTHER process (a ProxyCell from runtime/node.py) gets the wire
    ask: a temporary local reply cell receives the spawned cell's token
    back over the socket."""
    cell = location.cell if hasattr(location, "cell") else location
    fabric = getattr(cell, "_fabric", None)
    if fabric is not None:
        # cross-process: the request and reply are both wire frames
        from .system import RawRef

        address = cell.system.address
        if fabric._conn_for(address) is None:
            raise ConnectionError(
                f"remote spawn of {factory_key!r}: no live connection to "
                f"{address!r}"
            )
        system = fabric.system
        event = threading.Event()
        box = {}

        class _Reply(RawBehavior):
            def on_message(self, msg: Any) -> Any:
                if isinstance(msg, _SpawnReply):
                    box["reply"] = msg
                    event.set()
                return None

        # Pinned: the caller blocks a shared-pool worker in event.wait,
        # so the reply must not need a shared-pool worker to land —
        # N concurrent spawns would otherwise starve every reply.
        reply_cell = system.spawn_system_raw(
            _Reply(), f"spawn-reply-{next(_reply_seq)}", pinned=True
        )
        try:
            cell.tell(_SpawnWire(factory_key, spawn_info, RawRef(reply_cell)))
            if not event.wait(timeout_s):
                raise TimeoutError(
                    f"remote spawn of {factory_key!r} timed out"
                )
            reply = box["reply"]
            if reply.error:
                raise RuntimeError(
                    f"remote spawn of {factory_key!r} failed at "
                    f"{address!r}: {reply.error}"
                )
            return reply.cell
        finally:
            reply_cell.stop()
    event = threading.Event()
    cell.tell(_Spawn(factory_key, spawn_info, event))
    if not event.wait(timeout_s):
        raise TimeoutError(f"remote spawn of {factory_key!r} timed out")
    return event.result  # type: ignore[attr-defined]
