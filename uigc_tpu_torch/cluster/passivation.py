"""Copy of ``uigc_tpu/cluster/passivation.py`` (pure Python).  What
differs: the passivation capture reads the state through
``sharding.captured_state`` (a ref to the entity's own descendant, which
stops with it, becomes None); the reference captures
``snapshot_state()`` as is.

Idle-entity passivation: spill, stop, recreate on next send.

Passivation is the sharding layer's own quiescence judgment, sitting
beside the GC engines' one: entities are pseudoroots (the GC never
collects them), so *something* must decide when an idle entity stops
occupying a cell, a mailbox, and a shadow-graph slot.  The decision is
driven by the cell's mailbox-idle clock
(:meth:`~uigc_tpu_torch.runtime.cell.ActorCell.idle_seconds`): an entity whose
mailbox has been empty and untouched for ``passivate_after`` seconds is
asked to capture its state, which lands in the region's in-memory
:class:`StateStore`; the cell then terminates through the normal stop
protocol (the engine's death accounting runs, the shadow slot is
reclaimed by the next GC wave — the ``terminated-by-GC`` arc of the
entity lifecycle).  The next message routed to the key re-activates the
entity from the store with its state intact.

The capture command rides the region's transition machinery (the same
buffer-while-captured discipline as migration), so a message that races
the passivation is buffered and triggers an immediate re-activation —
passivation can never lose traffic, only waste a spill.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any, Dict, List, Optional

from ..utils import events
from .sharding import _ACTIVE, _EntityCtl, _PASSIVATING, captured_state

if TYPE_CHECKING:  # pragma: no cover
    from .sharding import Entity, ShardRegion


class StateStore:
    """Snapshot store for passivated entities (key -> state).

    The in-memory dict is the fast path; with a ``spill`` callback
    attached (the region wires it to the entity journal,
    cluster/journal.py) every put ALSO lands a durable snapshot record
    — the durable backend that lets a node holding only passivated
    entities die and have whoever inherits its shards recover them."""

    def __init__(self, spill: Optional[Any] = None) -> None:
        self._lock = threading.Lock()
        self._states: Dict[str, Any] = {}
        self._spill = spill

    def put(self, key: str, state: Any) -> None:
        with self._lock:
            self._states[key] = state
        if self._spill is not None:
            try:
                self._spill(key, state)
            except Exception:  # durability must not abort the spill
                import traceback

                traceback.print_exc()

    def pop(self, key: str) -> Any:
        with self._lock:
            return self._states.pop(key, None)

    def size(self) -> int:
        with self._lock:
            return len(self._states)

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._states

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._states)


class _PassivateCmd(_EntityCtl):
    """Capture command for passivation: snapshot, spill, stop."""

    __slots__ = ("region",)

    def __init__(self, region: "ShardRegion"):
        self.region = region

    def apply(self, entity: "Entity") -> Any:
        from ..runtime.behaviors import Behaviors
        from .migration import _drain_for_capture

        ctx = entity.context
        snapshot = captured_state(entity)
        pending = _drain_for_capture(ctx)
        passivate_captured(self.region, entity.key, snapshot, pending)
        return Behaviors.stopped()


class PassivationPolicy:
    """Mailbox-idle-time policy: scan the region's active entities and
    passivate those idle past the threshold.  ``idle_s <= 0`` disables
    passivation entirely."""

    def __init__(self, idle_s: float):
        self.idle_s = idle_s

    def scan(self, region: "ShardRegion") -> int:
        if self.idle_s <= 0:
            return 0
        passivated = 0
        with region._lock:
            candidates = [
                (key, rec.cell)
                for key, rec in region._entities.items()
                if rec.status == _ACTIVE
            ]
        for key, cell in candidates:
            if cell.idle_seconds() >= self.idle_s and cell.mailbox_size() == 0:
                if region._begin_transition(key, _PASSIVATING, _PassivateCmd(region)):
                    passivated += 1
        return passivated


def passivate_captured(region: "ShardRegion", key: str, snapshot: Any,
                       pending: List[Any]) -> None:
    """Entity-thread completion of a passivation capture: spill the
    snapshot, retire the record, and — if traffic raced in — re-activate
    immediately so nothing is lost.  The whole sequence runs under the
    region lock: between the spill and the reactivation check, a
    concurrently routed message could otherwise pop the stored snapshot
    and spawn its own cell, which the reactivation would then clobber
    with a blank-state duplicate."""
    with region._lock:
        region.store.put(key, snapshot)
        buffered = region._finish_transition(key)
        if events.recorder.enabled:
            events.recorder.commit(
                events.SHARD_ENTITY_PASSIVATED, key=key, type=region.type_name
            )
        leftover = list(pending) + list(buffered)
        if leftover:
            # The spill was wasted: new messages arrived mid-capture.
            # Pull the state straight back out and rebuild the entity.
            state = region.store.pop(key)
            region._reactivate(key, state, leftover)
