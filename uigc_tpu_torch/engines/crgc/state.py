"""Copy of ``uigc_tpu/engines/crgc/state.py`` (pure Python).

Per-actor CRGC state and the entry snapshot it flushes into.

Mirrors the reference's bounded, preallocated mutator-side records
(reference: crgc/State.java:5-124, crgc/Entry.java:5-37): four
fixed-capacity fields (created owner/target pairs, spawned actors, updated
refobs), a saturating receive count, and a move-and-clear flush.  Capacity
checks (``can_record_*``) force an early flush before overflow; the engine
calls them before every record (reference: CRGC.scala:108,121,158,172,215).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional

from ...interfaces import State as StateBase
from ...utils.validation import CapacityError
from . import refob as refob_info
from .refob import SHORT_MAX, CrgcRefob

if TYPE_CHECKING:  # pragma: no cover
    pass


class CrgcContext:
    """Cached CRGC config (reference: crgc/Context.java:8-16)."""

    __slots__ = ("delta_graph_size", "entry_field_size")

    def __init__(self, delta_graph_size: int, entry_field_size: int):
        self.delta_graph_size = delta_graph_size
        self.entry_field_size = entry_field_size


class Entry:
    """A flushed snapshot shipped from a mutator to the collector
    (reference: crgc/Entry.java:5-37).  Pooled and reused."""

    __slots__ = (
        "self_ref",
        "created_owners",
        "created_targets",
        "spawned_actors",
        "updated_refs",
        "updated_infos",
        "recv_count",
        "is_busy",
        "is_root",
    )

    def __init__(self, context: CrgcContext):
        size = context.entry_field_size
        self.self_ref: Optional[CrgcRefob] = None
        self.created_owners: List[Optional[CrgcRefob]] = [None] * size
        self.created_targets: List[Optional[CrgcRefob]] = [None] * size
        self.spawned_actors: List[Optional[CrgcRefob]] = [None] * size
        self.updated_refs: List[Optional[CrgcRefob]] = [None] * size
        self.updated_infos: List[int] = [0] * size
        self.recv_count = 0
        self.is_busy = False
        self.is_root = False

    def clean(self) -> None:
        """Reset for pool reuse (reference: Entry.java:26-36)."""
        self.self_ref = None
        for i in range(len(self.created_owners)):
            self.created_owners[i] = None
            self.created_targets[i] = None
            self.spawned_actors[i] = None
            self.updated_refs[i] = None
            self.updated_infos[i] = 0
        self.recv_count = 0
        self.is_busy = False
        self.is_root = False


class CrgcState(StateBase):
    """Mutable GC state owned by exactly one actor — single-writer by
    design (reference: crgc/State.java:5-43)."""

    __slots__ = (
        "self_ref",
        "context",
        "created_owners",
        "created_targets",
        "spawned_actors",
        "updated_refobs",
        "created_idx",
        "spawned_idx",
        "updated_idx",
        "recv_count",
        "is_root",
        "stop_requested",
    )

    def __init__(self, self_ref: CrgcRefob, context: CrgcContext):
        size = context.entry_field_size
        self.self_ref = self_ref
        self.context = context
        self.created_owners: List[Optional[CrgcRefob]] = [None] * size
        self.created_targets: List[Optional[CrgcRefob]] = [None] * size
        self.spawned_actors: List[Optional[CrgcRefob]] = [None] * size
        self.updated_refobs: List[Optional[CrgcRefob]] = [None] * size
        self.created_idx = 0
        self.spawned_idx = 0
        self.updated_idx = 0
        self.recv_count = 0
        self.is_root = False
        self.stop_requested = False

    def mark_as_root(self) -> None:
        self.is_root = True

    # Capacity checks (reference: State.java:49-88) ------------------- #

    def can_record_new_refob(self) -> bool:
        return self.created_idx < self.context.entry_field_size

    def record_new_refob(self, owner: CrgcRefob, target: CrgcRefob) -> None:
        if not self.can_record_new_refob():
            raise CapacityError(
                "state.capacity",
                "created-refs field written past capacity without a flush",
                field="created",
                index=self.created_idx,
                capacity=self.context.entry_field_size,
                actor=self.self_ref.target.path,
            )
        i = self.created_idx
        self.created_idx = i + 1
        self.created_owners[i] = owner
        self.created_targets[i] = target

    def can_record_new_actor(self) -> bool:
        return self.spawned_idx < self.context.entry_field_size

    def record_new_actor(self, child: CrgcRefob) -> None:
        if not self.can_record_new_actor():
            raise CapacityError(
                "state.capacity",
                "spawned-actors field written past capacity without a flush",
                field="spawned",
                index=self.spawned_idx,
                capacity=self.context.entry_field_size,
                actor=self.self_ref.target.path,
            )
        self.spawned_actors[self.spawned_idx] = child
        self.spawned_idx += 1

    def can_record_updated_refob(self, refob: CrgcRefob) -> bool:
        return refob.has_been_recorded or self.updated_idx < self.context.entry_field_size

    def record_updated_refob(self, refob: CrgcRefob) -> None:
        if not self.can_record_updated_refob(refob):
            raise CapacityError(
                "state.capacity",
                "updated-refobs field written past capacity without a flush",
                field="updated",
                index=self.updated_idx,
                capacity=self.context.entry_field_size,
                actor=self.self_ref.target.path,
                refob=repr(refob),
            )
        if refob.has_been_recorded:
            return
        refob.set_has_been_recorded()
        self.updated_refobs[self.updated_idx] = refob
        self.updated_idx += 1

    def can_record_message_received(self) -> bool:
        return self.recv_count < SHORT_MAX

    def record_message_received(self) -> None:
        if not self.can_record_message_received():
            raise CapacityError(
                "state.capacity",
                "receive count saturated without a flush",
                field="recv_count",
                value=self.recv_count,
                capacity=SHORT_MAX,
                actor=self.self_ref.target.path,
            )
        self.recv_count += 1

    # Flush (reference: State.java:90-124) ----------------------------- #

    def flush_to_entry(self, is_busy: bool, entry: Entry) -> None:
        entry.self_ref = self.self_ref
        entry.is_busy = is_busy
        entry.is_root = self.is_root

        for i in range(self.created_idx):
            entry.created_owners[i] = self.created_owners[i]
            entry.created_targets[i] = self.created_targets[i]
            self.created_owners[i] = None
            self.created_targets[i] = None
        self.created_idx = 0

        for i in range(self.spawned_idx):
            entry.spawned_actors[i] = self.spawned_actors[i]
            self.spawned_actors[i] = None
        self.spawned_idx = 0

        entry.recv_count = self.recv_count
        self.recv_count = 0

        for i in range(self.updated_idx):
            refob = self.updated_refobs[i]
            entry.updated_refs[i] = refob
            entry.updated_infos[i] = refob.info
            refob.reset()
            self.updated_refobs[i] = None
        self.updated_idx = 0

    def flush_to_ring(self, is_busy: bool, plane) -> None:
        """Move-and-clear flush into the packed plane (packed.py row
        layout) instead of an object Entry — same facts, same reset
        semantics as :meth:`flush_to_entry`, but the collector-side fold
        becomes pure array work.  Every cell named by the row is pinned
        in ``plane.uid_strong`` *before* the commit publishes the row,
        so the collector can always resolve the uid."""
        ring = plane.ring()
        us = plane.uid_strong
        v = ring.begin()
        sc = self.self_ref._target
        v[0] = plane.next_seq()
        v[1] = sc.uid
        us.setdefault(sc.uid, sc)
        v[2] = (1 if is_busy else 0) | (2 if self.is_root else 0)
        v[3] = self.recv_count
        self.recv_count = 0
        v[4:] = -1

        base = 4
        for i in range(self.created_idx):
            oc = self.created_owners[i]._target
            tc = self.created_targets[i]._target
            us.setdefault(oc.uid, oc)
            us.setdefault(tc.uid, tc)
            v[base + 2 * i] = oc.uid
            v[base + 2 * i + 1] = tc.uid
            self.created_owners[i] = None
            self.created_targets[i] = None
        self.created_idx = 0

        base += 2 * self.context.entry_field_size
        for i in range(self.spawned_idx):
            cc = self.spawned_actors[i]._target
            us.setdefault(cc.uid, cc)
            v[base + i] = cc.uid
            self.spawned_actors[i] = None
        self.spawned_idx = 0

        base += self.context.entry_field_size
        for i in range(self.updated_idx):
            refob = self.updated_refobs[i]
            tc = refob._target
            us.setdefault(tc.uid, tc)
            v[base + 2 * i] = tc.uid
            v[base + 2 * i + 1] = refob.info
            refob.reset()
            self.updated_refobs[i] = None
        self.updated_idx = 0
        ring.commit()
