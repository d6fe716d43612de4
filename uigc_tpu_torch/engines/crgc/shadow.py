"""Copy of ``uigc_tpu/engines/crgc/shadow.py`` (pure Python).  One
addition, off unless a graph sets ``sticky_undo``: an undo fold that also
covers the shadows that appear, or are reset, after it
(``merge_undo_log``, ``reset_undo_slice``).  The partitioned collector
turns it on (``engines/crgc/distributed.py``, ROADMAP.md Queue 3), and
so does the sanitizer's oracle beside it.

The oracle shadow graph: pointer-based, reference-exact semantics.

This is the behavioral twin of the reference's collector-side graph
(reference: crgc/Shadow.java:10-54, crgc/ShadowGraph.java:9-299).  The TPU
data plane (``arrays.py`` / ``ops/trace.py``) must agree with this oracle
on every liveness verdict; differential tests drive both over the same
entry streams — the same technique the reference author used
(ShadowGraph.java:176-199 ``assertEquals`` dual-graph debugging).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Set

from ...utils import events
from .messages import StopMsg, WaveMsg
from .state import CrgcContext, Entry

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell
    from .refob import CrgcRefob


def _cell_path(cell) -> str:
    """Stable display name for a cell (real or remote proxy)."""
    return getattr(cell, "path", repr(cell))


class Shadow:
    """Collector-side image of one actor (reference: Shadow.java:10-54)."""

    __slots__ = (
        "self_cell",
        "location",
        "outgoing",
        "supervisor",
        "recv_count",
        "mark",
        "is_root",
        "interned",
        "is_local",
        "is_busy",
        "is_halted",
        "partition",
        "touch_tick",
    )

    def __init__(self) -> None:
        self.self_cell: Optional["ActorCell"] = None
        self.location: Optional[str] = None
        #: cross-node partition id memo (parallel/partition.py) — pure
        #: in the cell's (address, uid), so computed once per shadow
        self.partition: Optional[int] = None
        #: mirror-decay clock (distributed mode): the graph's decay
        #: tick when a fold last mentioned this shadow
        self.touch_tick = 0
        #: net created-minus-deactivated refs toward each target; may be
        #: negative (reference: Shadow.java:14-19)
        self.outgoing: Dict["Shadow", int] = {}
        self.supervisor: Optional["Shadow"] = None
        #: received minus sent; nonzero means undelivered messages exist
        self.recv_count = 0
        self.mark = False
        self.is_root = False
        self.interned = False
        self.is_local = False
        self.is_busy = False
        self.is_halted = False

    def __repr__(self) -> str:  # pragma: no cover
        path = self.self_cell.path if self.self_cell is not None else "?"
        return (
            f"Shadow({path} recv={self.recv_count} root={self.is_root} "
            f"busy={self.is_busy} interned={self.interned} local={self.is_local} "
            f"halted={self.is_halted} out={len(self.outgoing)})"
        )


def _update_outgoing(outgoing: Dict[Shadow, int], target: Shadow, delta: int) -> None:
    """Zero counts are deleted, not stored (reference: ShadowGraph.java:64-73)."""
    count = outgoing.get(target, 0) + delta
    if count == 0:
        outgoing.pop(target, None)
    else:
        outgoing[target] = count


def clear_authoritative_state(shadow: Shadow) -> None:
    """Reset every authoritative slot of one shadow in place (the
    object is kept — other shadows' edges reference it by identity).
    Shared by the distributed absorb path and the sanitizer's oracle
    mirror of it, so the two can never drift on which fields count as
    authoritative."""
    shadow.outgoing.clear()
    shadow.supervisor = None
    shadow.recv_count = 0
    shadow.interned = False
    shadow.is_root = False
    shadow.is_busy = False
    shadow.is_halted = False


def dispatch_kills(cells) -> None:
    """Bulk teardown of a sweep's kill set: one dispatcher submission
    per dispatcher for the whole set, not one per actor (runtime/cell.py
    tell_bulk).  Shared by the single-host trace below and the
    distributed sweep (engines/crgc/distributed.py) — remote cells in
    the set are ProxyCells whose tell routes the StopMsg over the
    fabric."""
    if not cells:
        return
    from ...runtime.cell import tell_bulk

    tell_bulk((cell, StopMsg) for cell in cells)


class ShadowGraph:
    """The detection structure (reference: ShadowGraph.java:9-299)."""

    #: the sticky undo fold (module note): a partitioned collector folds
    #: a dead node's undo log while facts about its slice still arrive
    #: (absorb journals re-shipped after a remap) and resets the slices
    #: it gains after the fold.  With it on, the fold halts every shadow
    #: of the dead node whenever it appears, and owes each recipient's
    #: adjustment until its shadow exists, once per reset of its slice.
    sticky_undo = False

    def __init__(self, context: CrgcContext, local_address: Optional[str] = None):
        self.context = context
        #: address of the node this collector serves; shadows created from
        #: entries are local to it
        self.local_address = local_address
        self.marked = True  # polarity flips every trace (ShadowGraph.java:11)
        self.total_actors_seen = 0
        self.from_set: List[Shadow] = []
        self.shadow_map: Dict["ActorCell", Shadow] = {}
        #: why-live parent capture (telemetry/inspect.py), gated per wake
        #: by the collector exactly like the array backend's flag: when
        #: set, the next trace records ``last_parents`` — a
        #: ``{cell: (parent_cell, kind)}`` map where ``kind`` is
        #: "created" or "supervisor" and pseudoroot seeds are absent
        #: (their explanation is their own flags).
        self.capture_parents = False
        self.last_parents: Optional[Dict[Any, tuple]] = None
        #: accumulated per-edge send matrix ((owner_cell, target_cell)
        #: -> messages sent); None = off, enabled by the liveness
        #: inspector's attach.  Swept cells' rows are purged.
        self.send_matrix: Optional[Dict[tuple, int]] = None
        #: sticky undo state: addresses whose actors are halted, the
        #: folded logs, and the adjustments owed to absent shadows
        self.dead_locations: Set[str] = set()
        self._undo_folded: List[Any] = []
        self._undo_owed: Dict[Any, List[Any]] = {}

    # ------------------------------------------------------------- #
    # Shadow lookup
    # ------------------------------------------------------------- #

    def get_shadow_for_refob(self, refob: "CrgcRefob") -> Shadow:
        """Cache-aware lookup (reference: ShadowGraph.java:23-33)."""
        shadow = refob.target_shadow
        if shadow is not None and shadow is self.shadow_map.get(refob.target):
            return shadow
        shadow = self.get_shadow(refob.target)
        refob.target_shadow = shadow
        return shadow

    def get_shadow(self, cell: "ActorCell") -> Shadow:
        """(reference: ShadowGraph.java:35-43)"""
        shadow = self.shadow_map.get(cell)
        if shadow is not None:
            return shadow
        return self.make_shadow(cell)

    def make_shadow(self, cell: "ActorCell") -> Shadow:
        """(reference: ShadowGraph.java:45-62)"""
        self.total_actors_seen += 1
        shadow = Shadow()
        shadow.self_cell = cell
        shadow.location = cell.system.address
        shadow.mark = not self.marked  # unmarked under current polarity
        shadow.interned = False
        shadow.is_local = False
        self.shadow_map[cell] = shadow
        self.from_set.append(shadow)
        if self.sticky_undo:
            if shadow.location in self.dead_locations:
                shadow.is_halted = True
            owed = self._undo_owed.pop(cell, None)
            for field in owed or ():
                self._apply_undo_field(shadow, field)
        return shadow

    # ------------------------------------------------------------- #
    # Folding snapshots
    # ------------------------------------------------------------- #

    def merge_entry(self, entry: Entry) -> None:
        """Fold one mutator snapshot (reference: ShadowGraph.java:75-125)."""
        self_shadow = self.get_shadow_for_refob(entry.self_ref)
        self_shadow.interned = True
        self_shadow.is_local = True
        self_shadow.recv_count += entry.recv_count
        self_shadow.is_busy = entry.is_busy
        self_shadow.is_root = entry.is_root

        field_size = self.context.entry_field_size

        # Created refs: owner gains an outgoing edge toward target.
        for i in range(field_size):
            owner = entry.created_owners[i]
            if owner is None:
                break
            target_shadow = self.get_shadow_for_refob(entry.created_targets[i])
            owner_shadow = self.get_shadow_for_refob(owner)
            _update_outgoing(owner_shadow.outgoing, target_shadow, 1)

        # Spawned actors: set the child's supervisor.
        for i in range(field_size):
            child = entry.spawned_actors[i]
            if child is None:
                break
            child_shadow = self.get_shadow_for_refob(child)
            child_shadow.supervisor = self_shadow

        # Updated refobs: sends count against the target's recv balance;
        # deactivations remove an outgoing edge.
        from . import refob as refob_info

        sm = self.send_matrix
        for i in range(field_size):
            target = entry.updated_refs[i]
            if target is None:
                break
            target_shadow = self.get_shadow_for_refob(target)
            info = entry.updated_infos[i]
            send_count = refob_info.count(info)
            if send_count > 0:
                target_shadow.recv_count -= send_count  # may go negative
                if sm is not None:
                    key = (self_shadow.self_cell, target_shadow.self_cell)
                    sm[key] = sm.get(key, 0) + send_count
            if not refob_info.is_active(info):
                _update_outgoing(self_shadow.outgoing, target_shadow, -1)

    def merge_delta(self, delta) -> None:
        """Fold a peer node's compressed batch
        (reference: ShadowGraph.java:127-156)."""
        decoder = delta.decoder()
        for i, delta_shadow in enumerate(delta.shadows):
            shadow = self.get_shadow(decoder[i])
            shadow.interned = shadow.interned or delta_shadow.interned
            shadow.recv_count += delta_shadow.recv_count
            if delta_shadow.interned:
                # isBusy/isRoot are only meaningful if the actor produced
                # an entry in this period (reference: ShadowGraph.java:139-146).
                shadow.is_busy = delta_shadow.is_busy
                shadow.is_root = delta_shadow.is_root
            if delta_shadow.supervisor >= 0:
                shadow.supervisor = self.get_shadow(decoder[delta_shadow.supervisor])
            for target_id, count in delta_shadow.outgoing.items():
                _update_outgoing(
                    shadow.outgoing, self.get_shadow(decoder[target_id]), count
                )

    def merge_undo_log(self, log) -> None:
        """Halt a dead node's actors and revert its unadmitted effects
        (reference: ShadowGraph.java:158-174)."""
        if self.sticky_undo:
            self._undo_folded.append(log)
            self.dead_locations.add(log.node_address)
            self.reset_undo_slice(None, log)
            return
        for shadow in self.from_set:
            if shadow.location == log.node_address:
                shadow.is_halted = True
            field = log.admitted.get(shadow.self_cell)
            if field is not None:
                shadow.recv_count += field.message_count
                for target_cell, count in field.created_refs.items():
                    _update_outgoing(
                        shadow.outgoing, self.get_shadow(target_cell), count
                    )

    def _undo_scope(self, cell) -> bool:
        """Whose adjustments this graph applies (the partitioned graph:
        its owned slice)."""
        return True

    def _note_undo_write(self, shadow) -> None:
        """Called for each shadow the sticky fold writes."""

    def _apply_undo_field(self, shadow, field) -> None:
        shadow.recv_count += field.message_count
        for target_cell, count in field.created_refs.items():
            _update_outgoing(shadow.outgoing, self.get_shadow(target_cell), count)
        self._note_undo_write(shadow)

    def reset_undo_slice(
        self, in_slice: Optional[Callable[[Any], bool]], log: Any = None
    ) -> None:
        """Apply the folded undo logs (or only ``log``, at its fold) to
        the cells ``in_slice`` accepts (every cell when None): halt the
        shadows of dead nodes, and apply each recipient's adjustment to
        its shadow, or owe it until the shadow is made.  Called with a
        slice right after that slice's authoritative state was cleared
        (``reset_partition``), so every cell of it ends with exactly one
        adjustment per folded log."""
        if not self.sticky_undo:
            return
        if in_slice is not None:
            for cell in [c for c in self._undo_owed if in_slice(c)]:
                del self._undo_owed[cell]
        dead = self.dead_locations
        for shadow in self.from_set:
            if shadow.location in dead and not shadow.is_halted and (
                in_slice is None or in_slice(shadow.self_cell)
            ) and self._undo_scope(shadow.self_cell):
                shadow.is_halted = True
                self._note_undo_write(shadow)
        for folded in [log] if log is not None else self._undo_folded:
            for cell, field in folded.admitted.items():
                if (in_slice is not None and not in_slice(cell)) or (
                    not self._undo_scope(cell)
                ):
                    continue
                shadow = self.shadow_map.get(cell)
                if shadow is None:
                    self._undo_owed.setdefault(cell, []).append(field)
                else:
                    self._apply_undo_field(shadow, field)

    def forget_dead(self, address: str) -> None:
        """A downed address rejoined: actors it hosts from now on are
        not halted on sight."""
        self.dead_locations.discard(address)

    # ------------------------------------------------------------- #
    # The trace (reference: ShadowGraph.java:201-289)
    # ------------------------------------------------------------- #

    @staticmethod
    def is_pseudo_root(shadow: Shadow) -> bool:
        """(reference: ShadowGraph.java:201-203)"""
        return (
            shadow.is_root
            or shadow.is_busy
            or shadow.recv_count != 0
            or not shadow.interned
        ) and not shadow.is_halted

    def trace(self, should_kill: bool) -> int:
        """Mark-and-sweep over the shadow graph; returns the number of
        garbage actors found.  Unmarked local actors whose supervisor is
        marked get a StopMsg — killing the oldest unmarked ancestor kills
        the subtree via the runtime's stop cascade
        (reference: ShadowGraph.java:205-289)."""
        marked = self.marked
        # Why-live provenance (telemetry/inspect.py): when capture is on
        # for this wake, record which shadow's propagation first marked
        # each non-seed — the pointer-graph twin of the array backend's
        # marking-parent array.
        parents: Optional[Dict[Any, tuple]] = (
            {} if self.capture_parents else None
        )
        with events.recorder.timed(events.TRACING) as ev:
            to_set: List[Shadow] = []
            for shadow in self.from_set:
                if self.is_pseudo_root(shadow):
                    to_set.append(shadow)
                    shadow.mark = marked

            scanptr = 0
            while scanptr < len(to_set):
                owner = to_set[scanptr]
                scanptr += 1
                if owner.is_halted:
                    # Nothing reachable from a halted actor stays alive on
                    # its account (reference: ShadowGraph.java:226-229).
                    continue
                for target, count in owner.outgoing.items():
                    if count > 0 and target.mark != marked:
                        to_set.append(target)
                        target.mark = marked
                        if parents is not None:
                            parents[target.self_cell] = (
                                owner.self_cell, "created",
                            )
                # Mark the supervisor so parents outlive descendants —
                # deliberately incomplete (reference: ShadowGraph.java:242-267).
                supervisor = owner.supervisor
                if supervisor is not None and supervisor.mark != marked:
                    to_set.append(supervisor)
                    supervisor.mark = marked
                    if parents is not None:
                        parents[supervisor.self_cell] = (
                            owner.self_cell, "supervisor",
                        )
            if parents is not None:
                self.last_parents = parents

            num_garbage = 0
            num_live = 0
            # The sweep in its own timed event, for the wake profiler's
            # trace-vs-sweep attribution (telemetry/profile.py).
            with events.recorder.timed(events.SWEEP):
                kills: List[Any] = []
                for shadow in self.from_set:
                    if shadow.mark != marked:
                        num_garbage += 1
                        self.shadow_map.pop(shadow.self_cell, None)
                        if (
                            should_kill
                            and shadow.is_local
                            and not shadow.is_halted
                            and shadow.supervisor is not None
                            and shadow.supervisor.mark == marked
                        ):
                            kills.append(shadow.self_cell)
                    else:
                        num_live += 1
                dispatch_kills(kills)

                self.from_set = to_set
                self.marked = not marked
                sm = self.send_matrix
                if sm and num_garbage:
                    shadow_map = self.shadow_map
                    dead_keys = [
                        key
                        for key in sm
                        if key[0] not in shadow_map or key[1] not in shadow_map
                    ]
                    for key in dead_keys:
                        del sm[key]
            ev.fields["num_garbage_actors"] = num_garbage
            ev.fields["num_live_actors"] = num_live
        return num_garbage

    def start_wave(self) -> int:
        """Poke local roots to flush entries down the tree
        (reference: ShadowGraph.java:291-299)."""
        count = 0
        for shadow in self.from_set:
            if shadow.is_root and shadow.is_local:
                count += 1
                shadow.self_cell.tell(WaveMsg)
        return count

    # ------------------------------------------------------------- #
    # Diagnostics (reference: ShadowGraph.java:176-199, 302-330)
    # ------------------------------------------------------------- #

    def assert_equals(self, other: "ShadowGraph") -> None:
        """Differential-testing check comparing two graphs built from the
        same entry stream (reference: ShadowGraph.java:176-199
        ``assertEquals``).  Raises :class:`GraphMismatchError` — a
        structured error that survives ``python -O`` and carries every
        mismatching entry in its payload — instead of a bare assert."""
        from ...utils.validation import GraphMismatchError

        only_here = set(self.shadow_map) - set(other.shadow_map)
        only_there = set(other.shadow_map) - set(self.shadow_map)
        if only_here or only_there:
            raise GraphMismatchError(
                "graph.population",
                "shadow maps cover different actors",
                only_here=sorted(_cell_path(c) for c in only_here),
                only_there=sorted(_cell_path(c) for c in only_there),
            )
        mismatches: List[dict] = []
        for cell, mine in self.shadow_map.items():
            theirs = other.shadow_map[cell]
            diffs = {}
            for field in ("recv_count", "is_root", "interned", "is_busy"):
                a, b = getattr(mine, field), getattr(theirs, field)
                if a != b:
                    diffs[field] = (a, b)
            mine_sup = mine.supervisor.self_cell if mine.supervisor else None
            their_sup = theirs.supervisor.self_cell if theirs.supervisor else None
            if mine_sup is not their_sup:
                diffs["supervisor"] = (
                    _cell_path(mine_sup) if mine_sup else None,
                    _cell_path(their_sup) if their_sup else None,
                )
            # Compare by cell identity (distinct cells can share a path
            # across nodes); render paths only in the evidence payload.
            mine_out = {s.self_cell: c for s, c in mine.outgoing.items()}
            their_out = {s.self_cell: c for s, c in theirs.outgoing.items()}
            if mine_out != their_out:
                diffs["outgoing"] = (
                    sorted((_cell_path(c), n) for c, n in mine_out.items()),
                    sorted((_cell_path(c), n) for c, n in their_out.items()),
                )
            if diffs:
                mismatches.append({"actor": _cell_path(cell), "fields": diffs})
        if mismatches:
            raise GraphMismatchError(
                "graph.mismatch",
                f"{len(mismatches)} shadow(s) disagree between the graphs",
                mismatches=mismatches,
            )

    def addresses_in_graph(self) -> Dict[str, int]:
        """Uncollected shadows per node address
        (reference: ShadowGraph.java:331-340, structured instead of
        printed)."""
        counts: Dict[str, int] = {}
        for shadow in self.from_set:
            counts[shadow.location] = counts.get(shadow.location, 0) + 1
        return counts

    def investigate_live_set(self) -> Dict[str, object]:
        """Structured dump of why the live set is what it is
        (reference: ShadowGraph.java:342-394): population counters plus
        the cross-locality acquaintances that usually explain a leak
        suspicion (a local actor apparently held remotely, or vice
        versa)."""
        non_interned = roots = busy = nonzero_recv = nonlocal_ = 0
        root_acquaintances: Dict[str, int] = {}
        local_to_remote: List[tuple] = []
        remote_to_local = 0
        for shadow in self.from_set:
            if not shadow.interned:
                non_interned += 1
            if shadow.is_root:
                roots += 1
                root_acquaintances[_cell_path(shadow.self_cell)] = len(
                    shadow.outgoing
                )
            if shadow.is_busy:
                busy += 1
            if shadow.recv_count != 0:
                nonzero_recv += 1
            if not shadow.is_local:
                nonlocal_ += 1
                for out in shadow.outgoing:
                    if out.is_local:
                        remote_to_local += 1
            else:
                for out, count in shadow.outgoing.items():
                    if not out.is_local:
                        local_to_remote.append(
                            (
                                _cell_path(shadow.self_cell),
                                _cell_path(out.self_cell),
                                count,
                            )
                        )
        return {
            "total": len(self.from_set),
            "non_interned": non_interned,
            "roots": roots,
            "busy": busy,
            "nonzero_recv": nonzero_recv,
            "nonlocal": nonlocal_,
            "root_acquaintances": root_acquaintances,
            "local_to_remote": sorted(local_to_remote),
            "remote_to_local_count": remote_to_local,
        }

    def count_reachable_from(self, address: str) -> int:
        """How many actors are reachable from actors at ``address``
        (reference: ShadowGraph.java:302-330)."""
        to_set: List[Shadow] = []
        marked = self.marked
        for shadow in self.from_set:
            if shadow.location == address:
                to_set.append(shadow)
                shadow.mark = marked
        scanptr = 0
        while scanptr < len(to_set):
            owner = to_set[scanptr]
            scanptr += 1
            if owner.is_halted:
                continue
            for target, count in owner.outgoing.items():
                if count > 0 and target.mark != marked:
                    to_set.append(target)
                    target.mark = marked
        for shadow in to_set:
            shadow.mark = not marked
        return len(to_set)
