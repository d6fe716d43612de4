"""Copy of ``uigc_tpu/engines/crgc/distributed.py`` (pure Python).  Its
local fixpoint runs on the pointer plane (``shadow.py``), as in the
reference, so the partitioned collector launches no kernel.  What
differs:

- **The wave stamp.**  A routed delta carries its sender's wave cut
  (``DDelta``), and the receiver folds it into the running wave when the
  sender routed it before entering that wave
  (``DistributedBookkeeper._accept_delta``).  The reference defers every
  delta that arrives during a wave
  (``uigc_tpu/engines/crgc/distributed.py:889-903``), so the halves of
  one entry can fall into different waves on different nodes and a live
  actor can be swept.  On a ``NodeFabric`` the stamp rides the
  ``"delta"`` frame's trailing fields (``runtime/node.py``).
- **The per-link cut** (a Chandy-Lamport marker per link).  The stamp
  only helps if the delta reaches its owner before the wave ends there.
  A wave ends when the root has judged two quiet rounds, and each node's
  report travels up the reduction tree to its parent, not to the owners
  it routed deltas to.  The only counters the rounds compare are the
  dmark counts.  So with order kept only per link, a report (or the
  ``dfin`` it leads to) can overtake a delta still on another link: P
  routes a delta to O, enters the wave, reports to the root, and O can
  receive the root's ``dfin`` first.  The in-process ``Fabric`` hid this,
  because ``control_send`` enqueues into the receiver's mailbox at once.
  So each node, as it enters a wave, sends every peer a ``dcut`` marker
  (``DCut``, ``wire.encode_dcut``) that names the wave, the era, and the
  count of stamped deltas of that era it has routed to that peer; each
  delta carries its index in that count (``DDelta.index``).  An owner
  tracks, per (peer, era), how many stamped deltas it has received
  without a gap in the indices, and it is not *settled* in a wave
  (``_WaveState.settled``: it neither reports nor opens a round) until
  each live peer's marker for that wave or a later one is in and that
  many deltas have arrived (``_cut_open``).  A plain count would let a
  later delta stand in for a lost one.  Every member must send markers:
  a partitioned cluster that mixes the port with the reference, which
  has none, would never end a wave.
  Every delta a peer routed below the cut was sent before its marker,
  so it is folded before the owner's first settled report, and the two
  quiet rounds that end the wave count everything it changed.
  Why the marker needs nothing more on a ``NodeFabric``: every frame to
  one peer (``control_send``'s deltas and ``send_frame``'s markers
  alike) enters that peer's one writer queue and leaves in queue order,
  one sequence number each (``_send_frame``, ``_writer_loop``; the
  ``"fb"`` batch keeps queue order inside a flush); the shm ring carries
  the same bytes in the same order, and the in-stream ``shmgo`` barrier
  and the recovery drain keep ring and socket frames from interleaving;
  the receiver delivers each peer's frames in sequence order on one
  thread (the socket reader, the ring reader or that peer's decode lane)
  into the one collector cell's mailbox.  A frame that would arrive
  behind a newer one is discarded by the sequence layer as a duplicate,
  so reordering never changes the order the collector sees.
- **What a FaultPlan that reorders or drops frames leaves.**  On a
  ``NodeFabric`` the sequence layer turns a reordered frame into a lost
  one (above).  A lost stamped delta leaves a gap in its link's indices,
  its owner's count stops there, and the owner never settles in that
  era: the cluster
  completes no wave and collects nothing more until a membership change
  opens a new era, and it never sweeps on a cut that misses the delta.
  The new era forgives the loss without restoring the lost facts (the
  absorb journals re-ship only partitions that move), so from there the
  reference's model of a dropped frame applies.
  A held-back (delayed) delta holds the wave until it arrives.  Drops,
  duplicates and reorders of the other frame kinds are healed by the
  wave protocol as in the reference.  The in-process ``Fabric`` applies
  no fault plan to ``control_send``.

The distributed collector: shadow graph sharded ACROSS cluster nodes.

The reference (and the replicated multi-node mode in collector.py)
gives every node a FULL shadow-graph replica: each collector folds every
peer's delta broadcast and traces the whole graph, capping the
collector at what one host holds — the wall ROADMAP item 2 names.  This
module is the other end-state: each node owns only the shadow-graph
slice for the partitions it owns (parallel/partition.py — the SAME
rendezvous family as the ShardTable, so entity placement and
shadow partitioning never fight), and cross-node garbage is found by a
coordinator-free trace-wave protocol:

- **Routing**: a mutator entry's effects are split per affected actor
  and folded into per-owner delta graphs (delta.py ``fold_*``): flags +
  receive balance to the actor's owner, edges to the SOURCE actor's
  owner, supervisor pointers to the CHILD's owner, bare mentions to a
  created target's owner.  Deltas ride the fabric point-to-point to the
  one owner instead of broadcasting to everyone.
- **Trace waves**: each wave runs the local fixpoint over the owned
  slice only; marks that reach a *mirror* (an edge endpoint owned
  elsewhere) leave as cumulative ``dmark`` frames to the owner, which
  folds them as seeds and continues — so cross-node cycles iterate to
  the same global fixpoint the single-host trace computes.  Mark sets
  are cumulative per wave and re-sent until acked (``dmack``), so
  dropped/duplicated/reordered frames cannot corrupt or stall a wave.
- **Termination**: a Safra-style round — (settled, changed-since-last,
  sent, received) — aggregates leaf-to-root over the deterministic
  reduction tree (parallel/partition.py ``ReductionTree``, the
  Tascade-shaped asynchronous reduction of PAPERS.md); two consecutive
  clean rounds prove the global fixpoint and the root broadcasts
  ``dfin``.  No coordinator process, no per-wave full-graph allgather —
  the tree root is just the lowest live address and re-derives itself
  from membership.
- **Sweep**: each owner sweeps its own slice.  The kill gate (only the
  oldest unmarked ancestor is stopped; its stop cascades) needs the
  supervisor's authoritative mark, which may live on another node: a
  ``dgate`` query asks the supervisor's owner, which dispatches the
  StopMsg itself when the supervisor is live.  Unacked gates re-dirty
  the graph so the next wave retries — a lost frame can only DELAY a
  collection, never kill a live actor.
- **Absorb on death**: every node retains, per partition, a cumulative
  delta journal of the facts it generated.  When a member dies, the
  fence bumps, ownership remaps (rendezvous: only the dead node's
  partitions move), survivors re-send their journals for the moved
  partitions to the new owners, and the new owner re-folds from a reset
  slice — the dead node's own facts die with it, which (like a skipped
  undo fold) can only LEAK, never collect a live actor.  The existing
  undo-log quorum then halts the dead node's actors and reverts its
  unadmitted claims, restricted per node to the slice it owns.

Two sharding levels coexist: the mesh backend keeps sharding the
fold/trace across local devices *within* a node, and this layer shards
the graph *across* nodes — the two levels the reference collapses into
one.  (The partitioned local fixpoint currently runs the pointer plane;
the device planes plug in behind the same dmark interface.)
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List, Optional, Set, Tuple

from ...parallel.partition import PartitionMap, ReductionTree, cell_key
from ...runtime import wire
from ...utils import events
from .collector import Bookkeeper, DeltaMsg, _phase
from .delta import DeltaGraph
from .shadow import ShadowGraph, dispatch_kills

if TYPE_CHECKING:  # pragma: no cover
    from .engine import CRGC


# ------------------------------------------------------------------- #
# Protocol messages.  One shape for both fabrics: over a NodeFabric
# they cross as the dedicated version-tolerant frames (runtime/wire.py
# encode_dmark & co., decoded back into these classes by the frame
# handler); over the in-process Fabric they ride control_send as plain
# picklable objects.  Actor coordinates are always (address, uid) key
# tuples — never cells — so a frame round-trip cannot drag object
# graphs across the wire.
# ------------------------------------------------------------------- #


class DWave:
    __slots__ = ("wave", "fence", "origin", "round_id")

    def __init__(self, wave: int, fence: int, origin: str, round_id: int = 0):
        self.wave, self.fence, self.origin = wave, fence, origin
        self.round_id = round_id


class DMark:
    __slots__ = ("wave", "fence", "origin", "keys", "start", "round_id")

    def __init__(
        self, wave: int, fence: int, origin: str, keys: list,
        start: int = 0, round_id: int = 0,
    ):
        self.wave, self.fence, self.origin, self.keys = wave, fence, origin, keys
        self.start = start
        self.round_id = round_id


class DMack:
    __slots__ = ("wave", "origin", "count", "fence", "round_id", "report")

    def __init__(
        self, wave: int, origin: str, count: int, fence: int = 0,
        round_id: int = 0, report=None,
    ):
        self.wave, self.origin, self.count = wave, origin, count
        self.fence = fence
        self.round_id = round_id
        self.report = report


class DProbe:
    __slots__ = ("wave", "round_id", "origin", "fence")

    def __init__(self, wave: int, round_id: int, origin: str, fence: int = 0):
        self.wave, self.round_id, self.origin = wave, round_id, origin
        self.fence = fence


class DStat:
    __slots__ = ("wave", "round_id", "origin", "stats", "fence")

    def __init__(
        self, wave: int, round_id: int, origin: str, stats: dict,
        fence: int = 0,
    ):
        self.wave, self.round_id, self.origin, self.stats = (
            wave, round_id, origin, stats,
        )
        self.fence = fence


class DFin:
    __slots__ = ("wave", "fence", "origin")

    def __init__(self, wave: int, fence: int, origin: str):
        self.wave, self.fence, self.origin = wave, fence, origin


class DGate:
    __slots__ = ("wave", "fence", "origin", "pairs")

    def __init__(self, wave: int, fence: int, origin: str, pairs: list):
        self.wave, self.fence, self.origin, self.pairs = (
            wave, fence, origin, pairs,
        )


class DGack:
    __slots__ = ("wave", "origin", "count", "fence")

    def __init__(self, wave: int, origin: str, count: int, fence: int = 0):
        self.wave, self.origin, self.count = wave, origin, count
        self.fence = fence


class DDirty:
    __slots__ = ("origin",)

    def __init__(self, origin: str):
        self.origin = origin


class DCut:
    """The per-link wave marker: ``origin`` entered ``wave`` of era
    ``fence`` after routing ``count`` stamped deltas of that era to the
    receiver, in its wave state number ``entry`` (see the module note
    on the per-link cut)."""

    __slots__ = ("wave", "fence", "origin", "count", "entry")

    def __init__(
        self, wave: int, fence: int, origin: str, count: int, entry: int
    ):
        self.wave, self.fence, self.origin = wave, fence, origin
        self.count, self.entry = count, entry


class DJournal:
    """A retained per-partition delta journal re-sent to that
    partition's new owner after a membership change (the absorb path).
    Crosses control_send like DeltaMsg; the graph's own wire format
    applies in serialize mode."""

    __slots__ = ("fence", "partition", "graph", "_wire_buf")

    def __init__(self, fence: int, partition: int, graph: DeltaGraph):
        self.fence = fence
        self.partition = partition
        self.graph = graph
        self._wire_buf: Optional[bytes] = None

    def reencode(self, fabric, dst_system) -> "DJournal":
        if self._wire_buf is None:
            self._wire_buf = self.graph.serialize(wire.encode_cell)
        graph = DeltaGraph.deserialize(
            self._wire_buf,
            dst_system.engine.crgc_context,
            wire.make_decode_cell(fabric),
        )
        return DJournal(self.fence, self.partition, graph)


class DDelta(DeltaMsg):
    """A routed delta stamped with its sender's wave cut: ``(fence,
    cut)``.  The sender folds its own half of the same entries into
    every wave numbered above ``cut`` in era ``fence`` (the wave it was
    in when it routed them, else the last wave it finished), so the
    receiver folds this half into exactly those waves too — into the
    running wave when it is numbered above ``cut``, else after it.
    Without the stamp the two halves of one entry can land on opposite
    sides of a wave (``DistributedBookkeeper._accept_delta``).  ``index``
    numbers the stamped deltas of era ``fence`` on this link (the
    per-link cut, module note); -1 is a delta no marker counts."""

    __slots__ = ("fence", "cut", "index")

    def __init__(
        self, seqnum: int, graph: DeltaGraph, fence: int, cut: int,
        index: int = -1,
    ):
        super().__init__(seqnum, graph)
        self.fence = fence
        self.cut = cut
        self.index = index

    def reencode(self, fabric, dst_system) -> "DDelta":
        plain = super().reencode(fabric, dst_system)
        return DDelta(plain.seqnum, plain.graph, self.fence, self.cut,
                      self.index)


# ------------------------------------------------------------------- #
# The partitioned shadow graph
# ------------------------------------------------------------------- #


class PartitionedShadowGraph(ShadowGraph):
    """A ShadowGraph that is authoritative only for the slice the
    partition map assigns to this node.  Shadows for non-owned actors
    exist only as *mirrors* — edge endpoints and supervisor pointers of
    owned actors — whose authoritative state (flags, balances, edges)
    lives at their owner and never mutates here: marks reaching a
    mirror relay out as dmarks instead of propagating locally.

    ``fold_touched`` records which keys the fold paths wrote
    content-bearing state for since the last audit — the runtime twin
    of lint rule UL014 ("slot mutation outside the owning partition's
    fold path goes through the dmark/delta route"), asserted per sweep
    and by the chaos tests."""

    def __init__(self, context, local_address: Optional[str]):
        super().__init__(context, local_address)
        self.partition_map: Optional[PartitionMap] = None
        #: (address, uid) -> cell for every shadow in the graph; dmark
        #: seeds resolve through it without materializing proxies for
        #: actors this node has never heard of.
        self.key_index: Dict[Tuple[str, int], Any] = {}
        #: keys whose authoritative state a fold wrote since the last
        #: locality audit
        self.fold_touched: Set[Tuple[str, int]] = set()
        #: last audited boundary-edge count (telemetry gauge)
        self.boundary_edges = 0
        #: mirror-decay clock (ticks once per completed wave / idle
        #: wake) and the decayed mirrors parked outside the traversal
        #: working set: cell -> Shadow.  A decayed mirror's OBJECT stays
        #: alive inside its referencing owners' ``outgoing`` dicts (so
        #: edge identity is preserved and later +/-1 folds cancel), but
        #: it leaves ``from_set``/``key_index`` — the per-wave iteration
        #: and population surface — until ownership changes or its last
        #: referencing edge releases.
        self.decay_tick = 0
        self.evicted: Dict[Any, Any] = {}
        self.mirrors_evicted_total = 0

    # -- partition plumbing ---------------------------------------- #

    def set_partition_map(self, pmap: PartitionMap) -> None:
        self.partition_map = pmap
        # Ownership moved: stale locality records would false-positive
        # against the new map, and a decayed mirror may now be OWNED —
        # its authoritative slot must be back in the working set before
        # the absorb path resets/re-folds the gained slices.
        self.fold_touched.clear()
        self._revive_evicted()

    def _revive_evicted(self) -> None:
        """Re-admit every decayed mirror to the working set (called at
        each partition remap: a gained partition's shadows must be
        visible to ``reset_partition`` and the re-fold; still-foreign
        ones simply decay again)."""
        if not self.evicted:
            return
        tick = self.decay_tick
        for cell, shadow in self.evicted.items():
            shadow.touch_tick = tick
            self.from_set.append(shadow)
            self.key_index[cell_key(cell)] = cell
        self.evicted = {}

    def decay_mirrors(self, max_age: int) -> int:
        """Advance the decay clock and move foreign-owned mirrors that
        no fold has mentioned for ``max_age`` ticks out of the working
        set.  Relay correctness is untouched: the fixpoint reaches a
        mirror through its referencing owner's ``outgoing`` dict and
        relays by key — residency in ``from_set``/``key_index`` is pure
        iteration/population surface (the hub-node full-replica
        convergence this decays away).

        The O(population) scan runs only every ``max_age`` ticks — a
        shadow cannot expire sooner than one full window after its
        last touch — so idle collector wakes pay amortized
        O(pop / max_age), never a full sweep per 10ms tick."""
        pmap = self.partition_map
        if max_age <= 0 or pmap is None:
            return 0
        self.decay_tick += 1
        if self.decay_tick % max_age:
            return 0
        floor = self.decay_tick - max_age
        keep: List[Any] = []
        evicted = self.evicted
        n = 0
        for shadow in self.from_set:
            if (
                shadow.touch_tick <= floor
                and not self.owns_shadow(shadow)
            ):
                cell = shadow.self_cell
                evicted[cell] = shadow
                self.key_index.pop(cell_key(cell), None)
                n += 1
                continue
            keep.append(shadow)
        if n:
            self.from_set = keep
            self.mirrors_evicted_total += n
            events.recorder.commit(
                events.DIST_MIRROR_EVICT,
                count=n,
                resident=len(keep),
                node=self.local_address,
            )
        return n

    def owns_key(self, key: Tuple[str, int]) -> bool:
        pmap = self.partition_map
        return pmap is not None and pmap.owns(key)

    def shadow_partition(self, shadow) -> Optional[int]:
        """The shadow's partition id, memoized on the shadow itself —
        key->partition is pure, and the ownership checks below run
        O(V+E) times per wave."""
        pmap = self.partition_map
        if pmap is None:
            return None
        p = shadow.partition
        if p is None:
            p = shadow.partition = pmap.partition_of(
                cell_key(shadow.self_cell)
            )
        return p

    def owns_shadow(self, shadow) -> bool:
        pmap = self.partition_map
        if pmap is None:
            return False
        return pmap.owns_partition(self.shadow_partition(shadow))

    def make_shadow(self, cell):
        shadow = super().make_shadow(cell)
        shadow.touch_tick = self.decay_tick
        self.key_index[cell_key(cell)] = cell
        return shadow

    def drop_shadow(self, cell) -> None:
        self.shadow_map.pop(cell, None)
        self.evicted.pop(cell, None)
        self.key_index.pop(cell_key(cell), None)

    def shadow_for_key(self, key: Tuple[str, int]):
        cell = self.key_index.get(key)
        if cell is None:
            return None
        return self.shadow_map.get(cell)

    # -- folds (locality-audited) ----------------------------------- #

    def merge_delta(self, delta) -> None:
        # Record which keys this delta writes authoritative state for
        # BEFORE folding: a content-bearing delta shadow (flags,
        # balance, supervisor, or edges) mutates its actor's slot; a
        # bare mention only ensures existence.
        # One pass over the decoder does double duty: record the
        # content-bearing keys for the locality audit, and refresh the
        # mirror-decay clock for every RESIDENT shadow the delta
        # mentions ("an owned edge touched it").  A decayed mirror is
        # deliberately NOT revived — ``get_shadow`` resolves it through
        # ``shadow_map``, so edge identity (and +/-1 fold cancellation)
        # is preserved without re-growing the working set; shadows the
        # fold CREATES get their tick in ``make_shadow``.
        decoder = delta.decoder()
        touched = self.fold_touched
        tick = self.decay_tick
        smap = self.shadow_map
        evicted = self.evicted
        for i, ds in enumerate(delta.shadows):
            cell = decoder[i]
            if cell is None:
                continue
            if ds.interned or ds.recv_count or ds.supervisor >= 0 or ds.outgoing:
                touched.add(cell_key(cell))
            if cell not in evicted:
                shadow = smap.get(cell)
                if shadow is not None:
                    shadow.touch_tick = tick
        super().merge_delta(delta)

    #: the sticky undo fold (shadow.py; ROADMAP.md Queue 3): an owner
    #: folds a dead node's undo log while the absorb journals of the
    #: partitions it gained may still be on their way, and it resets the
    #: partitions it gains after a fold.  The reference's fold reaches
    #: only the shadows present at that moment (``uigc_tpu/engines/crgc/
    #: distributed.py:380-406``), so a dead node's actor re-folded later
    #: stays unhalted and a recipient's admitted-count revert is lost:
    #: the survivors' cycles through the dead node never collect.
    sticky_undo = True

    def merge_undo_log(self, log) -> None:
        """Partition-restricted undo fold: every node receives the same
        quorum-complete log (ingress entries are broadcast), and each
        owner applies exactly the slice it owns — halts for owned
        actors hosted on the dead node, admitted-count reverts for
        owned recipients.  Non-owned adjustments are applied by THEIR
        owners from their own copy of the log.  Sticky: shadows that
        appear later, and slices reset later, get the fold too."""
        super().merge_undo_log(log)

    def _undo_scope(self, cell) -> bool:
        return self.owns_key(cell_key(cell))

    def _note_undo_write(self, shadow) -> None:
        if self.owns_shadow(shadow):
            self.fold_touched.add(cell_key(shadow.self_cell))

    def reset_partition(self, partitions: Set[int]) -> int:
        """In-place reset of the owned slice for ``partitions`` ahead of
        a journal re-fold (the absorb path).  Shadow OBJECTS are kept —
        edges from other partitions' shadows reference them by identity,
        and popping would strand those edges on orphans — only their
        authoritative state is cleared."""
        pmap = self.partition_map
        if pmap is None:
            return 0
        from .shadow import clear_authoritative_state

        n = 0
        for shadow in self.from_set:
            if self.shadow_partition(shadow) in partitions:
                clear_authoritative_state(shadow)
                n += 1
        self.reset_undo_slice(
            lambda cell: pmap.partition_of(cell_key(cell)) in partitions)
        return n

    # -- audits ------------------------------------------------------ #

    def audit_fold_locality(self) -> List[Tuple[str, int]]:
        """Keys whose authoritative state was folded here although the
        current map assigns them elsewhere.  Empty on a healthy node;
        nonempty means a fold bypassed the delta route (the UL014
        class).  Clears the audit window."""
        pmap = self.partition_map
        bad = (
            [k for k in self.fold_touched if not pmap.owns(k)]
            if pmap is not None
            else []
        )
        self.fold_touched.clear()
        return bad

    def boundary_edge_count(self) -> int:
        """Edges whose destination's slice lives on another node — the
        cross-node surface each wave's dmarks cover (telemetry:
        uigc_dist_boundary_edges)."""
        pmap = self.partition_map
        if pmap is None:
            return 0
        n = 0
        for shadow in self.from_set:
            if not self.owns_shadow(shadow):
                continue
            for target, count in shadow.outgoing.items():
                if count > 0 and not self.owns_shadow(target):
                    n += 1
            sup = shadow.supervisor
            if sup is not None and not self.owns_shadow(sup):
                n += 1
        self.boundary_edges = n
        return n

    def owned_population(self) -> int:
        return sum(1 for s in self.from_set if self.owns_shadow(s))


# ------------------------------------------------------------------- #
# Wave state
# ------------------------------------------------------------------- #


class _WaveState:
    __slots__ = (
        "wave", "fence", "marked", "queue", "seeded",
        "out_marks", "out_sets", "sent_upto", "acked",
        "recv_upto", "recv_ahead",
        "changed", "reported_round", "probe_round_seen", "child_stats",
        "fin", "idle", "cut_open", "entry",
        # root only
        "probe_round", "round_done", "quiet_sig", "rounds_run",
    )

    def __init__(self, wave: int, fence: int):
        self.wave = wave
        self.fence = fence
        self.marked: Set[Any] = set()          # Shadow objects (owned)
        self.queue: List[Any] = []             # pending propagation
        self.seeded = False
        self.out_marks: Dict[str, List] = {}   # peer -> ordered key list
        self.out_sets: Dict[str, Set] = {}     # peer -> key set (dedup)
        #: peer -> flush watermark (keys [0:sent_upto] already flushed
        #: this wave; the suffix protocol sends only past it)
        self.sent_upto: Dict[str, int] = {}
        #: peer -> acked contiguous-coverage watermark
        self.acked: Dict[str, int] = {}
        #: src -> contiguous received-position watermark
        self.recv_upto: Dict[str, int] = {}
        #: src -> out-of-order positions past the watermark
        self.recv_ahead: Dict[str, Set[int]] = {}
        self.changed = False
        self.reported_round = 0
        self.probe_round_seen = 0
        self.child_stats: Dict[int, Dict[str, dict]] = {}
        self.fin = False
        self.idle = 0
        #: peers whose per-link cut this wave still waits for
        #: (DistributedBookkeeper._cut_open); not settled until empty
        self.cut_open: Set[str] = set()
        #: this node's wave-state number (DCut.entry)
        self.entry = 0
        self.probe_round = 0
        self.round_done: Dict[int, bool] = {}
        #: the (sent, recv) signature of the last judged all-settled
        #: sent==recv round; an identical signature on the NEXT judged
        #: round proves the global fixpoint (the two-consecutive-quiet
        #: criterion — Mattern's four-counter argument over idempotent
        #: cumulative mark sets)
        self.quiet_sig: Optional[tuple] = None
        self.rounds_run = 0

    def sent_total(self) -> int:
        return sum(len(lst) for lst in self.out_marks.values())

    def recv_total(self) -> int:
        srcs = set(self.recv_upto) | set(self.recv_ahead)
        return sum(
            self.recv_upto.get(s, 0) + len(self.recv_ahead.get(s, ()))
            for s in srcs
        )

    def settled(self) -> bool:
        if self.queue or self.cut_open:
            return False
        for peer, lst in self.out_marks.items():
            if self.acked.get(peer, 0) < len(lst):
                return False
        return True


# ------------------------------------------------------------------- #
# The distributed Bookkeeper
# ------------------------------------------------------------------- #


class DistributedBookkeeper(Bookkeeper):
    """Collector loop for the partitioned mode.  Same cell, same timers,
    same membership plumbing as the replicated Bookkeeper — different
    fold routing and a wave protocol in place of the local trace."""

    def __init__(self, engine: "CRGC"):
        super().__init__(engine)
        config = engine.system.config
        n = config.get_int("uigc.crgc.dist-partitions")
        if n <= 0:
            n = config.get_int("uigc.cluster.num-shards")
        self.num_partitions = n
        self.fence = 0
        #: a higher era was adopted from a peer frame since the last
        #: remap (suppresses the remap's own +1 for that transition)
        self._fence_adopted = False
        self.pmap: Optional[PartitionMap] = None
        self.tree: Optional[ReductionTree] = None
        self.wave = 0
        self.ws: Optional[_WaveState] = None
        self._last_wave_done = 0
        self._last_marked: Set[Tuple[str, int]] = set()
        #: partition -> cumulative DeltaGraph of the facts THIS node
        #: generated for that partition (the absorb journal)
        self._retained: Dict[int, DeltaGraph] = {}
        #: partition -> size at its last compaction (the doubling
        #: floor that amortizes _compact_retained)
        self._retained_floor: Dict[int, int] = {}
        #: deferred folds as (graph, fence, cut): each folds into the
        #: waves above ``cut`` of era ``fence`` (see DDelta)
        self._pending_deltas: List[Tuple[DeltaGraph, int, int]] = []
        self._pending_journals: List[DJournal] = []
        self._pending_undo: List[Any] = []
        self._dirty_hint = False
        #: re-entrancy latch for sweep -> next-wave chaining
        self._chain_guard = False
        #: foreign-owned mirrors leave the traversal working set after
        #: this many decay ticks without a fold touching them (0 = off)
        self.mirror_decay = config.get_int("uigc.crgc.mirror-decay-waves")
        #: remote-supervisor kill gates from the last sweep, re-derived
        #: per wave; unacked gates keep the graph dirty so the next
        #: wave retries (a lost frame delays, never leaks a kill
        #: decision)
        self._gates_wave = 0
        self._gates_out: Dict[str, List] = {}
        self._gates_acked: Dict[str, int] = {}
        #: (origin, wave) -> processed gate-pair set (dedup + ack count)
        self._gates_seen: Dict[Tuple[str, int], Set] = {}
        # Per-owner delta builders for the current drain.
        self._builders: Dict[str, DeltaGraph] = {}
        #: the per-link cut: (owner, fence) -> stamped deltas routed
        #: there; (origin, fence) -> stamped deltas received from there
        #: without a gap (the next index expected); origin -> (fence,
        #: wave, count) of its newest marker
        self._cut_sent: Dict[Tuple[str, int], int] = {}
        self._cut_recv: Dict[Tuple[str, int], int] = {}
        self._cut_marks: Dict[str, Tuple[int, int, int]] = {}
        #: wave states created here, and origin -> (fence, wave, entry)
        #: of the newest marker seen (a restarted wave, module note)
        self._wave_entries = 0
        self._cut_entry: Dict[str, Tuple[int, int, int]] = {}
        # Stats for the bench / dashboard.
        self.waves_completed = 0
        self.total_dist_garbage = 0
        self.marks_sent = 0
        self.mark_bytes = 0
        self.marks_received = 0
        self.rounds_total = 0

    # -- plumbing ---------------------------------------------------- #

    @property
    def _me(self) -> str:
        return self.engine.system.address

    def _graph(self):
        # Through the sanitizer's mirror when attached: custom methods
        # pass straight through its __getattr__, fold methods are
        # observed — which is exactly the contract the oracle needs.
        return self.shadow_graph

    def bind(self, cell: Any) -> None:
        super().bind(cell)
        fabric = self.engine.system.fabric
        reg = getattr(fabric, "register_frame_handler", None)
        if reg is not None:
            for kind in wire.DIST_FRAME_KINDS:
                reg(kind, self._on_dist_frame)

    def _on_dist_frame(self, from_address: str, frame: tuple) -> None:
        """Transport-thread entry: decode (tolerantly) and hand the
        message to the collector cell — all protocol state mutates on
        the one thread that owns the graph."""
        kind = frame[0]
        msg: Any = None
        if kind == "dwave":
            d = wire.decode_dwave(frame)
            msg = DWave(*d) if d else None
        elif kind == "dmark":
            d = wire.decode_dmark(frame)
            msg = DMark(*d) if d else None
        elif kind == "dmack":
            d = wire.decode_dmack(frame)
            msg = DMack(*d) if d else None
        elif kind == "dprobe":
            d = wire.decode_dprobe(frame)
            msg = DProbe(*d) if d else None
        elif kind == "dstat":
            d = wire.decode_dstat(frame)
            msg = DStat(*d) if d else None
        elif kind == "dfin":
            d = wire.decode_dfin(frame)
            msg = DFin(*d) if d else None
        elif kind == "dgate":
            d = wire.decode_dgate(frame)
            msg = DGate(*d) if d else None
        elif kind == "dgack":
            d = wire.decode_dgack(frame)
            msg = DGack(*d) if d else None
        elif kind == "ddirty":
            d = wire.decode_ddirty(frame)
            msg = DDirty(d) if d else None
        elif kind == "dcut":
            d = wire.decode_dcut(frame)
            msg = DCut(*d) if d else None
        elif kind == "djnl":
            d = wire.decode_djournal(frame)
            if d is not None:
                try:
                    graph = DeltaGraph.deserialize(
                        d[2],
                        self.engine.crgc_context,
                        wire.make_decode_cell(self.engine.system.fabric),
                    )
                except Exception:
                    graph = None  # malformed journal: drop (leak-safe)
                if graph is not None:
                    msg = DJournal(d[0], d[1], graph)
        if msg is not None:
            self.cell.tell(msg)

    def _send_dist(self, peer: str, frame: tuple, msg: Any) -> None:
        """One protocol send: the dedicated frame on a NodeFabric (so
        FaultPlan can target the kind and mixed versions stay
        tolerant), the message object over the in-process fabric."""
        if peer == self._me:
            return
        fabric = self.engine.system.fabric
        send = getattr(fabric, "send_frame", None)
        if send is not None:
            send(peer, frame)
            return
        gc = self.remote_gcs.get(peer)
        if gc is not None:
            fabric.control_send(self.engine.system, gc, msg)

    def _resolve_key(self, key: Tuple[str, int]):
        """Key -> cell, for kill dispatch: the graph's index first (no
        allocation), the fabric's token resolver second."""
        cell = self._graph().key_index.get(key)
        if cell is not None:
            return cell
        fabric = self.engine.system.fabric
        hook = getattr(fabric, "resolve_cell_token", None)
        if hook is not None:
            try:
                return hook(key[0], key[1])
            except Exception:
                return None
        system = fabric.systems.get(key[0])
        if system is None:
            return None
        return system.resolve_cell(key[1])

    # -- membership -------------------------------------------------- #

    def add_member(self, address: str) -> None:
        before = self.started
        if address in self.downed_gcs:
            self._graph().forget_dead(address)
        super().add_member(address)
        if self.multi_node and address in self.remote_gcs:
            self._remap_partitions()
        if not before and self.started:
            self._graph_dirty = True

    def remove_member(self, address: str) -> None:
        super().remove_member(address)
        if self.multi_node:
            self._remap_partitions()

    def _cluster_fence(self) -> int:
        """Reuse the partition arbiter's fence when cluster sharding is
        attached, so the collector's partition era and the shard
        plane's quarantine era can never diverge."""
        cluster = getattr(self.engine.system, "cluster", None)
        arb = getattr(cluster, "arbiter", None)
        return getattr(arb, "fence", 0) if arb is not None else 0

    def _reset_wave_plane(self) -> None:
        """A fence change opens a new wave ERA: wave ids restart at 1
        (the root mints them), completed-wave watermarks and gate state
        reset, and the in-flight wave aborts.  Every live node runs the
        identical reset at the same membership transition, so the
        numbering stays agreed; the wave-keyed frames carry the fence,
        so a straggler from the old era can never alias the new one."""
        self.wave = 0
        self._last_wave_done = 0
        self._last_marked = set()
        self.ws = None
        self._gates_wave = 0
        self._gates_out = {}
        self._gates_acked = {}
        self._gates_seen = {}
        for counts in (self._cut_sent, self._cut_recv):
            for key in [k for k in counts if k[1] < self.fence]:
                del counts[key]

    def _adopt_fence(self, fence: int) -> bool:
        """A frame from a higher partition era than our local
        transition count reached — we are the node that was dead, or we
        joined late and missed transitions.  Adopt the era (same member
        view, re-stamped) so fences converge to the cluster max with
        zero coordination frames; our own lower-era frames were dropped
        by the peers and re-send under the adopted era."""
        if fence <= self.fence:
            return False
        self.fence = fence
        # The adopted era was minted by a peer's remap — usually for a
        # membership transition WE have not processed yet.  Our own
        # remap for that transition must not bump past it, or every
        # membership change costs the cluster two era resets instead
        # of one (see _remap_partitions).
        self._fence_adopted = True
        if self.pmap is not None:
            self.pmap = PartitionMap(
                self.pmap.members, self.num_partitions, fence, self._me,
                cache=self.pmap._pcache,
            )
            g = self._graph()
            g.set_partition_map(self.pmap)
            # Peers route this era's facts by its member view, which we
            # may not hold yet: deltas for partitions we gain at our own
            # remap can fold before it.  So the absorb's reset happens
            # now, on every slice we do not own (mirror state only, or a
            # slice we owned in an earlier era), and the remap skips it:
            # the reference resets at the remap and wipes those facts
            # (uigc_tpu/engines/crgc/distributed.py:795-799), a lost
            # release leaking its target, a lost create collecting it.
            me, pmap = self._me, self.pmap
            g.reset_partition({p for p in range(self.num_partitions)
                               if pmap.owner(p) != me})
            if self.tree is None:
                self.tree = ReductionTree(self.pmap.members)
        self._reset_wave_plane()
        self._graph_dirty = True
        self._fold_ready_journals()
        return True

    def _remap_partitions(self) -> None:
        members = sorted([self._me] + list(self.remote_gcs))
        old = self.pmap
        if old is not None and old.members == members:
            return
        adopted = self._fence_adopted
        if old is not None and not adopted:
            self.fence = max(self.fence + 1, self._cluster_fence())
        else:
            # First map, or an adopted era already covers this
            # transition (the peer that minted it had processed it).
            self.fence = max(self.fence, self._cluster_fence())
        self._fence_adopted = False
        self.pmap = PartitionMap(
            members, self.num_partitions, self.fence, self._me,
            cache=old._pcache if old is not None else None,
        )
        self.tree = ReductionTree(members)
        g = self._graph()
        g.set_partition_map(self.pmap)
        # New era: abort the in-flight wave (its marks were computed
        # against the old ownership and member set) and restart the
        # wave numbering — see _reset_wave_plane.
        self._reset_wave_plane()
        self._graph_dirty = True
        if old is None:
            return
        moved = self.pmap.moved_partitions(old)
        if not moved:
            return
        gained = [p for p in moved if self.pmap.owner(p) == self._me]
        if gained:
            # Absorb: reset the gained slices in place, then re-fold
            # this node's own journal; the surviving peers re-send
            # theirs below (each under the bumped fence).  In an
            # adopted era the slices were reset at the adoption
            # (_adopt_fence), and what folded into them since is the
            # new era's own routed facts, which no journal repeats:
            # only the folded undo logs are applied to them anew.
            if adopted:
                gset = set(gained)
                pmap = self.pmap
                g.reset_undo_slice(
                    lambda cell: pmap.partition_of(cell_key(cell)) in gset)
            else:
                g.reset_partition(set(gained))
            for p in gained:
                journal = self._retained.get(p)
                if journal is not None and journal.non_empty():
                    g.merge_delta(journal)
                    events.recorder.commit(
                        events.DIST_REFOLD,
                        partition=p,
                        shadows=journal.size,
                        node=self._me,
                        fence=self.fence,
                    )
        for p in moved:
            owner = self.pmap.owner(p)
            if owner is None or owner == self._me:
                continue
            journal = self._retained.get(p)
            if journal is not None and journal.non_empty():
                fabric = self.engine.system.fabric
                send = getattr(fabric, "send_frame", None)
                if send is not None:
                    send(
                        owner,
                        wire.encode_djournal(
                            self.fence, p, journal.serialize(wire.encode_cell)
                        ),
                    )
                else:
                    gc = self.remote_gcs.get(owner)
                    if gc is not None:
                        fabric.control_send(
                            self.engine.system,
                            gc,
                            DJournal(self.fence, p, journal),
                        )
        # Fold journals that arrived ahead of our own fence bump.
        self._fold_ready_journals()

    # -- message dispatch -------------------------------------------- #

    def on_message(self, msg: Any) -> Any:
        if isinstance(msg, DDelta):
            key = (msg.graph.address, msg.fence)
            if msg.index == self._cut_recv.get(key, 0):
                self._cut_recv[key] = msg.index + 1
            # else a gap: an earlier delta of the link was lost, and the
            # count stays short of every later marker (module note)
            self._accept_delta(msg.graph, msg.fence, msg.cut)
            self._recheck_cut(msg.graph.address)
        elif isinstance(msg, DCut):
            self._on_dcut(msg)
        elif isinstance(msg, DWave):
            self._on_dwave(msg)
        elif isinstance(msg, DMark):
            self._on_dmark(msg)
        elif isinstance(msg, DMack):
            self._on_dmack(msg)
        elif isinstance(msg, DProbe):
            self._on_dprobe(msg)
        elif isinstance(msg, DStat):
            self._on_dstat(msg)
        elif isinstance(msg, DFin):
            self._on_dfin(msg)
        elif isinstance(msg, DGate):
            self._on_dgate(msg)
        elif isinstance(msg, DGack):
            self._on_dgack(msg)
        elif isinstance(msg, DDirty):
            self._dirty_hint = True
            # Event-driven wave start: the root opens the wave the
            # moment the hint lands instead of on its next timer wake.
            self._maybe_begin_wave()
        elif isinstance(msg, DJournal):
            self._on_djournal(msg)
        else:
            return super().on_message(msg)
        return None

    # -- fold routing ------------------------------------------------ #

    def _scrub_strayed_keys(self) -> None:
        """A delta routed under an older partition map can land after a
        remap: its content keys are no longer owned here, which is a
        sender-side race (the facts re-ship to the new owner via the
        retained journal), not a fold-locality bug.  Drop those keys
        from the audit window so crgc.dist_locality_violation keeps its
        'always a bug' meaning — every non-delta fold path (and any
        direct merge_delta outside this router) keeps the full audit."""
        g = self._graph()
        pmap = self.pmap
        if pmap is None:
            return
        touched = g.fold_touched
        for key in [k for k in touched if not pmap.owns(k)]:
            touched.discard(key)

    def handle_delta(self, graph: DeltaGraph) -> None:
        """An unstamped delta: folded past a running wave (the
        reference's rule for every delta)."""
        cut = self.ws.wave if self.ws is not None else self._last_wave_done
        self._accept_delta(graph, self.fence, cut)

    def _accept_delta(self, graph: DeltaGraph, fence: int, cut: int) -> None:
        """Fold a peer's routed delta into the waves above its cut.

        The reference deferred every delta that arrived during a wave.
        But one entry's effects are routed to several owners: the
        sender folds the half it owns at once (when it is between
        waves), while the half it ships can reach an owner that already
        entered the next wave, and wait there until that wave is swept.
        The wave then traces a cut in which, say, a new actor is
        interned and its receive balance settled at its own owner, while
        the created edge that keeps it alive is still pending at its
        creator's owner: the actor is unmarked and its kill is gated
        through.  The stamp closes the gap: a delta cut below the
        running wave folds into it now; later ones wait."""
        if graph.address not in self.remote_gcs:
            return
        # The undo accounting must see every peer delta immediately
        # (it reverts the SENDER's unadmitted claims at its death).
        self.undo_logs[graph.address].merge_delta_graph(graph)
        ws = self.ws
        if self.pmap is None or fence > self.fence:
            self._pending_deltas.append((graph, fence, cut))
        elif ws is not None:
            if fence < self.fence or cut < ws.wave:
                self._fold_into_wave(ws, graph)
            else:
                self._pending_deltas.append((graph, fence, cut))
        elif fence < self.fence or cut <= self._last_wave_done:
            with events.recorder.timed(events.MERGING_DELTA_GRAPHS):
                self._graph().merge_delta(graph)
            self._scrub_strayed_keys()
            self._graph_dirty = True
        else:
            self._pending_deltas.append((graph, fence, cut))

    def _fold_into_wave(self, ws: "_WaveState", graph: DeltaGraph) -> None:
        """Fold a delta into the running wave.  Marks only grow: the
        seeding pass runs again (new pseudoroots), every marked shadow
        the delta names pushes again (its new edges and supervisor), and
        the round is flagged changed so termination waits for it."""
        g = self._graph()
        with events.recorder.timed(events.MERGING_DELTA_GRAPHS):
            g.merge_delta(graph)
        self._scrub_strayed_keys()
        self._graph_dirty = True
        ws.seeded = False
        for cell in graph.decoder():
            shadow = g.shadow_map.get(cell)
            if shadow is not None and shadow in ws.marked and self._owned(shadow):
                ws.queue.append(shadow)
        ws.changed = True
        self._pump(ws)

    def _on_djournal(self, msg: DJournal) -> None:
        """Deliberately does NOT adopt a higher fence here: a journal
        can outrun our own MemberRemoved, and adopting would make
        _fold_ready_journals judge its ownership against the STALE
        member view (and drop it).  Pending until our remap catches up
        keeps the fold correct in both orders."""
        if msg.fence < self.fence:
            return  # a stale era's absorb — superseded
        self._pending_journals.append(msg)
        self._fold_ready_journals()

    def _fold_ready_journals(self) -> None:
        if self.ws is not None:
            return
        keep: List[DJournal] = []
        for j in self._pending_journals:
            if j.fence > self.fence or (
                j.fence == self.fence and self._fence_adopted
            ):
                # Our membership view hasn't caught up.  An ADOPTED era
                # re-stamps the member view of before its transition,
                # so ownership judged now would be the old era's: a
                # journal for a partition we gain at our own remap
                # would be dropped and its facts lost (a leak).
                keep.append(j)
            elif j.fence == self.fence and self.pmap is not None:
                if self.pmap.owner(j.partition) == self._me:
                    with events.recorder.timed(events.MERGING_DELTA_GRAPHS):
                        self._graph().merge_delta(j.graph)
                    self._scrub_strayed_keys()
                    events.recorder.commit(
                        events.DIST_REFOLD,
                        partition=j.partition,
                        shadows=j.graph.size,
                        node=self._me,
                        fence=self.fence,
                    )
                    self._graph_dirty = True
            # stale fence or not-owned: drop (leak-safe; the sender
            # re-ships under the next fence if ownership says so)
        self._pending_journals = keep

    def _builder(self, owner: str) -> DeltaGraph:
        b = self._builders.get(owner)
        if b is None:
            b = DeltaGraph(self._me, self.engine.crgc_context)
            self._builders[owner] = b
        return b

    def _retained_for(self, partition: int) -> DeltaGraph:
        j = self._retained.get(partition)
        if j is None:
            j = DeltaGraph(self._me, self.engine.crgc_context)
            self._retained[partition] = j
        return j

    def _sinks(self, cell) -> Tuple[DeltaGraph, DeltaGraph]:
        """(owner builder, retained journal) for one affected actor."""
        key = cell_key(cell)
        p = self.pmap.partition_of(key)
        owner = self.pmap.owner(p) or self._me
        return self._builder(owner), self._retained_for(p)

    def _route_entry(self, entry: Any) -> None:
        """Split one mutator snapshot's effects per affected actor's
        owner — the partitioned replacement for folding the whole entry
        into a local replica."""
        from . import refob as refob_info

        self_cell = entry.self_ref.target
        for sink in self._sinks(self_cell):
            sink.fold_self(
                self_cell, entry.recv_count, entry.is_busy, entry.is_root
            )
        field_size = self.engine.crgc_context.entry_field_size
        for i in range(field_size):
            owner_ref = entry.created_owners[i]
            if owner_ref is None:
                break
            owner_cell = owner_ref.target
            target_cell = entry.created_targets[i].target
            for sink in self._sinks(owner_cell):
                sink.fold_created(owner_cell, target_cell)
            for sink in self._sinks(target_cell):
                sink.touch(target_cell)
        for i in range(field_size):
            child = entry.spawned_actors[i]
            if child is None:
                break
            child_cell = child.target
            for sink in self._sinks(child_cell):
                sink.fold_spawned(child_cell, self_cell)
        for i in range(field_size):
            target = entry.updated_refs[i]
            if target is None:
                break
            target_cell = target.target
            info = entry.updated_infos[i]
            send_count = refob_info.count(info)
            if send_count > 0:
                for sink in self._sinks(target_cell):
                    sink.fold_sends(target_cell, send_count)
            if not refob_info.is_active(info):
                for sink in self._sinks(self_cell):
                    sink.fold_deactivate(self_cell, target_cell)

    def _flush_builders(self) -> None:
        fabric = self.engine.system.fabric
        for owner, delta in self._builders.items():
            if not delta.non_empty():
                continue
            if owner == self._me:
                if self.ws is not None:
                    self._pending_deltas.append((delta, self.fence, self.ws.wave))
                else:
                    with events.recorder.timed(events.MERGING_DELTA_GRAPHS):
                        self._graph().merge_delta(delta)
                    self._scrub_strayed_keys()
                    self._graph_dirty = True
                continue
            gc = self.remote_gcs.get(owner)
            if gc is not None:
                cut = self.ws.wave if self.ws is not None else self._last_wave_done
                key = (owner, self.fence)
                index = self._cut_sent.get(key, 0)
                fabric.control_send(
                    self.engine.system,
                    gc,
                    DDelta(self.delta_graph_id, delta, self.fence, cut, index),
                )
                self.delta_graph_id += 1
                self._cut_sent[key] = index + 1
        self._builders = {}

    def _fold_pending(self, upto: Optional[int] = None) -> None:
        """Fold everything a wave deferred (peer deltas, undo logs,
        absorb journals) — only between waves, so each wave's trace is
        a consistent snapshot.  A deferred delta folds once the wave
        about to run (``upto``; by default the one after the last
        finished) is above its cut."""
        if self.ws is not None:
            return
        if upto is None:
            upto = self._last_wave_done + 1
        if self._pending_deltas:
            g = self._graph()
            keep = []
            with events.recorder.timed(events.MERGING_DELTA_GRAPHS):
                for delta, fence, cut in self._pending_deltas:
                    if self.pmap is None or fence > self.fence or (
                        fence == self.fence and cut >= upto
                    ):
                        keep.append((delta, fence, cut))
                    else:
                        g.merge_delta(delta)
            if len(keep) < len(self._pending_deltas):
                self._scrub_strayed_keys()
                self._graph_dirty = True
            self._pending_deltas = keep
        if self._pending_undo:
            g = self._graph()
            for log in self._pending_undo:
                g.merge_undo_log(log)
            self._pending_undo = []
            self._graph_dirty = True
        self._fold_ready_journals()

    def _maybe_fold_undo_log(self, addr: str) -> None:
        """Same exactly-once quorum as the base collector, but the fold
        defers past an active wave and never runs its own trace — the
        wave machinery re-derives verdicts from the folded state."""
        if addr in self.undone_gcs:
            return
        log = self.undo_logs.get(addr)
        if log is None:
            return
        my_addr = self._me
        if my_addr in log.finalized_by and all(
            peer in log.finalized_by for peer in self.remote_gcs
        ):
            self.undone_gcs.add(addr)
            events.recorder.commit(
                events.UNDO_FOLD, address=addr, node=my_addr, **log.summary()
            )
            self._pending_undo.append(log)
            self._graph_dirty = True
            if self.ws is None:
                self._fold_pending()

    # -- the collector wake ------------------------------------------ #

    def _collect_inner(self, wake: Any) -> tuple:
        engine = self.engine
        queue = engine.queue
        pool = engine.entry_pool
        count = 0
        with events.recorder.timed(events.PROCESSING_ENTRIES) as ev:
            with _phase(wake, "ingest"):
                batch = []
                while True:
                    try:
                        entry = queue.popleft()
                    except IndexError:
                        break
                    count += 1
                    batch.append(entry)
            with _phase(wake, "fold"):
                if batch and self.pmap is not None:
                    for entry in batch:
                        self._route_entry(entry)
                    for entry in batch:
                        entry.clean()
                        pool.append(entry)
                elif batch:
                    # Membership not yet complete: push back and retry
                    # next wake (GC is gated on full membership anyway).
                    for entry in reversed(batch):
                        queue.appendleft(entry)
                    count = 0
            with _phase(wake, "broadcast"):
                self._flush_builders()
            ev.fields["num_entries"] = count
        self.total_entries += count
        if count:
            self._graph_dirty = True
        with _phase(wake, "trace"):
            n_garbage = self._wave_step()
        return count, n_garbage

    # -- wave machinery ---------------------------------------------- #

    def _is_root(self) -> bool:
        return self.tree is not None and self.tree.root == self._me

    def _gates_pending(self) -> bool:
        for peer, lst in self._gates_out.items():
            if self._gates_acked.get(peer, 0) < len(lst):
                return True
        return False

    def _wave_step(self) -> int:
        """The per-wake driver.  Since the pipelined rework this is the
        RETRANSMIT / healing plane: marks, acks, probes and reports all
        fire event-driven as frames arrive (:meth:`_pump`), so a
        healthy wave converges at message latency; the wake re-drives
        whatever a dropped frame stalled."""
        if self.pmap is None or not self.started:
            return 0
        n_garbage = 0
        if self.ws is None:
            self._fold_pending()
            self._resend_gates()
            self._maybe_begin_wave()
            self._graph().decay_mirrors(self.mirror_decay)
        ws = self.ws
        if ws is not None:
            self._fixpoint(ws)
            self._send_dmarks(ws, retransmit=True)
            self._send_cut_marks(ws)
            if self._is_root():
                # Keep late joiners / dropped dwave frames in the wave
                # (the round stamp rides along — dprobe's fallback).
                for peer in self.remote_gcs:
                    self._send_dist(
                        peer,
                        wire.encode_dwave(
                            ws.wave, ws.fence, self._me, ws.probe_round
                        ),
                        DWave(ws.wave, ws.fence, self._me, ws.probe_round),
                    )
                self._root_termination(ws)
            self._flush_stat_report(ws)
            if not ws.fin and not self._is_root():
                # Fin-loss healing: a settled, reported, change-free
                # node that hears nothing for a few wakes re-reports
                # its aggregate unsolicited; an ancestor that already
                # completed this wave re-serves the dfin (see
                # _on_dstat), so a dropped dfin can only delay a sweep.
                if ws.settled() and ws.reported_round > 0 and not ws.queue:
                    ws.idle += 1
                    if ws.idle >= 3:
                        ws.idle = 0
                        ws.reported_round = ws.probe_round_seen - 1
                        self._flush_stat_report(ws)
                else:
                    ws.idle = 0
            if ws.fin:
                n_garbage = self._sweep(ws)
        return n_garbage

    def _maybe_begin_wave(self) -> None:
        """Start (root) or solicit (non-root) a wave when dirty work is
        waiting and none is in flight."""
        if self.ws is not None or self.pmap is None or not self.started:
            return
        if self._is_root():
            if self._graph_dirty or self._dirty_hint or self._gates_pending():
                self._start_wave()
                ws = self.ws
                if ws is not None:
                    self._pump(ws)
        elif self._graph_dirty or self._gates_pending():
            root = self.tree.root
            if root is not None and root != self._me:
                self._send_dist(
                    root, wire.encode_ddirty(self._me), DDirty(self._me)
                )

    def _pump(self, ws: _WaveState) -> None:
        """One event-driven propagation step: drain the local fixpoint,
        flush fresh boundary marks, push the termination machinery.
        Called from every protocol-frame handler, so mark propagation
        crosses the cluster at message latency instead of one hop per
        collector wake — the latency collapse that lets the partitioned
        trace outrun the replicated fold."""
        self._fixpoint(ws)
        self._send_dmarks(ws)
        self._finish_pump(ws)

    def _start_wave(self) -> None:
        self._fold_pending(upto=self.wave + 1)
        self.wave += 1
        self._dirty_hint = False
        self._graph_dirty = False
        self.ws = _WaveState(self.wave, self.fence)
        for peer in self.remote_gcs:
            self._send_dist(
                peer,
                wire.encode_dwave(self.wave, self.fence, self._me),
                DWave(self.wave, self.fence, self._me),
            )
        self._open_cut(self.ws)

    def _enter_wave(self, wave: int, fence: int) -> bool:
        """Adopt a wave the root (or a peer's dmark racing the dwave)
        announced.  A HIGHER fence is adopted first (our membership
        view lags — see _adopt_fence); frames from an older era are
        ignored — the sender re-ships once its view converges."""
        if self.pmap is None:
            # Join race: a peer whose membership completed first can
            # open a wave before our partition map exists.  Refuse the
            # wave (no state to trace against, and the mark handlers
            # consult the map); the sender's wake-driven retransmits
            # re-deliver once our remap lands.
            return False
        if fence > self.fence:
            self._adopt_fence(fence)
        if fence != self.fence:
            return False
        if wave <= self._last_wave_done:
            return False
        ws = self.ws
        if ws is not None:
            if ws.wave == wave:
                return True
            if ws.wave > wave:
                return False
            self.ws = None  # a newer wave supersedes; re-derive
        self._fold_pending(upto=wave)
        self.wave = max(self.wave, wave)
        self._graph_dirty = False
        self.ws = _WaveState(wave, fence)
        self._open_cut(self.ws)
        return True

    # -- the per-link cut (module note) ------------------------------- #

    def _open_cut(self, ws: _WaveState) -> None:
        """On entering a wave: number the wave state, mark every link,
        then list the peers whose own marks this node still waits for."""
        self._wave_entries += 1
        ws.entry = self._wave_entries
        self._send_cut_marks(ws)
        for peer in self.pmap.members:
            if peer != self._me and self._cut_open(ws, peer):
                ws.cut_open.add(peer)

    def _send_cut_marks(self, ws: _WaveState) -> None:
        """Mark every link with the wave and the stamped deltas routed
        on it so far.  Re-sent on every wake of the wave (a lost marker
        only delays it): each marker follows the deltas it counts on
        its link."""
        for peer in self.pmap.members:
            if peer == self._me:
                continue
            count = self._cut_sent.get((peer, ws.fence), 0)
            self._send_dist(
                peer,
                wire.encode_dcut(ws.wave, ws.fence, self._me, count, ws.entry),
                DCut(ws.wave, ws.fence, self._me, count, ws.entry),
            )

    def _cut_open(self, ws: _WaveState, peer: str) -> bool:
        """Does ``ws`` still wait for ``peer``'s side of the cut: its
        marker for this wave (or a later one) of this era, and every
        stamped delta the marker counts?"""
        mark = self._cut_marks.get(peer)
        if mark is None or mark[0] != ws.fence or mark[1] < ws.wave:
            return True
        return self._cut_recv.get((peer, ws.fence), 0) < mark[2]

    def _recheck_cut(self, peer: str) -> None:
        ws = self.ws
        if ws is None or peer not in ws.cut_open:
            return
        if not self._cut_open(ws, peer):
            ws.cut_open.discard(peer)
            if not ws.cut_open:
                self._pump(ws)

    def _on_dcut(self, msg: DCut) -> None:
        mark = self._cut_marks.get(msg.origin)
        if mark is None or (msg.fence, msg.wave, msg.count) > mark:
            self._cut_marks[msg.origin] = (msg.fence, msg.wave, msg.count)
        seen = self._cut_entry.get(msg.origin)
        self._cut_entry[msg.origin] = (msg.fence, msg.wave, msg.entry)
        ws = self.ws
        if (
            seen is not None
            and seen[:2] == (msg.fence, msg.wave)
            and seen[2] != msg.entry
            and ws is not None
            and (ws.fence, ws.wave) == (msg.fence, msg.wave)
        ):
            self._restart_link(ws, msg.origin)
        self._recheck_cut(msg.origin)

    def _restart_link(self, ws: _WaveState, peer: str) -> None:
        """``peer`` restarted this wave in place: its remap aborted the
        wave it had entered in an era adopted from a peer (under the
        member view of before the era's transition), and the root's
        retransmits brought it back into the same wave id with fresh
        counters.  The reference has no such signal: the marks the
        aborted state had acknowledged are never re-sent, the peer's
        fresh receive count never reaches our send count, and no round
        of the era is ever quiet (``uigc_tpu/engines/crgc/distributed.py
        :765-787`` resets the wave plane at a remap that adopted its
        fence).  So restart this link's side of the wave too: re-send our
        marks from the start and count the peer's from the start.  Marks
        it relayed before the restart stay (marks only grow)."""
        ws.acked.pop(peer, None)
        ws.sent_upto.pop(peer, None)
        ws.recv_upto.pop(peer, None)
        ws.recv_ahead.pop(peer, None)
        ws.changed = True
        self._send_dmarks(ws)

    def _owned(self, shadow) -> bool:
        # Through the graph's per-shadow partition memo: this runs
        # O(V+E) times per wave and a blake2b per call dominates the
        # trace otherwise.
        return self._graph().owns_shadow(shadow)

    def _fixpoint(self, ws: _WaveState) -> None:
        """Drain the wave's propagation queue: local push over owned
        slots.  Marks crossing a partition boundary never enter the
        queue — they are propagation-blocked straight into the
        per-owner mark buffer at push time (``_relay_mark``), so each
        drain costs one buffer append per boundary edge and the flush
        is O(owners) frames, not O(pending batches)."""
        g = self._graph()
        if not ws.seeded:
            ws.seeded = True
            marked, queue = ws.marked, ws.queue
            for shadow in g.from_set:
                if (
                    self._owned(shadow)
                    and g.is_pseudo_root(shadow)
                    and shadow not in marked
                ):
                    marked.add(shadow)
                    queue.append(shadow)
        queue = ws.queue
        if not queue:
            return
        marked = ws.marked
        owned = self._owned
        relay = self._relay_mark
        progressed = False
        while queue:
            shadow = queue.pop()
            progressed = True
            if shadow.is_halted:
                continue
            for target, count in shadow.outgoing.items():
                if count > 0 and target not in marked:
                    if owned(target):
                        marked.add(target)
                        queue.append(target)
                    else:
                        relay(ws, target)
            sup = shadow.supervisor
            if sup is not None and sup not in marked:
                if owned(sup):
                    marked.add(sup)
                    queue.append(sup)
                else:
                    relay(ws, sup)
        if progressed:
            ws.changed = True

    def _relay_mark(self, ws: _WaveState, shadow: Any) -> None:
        """A mark reached a mirror: buffer its key for the owner (dedup
        per wave), never propagate through non-authoritative state."""
        self._relay_key(ws, cell_key(shadow.self_cell))

    def _relay_key(self, ws: _WaveState, key: Tuple[str, int]) -> None:
        owner = self.pmap.owner_of(key)
        if owner is None or owner == self._me:
            return
        s = ws.out_sets.setdefault(owner, set())
        if key not in s:
            s.add(key)
            ws.out_marks.setdefault(owner, []).append(key)

    def _keyset_capable(self, peer: str) -> bool:
        """Can ``peer`` decode the binary key-set payload?  NodeFabric
        peers advertise SCHEMA_DIST_KEYS through the schema-codec hello
        caps; the in-process fabric is the same build by
        construction.  A legacy peer gets the JSON shape."""
        fabric = self.engine.system.fabric
        ids_fn = getattr(fabric, "peer_schema_ids", None)
        if ids_fn is None:
            return True
        from ...runtime import schema as wire_schema

        return wire_schema.SCHEMA_DIST_KEYS in ids_fn(peer)

    def _round_stamp(self, ws: _WaveState) -> int:
        return ws.probe_round if self._is_root() else ws.probe_round_seen

    def _send_dmarks(self, ws: _WaveState, retransmit: bool = False) -> None:
        """Flush boundary marks, one frame per owner.  Schema-capable
        peers get the suffix protocol: each flush carries only the keys
        past the flush watermark, binary-encoded; the per-wake
        ``retransmit`` pass re-covers the span past the peer's ACK
        watermark, so drops, dups and reorders all degrade to a
        retransmit of an idempotent, position-addressed set union.
        Legacy peers get the old full-cumulative JSON frame."""
        for peer, lst in ws.out_marks.items():
            total = len(lst)
            acked = ws.acked.get(peer, 0)
            upto = ws.sent_upto.get(peer, 0)
            if self._keyset_capable(peer):
                start = upto
                if retransmit and acked < upto:
                    start = acked
                if start >= total:
                    continue
                chunk = lst[start:]
                frame = wire.encode_dmark(
                    ws.wave, ws.fence, self._me, chunk,
                    start=start, binary=True,
                    round_id=self._round_stamp(ws),
                )
                msg = DMark(
                    ws.wave, ws.fence, self._me, list(chunk),
                    start, self._round_stamp(ws),
                )
            else:
                if acked >= total:
                    continue
                if not retransmit and upto >= total:
                    continue
                chunk = lst
                frame = wire.encode_dmark(
                    ws.wave, ws.fence, self._me, lst, binary=False
                )
                msg = DMark(ws.wave, ws.fence, self._me, list(lst))
            self._send_dist(peer, frame, msg)
            ws.sent_upto[peer] = total
            self.marks_sent += len(chunk)
            self.mark_bytes += len(frame[4])
            events.recorder.commit(
                events.DIST_MARKS,
                count=len(chunk),
                bytes=len(frame[4]),
                dst=peer,
                node=self._me,
            )

    def _note_round(self, ws: _WaveState, round_id: int) -> None:
        """Epidemic round dissemination: every dwave/dmark/dmack frame
        carries the sender's known termination round, so non-roots
        learn the round from the data plane and explicit dprobe frames
        become the drop-healing fallback."""
        if round_id and not self._is_root() and round_id > ws.probe_round_seen:
            ws.probe_round_seen = round_id

    def _on_dwave(self, msg: DWave) -> None:
        if not self._enter_wave(msg.wave, msg.fence):
            return
        ws = self.ws
        if ws is None or ws.wave != msg.wave:
            return
        self._note_round(ws, msg.round_id)
        self._pump(ws)

    def _on_dmark(self, msg: DMark) -> None:
        if not self._enter_wave(msg.wave, msg.fence):
            return
        ws = self.ws
        if ws is None or ws.wave != msg.wave:
            return
        self._note_round(ws, msg.round_id)
        g = self._graph()
        up = ws.recv_upto.get(msg.origin, 0)
        ahead = ws.recv_ahead.setdefault(msg.origin, set())
        # Seed EVERY key in the frame (idempotent via ws.marked):
        # positions below track coverage of the sender's mark list as
        # SPANS only — the binary codec re-orders keys inside a frame
        # (address-grouped, uid-sorted), so per-position key identity
        # is not stable across differently-bounded retransmits, and
        # skipping "already covered" positions key-by-key could drop a
        # mark whose position was covered by a frame that carried a
        # DIFFERENT key there.  A frame's key set is exactly the
        # sender's list[start:start+n] as a set, so span coverage <=>
        # every one of those keys delivered, in any order.
        for key in msg.keys:
            k = (key[0], int(key[1]))
            if not self.pmap.owns(k):
                # Misrouted mark: the sender's partition map disagrees
                # with ours (the _adopt_fence window re-stamps a stale
                # member view at the adopted fence, so two maps can
                # share a fence with divergent ownership).  Forward by
                # OUR map instead of consuming through a mirror — the
                # relay converges as the views do, and a live actor's
                # mark can never be silently absorbed short of its
                # true owner.
                self._relay_key(ws, k)
                continue
            shadow = g.shadow_for_key(k)
            if shadow is not None and shadow not in ws.marked:
                ws.marked.add(shadow)
                ws.queue.append(shadow)
        new = 0
        for pos in range(msg.start, msg.start + len(msg.keys)):
            if pos < up or pos in ahead:
                continue
            ahead.add(pos)
            new += 1
        while up in ahead:
            ahead.discard(up)
            up += 1
        ws.recv_upto[msg.origin] = up
        if new:
            ws.changed = True
            self.marks_received += new
        # Propagate BEFORE acking: the fixpoint drains synchronously,
        # so the ack's piggybacked report (and the termination stats it
        # reflects) already cover the seeds this frame delivered.
        self._fixpoint(ws)
        self._send_dmarks(ws)
        # Always ack with the contiguous watermark — a duplicate
        # frame's ack heals a lost earlier ack.
        rid, report = self._piggyback_report(ws, msg.origin)
        self._send_dist(
            msg.origin,
            wire.encode_dmack(
                ws.wave, self._me, up, self.fence, rid, report
            ),
            DMack(ws.wave, self._me, up, self.fence, rid, report),
        )
        self._finish_pump(ws)

    def _on_dmack(self, msg: DMack) -> None:
        if msg.fence != self.fence:
            self._adopt_fence(msg.fence)
            return  # old era's ack (or we just reset): nothing to count
        ws = self.ws
        if ws is None or ws.wave != msg.wave:
            return
        self._note_round(ws, msg.round_id)
        prev = ws.acked.get(msg.origin, 0)
        if msg.count > prev:
            ws.acked[msg.origin] = msg.count
        if (
            msg.report is not None
            and msg.round_id > 0
            and self.tree is not None
            and msg.origin in self.tree.children(self._me)
            and not self.tree.children(msg.origin)
        ):
            # A leaf child's termination report rode the ack.
            settled, changed, sent, recv, nodes = msg.report
            ws.child_stats.setdefault(msg.round_id, {})[msg.origin] = {
                "settled": bool(settled),
                "changed": bool(changed),
                "sent": sent,
                "recv": recv,
                "nodes": nodes,
            }
        self._pump(ws)

    def _piggyback_report(self, ws: _WaveState, peer: str):
        """(round stamp, report-or-None) for an outgoing dmack: a LEAF
        whose parent is the ack's destination attaches its settled
        report for the current round, so the common termination path
        needs no explicit dstat frame at all."""
        rid = self._round_stamp(ws)
        if (
            self.tree is None
            or self._is_root()
            or peer != self.tree.parent(self._me)
            or self.tree.children(self._me)
            or rid <= ws.reported_round
            or not ws.settled()
        ):
            return rid, None
        agg = self._own_stats(ws)
        ws.reported_round = rid
        return rid, (
            int(agg["settled"]), int(agg["changed"]),
            agg["sent"], agg["recv"], agg["nodes"],
        )

    # -- termination (Safra over the reduction tree) ----------------- #

    def _finish_pump(self, ws: _WaveState) -> None:
        """Termination tail of one pump: judge/report, and when the
        wave finished, sweep NOW (not on the next timer wake) and chain
        straight into the next wave if dirty work is already waiting —
        the pipelining that removes every wake-interval barrier from
        the wave lifecycle."""
        if self._is_root():
            self._root_termination(ws)
        else:
            self._flush_stat_report(ws)
        if ws.fin and self.ws is ws:
            n_garbage = self._sweep(ws)
            self._after_wake(n_garbage)
            self._chain_after_sweep()

    def _chain_after_sweep(self) -> None:
        # Re-entrancy latch: a chained wave that somehow finishes
        # synchronously (single-member trees) must not recurse through
        # sweep->begin->sweep — the timer wake picks the tail up.
        if self._chain_guard:
            return
        self._chain_guard = True
        try:
            self._maybe_begin_wave()
        finally:
            self._chain_guard = False

    def _own_stats(self, ws: _WaveState) -> dict:
        stats = {
            "settled": ws.settled(),
            "changed": ws.changed,
            "sent": ws.sent_total(),
            "recv": ws.recv_total(),
            "nodes": 1,
        }
        ws.changed = False
        return stats

    @staticmethod
    def _merge_stats(agg: dict, stats: dict) -> None:
        agg["settled"] = agg["settled"] and bool(stats.get("settled"))
        agg["changed"] = agg["changed"] or bool(stats.get("changed"))
        agg["sent"] += int(stats.get("sent", 0))
        agg["recv"] += int(stats.get("recv", 0))
        agg["nodes"] += int(stats.get("nodes", 1))

    def _on_dprobe(self, msg: DProbe) -> None:
        if not self._enter_wave(msg.wave, msg.fence):
            return
        ws = self.ws
        if ws is None or ws.wave != msg.wave:
            return
        if msg.round_id > ws.probe_round_seen:
            ws.probe_round_seen = msg.round_id
        for child in self.tree.children(self._me):
            self._send_dist(
                child,
                wire.encode_dprobe(msg.wave, msg.round_id, self._me, self.fence),
                DProbe(msg.wave, msg.round_id, self._me, self.fence),
            )
        self._pump(ws)

    def _on_dstat(self, msg: DStat) -> None:
        if msg.fence != self.fence:
            self._adopt_fence(msg.fence)
            return  # another era's rounds never merge into this one's
        ws = self.ws
        if ws is None or ws.wave != msg.wave:
            if (
                (ws is None or ws.wave > msg.wave)
                and msg.wave <= self._last_wave_done
            ):
                # A straggler still in a wave we completed: its dfin
                # was lost — re-serve it point-to-point.
                self._send_dist(
                    msg.origin,
                    wire.encode_dfin(msg.wave, self.fence, self._me),
                    DFin(msg.wave, self.fence, self._me),
                )
            return
        ws.child_stats.setdefault(msg.round_id, {})[msg.origin] = msg.stats
        self._pump(ws)

    def _flush_stat_report(self, ws: _WaveState) -> None:
        """Non-root: once LOCALLY SETTLED with every child's aggregate
        for the newest known round in, fold our own stats and push the
        subtree aggregate up the tree.  Settle-gating is what lets the
        root converge in ~2 rounds: a report always describes a locally
        quiescent subtree, so the first judged round after global
        quiescence is already quiet and the second confirms it."""
        if self.tree is None or self._is_root():
            return
        r = ws.probe_round_seen
        if r <= ws.reported_round or not ws.settled():
            return
        children = self.tree.children(self._me)
        got = ws.child_stats.get(r, {})
        if any(c not in got for c in children):
            return
        agg = self._own_stats(ws)
        for c in children:
            self._merge_stats(agg, got[c])
        parent = self.tree.parent(self._me)
        if parent is not None:
            self._send_dist(
                parent,
                wire.encode_dstat(ws.wave, r, self._me, agg, self.fence),
                DStat(ws.wave, r, self._me, agg, self.fence),
            )
        ws.reported_round = r

    def _send_probe(self, ws: _WaveState) -> None:
        for child in self.tree.children(self._me):
            self._send_dist(
                child,
                wire.encode_dprobe(
                    ws.wave, ws.probe_round, self._me, self.fence
                ),
                DProbe(ws.wave, ws.probe_round, self._me, self.fence),
            )

    def _judge_round(self, ws: _WaveState, r: int, agg: dict) -> None:
        """Judge one completed round at the root.  Termination: two
        consecutive judged rounds whose aggregates are all-settled with
        ``sent == recv`` AND an identical (sent, recv) signature.
        Sound by the four-counter argument over idempotent cumulative
        mark sets: during a wave the only sources of new local work are
        received marks (recv grows) and the wave's own seeding, so
        unchanged counters across two all-settled collections mean no
        node did or can do anything between them — global fixpoint."""
        ws.round_done[r] = True
        ws.rounds_run += 1
        self.rounds_total += 1
        events.recorder.commit(
            events.DIST_ROUND,
            wave=ws.wave,
            round=r,
            node=self._me,
            **{k: agg[k] for k in ("settled", "changed", "sent", "recv", "nodes")},
        )
        quiet = (
            agg["settled"]
            and agg["sent"] == agg["recv"]
            and agg["nodes"] == len(self.pmap.members)
        )
        sig = (agg["sent"], agg["recv"])
        # Single-round shortcut, sound ONLY at sent == recv == 0: a
        # settled report means an empty queue, queues grow only by
        # receiving marks, and receiving requires someone to have
        # queued a send — zero global sends at every report time means
        # none can ever occur.  (Nonzero totals genuinely need the
        # second confirming round: a mark can circulate behind the
        # report times and balance the counters by coincidence.)
        if quiet and (sig == (0, 0) or ws.quiet_sig == sig):
            ws.fin = True
            for peer in self.remote_gcs:
                self._send_dist(
                    peer,
                    wire.encode_dfin(ws.wave, ws.fence, self._me),
                    DFin(ws.wave, ws.fence, self._me),
                )
            return
        ws.quiet_sig = sig if quiet else None

    def _root_termination(self, ws: _WaveState) -> None:
        """Event-driven root judge: rounds open when the root itself is
        settled, complete as reports arrive (piggybacked on dmacks or
        explicit dstats), and the next round's probe goes out the
        moment the previous one is judged — round latency is message
        latency, with the per-wake dwave/dprobe re-sends as the
        drop-healing fallback timer."""
        if ws.fin or self.tree is None:
            return
        children = self.tree.children(self._me)
        if ws.probe_round == 0:
            if not ws.settled():
                return
            ws.probe_round = 1
            self._send_probe(ws)
        if not children:
            # Degenerate single-member tree: judge our own stats; the
            # second identical quiet round lands immediately.
            for _ in range(2):
                if ws.fin:
                    break
                r = ws.probe_round
                self._judge_round(ws, r, self._own_stats(ws))
                if not ws.fin:
                    ws.probe_round = r + 1
            return
        while not ws.fin:
            r = ws.probe_round
            got = ws.child_stats.get(r, {})
            if any(c not in got for c in children):
                return  # waiting on reports; the wake re-probe heals
            agg = self._own_stats(ws)
            for c in children:
                self._merge_stats(agg, got[c])
            self._judge_round(ws, r, agg)
            if not ws.fin:
                ws.probe_round = r + 1
                self._send_probe(ws)

    def _on_dfin(self, msg: DFin) -> None:
        if msg.fence > self.fence:
            # Our era lags; adopting resets the wave plane, so there is
            # no wave state left for this fin to close — the sender's
            # next wave (in the adopted era) covers the sweep.
            self._adopt_fence(msg.fence)
            return
        ws = self.ws
        if ws is None or ws.wave != msg.wave or ws.fence != msg.fence:
            return
        ws.fin = True
        # Sweep NOW, not on the next timer wake: the root's next dwave
        # may already be behind this frame in the stream, and entering
        # it would supersede (and silently skip) this wave's sweep.
        n_garbage = self._sweep(ws)
        self._after_wake(n_garbage)
        self._chain_after_sweep()

    # -- sweep ------------------------------------------------------- #

    def _sweep(self, ws: _WaveState) -> int:
        g = self._graph()
        me = self._me
        with events.recorder.timed(events.TRACING) as ev:
            garbage: List[Any] = []
            kills: List[Any] = []
            gates: Dict[str, List] = {}
            num_live = 0
            for shadow in list(g.from_set):
                if not self._owned(shadow):
                    continue
                if shadow in ws.marked:
                    num_live += 1
                    continue
                garbage.append(shadow)
                if shadow.is_halted:
                    continue
                sup = shadow.supervisor
                if sup is None:
                    continue
                if sup in ws.marked:
                    kills.append(shadow.self_cell)
                elif not self._owned(sup):
                    # The supervisor's authoritative mark lives at its
                    # owner: ask it to gate (and dispatch) the kill.
                    owner = self.pmap.owner_of(cell_key(sup.self_cell))
                    if owner is not None and owner != me:
                        gates.setdefault(owner, []).append(
                            (cell_key(sup.self_cell), cell_key(shadow.self_cell))
                        )
            gate_children = set()
            for pairs in gates.values():
                for _sup, child in pairs:
                    gate_children.add(child)
            # Remove decided garbage; keep gate-pending children so the
            # next wave re-derives (and re-gates) them if the decision
            # frame is lost.
            dead = set()
            for shadow in garbage:
                if cell_key(shadow.self_cell) in gate_children:
                    continue
                dead.add(shadow)
                g.drop_shadow(shadow.self_cell)
            # Mirror hygiene: keep only mirrors the surviving owned
            # slice still references.  A negative count references too:
            # a release folded before its create (the create still in
            # an absorb journal on its way) must cancel on the SAME
            # shadow object, or the create lands on a fresh one and
            # pins its target forever (the reference keeps positive
            # counts only, uigc_tpu/engines/crgc/distributed.py:1783).
            referenced = set()
            for shadow in g.from_set:
                if shadow in dead or not self._owned(shadow):
                    continue
                for target, count in shadow.outgoing.items():
                    if count != 0:
                        referenced.add(target)
                sup = shadow.supervisor
                if sup is not None:
                    referenced.add(sup)
            new_from = []
            for shadow in g.from_set:
                if shadow in dead:
                    continue
                if not self._owned(shadow) and shadow not in referenced:
                    g.drop_shadow(shadow.self_cell)
                    continue
                new_from.append(shadow)
            g.from_set = new_from
            # Decayed mirrors follow the same hygiene: once no owned
            # edge references one, its shadow_map pin goes too.
            for cell in [
                c for c, s in g.evicted.items() if s not in referenced
            ]:
                g.evicted.pop(cell, None)
                g.shadow_map.pop(cell, None)
            dispatch_kills(kills)
            # Count only actors actually removed this wave: a
            # gate-pending child stays in the graph for the dgate retry
            # and is re-derived every wave until the decision lands, so
            # counting `garbage` would tally it once per retry.
            n_garbage = len(dead)
            ev.fields["num_garbage_actors"] = n_garbage
            ev.fields["num_gate_pending"] = len(gate_children)
            ev.fields["num_live_actors"] = num_live
        # Locality audit: every content-bearing fold since the last
        # sweep must have landed in our own slice.
        bad = g.audit_fold_locality()
        if bad:
            events.recorder.commit(
                events.DIST_LOCALITY,
                node=me,
                keys=[f"{a}#{u}" for a, u in bad[:8]],
                count=len(bad),
            )
        g.boundary_edge_count()
        # Gates: remembered outside the wave state; unacked gates keep
        # the graph dirty so the next wave retries the decision.
        self._gates_wave = ws.wave
        self._gates_out = gates
        self._gates_acked = {}
        self._resend_gates()
        if gates:
            self._graph_dirty = True
        self._last_marked = {
            cell_key(s.self_cell) for s in ws.marked if self._owned(s)
        }
        san = getattr(self.engine.system, "sanitizer", None)
        if san is not None:
            # Distributed uigcsan: per-node oracles cannot judge a
            # cross-node cycle alone — record this sweep's verdicts for
            # the merged-oracle cross-check
            # (analysis.sanitizer.cross_check_distributed).
            san.note_dist_sweep(
                ws.wave,
                [cell_key(s.self_cell) for s in garbage],
                self._last_marked,
            )
        self._last_wave_done = ws.wave
        self.ws = None
        self.waves_completed += 1
        self.total_dist_garbage += n_garbage
        events.recorder.commit(
            events.DIST_WAVE,
            wave=ws.wave,
            node=me,
            garbage=n_garbage,
            gate_pending=len(gate_children),
            live=num_live,
            rounds=ws.rounds_run,
            marks_sent=ws.sent_total(),
            marks_recv=ws.recv_total(),
            boundary_edges=g.boundary_edges,
        )
        self._fold_pending()
        # With the wave closed and every deferred fold landed, the
        # retained journals can be judged against graph state (a delta
        # cut above this wave still waits: judge next time).
        if not self._pending_deltas:
            self._compact_retained()
        g.decay_mirrors(self.mirror_decay)
        return n_garbage

    def _compact_retained(self) -> None:
        """Amortized prune of the per-partition absorb journals —
        without it they pin every cell the node ever generated a fact
        about, an unbounded leak inside the collector itself.  Dropped:
        facts about provably-dead actors (locally terminated cells, and
        owned keys our own sweep already removed from the graph) and
        zero-information touch residue.  Leak-safe by construction —
        pruning a fact can only make a re-folded actor look MORE alive,
        never less (the same argument the absorb path's 'a dead node's
        facts die with it' rests on).  A journal compacts when it
        doubled since its last compaction, so the cost stays
        proportional to growth.  Must run only with no wave in flight
        and no pending folds: a live owned actor whose facts sit in
        _pending_deltas is not yet in key_index and would be judged
        dead."""
        pmap = self.pmap
        if pmap is None:
            return
        key_index = self._graph().key_index

        def keep(cell: Any, sh: Any) -> bool:
            if getattr(cell, "is_terminated", False):
                return False
            key = cell_key(cell)
            if pmap.owns(key) and key not in key_index:
                return False  # swept out of our own authoritative slice
            if (
                not sh.interned
                and not sh.outgoing
                and sh.recv_count == 0
                and sh.supervisor < 0
                and not sh.is_root
                and not sh.is_busy
            ):
                return False  # pure touch residue; re-created on demand
            return True

        for p, journal in list(self._retained.items()):
            size = journal.size
            if size < 64 or size < 2 * self._retained_floor.get(p, 0):
                continue
            compacted = journal.compact(keep)
            self._retained[p] = compacted
            self._retained_floor[p] = compacted.size

    def _resend_gates(self) -> None:
        for peer, pairs in self._gates_out.items():
            if self._gates_acked.get(peer, 0) >= len(pairs):
                continue
            self._send_dist(
                peer,
                wire.encode_dgate(self._gates_wave, self.fence, self._me, pairs),
                DGate(self._gates_wave, self.fence, self._me, list(pairs)),
            )

    def _on_dgate(self, msg: DGate) -> None:
        """Serve a peer's kill gate from our authoritative marks for
        that wave: a live (marked) supervisor means the child is the
        oldest unmarked ancestor — dispatch its StopMsg from here; an
        unmarked supervisor means our own sweep's cascade covers it.
        Idempotent: re-processed pairs are skipped, the cumulative ack
        heals lost acks."""
        if msg.fence > self.fence:
            # Era lag: adopt (resets our marks) — judging with old-era
            # marks could kill against stale ownership.  The sender's
            # unacked gate keeps its graph dirty; its next wave in the
            # adopted era re-derives and re-gates the decision.
            self._adopt_fence(msg.fence)
            return
        if msg.fence != self.fence:
            return
        marks: Optional[Set[Tuple[str, int]]] = None
        ws = self.ws
        if ws is not None and ws.wave == msg.wave:
            marks = {
                cell_key(s.self_cell) for s in ws.marked if self._owned(s)
            }
        elif self._last_wave_done == msg.wave:
            marks = self._last_marked
        if marks is None:
            return  # can't judge this wave; the sender's next wave retries
        seen = self._gates_seen.setdefault((msg.origin, msg.wave), set())
        kills = []
        for sup_key, child_key in msg.pairs:
            pair = (tuple(sup_key), tuple(child_key))
            if pair in seen:
                continue
            seen.add(pair)
            if pair[0] in marks:
                cell = self._resolve_key(pair[1])
                if cell is not None:
                    kills.append(cell)
        dispatch_kills(kills)
        # Bound the dedup memory: one wave back is all a retry can name.
        for key in [k for k in self._gates_seen if k[1] < msg.wave - 1]:
            del self._gates_seen[key]
        self._send_dist(
            msg.origin,
            wire.encode_dgack(msg.wave, self._me, len(seen), self.fence),
            DGack(msg.wave, self._me, len(seen), self.fence),
        )

    def _on_dgack(self, msg: DGack) -> None:
        if msg.fence != self.fence:
            self._adopt_fence(msg.fence)
            return
        if msg.wave != self._gates_wave:
            return
        prev = self._gates_acked.get(msg.origin, 0)
        if msg.count > prev:
            self._gates_acked[msg.origin] = msg.count

    # -- diagnostics -------------------------------------------------- #

    def diagnostic_dump(self) -> Dict[str, Any]:
        out = super().diagnostic_dump()
        g = self._graph()
        out["distributed"] = {
            "fence": self.fence,
            "wave": self.wave,
            "waves_completed": self.waves_completed,
            "garbage_total": self.total_dist_garbage,
            "marks_sent": self.marks_sent,
            "mark_bytes": self.mark_bytes,
            "marks_received": self.marks_received,
            "rounds_total": self.rounds_total,
            "owned_partitions": (
                self.pmap.owned_partitions() if self.pmap is not None else []
            ),
            "owned_population": g.owned_population(),
            "population": len(g.from_set),
            "boundary_edges": g.boundary_edges,
            "mirrors_evicted": len(g.evicted),
            "mirrors_evicted_total": g.mirrors_evicted_total,
        }
        return out
