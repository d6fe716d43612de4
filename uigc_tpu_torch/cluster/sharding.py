"""Copy of ``uigc_tpu/cluster/sharding.py`` (pure Python).  The placement
layer (``_stable_hash``, ``shard_of``, ``rendezvous_assign``,
``ShardTable``) is the one ``parallel/partition.py`` imports, as the
reference's does.  What differs (ROADMAP.md Queue 3):

- Every capture that carries an entity's state to a later incarnation
  reads it through :func:`captured_state`, which drops the refs to the
  entity's own descendants (they stop with it); here the quarantine
  capture and the journal snapshot, in ``migration.py`` the handoff, in
  ``passivation.py`` the passivation.  The reference hands the next
  incarnation a ref to a stopped child.
- An entity frame that a peer routes here while this node still holds
  its provisional seed table is parked (``_park_early``) until a table
  that includes the sender is in place, then routed by it.  The
  reference delivers it at once: the key spawns blank, and the peer's
  handoff of its state then loses to it (a join under traffic lost
  commands).

Cluster sharding: GC-aware entity placement over the node fabric.

The missing subsystem between "actor GC middleware" (PAPER.md's UIGC
capability) and a serving fabric: named entities are placed by key,
survive membership change by live migration (migration.py), and idle
entities passivate to an in-memory store (passivation.py) — a controlled
quiescence decision, which is exactly the judgment the GC engines
already make for unreferenced actors.

Design, in the spirit of Akka Cluster Sharding but coordinator-free:

- **Placement** is a pure function of the member set: entity key ->
  shard (stable hash) -> node (rendezvous hash over members).  Every
  node computes the same table from the same membership view, so there
  is no shard coordinator to block on; versioned tables are gossiped
  over the existing ``NodeFabric`` frames (new ``"shard"`` kind,
  version-tolerant like the trace header) purely to reconcile
  *transient* view differences — the Tascade-shaped choice (PAPERS.md:
  asynchronous dissemination, no synchronous coordinator).
- **Routing** goes through :class:`EntityRef`, a location-transparent
  handle (Palgol's remote-data-access model, PAPERS.md): it names a
  ``(type, key)`` coordinate, never a cell.  The local shard region
  resolves the current home, spawns entities on demand, buffers during
  handoff, and forwards stragglers instead of dead-lettering them.
- **GC-awareness**: entities are spawned as *root* actors (pseudoroots
  — explicitly managed by the region, exactly like the reference's
  root actors), so the engines never collect a placed entity out from
  under the sharding layer; passivation and migration stop entities
  through the normal termination protocol, whose death accounting
  (CRGC ``pre_signal``) keeps every balance sound.  Migrated snapshots
  have their refs re-registered through the destination engine
  (migration.translate_refs) and announced via the ``EngineTap``
  migration hooks so the sanitizer's oracle agrees.

Entity messages are *external* traffic at both ends (the root-adapter
wrap), like requests entering the cluster from outside: refs they carry
re-materialize as unmanaged root references on the receiving node and do
not, by themselves, keep their targets alive — the same contract as
``RawRef`` sends.  Refs inside a migrated snapshot, by contrast, ARE
re-registered with the destination engine and do keep targets alive.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import re
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

from ..interfaces import Refob
from ..runtime.behaviors import AbstractBehavior, ActorFactory, RawBehavior
from ..runtime.cell import MailboxOverflowError
from ..runtime.fabric import MemberRemoved, MemberUp
from ..runtime import wire
from ..utils import events

if TYPE_CHECKING:  # pragma: no cover
    from ..runtime.cell import ActorCell
    from ..runtime.system import ActorSystem

# Entity record statuses.
_ACTIVE = "active"
_HANDOFF = "handoff"
_PASSIVATING = "passivating"
#: losing side of a split-brain verdict: the entity is draining its
#: state to the journal and stopping (cluster/membership.py)
_QUARANTINING = "quarantining"

#: sentinel distinguishing "shard not held" from "held awaiting any grant"
_NOT_HELD = object()

#: sentinel for a quarantine capture whose snapshot_state() raised —
#: distinct from a legitimate None state (see _QuarantineCmd.apply)
_SNAPSHOT_FAILED = object()


class _GrantWatch:
    """One lost shard's outstanding handoffs.  ``scanned`` stays False
    between the table transition that created the watch and the handoff
    scan that registers its keys — an empty-but-unscanned watch must
    never be granted (the keys just haven't been enumerated yet)."""

    __slots__ = ("owner", "keys", "scanned")

    def __init__(self, owner: str):
        self.owner = owner
        self.keys: set = set()
        self.scanned = False


# ------------------------------------------------------------------- #
# Placement: key -> shard -> node
# ------------------------------------------------------------------- #


@functools.lru_cache(maxsize=1 << 16)
def _stable_hash(text: str) -> int:
    """64-bit mixing hash, stable across processes (the builtin hash is
    salted; CRC is too linear for rendezvous scoring — one member's
    suffix dominates every shard).  Memoized: routing hashes the same
    entity keys over and over."""
    return int.from_bytes(
        hashlib.blake2b(text.encode(), digest_size=8).digest(), "big"
    )


def shard_of(key: str, num_shards: int) -> int:
    """Stable key -> shard mapping; every node and every process must
    agree."""
    return _stable_hash(key) % num_shards


def rendezvous_assign(members: List[str], num_shards: int) -> Dict[int, str]:
    """Highest-random-weight assignment of shards to members: each
    shard lands on the member with the max hash(shard|member).  Pure and
    deterministic in the member set; removing one member moves only that
    member's shards (minimal churn), which is what keeps a rebalance
    from migrating the whole keyspace."""
    if not members:
        return {}
    out: Dict[int, str] = {}
    for shard in range(num_shards):
        out[shard] = max(members, key=lambda m: _stable_hash(f"{shard}|{m}"))
    return out


class ShardTable:
    """A versioned shard->address assignment.  Versions totally order
    table adoptions across the cluster: (version, origin) is a lamport
    pair, so two nodes that recompute concurrently converge on one
    winner even before their membership views agree.  The fence epoch
    (cluster/membership.py) orders tables ACROSS partition eras before
    the lamport pair: a quarantined minority's table — whatever its
    version counter says — can never supersede a survivor's."""

    __slots__ = ("version", "origin", "assignments", "fence")

    def __init__(
        self,
        version: int,
        origin: str,
        assignments: Dict[int, str],
        fence: int = 0,
    ):
        self.version = version
        self.origin = origin
        self.assignments = assignments
        self.fence = fence

    def owner(self, shard: int) -> Optional[str]:
        return self.assignments.get(shard)

    def supersedes(self, other: "ShardTable") -> bool:
        if self.fence != other.fence:
            return self.fence > other.fence
        if self.version != other.version:
            return self.version > other.version
        if self.assignments == other.assignments:
            return False
        return self.origin < other.origin  # deterministic tiebreak

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ShardTable(v{self.version}@{self.origin}"
            f"/f{self.fence}, {len(self.assignments)} shards)"
        )


# ------------------------------------------------------------------- #
# Entity user API
# ------------------------------------------------------------------- #


class _EntityCtl:
    """Base for sharding-internal control payloads delivered to entity
    cells (handoff capture, passivation capture).  Polymorphic apply()
    keeps :class:`Entity` free of imports from migration/passivation."""

    __slots__ = ()

    #: bounded mailboxes must never shed a control command — a lost
    #: capture wedges its key's transition forever (cell.py honors
    #: this in its shed-oldest path)
    uigc_unsheddable = True

    def apply(self, entity: "Entity") -> Any:
        raise NotImplementedError


class Entity(AbstractBehavior):
    """Base class for sharded entity behaviors.

    Subclasses implement :meth:`receive` (instead of ``on_message``,
    which the sharding layer reserves for its control protocol) and —
    if they want passivation/migration to preserve state —
    :meth:`snapshot_state`, returning a picklable value.  Refobs inside
    the snapshot (at any container depth) are re-registered through the
    destination engine on restore.
    """

    def __init__(self, context: Any, key: str):
        super().__init__(context)
        self.key = key

    # -- user surface ------------------------------------------------ #

    def receive(self, msg: Any) -> Any:
        raise NotImplementedError

    def snapshot_state(self) -> Any:
        """State to carry across passivation/migration; None means the
        entity restarts fresh."""
        return None

    # -- runtime surface --------------------------------------------- #

    def on_message(self, msg: Any) -> Any:
        if isinstance(msg, _EntityCtl):
            return msg.apply(self)
        return self.receive(msg)


#: factory signature: (ctx, key, restored_state_or_None) -> Entity
EntityFactory = Callable[[Any, str, Any], Entity]


def captured_state(entity: Entity) -> Any:
    """``entity.snapshot_state()`` as a later incarnation may hold it:
    every Refob (at any container depth) whose target is a descendant of
    the capturing cell becomes None.  A captured state is restored only
    in a later incarnation, once this cell has stopped (a handoff, a
    passivation or a quarantine stops it; a journal snapshot is replayed
    only after it is gone), and a stopping cell stops its children first
    (runtime/cell.py), so such a ref would name a stopped actor there:
    None tells the next incarnation to spawn anew.  The reference carries
    the ref as is (ROADMAP.md Queue 3)."""
    cell = entity.context.cell
    prefix = cell.path + "/"

    def scrub(obj: Any) -> Any:
        if isinstance(obj, Refob):
            target = obj.target
            if getattr(target, "system", None) is cell.system and str(
                getattr(target, "path", "")
            ).startswith(prefix):
                return None
            return obj
        if isinstance(obj, dict):
            return {scrub(k): scrub(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [scrub(v) for v in obj]
        if isinstance(obj, tuple):
            return tuple(scrub(v) for v in obj)
        if isinstance(obj, set):
            return {scrub(v) for v in obj}
        return obj

    return scrub(entity.snapshot_state())


class _JournalSnapCmd(_EntityCtl):
    """Periodic journal snapshot: capture ``snapshot_state()`` on the
    entity's own thread and commit it as the base record of the epoch
    the region already bumped (cluster/journal.py).  The entity keeps
    running — unlike the migration/passivation captures this is not a
    transition, just a durability checkpoint."""

    __slots__ = ("region", "key", "epoch")

    def __init__(self, region: "ShardRegion", key: str, epoch: int):
        self.region = region
        self.key = key
        self.epoch = epoch

    def apply(self, entity: "Entity") -> Any:
        journal = self.region.cluster.journal
        if journal is None:
            return None
        try:
            state = captured_state(entity)
            blob = wire.encode_message(state) if state is not None else None
        except Exception:  # a failing snapshot must not kill the entity
            import traceback

            traceback.print_exc()
            return None
        shard = self.region.cluster.shard_of_key(self.key)
        journal.commit_snapshot(
            self.region.type_name, shard, self.key, self.epoch, blob
        )
        return None


class _QuarantineCmd(_EntityCtl):
    """Split-brain quarantine capture (cluster/membership.py): this
    node LOST the verdict, so the entity drains to the journal and
    stops serving instead of double-serving against the winner's
    incarnation.  Runs on the entity's own thread, like the handoff
    capture: snapshot, drain the mailbox (with engine dead-letter
    accounting), journal everything, stop."""

    __slots__ = ("region",)

    def __init__(self, region: "ShardRegion"):
        self.region = region

    def apply(self, entity: "Entity") -> Any:
        from ..runtime.behaviors import Behaviors
        from .migration import _drain_for_capture

        ctx = entity.context
        try:
            snapshot = captured_state(entity)
        except Exception:  # a failing snapshot must not wedge the drain
            import traceback

            traceback.print_exc()
            # Sentinel, NOT None: None is a legitimate "restart fresh"
            # state, but a FAILED capture must not open a blank epoch
            # that supersedes the key's last valid journaled snapshot —
            # the drain keeps the existing epoch and journals only the
            # mailbox tail.
            snapshot = _SNAPSHOT_FAILED
        pending = _drain_for_capture(ctx)
        tap = ctx.engine.tap
        if tap is not None:
            try:
                tap.on_migrate_out(ctx.cell, entity.key)
            except Exception:  # taps observe, never alter control flow
                import traceback

                traceback.print_exc()
        self.region._quarantine_captured(entity.key, snapshot, pending)
        return Behaviors.stopped()


class EntityRef:
    """Location-transparent handle for a sharded entity.

    Routes ``tell`` through the local shard region: the region resolves
    the key's current home node, spawns the entity on demand, buffers
    during handoff, and forwards after migration — the caller never
    sees placement.  Crossing a node boundary inside a message, an
    EntityRef re-encodes as its ``(type, key)`` coordinates (wire.py)
    and re-binds to the destination's region.
    """

    __slots__ = ("_cluster", "type_name", "key")

    def __init__(self, cluster: "ClusterSharding", type_name: str, key: str):
        self._cluster = cluster
        self.type_name = type_name
        self.key = key

    def tell(self, msg: Any) -> None:
        # raise_overflow: a LOCAL sender under the "error" overflow
        # policy gets the MailboxOverflowError; re-routes and remote
        # deliveries degrade to shed-oldest instead (route()).
        self._cluster.route(self.type_name, self.key, msg, raise_overflow=True)

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, EntityRef)
            and other.type_name == self.type_name
            and other.key == self.key
        )

    def __hash__(self) -> int:
        return hash((self.type_name, self.key))

    def __repr__(self) -> str:
        return f"EntityRef({self.type_name}/{self.key})"


# ------------------------------------------------------------------- #
# Shard region: the per-type, per-node entity host
# ------------------------------------------------------------------- #


class _EntityRecord:
    __slots__ = ("cell", "status")

    def __init__(self, cell: "ActorCell", status: str = _ACTIVE):
        self.cell = cell
        self.status = status


class ShardRegion:
    """Hosts the local entities of one entity type.  All mutable state
    is guarded by one re-entrant lock; delivery inside the lock keeps
    mailbox order consistent with handoff marking (a message routed
    after a key enters handoff is ALWAYS buffered, never enqueued
    behind the capture command)."""

    def __init__(
        self,
        cluster: "ClusterSharding",
        type_name: str,
        factory: EntityFactory,
        passivate_after_s: Optional[float] = None,
    ):
        from .passivation import PassivationPolicy, StateStore

        self.cluster = cluster
        self.type_name = type_name
        self.factory = factory
        self._lock = threading.RLock()
        self._entities: Dict[str, _EntityRecord] = {}
        #: messages parked while their key is mid-handoff/passivation;
        #: each per-key deque is capped at cluster.buffer_limit (shed-
        #: oldest + shard.buffer_dropped accounting)
        self._buffers: Dict[str, deque] = {}
        #: durable backend: with a journal attached, passivated
        #: snapshots spill through it too, so they survive node death
        self.store = StateStore(
            spill=self._journal_spill if cluster.journal is not None else None
        )
        self.passivation = PassivationPolicy(
            passivate_after_s
            if passivate_after_s is not None
            else cluster.passivate_after_s
        )

    # -- user surface ------------------------------------------------ #

    def entity_ref(self, key: str) -> EntityRef:
        return EntityRef(self.cluster, self.type_name, key)

    def active_count(self) -> int:
        with self._lock:
            return sum(
                1 for r in self._entities.values() if r.status == _ACTIVE
            )

    def passive_count(self) -> int:
        return self.store.size()

    def buffered_depth(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buffers.values())

    def active_keys(self) -> List[str]:
        with self._lock:
            return [k for k, r in self._entities.items() if r.status == _ACTIVE]

    def record_keys(self) -> List[str]:
        """Every key with a record, INCLUDING those mid-transition —
        the rebalance scan must count a passivating key as outstanding
        or its about-to-spill snapshot strands behind an early grant."""
        with self._lock:
            return list(self._entities)

    # -- delivery ---------------------------------------------------- #

    def deliver_local(
        self, key: str, payload: Any, raise_overflow: bool = False
    ) -> None:
        """Deliver to the local entity for ``key``, activating it (from
        the passivation store, the journal, or fresh) when absent.
        With a journal attached the command is appended — CRC-framed,
        fsync per policy — BEFORE the entity can see it, so an ack the
        entity later sends implies the command is replayable.  (The
        journal is therefore an at-least-once log: a command the bound
        then sheds or refuses was journaled but never acked — replay
        may apply it, acked state can never regress.)

        Delivery runs under the region lock, which makes the bounded-
        mailbox admission REGION-granular backpressure by design: one
        saturated key under the "block" policy slows every producer of
        the type on this node (including the transport receive thread,
        which is the propagation path back to remote senders)."""
        journal = self.cluster.journal
        with self._lock:
            rec = self._entities.get(key)
            if rec is not None and rec.status != _ACTIVE:
                self._buffer_locked(key, payload)
                return
            if rec is None:
                if self.cluster.home_of(key) not in (
                    None,
                    self.cluster.address,
                ):
                    # Ownership recheck at the spawn boundary: the
                    # caller resolved the key's home BEFORE taking this
                    # lock, and under full-suite load that read can
                    # predate a whole completed handoff — the record is
                    # gone because the entity now lives at the NEW
                    # owner.  A blank on-demand spawn here would fork
                    # the key's state at the OLD owner (the rebalance-
                    # under-traffic lost-incr race); re-route by the
                    # current table instead (outside the lock).
                    reroute = True
                else:
                    reroute = False
                    snapshot = self.store.pop(key)
                    resumed = snapshot is not None
                    replay: Optional[List[Any]] = None
                    if snapshot is None and journal is not None:
                        recovered = self._recover_from_journal(key)
                        if recovered is not None:
                            snapshot, replay = recovered
                    cell = self._spawn(
                        key,
                        snapshot,
                        resumed=resumed,
                        recovered=replay is not None,
                    )
                    rec = self._entities[key] = _EntityRecord(cell)
                    if replay:
                        self._replay_commands(rec.cell, key, replay)
            else:
                reroute = False
            if not reroute:
                snap_epoch = None
                if journal is not None and not isinstance(payload, _EntityCtl):
                    snap_epoch = self._journal_command(key, payload)
                self._tell_entity(rec.cell, payload, raise_overflow)
                if snap_epoch is not None:
                    rec.cell.tell_unbounded(
                        _JournalSnapCmd(self, key, snap_epoch)
                    )
                return
        if events.recorder.enabled:
            events.recorder.commit(
                events.SHARD_FORWARDED,
                key=key,
                type=self.type_name,
                site="spawn_recheck",
            )
        self.cluster.route(
            self.type_name, key, payload, hops=1, raise_overflow=raise_overflow
        )

    def _replay_commands(self, cell: "ActorCell", key: str, replay: List[Any]) -> None:
        """Re-deliver a journal-recovered command tail through the
        journaling path (one :meth:`_redeliver` per command)."""
        journal = self.cluster.journal
        for cmd in replay:
            self._redeliver(cell, key, cmd, journal)

    @staticmethod
    def _tell_entity(cell: "ActorCell", payload: Any, raise_overflow: bool) -> None:
        """Bounded enqueue on an entity cell.  Only a local
        ``EntityRef.tell`` propagates the "error" policy's raise; every
        other path (transport frames, replay, straggler forwards)
        degrades to shed-oldest via the never-raising batch admission."""
        if raise_overflow:
            cell.tell(payload)
            return
        try:
            cell.tell(payload)
        except MailboxOverflowError:
            cell.tell_batch([payload])

    def _buffer_locked(self, key: str, payload: Any) -> None:
        """Park one message behind an in-flight transition; caller
        holds the region lock.  Bounded: past cluster.buffer_limit the
        OLDEST parked message is shed, with accounting — never silent
        unbounded growth while a shard is held."""
        buf = self._buffers.setdefault(key, deque())
        limit = self.cluster.buffer_limit
        if limit and len(buf) >= limit:
            buf.popleft()
            if events.recorder.enabled:
                events.recorder.commit(
                    events.SHARD_BUFFER_DROPPED,
                    site="handoff",
                    key=key,
                    type=self.type_name,
                )
        buf.append(payload)
        if events.recorder.enabled:
            events.recorder.commit(
                events.SHARD_HANDOFF_BUFFERED,
                key=key,
                type=self.type_name,
                depth=len(buf),
            )

    # -- durability plumbing (cluster/journal.py) --------------------- #

    def _journal_command(self, key: str, payload: Any) -> Optional[int]:
        """Append one delivered command; returns the bumped epoch when
        a snapshot is due (the caller enqueues the capture command
        BEHIND the payload it journaled).  Caller holds the region
        lock, which is what sequences the epoch bump against the
        commands it supersedes."""
        journal = self.cluster.journal
        shard = self.cluster.shard_of_key(key)
        try:
            blob = wire.encode_message(payload)
        except Exception:
            # Unpicklable payload: deliver it live, skip durability for
            # this one message — a delivery failure would be worse than
            # a replay hole.
            return None
        due = journal.note_command(self.type_name, shard, key, blob)
        if due:
            return journal.begin_snapshot(self.type_name, shard, key)
        return None

    def _journal_open(
        self, key: str, snapshot: Any, min_epoch: int = 0
    ) -> Optional[int]:
        """Activation-time epoch open (fresh/resumed/migrated/
        recovered state becomes the new base record); returns the epoch
        opened (None without a journal).  ``min_epoch`` is the causal
        floor a migrated activation must strictly exceed — the source's
        capture epoch shipped on the mig frame.  An unencodable
        snapshot must NOT open a blank epoch — that would supersede a
        valid prior image with nothing; extend the old epoch instead."""
        journal = self.cluster.journal
        if journal is None:
            return None
        shard = self.cluster.shard_of_key(key)
        if snapshot is None:
            return journal.open_epoch(
                self.type_name, shard, key, None, min_epoch=min_epoch
            )
        try:
            blob = wire.encode_message(snapshot)
        except Exception:
            import traceback

            traceback.print_exc()
            return journal.continue_epoch(self.type_name, shard, key)
        return journal.open_epoch(
            self.type_name, shard, key, blob, min_epoch=min_epoch
        )

    def _journal_spill(self, key: str, state: Any) -> None:
        """StateStore durable backend: a passivated snapshot spills
        through the journal too, so passivated entities survive node
        death (recovered by whoever inherits the shard)."""
        self._journal_open(key, state)

    def _recover_from_journal(
        self, key: str, fresh: bool = True
    ) -> Optional[Tuple[Any, List[Any]]]:
        """(state, replay_commands) decoded from the journal, or None.
        Caller holds the region lock.  ``fresh`` re-scans the shard's
        files first — the on-demand activation path must see every
        append the previous owner flushed, or a stale image could
        supersede its later acked commands; the eager member-death
        sweep (recover_key) already invalidated once and passes False."""
        journal = self.cluster.journal
        shard = self.cluster.shard_of_key(key)
        t0 = time.perf_counter()
        if fresh:
            journal.invalidate_shard(self.type_name, shard)
        found = journal.recover(self.type_name, shard, key)
        if found is None:
            return None
        state_blob, cmd_blobs = found
        codec = self.cluster._codec
        state = None
        if state_blob is not None:
            try:
                state = wire.decode_message(codec, state_blob)
            except Exception:
                import traceback

                traceback.print_exc()
        replay: List[Any] = []
        skipped = 0
        for blob in cmd_blobs:
            try:
                replay.append(wire.decode_message(codec, blob))
            except Exception:
                # A command whose refs no longer resolve (its sender's
                # node died with it): counted, never a recovery abort.
                skipped += 1
        journal.recovered_entities += 1
        if events.recorder.enabled:
            events.recorder.commit(
                events.JOURNAL_RECOVERED,
                duration_s=time.perf_counter() - t0,
                key=key,
                type=self.type_name,
                cmds=len(replay),
                skipped=skipped,
            )
        return state, replay

    def recover_key(self, key: str) -> bool:
        """Eagerly reconstruct one journaled entity (the member-death
        recovery sweep).  True when an entity was recovered."""
        journal = self.cluster.journal
        if journal is None:
            return False
        with self._lock:
            if key in self._entities or self.store.contains(key):
                return False
            recovered = self._recover_from_journal(key, fresh=False)
            if recovered is None:
                return False
            state, replay = recovered
            cell = self._spawn(key, state, recovered=True)
            self._entities[key] = _EntityRecord(cell)
            self._replay_commands(cell, key, replay)
        return True

    def _spawn(
        self,
        key: str,
        snapshot: Any,
        resumed: bool = False,
        migrated: bool = False,
        recovered: bool = False,
        min_epoch: int = 0,
    ) -> "ActorCell":
        """Construct the entity cell as a root actor (a pseudoroot: the
        region, not the GC, decides when it dies).  Caller holds the
        region lock."""
        from .migration import translate_refs

        cluster = self.cluster
        system = cluster.system
        factory_fn = self.factory
        type_name = self.type_name

        def setup(ctx: Any) -> Entity:
            state = snapshot
            if migrated and state is not None:
                # Re-register carried refs through the DESTINATION
                # engine: the shadow graph gains (entity -> target)
                # edges, so targets kept alive by migrated state stay
                # provably reachable.
                state = translate_refs(state, ctx)
            behavior = factory_fn(ctx, key, state)
            if not isinstance(behavior, Entity):
                raise TypeError(
                    f"entity factory for {type_name!r} must return an "
                    f"Entity subclass, got {type(behavior).__name__}"
                )
            return behavior

        name = f"sh-{type_name}-{_safe_name(key)}-{next(cluster._name_seq)}"
        cell = system.spawn_cell(
            ActorFactory(setup, is_root=True),
            name,
            system._user_guardian,
            system.engine.root_spawn_info(),
        )
        if cluster.entity_mailbox_limit:
            cell.set_mailbox_bound(
                cluster.entity_mailbox_limit, cluster.entity_overflow_policy
            )
        if cluster.journal is not None:
            # New incarnation, new epoch: the state this cell starts
            # from becomes the journal's base record for the key (for a
            # migrated spawn, strictly past the source's capture epoch).
            self._journal_open(key, snapshot, min_epoch=min_epoch)
        if migrated:
            tap = system.engine.tap
            if tap is not None:
                try:
                    tap.on_migrate_in(cell, key)
                except Exception:  # taps observe, never alter control flow
                    import traceback

                    traceback.print_exc()
        if events.recorder.enabled:
            events.recorder.commit(
                events.SHARD_ENTITY_ACTIVATED,
                key=key,
                type=type_name,
                resumed=resumed,
                migrated=migrated,
                recovered=recovered,
            )
        return cell

    # -- transition plumbing (migration.py / passivation.py) --------- #

    def _begin_transition(self, key: str, status: str, cmd: _EntityCtl) -> bool:
        """Flip an ACTIVE entity into a buffering transition state and
        enqueue its capture command.  The lock is held across the tell,
        so no region-routed message can slip in behind the command."""
        with self._lock:
            rec = self._entities.get(key)
            if rec is None or rec.status != _ACTIVE:
                return False
            rec.status = status
            self._buffers.setdefault(key, deque())
            # Control commands bypass the mailbox bound: the capture
            # MUST reach the entity even when its mailbox is saturated
            # (and a blocked tell here would hold the region lock).
            rec.cell.tell_unbounded(cmd)
            return True

    def _finish_transition(self, key: str) -> List[Any]:
        """Drop the record for a completed transition and return the
        messages buffered during it.  An ACTIVE record is left alone —
        a bounced handoff re-activates the key locally BEFORE its
        self-ack lands here, and popping the live record would orphan
        the cell."""
        with self._lock:
            rec = self._entities.get(key)
            if rec is not None and rec.status != _ACTIVE:
                self._entities.pop(key)
            return self._buffers.pop(key, [])

    def _reactivate(self, key: str, snapshot: Any, pending: List[Any],
                    migrated: bool = False, min_epoch: int = 0) -> None:
        """Install a fresh cell for ``key`` (post-migration apply, or a
        passivation that raced with new traffic) and deliver pending.
        With a journal, the spawn opened a fresh epoch from the shipped
        snapshot and every pending/buffered delivery appends under it —
        the migration-in checkpoint that makes acked-but-unprocessed
        messages durable at the destination.  Deliveries here bypass
        the mailbox bound: shipped pending was already admitted (and
        possibly acked) at the source, buffered traffic already passed
        the region's buffer cap — shedding either would lose admitted
        state; bounds re-apply to new traffic.

        Stale-copy guard: ``min_epoch`` is the source's capture epoch
        (the mig frame's trailing element).  When the journal already
        holds a HIGHER epoch for the key, the shipped snapshot predates
        state a later incarnation journaled — a late retry of an old
        handoff slipping past long-resolved holds (under load a mig
        frame can wander for seconds).  Applying it would mint a fresh
        wall-epoch base that permanently supersedes those acked
        commands in every future recovery merge.  The journal is
        authoritative there: reconstruct from it (fresh scan) and
        deliver the shipped pending on top, surfaced as a structured
        ``shard.state_conflict`` — never a silent regression."""
        journal = self.cluster.journal
        replay: List[Any] = []
        recovered_stale = False
        if migrated and min_epoch and journal is not None:
            shard = self.cluster.shard_of_key(key)
            journal.invalidate_shard(self.type_name, shard)
            if journal.known_epoch(self.type_name, shard, key) > min_epoch:
                recovered_stale = True
        with self._lock:
            if recovered_stale:
                found = self._recover_from_journal(key, fresh=False)
                if found is not None:
                    snapshot, replay = found
                    migrated = False  # journal state, not the stale blob
                    if events.recorder.enabled:
                        events.recorder.commit(
                            events.SHARD_STATE_CONFLICT,
                            key=key,
                            type=self.type_name,
                            src="stale-migration",
                        )
            buffered = self._buffers.pop(key, [])
            cell = self._spawn(
                key, snapshot, resumed=snapshot is not None,
                migrated=migrated, min_epoch=min_epoch,
            )
            self._entities[key] = _EntityRecord(cell)
            for payload in replay:
                self._redeliver(cell, key, payload, journal)
            for payload in pending:
                self._redeliver(cell, key, payload, journal)
            for payload in buffered:
                self._redeliver(cell, key, payload, journal)

    def _quarantine_captured(
        self, key: str, snapshot: Any, pending: List[Any]
    ) -> None:
        """Entity-thread completion of a quarantine capture: checkpoint
        the final state + the drained-but-unprocessed tail to the
        journal (still under THIS side's fence — at heal the recovery
        merge applies the conflict rule), then drop the record.  The
        mailbox tail was already journaled at original delivery, so
        replay covers it; region buffers were NOT (the buffering path
        skips the journal), so they park in the cluster's deferred
        queue for a post-heal re-route."""
        journal = self.cluster.journal
        if journal is not None:
            try:
                if snapshot is not _SNAPSHOT_FAILED:
                    self._journal_open(key, snapshot)
                # A failed capture keeps the key's existing epoch: the
                # prior base snapshot stays authoritative and the tail
                # below appends under it — a blank epoch here would
                # supersede valid state with nothing.
                for payload in pending:
                    self._journal_command(key, payload)
            except Exception:  # durability must not abort the drain
                import traceback

                traceback.print_exc()
        with self._lock:
            rec = self._entities.get(key)
            if rec is not None and rec.status == _QUARANTINING:
                self._entities.pop(key)
            buffered = self._buffers.pop(key, [])
        for payload in buffered:
            self.cluster._defer(self.type_name, key, payload)
        if journal is not None:
            journal.forget(self.type_name, key)

    def _redeliver(self, cell: "ActorCell", key: str, payload: Any, journal) -> None:
        """One reactivation/replay delivery.  Three invariants: (a)
        these payloads were already admitted (acked, shipped, or
        buffer-capped) — they bypass the mailbox bound, shedding them
        would lose admitted state; (b) the payload is journaled (unless
        it is a control command) BEFORE the enqueue; (c) a snapshot the
        append triggers is enqueued IMMEDIATELY behind its triggering
        command, so the captured state contains exactly the commands
        journaled before the epoch bump — deferring it to the end of
        the batch would fold post-bump commands into the snapshot AND
        replay them again on the next recovery (double-apply)."""
        snap_epoch = None
        if journal is not None and not isinstance(payload, _EntityCtl):
            snap_epoch = self._journal_command(key, payload)
        cell.tell_unbounded(payload)
        if snap_epoch is not None:
            cell.tell_unbounded(_JournalSnapCmd(self, key, snap_epoch))

    def stats(self) -> Dict[str, Any]:
        return {
            "type": self.type_name,
            "active": self.active_count(),
            "passivated": self.passive_count(),
            "buffered": self.buffered_depth(),
        }


_SAFE_NAME = re.compile(r"[^A-Za-z0-9_.-]")


def _safe_name(key: str) -> str:
    return _SAFE_NAME.sub("_", key)[:48]


# ------------------------------------------------------------------- #
# Coordinator cell messages
# ------------------------------------------------------------------- #


class _Tick:
    __slots__ = ()


class _Rebalance:
    __slots__ = ()


class _FrameMsg:
    __slots__ = ("from_address", "frame")

    def __init__(self, from_address: str, frame: tuple):
        self.from_address = from_address
        self.frame = frame


class _Coordinator(RawBehavior):
    """Unmanaged, pinned cell serializing all cluster control work:
    membership events, gossip, migration control, passivation scans.
    Keeps the control plane single-threaded the same way the Bookkeeper
    keeps the collector single-threaded."""

    def __init__(self, cluster: "ClusterSharding"):
        self.cluster = cluster

    def on_message(self, msg: Any) -> Any:
        cluster = self.cluster
        if isinstance(msg, MemberUp):
            cluster._member_up(msg.address)
        elif isinstance(msg, MemberRemoved):
            cluster._member_removed(msg.address)
        elif isinstance(msg, _Tick):
            cluster._tick()
        elif isinstance(msg, _Rebalance):
            cluster._recompute_table(force=True)
        elif isinstance(msg, _FrameMsg):
            cluster._handle_frame(msg.from_address, msg.frame)
        return None


class _CodecFacade:
    """Resolution context for cluster payload decode: token resolution
    delegates to the real fabric, but ``.system`` is pinned to the
    receiving system so ``(entity)`` tokens bind to the local cluster
    even on the in-process Fabric (which hosts several systems and has
    no single ``.system``)."""

    def __init__(self, fabric: Any, system: "ActorSystem"):
        self._fabric = fabric
        self.system = system
        self.systems = (
            fabric.systems if fabric is not None else {system.address: system}
        )
        # Reply handles that ride cluster payloads (gateway ClientRefs)
        # re-bind to their decode context and later *send* through it,
        # so the facade must also stand in for the fabric's transport
        # face.  Plain attributes, not methods: on a transport-less
        # fabric ``send_frame`` is None and the handle's local-delivery
        # fallback (via ``systems``) kicks in.
        self.address = getattr(fabric, "address", None) or system.address
        self.send_frame = getattr(fabric, "send_frame", None)

    def resolve_cell_token(self, address: str, uid: int):
        hook = getattr(self._fabric, "resolve_cell_token", None)
        if hook is not None:
            return hook(address, uid)
        system = self.systems.get(address)
        if system is None:
            raise LookupError(f"unknown system {address!r} on this fabric")
        cell = system.resolve_cell(uid)
        if cell is None:
            raise LookupError(f"no cell uid={uid} in {address!r}")
        return cell


# ------------------------------------------------------------------- #
# ClusterSharding: the per-system composition root
# ------------------------------------------------------------------- #


class ClusterSharding:
    """Attach to a system (``ClusterSharding.attach(system)``), then
    ``start(type_name, factory)`` entity types and address them through
    :meth:`entity_ref`.  Works over the cross-process ``NodeFabric``
    (shard/entity/migration traffic as wire frames), the in-process
    ``Fabric`` (direct peer-region hand-off, same codec discipline),
    and fabric-less single systems (everything local)."""

    def __init__(
        self,
        system: "ActorSystem",
        num_shards: Optional[int] = None,
        proxy_only: bool = False,
    ):
        config = system.config
        self.system = system
        self.address = system.address
        #: a proxy-only member (an ingress gateway) participates in
        #: membership, gossip and routing but NEVER owns shards: it
        #: joins permanently draining with an empty member view, so its
        #: seed table is vacuous and every peer that links up is told
        #: "sleave" before it can assign shards here (``_member_up``).
        self.proxy_only = proxy_only
        self.num_shards = num_shards or config.get_int("uigc.cluster.num-shards")
        self.passivate_after_s = config.get_int("uigc.cluster.passivate-after") / 1000.0
        self.tick_s = config.get_int("uigc.cluster.tick-interval") / 1000.0
        self.retry_s = config.get_int("uigc.cluster.handoff-retry") / 1000.0
        self.max_hops = config.get_int("uigc.cluster.max-forward-hops")
        self.hold_timeout_s = config.get_int("uigc.cluster.hold-timeout") / 1000.0
        #: per-key handoff/hold buffer cap (0 = unbounded legacy)
        self.buffer_limit = config.get_int("uigc.cluster.buffer-limit")
        #: global deferred-route queue cap
        self.deferred_limit = config.get_int("uigc.cluster.deferred-limit")
        self.entity_mailbox_limit = (
            config.get_int("uigc.cluster.entity-mailbox-limit")
            or config.get_int("uigc.runtime.mailbox-limit")
        )
        self.entity_overflow_policy = config.get_string(
            "uigc.runtime.overflow-policy"
        )
        #: event-sourced entity journal (cluster/journal.py); None when
        #: uigc.cluster.journal-dir is unset — the pre-durability mode
        self.journal = None
        journal_dir = config.get_string("uigc.cluster.journal-dir")
        if journal_dir:
            from .journal import EntityJournal

            fabric_ref = system.fabric
            address = system.address

            def _journal_fault(nbytes: int):
                # resolved per append so a plan set AFTER attach (or
                # swapped mid-test) still injects
                plan = getattr(fabric_ref, "fault_plan", None)
                if plan is None:
                    return None
                return plan.journal_append(address, nbytes)

            self.journal = EntityJournal(
                journal_dir,
                system.address,
                fsync=config.get_string("uigc.cluster.journal-fsync"),
                fsync_interval_s=config.get_int(
                    "uigc.cluster.journal-fsync-interval"
                )
                / 1000.0,
                segment_bytes=config.get_int(
                    "uigc.cluster.journal-segment-bytes"
                ),
                snapshot_every=config.get_int(
                    "uigc.cluster.journal-snapshot-every"
                ),
                fault_fn=_journal_fault if fabric_ref is not None else None,
            )
        #: split-brain arbiter (cluster/membership.py).  "off" disables
        #: arbitration entirely — every verdict acts immediately, the
        #: pre-PR-13 behavior.
        strategy = config.get_string("uigc.cluster.sbr-strategy") or "off"
        self.arbiter = None
        if strategy != "off":
            from .membership import MembershipArbiter

            self.arbiter = MembershipArbiter(
                system.address,
                strategy=strategy,
                settle_s=config.get_int("uigc.cluster.sbr-settle") / 1000.0,
                quorum_size=config.get_int("uigc.cluster.sbr-quorum-size"),
                min_members=config.get_int("uigc.cluster.sbr-min-members"),
            )
        #: this node LOST a split-brain verdict: placement stopped,
        #: entities drained to the journal, routing parks everything
        #: until a survivor's fence arrives through the handshake
        self._quarantined = False
        #: the quarantine drain finished and the journal froze
        self._quarantine_checkpointed = False
        #: entities drained by the quarantine (for the settle event)
        self._quarantine_entities = 0
        #: previously-downed addresses whose links are back up but whose
        #: ``mship`` handshake has not yet confirmed the adopted fence —
        #: they are NOT placement members until it does
        self._pending_rejoin: set = set()

        #: key -> shard memo: the blake2b in shard_of was a measurable
        #: slice of every routed message.  GIL-atomic dict ops, bounded
        #: by wholesale clear (hot keys re-warm in one burst).
        self._shard_cache: Dict[str, int] = {}

        self._lock = threading.RLock()
        self._regions: Dict[str, ShardRegion] = {}
        self._members: set = set() if proxy_only else {self.address}
        self._table = ShardTable(0, self.address, {})
        self._name_seq = itertools.count(1)
        #: routes that could not be sent (no link yet / table vacuum /
        #: hop limit) — retried every tick instead of being dropped
        #: routes parked for table convergence; deque so the
        #: shed-oldest cap pops O(1)
        self._deferred: deque = deque()  # unbounded: capped by deferred_limit in _defer

        #: shard-grant protocol state.  A shard GAINED from a live
        #: previous owner is *held*: its traffic buffers here until the
        #: previous owner grants it (all its handoffs acked), it dies,
        #: or the hold times out.  Without the hold, traffic during the
        #: table-divergence window can spawn a fresh on-demand entity
        #: at the new home that then WINS against the in-flight
        #: migration snapshot — silently discarding the entity's state.
        self._holds: Dict[int, str] = {}
        self._hold_deadlines: Dict[int, float] = {}
        self._hold_buffers: Dict[int, deque] = {}
        #: shards we LOST: new owner plus the (type, key) handoffs that
        #: must complete before we grant the shard away.
        self._grant_watch: Dict[int, _GrantWatch] = {}
        #: True while the table was computed from a single-member view
        #: (the seed).  Self-ownership "confirmed" out of a provisional
        #: table is NOT trustworthy — a joining node claims the whole
        #: keyspace for a moment — so those shards are held too.
        self._provisional = True
        #: entity frames a peer routed here while this node still held
        #: its provisional seed table (the peer's MemberUp not yet
        #: processed), per sender: routed by the table that includes
        #: the sender, once there is one (ROADMAP.md Queue 3)
        self._early: Dict[str, deque] = {}
        #: peers removed since their last MemberUp: their late frames
        #: route as in the reference, never parked
        self._gone: set = set()
        #: voluntary departures (the drain lifecycle): addresses that
        #: asked to stop receiving placements but whose links are still
        #: up for the handoffs — holds waiting on THEIR grants stay
        #: armed, unlike a death verdict's.
        self._leaving: set = set()
        #: this node is draining: it excludes itself from placement,
        #: rebroadcasts its departure every tick, and refuses to
        #: re-adopt shards a stale peer table hands back.  A proxy-only
        #: member is BORN draining — same machinery, permanent state.
        self._draining = proxy_only
        self._closed = False
        self._ticks = 0
        #: last table version rebroadcast by the anti-entropy gossip
        self._gossiped_version = -1

        from .migration import MigrationManager

        self.migrations = MigrationManager(self)

        fabric = system.fabric
        self._codec = _CodecFacade(fabric, system)
        self._wire_frames = fabric is not None and hasattr(fabric, "send_frame")
        if self._wire_frames:
            for kind in wire.SHARD_FRAME_KINDS:
                fabric.register_frame_handler(kind, self._on_transport_frame)

        self._coordinator = system.spawn_system_raw(
            _Coordinator(self), "shard-coordinator", pinned=True
        )
        if fabric is not None:
            fabric.subscribe(self._coordinator)
        # Seed the table from the members known right now (at least
        # self).  The subscribe replay above delivers current peers
        # asynchronously; each one recomputes.  Without this seed a
        # single node defers every route until a SECOND member joins —
        # the MemberUp(self) replay dedups against the pre-seeded set.
        self._recompute_table()
        self._timer_key = ("cluster-tick", id(self))
        system.timers.schedule_fixed_delay(
            self.tick_s,
            lambda: self._coordinator.tell(_Tick()),
            key=self._timer_key,
        )

    # -- lifecycle --------------------------------------------------- #

    @classmethod
    def attach(
        cls,
        system: "ActorSystem",
        num_shards: Optional[int] = None,
        proxy_only: bool = False,
    ) -> "ClusterSharding":
        sharding = cls(system, num_shards, proxy_only=proxy_only)
        system.cluster = sharding
        return sharding

    def close(self) -> None:
        self._closed = True
        self.system.timers.cancel(self._timer_key)
        fabric = self.system.fabric
        if self._wire_frames:
            for kind in wire.SHARD_FRAME_KINDS:
                fabric.register_frame_handler(kind, None)
        if self.journal is not None:
            self.journal.close()
        if self.system.cluster is self:
            self.system.cluster = None

    # -- entity types ------------------------------------------------ #

    def start(
        self,
        type_name: str,
        factory: EntityFactory,
        passivate_after_s: Optional[float] = None,
    ) -> ShardRegion:
        """Register an entity type; returns its local region.  Every
        node of the cluster must start the same types (the same
        requirement Akka Cluster Sharding imposes)."""
        with self._lock:
            if type_name in self._regions:
                raise ValueError(f"entity type {type_name!r} already started")
            region = ShardRegion(self, type_name, factory, passivate_after_s)
            self._regions[type_name] = region
            return region

    def region(self, type_name: str) -> ShardRegion:
        with self._lock:
            return self._regions[type_name]

    def entity_ref(self, type_name: str, key: str) -> EntityRef:
        return EntityRef(self, type_name, key)

    # -- placement --------------------------------------------------- #

    def shard_of_key(self, key: str) -> int:
        """Memoized :func:`shard_of` (routing hot path)."""
        shard = self._shard_cache.get(key)
        if shard is None:
            if len(self._shard_cache) >= 65536:
                self._shard_cache.clear()
            shard = self._shard_cache[key] = shard_of(key, self.num_shards)
        return shard

    def home_of(self, key: str) -> Optional[str]:
        return self._table.owner(self.shard_of_key(key))

    @property
    def current_fence(self) -> int:
        """The partition era this node operates under (0 when
        arbitration is off — the pre-fencing era every fenced site
        treats as unordered)."""
        return self.arbiter.fence if self.arbiter is not None else 0

    @property
    def quarantined(self) -> bool:
        return self._quarantined

    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._members)

    def table_snapshot(self) -> ShardTable:
        t = self._table
        return ShardTable(t.version, t.origin, dict(t.assignments))

    # -- routing ----------------------------------------------------- #

    def route(
        self,
        type_name: str,
        key: str,
        payload: Any,
        hops: int = 0,
        raise_overflow: bool = False,
    ) -> None:
        """Deliver ``payload`` to the entity for ``key`` wherever it
        currently lives.  ``raise_overflow`` propagates a bounded-
        mailbox "error" verdict to the caller — set only by a local
        ``EntityRef.tell``; transport frames, deferred re-routes and
        migration straggler forwards degrade to shed-oldest instead
        (a raise there would kill a receive loop or the coordinator)."""
        if self._quarantined:
            # Losing side of a split-brain verdict: serving here would
            # be the dual activation the fencing plane exists to
            # prevent.  Park the message (bounded by deferred_limit);
            # the post-heal flush re-routes it by the survivor's table.
            if events.recorder.enabled:
                events.recorder.commit(
                    events.FENCE_REJECTED,
                    site="route",
                    key=key,
                    type=type_name,
                )
            self._defer(type_name, key, payload)
            return
        shard = self.shard_of_key(key)
        home = self._table.owner(shard)
        if home is None:
            self._defer(type_name, key, payload)
            return
        if home == self.address:
            with self._lock:
                if shard in self._holds:
                    # Shard gained but not yet granted: hold the
                    # message so an on-demand spawn cannot race (and
                    # discard) the in-flight migration snapshot.
                    buf = self._hold_buffers.setdefault(shard, deque())
                    if self.buffer_limit and len(buf) >= self.buffer_limit:
                        # account the message actually dropped (the
                        # popped oldest), not the one being admitted
                        d_type, d_key, _d_payload = buf.popleft()
                        if events.recorder.enabled:
                            events.recorder.commit(
                                events.SHARD_BUFFER_DROPPED,
                                site="hold",
                                key=d_key,
                                type=d_type,
                            )
                    buf.append((type_name, key, payload))
                    held = len(buf)
                else:
                    held = 0
            if held:
                if events.recorder.enabled:
                    events.recorder.commit(
                        events.SHARD_HANDOFF_BUFFERED,
                        key=key,
                        type=type_name,
                        depth=held,
                        shard=shard,
                    )
                return
            region = self._regions.get(type_name)
            if region is None:
                self._defer(type_name, key, payload)
                return
            region.deliver_local(key, payload, raise_overflow=raise_overflow)
            return
        if hops >= self.max_hops:
            # Tables are diverging (a rebalance in flight); park the
            # message until gossip converges rather than ping-ponging.
            self._defer(type_name, key, payload)
            return
        # Schema-native payload bytes when the peer negotiated the
        # codec (runtime/schema.py), pickle otherwise — decode_message
        # dispatches on the body's magic, so the frame never knows.
        peer_ids = getattr(self.system.fabric, "peer_schema_ids", None)
        encoded = wire.encode_message_schema(
            payload, peer_ids(home) if peer_ids is not None else ()
        )
        if not self._send_frame(
            home,
            wire.encode_entity_frame(
                type_name, key, hops + 1, encoded, self.current_fence
            ),
        ):
            self._defer(type_name, key, payload)

    def _defer(self, type_name: str, key: str, payload: Any) -> None:
        with self._lock:
            if (
                self.deferred_limit
                and len(self._deferred) >= self.deferred_limit
            ):
                d_type, d_key, _d_payload = self._deferred.popleft()
                if events.recorder.enabled:
                    events.recorder.commit(
                        events.SHARD_BUFFER_DROPPED,
                        site="deferred",
                        key=d_key,
                        type=d_type,
                    )
            self._deferred.append((type_name, key, payload))

    # -- transport --------------------------------------------------- #

    def _send_frame(self, dst: str, frame: tuple) -> bool:
        if dst == self.address:
            self._coordinator.tell(_FrameMsg(self.address, frame))
            return True
        fabric = self.system.fabric
        if fabric is None:
            return False
        if self._wire_frames:
            return fabric.send_frame(dst, frame)
        peer = fabric.systems.get(dst)
        cluster = getattr(peer, "cluster", None)
        if cluster is None or getattr(peer, "address", None) in fabric.crashed:
            return False
        cluster._coordinator.tell(_FrameMsg(self.address, frame))
        return True

    def _on_transport_frame(self, from_address: str, frame: tuple) -> None:
        # Entity traffic is the hot path and needs none of the
        # coordinator's serialization: route() is lock-protected and
        # already runs on arbitrary sender threads (every local
        # EntityRef.tell), so inbound "ent" frames decode + route
        # directly on the transport thread — the per-link FIFO is
        # preserved (one receive thread per link), and a whole
        # cluster's entity stream no longer funnels through ONE
        # GIL-serialized coordinator mailbox.  Reordering against a
        # trailing control frame is benign by construction: an "ent"
        # overtaken by its peer's "sgrant" would at worst deliver
        # where it previously buffered (the hold is an optimization
        # barrier, not a correctness one in that direction), and an
        # "ent" processed early simply buffers until the grant lands.
        if frame[0] == "ent":
            self._handle_ent_frame(from_address, frame)
            return
        # Control work (tables, migration, grants) stays serialized on
        # the coordinator cell.
        self._coordinator.tell(_FrameMsg(from_address, frame))

    # -- coordinator-side handlers ----------------------------------- #

    def _population_locked(self) -> int:
        """Nodes that still participate in the grant protocol; caller
        holds the lock.  Counts LEAVING nodes (alive, mid-drain, will
        still grant) and a draining self (already out of _members): a
        2-node cluster mid-drain is NOT a sole survivor, and treating
        it as one would release holds and let on-demand spawns race
        the drain's in-flight migrations."""
        return (
            len(self._members)
            + len(self._leaving)
            + (1 if self._draining else 0)
        )

    def _member_up(self, address: str) -> None:
        with self._lock:
            self._gone.discard(address)
        if self.arbiter is not None and address != self.address:
            admitted = self.arbiter.on_member_up(address)
            # Exchange the membership handshake on every link-up: it
            # carries the fence, the live view and the join stamps —
            # fence sync for fresh joiners, the rejoin protocol for
            # healed ones, seniority convergence for keep-oldest.
            self._send_mship(address)
            if not admitted:
                # Downed this era (or we are quarantined): placement
                # admission waits for the peer's handshake to confirm
                # the adopted fence.
                with self._lock:
                    self._pending_rejoin.add(address)
                return
        if self._draining:
            if address == self.address:
                # The fabric's subscribe replay includes ourselves; a
                # draining (or proxy-only) member must never re-enter
                # its own placement view — re-adding self here would
                # recompute a table claiming the whole keyspace.
                return
            # A draining (or proxy-only) node tells every NEW link its
            # departure immediately: without this, the peer's MemberUp
            # adds us to its view and it may assign shards here during
            # the window before the tick's sleave re-broadcast lands.
            self._send_frame(address, wire.encode_shard_leave(self.address))
        with self._lock:
            self._leaving.discard(address)
            if address in self._members:
                return
            self._members.add(address)
        self._recompute_table()

    def _member_leaving(self, address: str) -> None:
        """Voluntary departure (the drain lifecycle, "sleave" frame):
        stop PLACING on the node but keep every hold waiting on its
        grants armed — it is alive and migrating its entities to us."""
        if address == self.address:
            return
        if self.arbiter is not None:
            self.arbiter.on_leaving(address)
        with self._lock:
            already = address in self._leaving
            self._leaving.add(address)
            if address not in self._members:
                if already:
                    return  # re-broadcast of a departure we adopted
                was_member = False
            else:
                was_member = True
                self._members.discard(address)
        if was_member:
            self._recompute_table()
            self._flush_deferred()

    def _member_removed(self, address: str) -> None:
        with self._lock:
            self._pending_rejoin.discard(address)
            self._gone.add(address)
            self._deferred.extend(self._early.pop(address, ()))
        if self.arbiter is not None and self.arbiter.track_unreachable(address):
            # Arbitrated: the verdict (and with it shard inheritance)
            # waits for the settle window — the side that will LOSE
            # must never start acquiring shards.  The tick polls the
            # decision (``_poll_arbiter``).
            return
        self._apply_member_removed(address)

    def _apply_member_removed(self, address: str) -> None:
        """Execute one removal: release grant state, recompute, absorb
        the dead node's journaled entities.  Runs immediately when
        arbitration is off (or not applicable), or at decision time on
        the SURVIVING side of a settled verdict."""
        with self._lock:
            self._leaving.discard(address)
            was_member = address in self._members
            touched = self._forget_dead_locked(address)
            if not was_member and not touched:
                return
            self._members.discard(address)
            old_assignments = dict(self._table.assignments)
        self._recompute_table()
        self.migrations.retarget_dead(address)
        if self.journal is not None:
            # Peer files may hold state we must now serve: drop stale
            # scan caches, then eagerly reconstruct the journaled
            # entities of every shard we inherited from the dead node.
            self.journal.invalidate_cache()
            self._recover_inherited(address, old_assignments)
        self._flush_deferred()

    def _forget_dead_locked(self, address: str) -> bool:
        """Release grant/hold state pointing at a dead address; caller
        holds the lock.  True when anything referenced it (so a death
        verdict for an already-left member still cleans up)."""
        touched = False
        for shard in [
            s for s, owner in self._holds.items() if owner == address
        ]:
            self._release_hold_locked(shard)
            touched = True
        for shard in [
            s
            for s, watch in self._grant_watch.items()
            if watch.owner == address
        ]:
            del self._grant_watch[shard]
            touched = True
        return touched

    def _recover_inherited(
        self, dead: str, old_assignments: Dict[int, str]
    ) -> None:
        """Journal-recover every entity of a shard that moved
        ``dead`` -> this node.  Restricted to gained-from-dead shards:
        a shard gained from a LIVE owner gets its state via the
        migration protocol, and recovering a stale journal copy under
        it would race (and lose against) the authoritative handoff."""
        table = self._table
        for region in list(self._regions.values()):
            for shard in self.journal.shards(region.type_name):
                if table.owner(shard) != self.address:
                    continue
                if old_assignments.get(shard) != dead:
                    continue
                for key in self.journal.keys_for_shard(
                    region.type_name, shard
                ):
                    try:
                        region.recover_key(key)
                    except Exception:
                        import traceback

                        traceback.print_exc()

    # -- split-brain arbitration (cluster/membership.py) -------------- #

    def _poll_arbiter(self) -> None:
        """Tick-driven: execute a settled split-brain verdict.  The
        surviving side bumps its fence and absorbs the downed members'
        shards; the losing side quarantines."""
        decision = self.arbiter.poll()
        if decision is None:
            return
        if events.recorder.enabled:
            events.recorder.commit(
                events.SBR_DECISION,
                strategy=decision.strategy,
                survived=decision.survived,
                downed=list(decision.downed),
                live=len(decision.live),
                seen=len(decision.seen),
                fence=decision.fence,
                reason=decision.reason,
            )
        if decision.survived:
            if self.journal is not None:
                self.journal.set_fence(decision.fence)
            for address in decision.downed:
                self._apply_member_removed(address)
            # Stamp the new fence even when assignments happen not to
            # change, and push it to the same-side peers immediately.
            self._recompute_table(force=True)
            self._broadcast_mship()
        else:
            self._enter_quarantine(decision)

    def _enter_quarantine(self, decision) -> None:
        """This node LOST the verdict: stop acquiring shards, drain
        every hosted entity to the journal, stop serving.  Nothing is
        deleted — the journal keeps the final state (under the stale
        fence, subject to the heal-time conflict rule) and parked
        traffic re-routes after the rejoin."""
        with self._lock:
            if self._quarantined:
                return
            self._quarantined = True
            self._quarantine_checkpointed = False
            self._quarantine_entities = 0
            self._members = {self.address}
            # Grant/hold state points across the partition: drop it —
            # hold buffers park in the deferred queue.
            for shard in list(self._holds):
                self._release_hold_locked(shard)
            self._grant_watch.clear()
        if events.recorder.enabled:
            events.recorder.commit(
                events.SBR_DOWNED,
                strategy=decision.strategy,
                downed_with=list(decision.downed),
                reason=decision.reason,
            )
        self._quarantine_scan()

    def _quarantine_scan(self) -> int:
        """Begin (or extend) the drain: every ACTIVE entity gets a
        quarantine capture (journal checkpoint + stop) through the same
        transition machinery handoffs use.  Returns captures begun.
        Called on entry AND every tick until the freeze: a delivery
        that raced the lock-free quarantine check in ``route`` can
        activate an entity AFTER the first sweep — the re-scan catches
        such strays before the journal freezes, so nothing can keep
        serving from memory against a frozen append plane."""
        with self._lock:
            regions = list(self._regions.values())
        begun = 0
        for region in regions:
            for key in region.active_keys():
                if region._begin_transition(
                    key, _QUARANTINING, _QuarantineCmd(region)
                ):
                    begun += 1
        self._quarantine_entities += begun
        return begun

    def _quarantine_drained(self) -> bool:
        """Nothing left that the freeze could strand.  ACTIVE counts as
        not-drained (an activation that raced the lock-free route gate
        lands AFTER a sweep — the next tick's re-scan captures it, and
        freezing under it would leave an entity serving from memory
        against a frozen journal for the whole partition), as does a
        capture in flight and a local passivation spill.  A pre-verdict
        HANDOFF record deliberately does NOT block the freeze: its
        state was journal-checkpointed at capture, and its ack depends
        on a peer across the cut — waiting would wedge the quarantine
        forever."""
        with self._lock:
            regions = list(self._regions.values())
        for region in regions:
            with region._lock:
                if any(
                    rec.status in (_ACTIVE, _QUARANTINING, _PASSIVATING)
                    for rec in region._entities.values()
                ):
                    return False
        return True

    def _quarantine_settle(self) -> None:
        """Every capture landed: checkpoint (flush + fsync) and FREEZE
        the journal — from here on a stale append is refused at the
        append site, so zero fenced-stale records can reach a recovery
        merge."""
        with self._lock:
            if self._quarantine_checkpointed or not self._quarantined:
                return
            self._quarantine_checkpointed = True
        if self.journal is not None:
            self.journal.checkpoint()
            self.journal.freeze()
        if events.recorder.enabled:
            events.recorder.commit(
                events.SBR_QUARANTINE,
                entities=self._quarantine_entities,
                checkpointed=self.journal is not None,
            )

    def _leave_quarantine(self, fence: int, via: str) -> None:
        """Heal-time rejoin: a survivor's handshake delivered a higher
        fence.  Adopt it, unfreeze the journal, and re-enter the
        cluster as a fresh member — peers re-admit us through their own
        handshakes, the rebalance hands our share of the keyspace back,
        and journal recovery (conflict rule applied) reconstructs it."""
        self.arbiter.rejoin(fence)
        if self.journal is not None:
            self.journal.unfreeze(fence)
            self.journal.invalidate_cache()
        with self._lock:
            self._quarantined = False
            self._quarantine_checkpointed = False
            self._members = {self.address}
        if events.recorder.enabled:
            events.recorder.commit(events.SBR_REJOIN, fence=fence, via=via)
        self._admit_rejoin(via)

    def _admit_rejoin(self, address: str) -> None:
        """A previously-downed peer completed the handshake (its view
        carries our fence): re-admit it to placement."""
        self.arbiter.admit(address)
        with self._lock:
            self._pending_rejoin.discard(address)
            self._leaving.discard(address)
            already = address in self._members
            self._members.add(address)
        if not already:
            self._recompute_table()
            self._flush_deferred()

    def _send_mship(self, address: str) -> None:
        if self.arbiter is None or address == self.address:
            return
        fence, members, stamps, quarantined = self.arbiter.view()
        self._send_frame(
            address,
            wire.encode_mship(
                self.address,
                fence,
                members,
                stamps,
                quarantined,
                self._table.version,
            ),
        )

    def _broadcast_mship(self) -> None:
        if self.arbiter is None:
            return
        with self._lock:
            targets = set(self._members) | set(self._pending_rejoin)
        targets.discard(self.address)
        for address in targets:
            self._send_mship(address)

    def _on_mship(self, from_address: str, frame: tuple) -> None:
        """Membership handshake / anti-entropy (coordinator thread)."""
        if self.arbiter is None:
            return
        doc = wire.decode_mship(frame)
        if doc is None:
            return
        arbiter = self.arbiter
        arbiter.merge_stamps(doc["stamps"])
        peer_fence = doc["fence"]
        my_fence = arbiter.fence
        if peer_fence > my_fence:
            if self._quarantined and not doc["quarantined"]:
                if not self._quarantine_checkpointed:
                    # The drain is still landing on entity threads: a
                    # rejoin NOW would unfreeze the journal and let the
                    # remaining captures stamp this side's divergent
                    # state with the SURVIVOR's fence — unrejectable at
                    # the next merge.  Wait; the peer's periodic mship
                    # gossip retries the handshake.  (Same thread as
                    # the tick that sets the flag — no race.)
                    return
                self._leave_quarantine(peer_fence, via=from_address)
            else:
                arbiter.adopt_fence(peer_fence)
                if self.journal is not None:
                    self.journal.set_fence(peer_fence)
                # Re-stamp the local table under the adopted fence so
                # our gossip is comparable again.
                self._recompute_table(force=True)
            self._send_mship(from_address)  # confirm the adoption
            return
        if peer_fence < my_fence:
            self._send_mship(from_address)  # help the peer catch up
            return
        # Equal fences: disagreement detection + rejoin admission.
        conflicts = arbiter.disagreement(doc)
        if conflicts and events.recorder.enabled:
            events.recorder.commit(
                events.MEMBERSHIP_DISAGREEMENT,
                peer=from_address,
                conflicts=conflicts[:8],
            )
        with self._lock:
            pending = from_address in self._pending_rejoin
        if pending and not doc["quarantined"] and not self._quarantined:
            self._admit_rejoin(from_address)

    def rebalance(self) -> None:
        """Explicit rebalance kick: recompute from the current member
        view, gossip, and hand off anything this node no longer owns.
        Routed through the coordinator so table transitions stay
        single-threaded — a caller-thread recompute could race the
        coordinator's grant pass into granting a freshly lost shard
        before its keys are registered."""
        self._coordinator.tell(_Rebalance())

    # -- drain lifecycle (zero-downtime rolling restart) -------------- #

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Gracefully empty this node: stop accepting placements
        (broadcast a "sleave", exclude self from the table), hand off
        every hosted entity — live AND passivated — through the
        existing migration/grant protocol, checkpoint the journal, and
        wait until nothing remains.  Returns True when fully drained
        within the timeout; False leaves whatever residue the journal
        can still recover after the restart.

        The restart half needs no inverse call: a fresh process on the
        same address reconnects, peers see MemberUp, and the rebalance
        migrates its share of the keyspace back."""
        t0 = time.monotonic()
        with self._lock:
            first = not self._draining
            self._draining = True
            self._members.discard(self.address)
        if first and events.recorder.enabled:
            events.recorder.commit(events.NODE_DRAINING, address=self.address)
        self._broadcast_leave()
        self._coordinator.tell(_Rebalance())
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._drained():
                break
            time.sleep(0.02)
        if self.journal is not None:
            self.journal.checkpoint()
        drained = self._drained()
        if events.recorder.enabled:
            events.recorder.commit(
                events.NODE_DRAINED,
                duration_s=time.monotonic() - t0,
                address=self.address,
                complete=drained,
            )
        return drained

    def _drained(self) -> bool:
        """Nothing left to hand off: no pending migrations, no grant
        watches, no entity records, no parked traffic, no spilled
        state."""
        if self.migrations.pending_count():
            return False
        with self._lock:
            if self._grant_watch:
                return False
            if self._deferred or self._hold_buffers or self._early:
                return False
            regions = list(self._regions.values())
        for region in regions:
            with region._lock:
                if region._entities or any(region._buffers.values()):
                    return False
            if region.store.size():
                return False
        return True

    def _broadcast_leave(self) -> None:
        frame = wire.encode_shard_leave(self.address)
        for member in self.members():
            if member != self.address:
                self._send_frame(member, frame)

    def _recompute_table(self, force: bool = False) -> None:
        with self._lock:
            assignments = rendezvous_assign(sorted(self._members), self.num_shards)
            if assignments == self._table.assignments and not force:
                return
            old = self._table.assignments
            # Fence = max(arbiter, adopted table): a peer whose shard
            # gossip outran its mship handshake has already adopted a
            # higher-fence table — recomputing at the (stale) arbiter
            # fence would regress it, misroute toward downed members,
            # and gossip a table everyone rejects.  Fences only move
            # forward.
            self._table = ShardTable(
                self._table.version + 1,
                self.address,
                assignments,
                fence=max(self.current_fence, self._table.fence),
            )
            table = self._table
            self._table_transition(old, assignments)
        if events.recorder.enabled:
            events.recorder.commit(
                events.SHARD_TABLE,
                version=table.version,
                shards=len(table.assignments),
                origin=self.address,
            )
        self._gossip()
        self._scan_handoffs()

    def _adopt_table(
        self,
        version: int,
        origin: str,
        assignments: Dict[int, str],
        fence: int = 0,
    ) -> None:
        incoming = ShardTable(version, origin, assignments, fence=fence)
        with self._lock:
            if not incoming.supersedes(self._table):
                return
            old = self._table.assignments
            self._table = incoming
            self._table_transition(old, assignments)
            # A stale peer (one that missed the "sleave") may hand a
            # draining node its shards back; adopt for ordering, then
            # immediately supersede with a self-excluding recompute
            # (the tick's sleave re-broadcast heals the peer's view).
            readopted = self._draining and any(
                owner == self.address for owner in assignments.values()
            )
        if events.recorder.enabled:
            events.recorder.commit(
                events.SHARD_TABLE,
                version=version,
                shards=len(assignments),
                origin=origin,
            )
        if readopted:
            self._recompute_table(force=True)
            return
        self._scan_handoffs()

    def _table_transition(self, old: Dict[int, str], new: Dict[int, str]) -> None:
        """Shard-grant bookkeeping for one table change (caller holds
        the lock): hold every shard we GAIN from a live previous owner
        until that owner grants it; watch every shard we LOSE so we can
        grant it once our handoffs for it complete."""
        now = time.monotonic()
        was_provisional = self._provisional
        new_provisional = self._population_locked() <= 1
        self._provisional = new_provisional
        if not new_provisional:
            # Peers' early frames route by this table, after the holds
            # below are in place (the next deferred flush).
            for parked in self._early.values():
                self._deferred.extend(parked)
            self._early.clear()
        if new_provisional:
            # Sole member again: there is nobody left to wait on.
            for shard in list(self._holds):
                self._release_hold_locked(shard)
            return
        for shard, owner in new.items():
            prev = old.get(shard)
            if owner == self.address:
                if (
                    prev is not None
                    and prev != self.address
                    and (prev in self._members or prev in self._leaving)
                ):
                    # Gained from a live previous owner: hold until ITS
                    # grant (or death, or timeout).
                    self._holds[shard] = prev
                    self._hold_deadlines[shard] = now + self.hold_timeout_s
                elif (
                    prev == self.address
                    and was_provisional
                    and not new_provisional
                    and shard not in self._holds
                ):
                    # "Confirmed" to self out of the seed table: a node
                    # that just joined claimed the whole keyspace for a
                    # moment, so this ownership is not evidence that no
                    # peer is migrating the shard's entities to us.
                    # Hold for ANY peer's grant (owner None = any).
                    self._holds[shard] = None  # type: ignore[assignment]
                    self._hold_deadlines[shard] = now + self.hold_timeout_s
            elif shard in self._holds:
                # The shard moved on before we were granted it: whatever
                # we were holding belongs elsewhere now — re-route it.
                self._release_hold_locked(shard)
        for shard, prev in old.items():
            if prev == self.address and new.get(shard) != self.address:
                new_owner = new.get(shard)
                if new_owner is not None:
                    self._grant_watch[shard] = _GrantWatch(new_owner)
                self._holds.pop(shard, None)
                self._hold_deadlines.pop(shard, None)

    def _release_hold_locked(self, shard: int) -> None:
        """Caller holds the lock.  Clears the hold; buffered traffic is
        moved to the deferred queue (flushed next tick, re-routed by
        the then-current table)."""
        self._holds.pop(shard, None)
        self._hold_deadlines.pop(shard, None)
        for type_name, key, payload in self._hold_buffers.pop(shard, []):
            self._deferred.append((type_name, key, payload))

    def _release_hold(self, shard: int) -> None:
        with self._lock:
            self._release_hold_locked(shard)
        self._flush_deferred()

    def _flush_deferred(self) -> None:
        with self._lock:
            deferred, self._deferred = self._deferred, deque()  # unbounded: capped by deferred_limit in _defer
        for type_name, key, payload in deferred:
            self.route(type_name, key, payload)

    def _handoff_done(self, type_name: str, key: str) -> None:
        """MigrationManager callback: one outbound handoff acked.  When
        every handoff of a lost shard is done, grant the shard away."""
        shard = shard_of(key, self.num_shards)
        grant_to = None
        with self._lock:
            watch = self._grant_watch.get(shard)
            if watch is not None:
                watch.keys.discard((type_name, key))
                if not watch.keys and watch.scanned:
                    grant_to = watch.owner
                    del self._grant_watch[shard]
        if grant_to is not None:
            self._send_frame(
                grant_to,
                wire.encode_shard_grant(shard, self.address, self.current_fence),
            )

    def _gossip(self) -> None:
        table = self._table
        self._gossiped_version = table.version
        frame = wire.encode_shard_frame(
            table.version, table.origin, table.assignments, table.fence
        )
        for member in self.members():
            if member != self.address:
                self._send_frame(member, frame)

    def _scan_handoffs(self) -> None:
        """Hand off everything this node no longer owns: live entities
        migrate with their state, PASSIVATED entities ship their spilled
        snapshot (otherwise the store copy strands on the old owner and
        the new owner would recreate the entity blank)."""
        with self._lock:
            regions = list(self._regions.values())
        for region in regions:
            type_name = region.type_name
            for key in region.record_keys():
                if self._moves_away(key):
                    # Register EVERY record (active or mid-transition)
                    # against the grant watch; begin() is a no-op for
                    # non-ACTIVE records — a key mid-handoff resolves
                    # through its ack, a key mid-passivation spills to
                    # the store and ships on the next tick.
                    self._watch_key(type_name, key)
                    self.migrations.begin(region, key)
            for key in region.store.keys():
                if self._moves_away(key):
                    self._watch_key(type_name, key)
                    self.migrations.ship_passive(region, key)
        with self._lock:
            # The scan enumerated every region: watches are now fully
            # populated and may be granted once their keys drain.
            for watch in self._grant_watch.values():
                watch.scanned = True
        self._grant_ready()

    def _moves_away(self, key: str) -> bool:
        home = self.home_of(key)
        return home is not None and home != self.address

    def _watch_key(self, type_name: str, key: str) -> None:
        """Register an outbound handoff against its shard's grant watch
        BEFORE starting it, so the ack can never race the registration."""
        shard = shard_of(key, self.num_shards)
        with self._lock:
            watch = self._grant_watch.get(shard)
            if watch is not None:
                watch.keys.add((type_name, key))

    def _key_outstanding(self, type_name: str, key: str) -> bool:
        """Is any trace of this key still on this node (an unacked
        handoff, a live/transitioning record, a stored snapshot)?"""
        if self.migrations.is_pending(type_name, key):
            return True
        region = self._regions.get(type_name)
        if region is None:
            return False
        with region._lock:
            if key in region._entities:
                return True
        return region.store.contains(key)

    def _grant_ready(self) -> None:
        """Grant away every lost shard with no outstanding handoffs
        (pruning keys that already left by other means).  The
        outstanding probes take region locks, so they run OUTSIDE the
        cluster lock — an entity constructor may hold a region lock
        while routing (which takes the cluster lock), and nesting the
        other way around would deadlock."""
        with self._lock:
            snapshot = {
                s: set(w.keys)
                for s, w in self._grant_watch.items()
                if w.scanned
            }
        if not snapshot:
            return
        still_map = {
            shard: {(t, k) for (t, k) in keys if self._key_outstanding(t, k)}
            for shard, keys in snapshot.items()
        }
        ready: List[Tuple[int, str]] = []
        with self._lock:
            for shard, watch in list(self._grant_watch.items()):
                checked = still_map.get(shard)
                if checked is None:
                    continue
                # keys registered since the snapshot stay outstanding
                watch.keys = checked | (watch.keys - snapshot[shard])
                if not watch.keys:
                    del self._grant_watch[shard]
                    ready.append((shard, watch.owner))
        for shard, owner in ready:
            self._send_frame(
                owner,
                wire.encode_shard_grant(shard, self.address, self.current_fence),
            )

    def _tick(self) -> None:
        if self._closed:
            return
        self._ticks += 1
        if self.arbiter is not None:
            self._poll_arbiter()
            if self._quarantined:
                if not self._quarantine_checkpointed:
                    # Re-sweep for stray activations that raced the
                    # quarantine flag, then freeze once truly drained.
                    if (
                        self._quarantine_scan() == 0
                        and self._quarantine_drained()
                    ):
                        self._quarantine_settle()
            elif self._ticks % 5 == 0:
                # Periodic membership anti-entropy: fence sync for
                # laggards, disagreement detection for the
                # split_brain_suspected alert.
                self._broadcast_mship()
        # Anti-entropy gossip heals dropped gossip frames, but a quiet
        # cluster does not need the full table rebroadcast 10x/second:
        # gossip immediately when the version moved, else every 5th tick.
        if self._table.version != self._gossiped_version or self._ticks % 5 == 0:
            self._gossip()
        if self._draining:
            # Re-broadcast the departure until death: a peer that
            # missed the one-shot "sleave" keeps assigning shards back.
            self._broadcast_leave()
        if self._quarantined:
            # Not serving: no handoffs, no passivation, no deferred
            # flush (route would only re-park everything) — just wait
            # for the drain to settle and the heal handshake to arrive.
            return
        self.migrations.retry_due()
        now = time.monotonic()
        with self._lock:
            regions = list(self._regions.values())
            multi_member = self._population_locked() > 1
            for shard in [
                s for s, d in self._hold_deadlines.items() if d <= now
            ]:
                # Safety valve: a grant that never arrives (lost frame
                # from a wedged-but-not-dead peer) must not hold the
                # shard's traffic forever.
                self._release_hold_locked(shard)
        for region in regions:
            region.passivation.scan(region)
            # Late spills: a snapshot that landed in the store AFTER
            # the rebalance scan (its key was mid-passivation then)
            # still belongs elsewhere — ship it now.  Single-member
            # clusters skip the walk: nothing can move away.
            if multi_member:
                for key in region.store.keys():
                    if self._moves_away(key):
                        self._watch_key(region.type_name, key)
                        self.migrations.ship_passive(region, key)
        if self.journal is not None:
            self.journal.flush_due()
            # Segment rolls queue re-snapshots so old segments compact;
            # enqueue a capture for every owed key that is active here.
            for type_name, shard, key in self.journal.resnap_due():
                region = self._regions.get(type_name)
                if region is None:
                    continue
                with region._lock:
                    rec = region._entities.get(key)
                    if rec is None or rec.status != _ACTIVE or rec.cell is None:
                        continue
                    epoch = self.journal.begin_snapshot(type_name, shard, key)
                    rec.cell.tell_unbounded(_JournalSnapCmd(region, key, epoch))
        self._grant_ready()
        self._flush_deferred()

    def _handle_ent_frame(self, from_address: str, frame: tuple) -> None:
        """One entity-routed message: decode the payload (schema or
        pickle, by magic) and route.  Runs on the transport receive
        thread (hot path) or the coordinator (local loopback sends)."""
        decoded = wire.decode_entity_frame(frame)
        if decoded is None:
            return
        type_name, key, hops, payload_bytes, fence = decoded
        try:
            payload = wire.decode_message(self._codec, payload_bytes)
        except Exception:
            import traceback

            traceback.print_exc()
            return
        if fence > self.current_fence:
            # Routed under a NEWER partition era than ours: WE are the
            # stale side.  Park the message (it re-routes after the
            # handshake catches us up) and ask the sender for its view.
            if events.recorder.enabled:
                events.recorder.commit(
                    events.FENCE_REJECTED,
                    site="ent",
                    key=key,
                    type=type_name,
                    fence=fence,
                )
            self._defer(type_name, key, payload)
            self._send_mship(from_address)
            return
        if self._park_early(from_address, type_name, key, payload):
            return
        if self.home_of(key) != self.address and events.recorder.enabled:
            events.recorder.commit(
                events.SHARD_FORWARDED, key=key, type=type_name, hops=hops
            )
        self.route(type_name, key, payload, hops=hops)

    def _park_early(
        self, from_address: str, type_name: str, key: str, payload: Any
    ) -> bool:
        """Park a peer's entity frame while this node is provisional.
        The sender routed by a table that names this node, so it is a
        member this node has not processed yet; the seed table claims
        every shard, and a delivery now would spawn the key blank here
        while the sender's handoff of its state is still to come (the
        reference delivers it, and the handoff then loses to the blank
        entity: ``shard.state_conflict``).  True when parked."""
        if from_address == self.address:
            return False
        with self._lock:
            if not self._provisional or from_address in self._gone:
                return False
            parked = self._early.setdefault(from_address, deque())
            if self.deferred_limit and len(parked) >= self.deferred_limit:
                d_type, d_key, _d_payload = parked.popleft()
                if events.recorder.enabled:
                    events.recorder.commit(
                        events.SHARD_BUFFER_DROPPED,
                        site="early",
                        key=d_key,
                        type=d_type,
                    )
            parked.append((type_name, key, payload))
        return True

    def _handle_frame(self, from_address: str, frame: tuple) -> None:
        kind = frame[0]
        if kind == "shard":
            decoded = wire.decode_shard_frame(frame)
            if decoded is not None:
                self._adopt_table(*decoded)
        elif kind == "ent":
            self._handle_ent_frame(from_address, frame)
        elif kind == "mig":
            self.migrations.apply_incoming(from_address, frame)
        elif kind == "miga":
            self.migrations.on_ack(frame)
        elif kind == "sgrant":
            decoded = wire.decode_shard_grant(frame)
            if decoded is None:
                return
            shard, origin, fence = decoded
            if fence < self.current_fence:
                # A grant minted under a superseded era (a stale owner
                # releasing ownership it no longer holds): refuse it —
                # the hold's timeout is the legitimate escape.
                if events.recorder.enabled:
                    events.recorder.commit(
                        events.FENCE_REJECTED,
                        site="sgrant",
                        shard=shard,
                        origin=origin,
                        fence=fence,
                    )
                return
            with self._lock:
                holder = self._holds.get(shard, _NOT_HELD)
                granted = holder is not _NOT_HELD and (
                    holder is None or holder == origin
                )
            if granted:
                self._release_hold(shard)
        elif kind == "sleave":
            origin = wire.decode_shard_leave(frame)
            if origin is not None:
                self._member_leaving(origin)
        elif kind == "mship":
            self._on_mship(from_address, frame)

    # -- observability ----------------------------------------------- #

    def gauge_value(self, field: str) -> Optional[float]:
        """Cheap single-field read for the telemetry gauges — a metrics
        scrape polls six fields, and rebuilding the full :meth:`stats`
        walk (every region lock + the migration lock) per gauge would
        multiply lock contention on the routing path for nothing."""
        if field == "table_size":
            return len(self._table.assignments)
        if field == "table_version":
            return self._table.version
        if field == "migrations_pending":
            return self.migrations.pending_count()
        if field == "journal_unsynced":
            return (
                self.journal.unsynced_records()
                if self.journal is not None
                else None
            )
        if field == "journal_live_keys":
            return (
                self.journal.live_keys() if self.journal is not None else None
            )
        if field == "journal_segments":
            return (
                self.journal.segment_count()
                if self.journal is not None
                else None
            )
        with self._lock:
            regions = list(self._regions.values())
        if field == "active":
            return sum(r.active_count() for r in regions)
        if field == "passivated":
            return sum(r.passive_count() for r in regions)
        if field == "buffered":
            return sum(r.buffered_depth() for r in regions)
        return None

    def stats(self) -> Dict[str, Any]:
        # Region counters are read OUTSIDE the cluster lock (same
        # ordering rule as _grant_ready: region locks never nest inside
        # the cluster lock).
        with self._lock:
            regions = list(self._regions.values())
            table = self._table
            held = len(self._holds)
            draining = self._draining
            leaving = sorted(self._leaving)
        out = {
            "table_version": table.version,
            "table_size": len(table.assignments),
            "table_fence": table.fence,
            "held_shards": held,
            "members": self.members(),
            "draining": draining,
            "leaving": leaving,
            "quarantined": self._quarantined,
            "active": sum(r.active_count() for r in regions),
            "passivated": sum(r.passive_count() for r in regions),
            "buffered": sum(r.buffered_depth() for r in regions),
            "migrations_pending": self.migrations.pending_count(),
            "regions": [r.stats() for r in regions],
        }
        if self.arbiter is not None:
            out["membership"] = self.arbiter.stats()
        if self.journal is not None:
            out["journal"] = self.journal.stats()
        return out
