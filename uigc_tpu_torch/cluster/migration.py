"""Copy of ``uigc_tpu/cluster/migration.py`` (pure Python).  What
differs: the handoff capture reads the state through
``sharding.captured_state`` (a ref to the entity's own descendant, which
stops with it, becomes None); the reference captures
``snapshot_state()`` as is.

Live entity migration: quiesce, snapshot, ship, reconstruct, forward.

One handoff is a four-step protocol between two shard regions:

1. **Quiesce** — the source region flips the key into the ``handoff``
   state *before* enqueuing the capture command, holding the region
   lock across the tell; every message routed afterwards buffers in the
   region, so the capture command is provably the entity's last input.
2. **Capture** — the entity processes :class:`_HandoffCmd` on its own
   dispatcher thread: it snapshots behavior state, drains whatever the
   mailbox still holds (stragglers sent outside the region path), fires
   the :meth:`~uigc_tpu_torch.engines.engine.EngineTap.on_migrate_out` tap,
   hands everything to the migration manager and returns ``stopped`` —
   the normal termination protocol, whose engine-side death accounting
   (CRGC ``pre_signal``) flushes a sound final entry.
3. **Ship** — the state rides a ``"mig"`` wire frame.  The frame can be
   dropped, duplicated or partitioned by a ``FaultPlan``; the manager
   keeps the encoded state and *re-sends on a timer until acked*, and
   the receiver dedups by migration id and by already-active key — so a
   faulty link can neither lose nor duplicate entity state.
4. **Reconstruct + forward** — the target spawns the entity from the
   snapshot (refs re-registered through ITS engine via
   :func:`translate_refs`, announced by ``on_migrate_in``), delivers the
   shipped pending messages, then acks.  On the ack the source drops
   its tombstone record and re-routes everything it buffered — to the
   new home, so stragglers forward instead of dead-lettering.

If the target dies mid-handoff the next retry re-resolves the key's
home from the *current* shard table; if the table has swung back to the
source itself, the state is applied locally — a migration can bounce
but cannot strand.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Dict, List, Tuple

from ..interfaces import GCMessage, Refob
from ..runtime import wire
from ..runtime.behaviors import Behaviors
from ..utils import events
from .sharding import (
    _ACTIVE,
    _EntityCtl,
    _HANDOFF,
    _NOT_HELD,
    captured_state,
    shard_of,
)

if TYPE_CHECKING:  # pragma: no cover
    from .sharding import ClusterSharding, Entity, ShardRegion


def translate_refs(obj: Any, ctx: Any) -> Any:
    """Re-register every Refob reachable in a restored snapshot through
    the destination engine: each becomes a fresh ref created for the
    new entity incarnation (``ctx.create_ref``), so the shadow graph
    gains the (entity -> target) edges that keep snapshot-held targets
    provably alive.  Containers (dict/list/tuple/set) are rebuilt;
    everything else passes through untouched."""
    if isinstance(obj, Refob):
        return ctx.create_ref(obj, ctx.self_ref)
    if isinstance(obj, dict):
        return {
            translate_refs(k, ctx): translate_refs(v, ctx)
            for k, v in obj.items()
        }
    if isinstance(obj, list):
        return [translate_refs(v, ctx) for v in obj]
    if isinstance(obj, tuple):
        return tuple(translate_refs(v, ctx) for v in obj)
    if isinstance(obj, set):
        return {translate_refs(v, ctx) for v in obj}
    return obj


def _drain_for_capture(ctx: Any) -> List[Any]:
    """Drain the capturing entity's mailbox and return the payloads to
    forward.  A mailbox holds a MIX: engine envelopes (AppMsg-like
    GCMessages carrying ``payload``) from managed senders, and RAW
    payloads from external tells — the root adapter wraps at invoke
    time, not at enqueue.

    Every managed envelope is first routed through the engine's
    dead-letter accounting (``on_dead_letter``): the sender's egress
    already stamped the send, so without the synthetic receive the
    stopped entity's shadow would keep a permanently nonzero recv
    balance (a pseudoroot that pins everything it references — the
    exact leak class the dead-letter accounting closed), and the
    refs the envelope carried would never release.  The PAYLOAD is then
    forwarded to the new incarnation as fresh external traffic — the
    envelope died with the old cell, the content survives; any refs
    riding it follow the entity-message contract (unmanaged root
    references)."""
    drained = ctx.cell.drain_mailbox()
    out = []
    engine = ctx.engine
    cell = ctx.cell
    for msg in drained:
        if isinstance(msg, GCMessage):
            if not hasattr(msg, "payload"):
                continue  # engine control (StopMsg/WaveMsg): no content
            # NOTE: the payload itself may legitimately be None (a user
            # sent None) — discriminate by the slot, not the value, or
            # that message would vanish unaccounted.
            try:
                engine.on_dead_letter(cell, msg)
            except Exception:  # accounting must not abort the capture
                import traceback

                traceback.print_exc()
            out.append(msg.payload)
        else:
            out.append(msg)
    return out


class _HandoffCmd(_EntityCtl):
    """Capture command for a live migration; delivered as the entity's
    last region-routed message."""

    __slots__ = ("region",)

    def __init__(self, region: "ShardRegion"):
        self.region = region

    def apply(self, entity: "Entity") -> Any:
        ctx = entity.context
        snapshot = captured_state(entity)
        pending = _drain_for_capture(ctx)
        tap = ctx.engine.tap
        if tap is not None:
            try:
                tap.on_migrate_out(ctx.cell, entity.key)
            except Exception:  # taps observe, never alter control flow
                import traceback

                traceback.print_exc()
        self.region.cluster.migrations._captured(
            self.region, entity.key, snapshot, pending
        )
        return Behaviors.stopped()


class _Migration:
    """One in-flight outbound handoff, kept until acked."""

    __slots__ = (
        "region",
        "key",
        "mig_id",
        "blob",
        "epoch",
        "started",
        "last_sent",
        "attempts",
    )

    def __init__(
        self,
        region: "ShardRegion",
        key: str,
        mig_id: tuple,
        blob: bytes,
        epoch: int = 0,
    ):
        self.region = region
        self.key = key
        self.mig_id = mig_id
        self.blob = blob
        #: the source-side journal epoch of the captured state; ships
        #: on the mig frame so the destination's activation epoch
        #: strictly supersedes it
        self.epoch = epoch
        self.started = time.monotonic()
        self.last_sent = 0.0
        self.attempts = 0


class MigrationManager:
    """Owns every outbound handoff of one node plus the inbound dedup
    window.  Driven by the cluster coordinator (begin/scan/retry) and by
    entity dispatcher threads (capture completion)."""

    def __init__(self, cluster: "ClusterSharding"):
        self.cluster = cluster
        self._lock = threading.Lock()
        #: (type_name, key) -> _Migration awaiting ack
        self._pending: Dict[Tuple[str, str], _Migration] = {}
        self._seq = itertools.count(1)
        #: inbound dedup: recently applied migration ids (a duplicated
        #: or retried "mig" frame must not reconstruct twice)
        self._applied: set = set()
        self._applied_order: deque = deque(maxlen=4096)
        #: completed-handoff count, for stats/benches
        self.completed = 0

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def is_pending(self, type_name: str, key: str) -> bool:
        with self._lock:
            return (type_name, key) in self._pending

    # -- outbound ----------------------------------------------------- #

    def begin(self, region: "ShardRegion", key: str) -> bool:
        """Start handing off ``key`` (idempotent: a key already mid
        handoff is left alone)."""
        with self._lock:
            if (region.type_name, key) in self._pending:
                return False
        return region._begin_transition(key, _HANDOFF, _HandoffCmd(region))

    def ship_passive(self, region: "ShardRegion", key: str) -> bool:
        """Hand off a PASSIVATED entity: no cell to quiesce — the
        spilled snapshot ships directly.  A placeholder record keeps
        traffic for the key buffering while the state is in flight
        (exactly like a live handoff's tombstone)."""
        from .sharding import _EntityRecord

        if self.is_pending(region.type_name, key):
            return False
        with region._lock:
            if key in region._entities:
                return False  # reactivated meanwhile: the live scan owns it
            snapshot = region.store.pop(key)
            if snapshot is None:
                return False  # already gone (delivered or shipped)
            region._entities[key] = _EntityRecord(None, _HANDOFF)
            region._buffers.setdefault(key, deque())
        self._captured(region, key, snapshot, [])
        return True

    def _captured(
        self,
        region: "ShardRegion",
        key: str,
        snapshot: Any,
        pending: List[Any],
    ) -> None:
        """Entity-thread completion of the capture: encode once, then
        ship (and keep for retries)."""
        epoch = 0
        if region.cluster.journal is not None:
            # Journal checkpoint at the handoff boundary: the captured
            # snapshot (plus the drained-but-unprocessed pending tail)
            # becomes the key's newest epoch, so a crash anywhere
            # between capture and ack leaves the state recoverable by
            # whoever inherits the shard.  Safe without the region
            # lock: the key is mid-HANDOFF, so no concurrent delivery
            # can interleave commands for it.
            try:
                epoch = region._journal_open(key, snapshot) or 0
                for payload in pending:
                    region._journal_command(key, payload)
            except Exception:  # durability must not abort the handoff
                import traceback

                traceback.print_exc()
        blob = wire.encode_message((snapshot, pending))
        mig = _Migration(
            region, key, (self.cluster.address, next(self._seq)), blob, epoch
        )
        with self._lock:
            self._pending[(region.type_name, key)] = mig
        self._ship(mig)

    def _ship(self, mig: _Migration) -> None:
        cluster = self.cluster
        mig.last_sent = time.monotonic()
        mig.attempts += 1
        home = cluster.home_of(mig.key)
        if home is None:
            return  # membership vacuum: the retry timer re-resolves
        # Fence-stamped at SEND time (not capture time): a handoff that
        # survives a heal re-ships under the ADOPTED era and becomes
        # acceptable again — only a sender still living in a superseded
        # era is refused.
        frame = wire.encode_migration_frame(
            mig.region.type_name,
            mig.key,
            mig.mig_id,
            mig.blob,
            cluster.current_fence,
            mig.epoch,
        )
        if home == cluster.address:
            # The table swung back to us (the target died mid-handoff):
            # apply our own state locally instead of shipping.
            self.apply_incoming(cluster.address, frame)
            return
        cluster._send_frame(home, frame)

    def retry_due(self) -> None:
        """Timer-driven at-least-once shipping: re-send every unacked
        handoff whose retry interval elapsed, re-resolving the target
        from the current table each time."""
        now = time.monotonic()
        with self._lock:
            due = [
                m
                for m in self._pending.values()
                if now - m.last_sent >= self.cluster.retry_s
            ]
        for mig in due:
            self._ship(mig)

    def retarget_dead(self, address: str) -> None:
        """A member died: anything we were shipping to it re-resolves
        on the next retry; force that retry now."""
        with self._lock:
            for mig in self._pending.values():
                mig.last_sent = 0.0
        self.retry_due()

    def on_ack(self, frame: tuple) -> None:
        decoded = wire.decode_migration_ack(frame)
        if decoded is None:
            return
        type_name, key, mig_id = decoded
        with self._lock:
            mig = self._pending.get((type_name, key))
            if mig is None or mig.mig_id != tuple(mig_id):
                return  # stale ack (an earlier incarnation's)
            del self._pending[(type_name, key)]
            self.completed += 1
        duration = time.monotonic() - mig.started
        if events.recorder.enabled:
            events.recorder.commit(
                events.SHARD_MIGRATION,
                duration_s=duration,
                key=key,
                type=type_name,
                src=self.cluster.address,
                dst=self.cluster.home_of(key),
            )
        # Tombstone flush: everything buffered during the handoff
        # re-routes — the table now names the new home, so stragglers
        # forward instead of dead-lettering.
        buffered = mig.region._finish_transition(key)
        journal = self.cluster.journal
        if journal is not None:
            # The key left this node: stop tracking it — UNLESS the
            # handoff bounced home (the record re-activated locally
            # before this self-ack landed), where the live epoch must
            # keep numbering forward.  Check + forget under the region
            # lock as ONE step: a re-activation racing between them
            # would have its fresh epoch tracking erased (every
            # activation path opens the epoch under this same lock).
            with mig.region._lock:
                if mig.region._entities.get(key) is None:
                    journal.forget(type_name, key)
        for payload in buffered:
            self.cluster.route(type_name, key, payload)
        # Grant bookkeeping: this may have been the shard's last key.
        self.cluster._handoff_done(type_name, key)

    # -- inbound ------------------------------------------------------ #

    def apply_incoming(self, from_address: str, frame: tuple) -> None:
        decoded = wire.decode_migration_frame(frame)
        if decoded is None:
            return
        type_name, key, mig_id, blob, fence, src_epoch = decoded
        mig_id = tuple(mig_id)
        cluster = self.cluster
        if cluster._quarantined:
            return  # not serving: no ack, the sender re-resolves
        if fence < cluster.current_fence:
            # State shipped under a superseded partition era — a stale
            # owner's post-partition copy.  Refused, never merged: no
            # ack and no dedup entry, so a sender that heals and adopts
            # the current fence gets a full fresh attempt.
            if events.recorder.enabled:
                events.recorder.commit(
                    events.FENCE_REJECTED,
                    site="mig",
                    key=key,
                    type=type_name,
                    src=from_address,
                    fence=fence,
                )
            return
        region = cluster._regions.get(type_name)
        if region is None:
            return  # type not started here; sender keeps retrying
        shard = shard_of(key, cluster.num_shards)
        with cluster._lock:
            holder = cluster._holds.get(shard, _NOT_HELD)
        if holder is not _NOT_HELD and holder is not None and holder != from_address:
            # The shard is held for a DIFFERENT previous owner whose
            # state is authoritative.  This frame is a stale copy (an
            # earlier handoff whose ack was lost before the table moved
            # on): deliberately no ack — the sender retries after the
            # hold resolves, when the authoritative incarnation is
            # resident and the stale snapshot is safely discarded.
            return
        with self._lock:
            duplicate = mig_id in self._applied
        if duplicate:
            self._ack(from_address, type_name, key, mig_id)
            return
        try:
            snapshot, pending = wire.decode_message(cluster._codec, blob)
        except Exception:
            import traceback

            traceback.print_exc()
            # Undecodable state: no ack AND no dedup entry — the retry
            # must get a full fresh attempt, not a duplicate-ack that
            # would destroy the sender's only copy.
            return
        with region._lock:
            rec = region._entities.get(key)
            if rec is not None and rec.status == _ACTIVE:
                # The key is already live here (recreated on demand in
                # a table-divergence window the shard-hold protocol
                # could not cover).  The resident incarnation wins —
                # its processed messages are real — and the shipped
                # pending messages are delivered, so no MESSAGE is lost
                # or duplicated; the dropped snapshot is surfaced as a
                # structured conflict, never silently.
                if snapshot is not None and events.recorder.enabled:
                    events.recorder.commit(
                        events.SHARD_STATE_CONFLICT,
                        key=key,
                        type=type_name,
                        src=from_address,
                    )
                for payload in pending:
                    region.deliver_local(key, payload)
            elif rec is not None:
                # The key is mid-transition HERE.  Two cases:
                if from_address == cluster.address and self.is_pending(
                    type_name, key
                ):
                    # Our own bounced handoff (the table swung back
                    # before the target acked): the record is our
                    # tombstone, not a resident — reconstruct over it.
                    region._reactivate(
                        key, snapshot, pending,
                        migrated=True, min_epoch=src_epoch,
                    )
                else:
                    # A foreign snapshot colliding with our own in-
                    # flight capture: applying now could double-spawn
                    # against a still-live cell.  No ack — the sender
                    # retries once our transition resolves.
                    return
            else:
                region.store.pop(key)
                region._reactivate(
                    key, snapshot, pending, migrated=True, min_epoch=src_epoch
                )
        with self._lock:
            self._remember(mig_id)
        self._ack(from_address, type_name, key, mig_id)

    def _remember(self, mig_id: tuple) -> None:
        # caller holds self._lock
        if len(self._applied_order) == self._applied_order.maxlen:
            self._applied.discard(self._applied_order[0])
        self._applied_order.append(mig_id)
        self._applied.add(mig_id)

    def _ack(self, to_address: str, type_name: str, key: str, mig_id: tuple) -> None:
        self.cluster._send_frame(
            to_address, wire.encode_migration_ack(type_name, key, mig_id)
        )
