"""Copy of ``uigc_tpu/cluster/journal.py`` (pure Python); only the
package-relative imports resolve to the port's modules.  The on-disk
format (segment names, ``uJ`` frames, the pickled record tuple) is the
reference's byte for byte, so a journal directory written by either
package replays in the other: ``EntityJournal.recover`` merges a key's
records, and ``ShardRegion._recover_from_journal`` (``sharding.py``)
decodes the state and the commands it replays.

Event-sourced entity journal: CRC-framed segments, snapshot + replay.

The sharding layer made entities placeable and migratable, but
their state still died with the node: ``NodeFabric.die()`` lost every
active entity it hosted, and the shard-grant path rehomed dead shards
by spawning entities *blank*.  This module is the durability plane
underneath: every command a region delivers is appended to a per-shard
segment file before the entity sees it, periodic
``Entity.snapshot_state()`` snapshots bound replay length, and recovery
reconstructs an entity as *latest snapshot + command replay* — on the
node that inherits the shard, not the one that died.

Layout (``uigc.cluster.journal-dir``; "" disables journaling)::

    <dir>/<type>/<shard>/<node>.<segment>.uj

Nodes of one cluster share the directory (the shared-disk model — in
tests and the serving bench that is a tmpdir, in a deployment a mounted
volume), but each node appends ONLY to its own files, so there is no
write contention and no cross-process locking.  Recovery reads every
file of a shard and merges per key.

Record framing — the torn-write contract::

    b"uJ" | u32 payload_len | u32 crc32(payload) | payload

``payload`` pickles ``(key, epoch, seq, kind, blob)``.  A crash (real,
or the FaultPlan's ``torn_journal_append``) can tear the tail of the
last record; a recovery scan verifies magic, length and CRC per frame
and STOPS that file at the first bad frame, reporting
``journal.torn_record`` — everything before the tear replays, nothing
after it is guessed at.

Epoch/seq semantics — how snapshots supersede commands:

- Every activation of a key on a node opens a new **epoch** (one past
  the highest epoch visible for the key, across all files) and writes a
  snapshot record at ``seq 0`` — the migrated/resumed/recovered state
  as of that instant.
- Commands append at ``seq 1, 2, ...`` within the epoch.
- A periodic snapshot (every ``journal-snapshot-every`` commands, or on
  segment roll) *bumps the epoch at enqueue time* under the region
  lock, so commands journaled before the bump are exactly the commands
  whose effects the snapshot will contain; the snapshot record itself
  is written later, from the entity's own thread.
- Replay sorts a key's records by ``(epoch, seq)``, takes the LAST
  snapshot as the base, and re-applies every later command — including
  commands of a newer epoch whose snapshot never landed (the crash hit
  between bump and capture).

Compaction: a segment past ``journal-segment-bytes`` rolls to a fresh
file; keys whose current epoch still starts in an old segment are
re-snapshotted (the region drives this from the cluster tick), and a
segment every one of whose records is superseded by a newer epoch in a
newer segment is deleted.  Only a node's OWN segments are ever deleted
— a dead peer's files are someone's recovery source, never garbage.

Fenced epochs: every record additionally carries the writer's
**fence** — the partition era minted by the membership arbiter
(cluster/membership.py).  Within one fence the hybrid-logical epochs
order activations exactly as before; ACROSS fences the wall clock can
no longer be trusted (a partitioned minority keeps appending under
fresh wall-ms epochs while the majority, which bumped its fence on the
split-brain verdict, opens its own).  Recovery therefore resolves per
key: the highest fence wins, and any lower-fence record whose epoch
claims to supersede the high-fence base is a **conflict** — counted,
reported (``cluster.fence_rejected`` site="recovery") and QUARANTINED
out of the replay, never silently merged.  Lower-fence records that
predate the high-fence base (ordinary history the survivor's
activation already saw) replay normally, which is what lets a healed
minority's non-conflicting journal suffix survive the merge.  A node
the arbiter downs has its append plane **frozen**: post-verdict
command appends are refused at the append site
(``uigc_fence_rejected_total{site="journal"}``), so zero fenced-stale
appends can reach a recovery merge.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..utils import events

_MAGIC = b"uJ"
_HEADER = struct.Struct(">2sII")

#: record kinds
_SNAP = "s"
_CMD = "c"

#: Epochs are hybrid-logical: ``max(highest_seen + 1, wall_ms)``.  The
#: wall-clock floor makes a LATER activation supersede an earlier one
#: even when the activating node's view of peer segment files is stale
#: (scans are cached between membership changes; a checkpoint a peer
#: appended moments ago may not be visible yet).  Within one host —
#: every test and bench topology — wall time is shared; cross-host
#: deployments of the shared-disk journal inherit the usual
#: clock-skew caveat.  Milliseconds since 2026-01-01 keep the ints
#: compact.
_EPOCH_BASE_MS = 1_767_225_600_000


def _epoch_floor() -> int:
    return time.time_ns() // 1_000_000 - _EPOCH_BASE_MS


def _frame_record(payload: bytes) -> bytes:
    return _HEADER.pack(_MAGIC, len(payload), zlib.crc32(payload)) + payload


def _safe_component(text: str) -> str:
    out = []
    for ch in text:
        out.append(ch if ch.isalnum() or ch in "._-" else "_")
    return "".join(out)[:80]


class _Writer:
    """One node's open append handle for one (type, shard)."""

    __slots__ = (
        "dirpath",
        "prefix",
        "segment",
        "fh",
        "bytes",
        "unsynced",
        "last_sync",
        "segment_keys",
        "segment_snaps",
    )

    def __init__(self, dirpath: str, prefix: str, segment: int):
        self.dirpath = dirpath
        self.prefix = prefix
        self.segment = segment
        self.fh = open(self._path(segment), "ab")
        self.bytes = self.fh.tell()
        self.unsynced = 0
        self.last_sync = time.monotonic()
        #: per OWN segment: key -> highest epoch recorded in it (any
        #: record kind)
        self.segment_keys: Dict[int, Dict[str, int]] = {segment: {}}
        #: per OWN segment: key -> highest COMMITTED SNAPSHOT epoch.
        #: The compaction proof: a segment is deletable only when every
        #: key in it has a SNAPSHOT at a strictly higher epoch in a
        #: newer segment — bare commands of a bumped epoch whose
        #: capture never landed do NOT supersede (recovery still needs
        #: the old base to replay under them).
        self.segment_snaps: Dict[int, Dict[str, int]] = {segment: {}}

    def _path(self, segment: int) -> str:
        return os.path.join(self.dirpath, f"{self.prefix}.{segment:05d}.uj")

    def roll(self) -> None:
        try:
            self.fh.flush()
            os.fsync(self.fh.fileno())
        except (OSError, ValueError):
            pass
        self.fh.close()
        self.segment += 1
        self.fh = open(self._path(self.segment), "ab")
        self.bytes = 0
        self.unsynced = 0
        self.segment_keys[self.segment] = {}
        self.segment_snaps[self.segment] = {}

    def close(self) -> None:
        try:
            self.fh.flush()
            os.fsync(self.fh.fileno())
        except (OSError, ValueError):
            pass
        try:
            self.fh.close()
        except OSError:
            pass


class EntityJournal:
    """One node's journal handle: append plane + recovery plane.

    Thread-safety: one lock serializes appends and writer management
    (regions already serialize per key under their own lock; the
    journal lock makes cross-region appends to one shard file safe).
    Recovery scans read closed byte ranges of files and take the same
    lock only to consult the in-memory live map.
    """

    def __init__(
        self,
        base_dir: str,
        node: str,
        fsync: str = "interval",
        fsync_interval_s: float = 0.05,
        segment_bytes: int = 1 << 20,
        snapshot_every: int = 64,
        fault_fn: Optional[Callable[[int], Optional[int]]] = None,
    ):
        self.base_dir = base_dir
        self.node = node
        self.node_safe = _safe_component(node)
        self.fsync = fsync
        self.fsync_interval_s = fsync_interval_s
        self.segment_bytes = segment_bytes
        self.snapshot_every = max(1, snapshot_every)
        #: FaultPlan.journal_append hook: framed-record size -> None or
        #: the byte prefix to write before the simulated crash
        self.fault_fn = fault_fn
        self._lock = threading.Lock()
        self._writers: Dict[Tuple[str, int], _Writer] = {}
        #: (type, key) -> [epoch, seq, shard, epoch_segment] for keys
        #: THIS node is currently journaling
        self._live: Dict[Tuple[str, str], list] = {}
        #: lazily loaded per-shard recovery indexes; invalidated on
        #: membership change (a peer's files may have grown)
        self._recover_cache: Dict[Tuple[str, int], Dict[str, list]] = {}
        #: file-granular parse cache underneath the shard index:
        #: path -> ((size, mtime_ns), parsed records).  Shard-index
        #: invalidation is cheap-by-design (membership changes clear it
        #: wholesale), so without this layer every invalidation
        #: re-parsed EVERY segment of every shard — after a partition
        #: era's extra segments that rescan dominated recovery time
        #: (the per-shard-scan cost).  Append-only
        #: files revalidate with one stat: same size+mtime = same
        #: records.
        self._file_cache: Dict[str, Tuple[tuple, list]] = {}
        #: (type, shard, key) sets due a re-snapshot after a roll
        self._resnap_due: Set[Tuple[str, int, str]] = set()
        #: the torn-append injection (or a real I/O error) killed the
        #: append plane — everything after the tear is lost, as it
        #: would be in the crashed process this simulates
        self._dead = False
        #: current partition era, stamped on every record (the arbiter
        #: updates it; 0 = the pre-fencing era)
        self.fence = 0
        #: the arbiter downed this node: command appends are refused
        #: until a heal-time rejoin unfreezes under the new fence
        self._frozen = False
        # counters for gauges/stats
        self.appended_records = 0
        self.appended_bytes = 0
        self.recovered_entities = 0
        self.torn_records = 0
        #: lower-fence records quarantined out of recovery merges
        self.fence_conflicts = 0
        #: appends refused while frozen (the stale-owner reject site)
        self.fence_rejected_appends = 0

    # ------------------------------------------------------------- #
    # Append plane
    # ------------------------------------------------------------- #

    def _shard_dir(self, type_name: str, shard: int) -> str:
        return os.path.join(
            self.base_dir, _safe_component(type_name), f"{shard:05d}"
        )

    def _writer(self, type_name: str, shard: int) -> _Writer:
        key = (type_name, shard)
        writer = self._writers.get(key)
        if writer is None:
            dirpath = self._shard_dir(type_name, shard)
            os.makedirs(dirpath, exist_ok=True)
            # resume past our own highest existing segment (restart
            # with a reused address must never append to a file a torn
            # tail may end)
            prefix = self.node_safe
            existing = [
                int(name[len(prefix) + 1 : -3])
                for name in os.listdir(dirpath)
                if name.startswith(prefix + ".") and name.endswith(".uj")
            ]
            segment = (max(existing) + 1) if existing else 0
            writer = self._writers[key] = _Writer(dirpath, prefix, segment)
        return writer

    def _append(
        self,
        type_name: str,
        shard: int,
        key: str,
        epoch: int,
        seq: int,
        kind: str,
        blob: Optional[bytes],
    ) -> None:
        """Caller holds ``self._lock``."""
        if self._dead:
            return
        if self._frozen:
            # Fenced-stale append: the arbiter downed this node, so its
            # writes must never reach a recovery merge.  Refused HERE —
            # at the append site — not discovered later by the merge.
            self.fence_rejected_appends += 1
            if events.recorder.enabled:
                events.recorder.commit(
                    events.FENCE_REJECTED,
                    site="journal",
                    key=key,
                    type=type_name,
                    fence=self.fence,
                )
            return
        payload = pickle.dumps(
            (key, epoch, seq, kind, blob, self.fence),
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        frame = _frame_record(payload)
        writer = self._writer(type_name, shard)
        keep = None
        if self.fault_fn is not None:
            keep = self.fault_fn(len(frame))
        try:
            if keep is not None:
                # Simulated crash mid-write: the prefix reaches the
                # file (flushed — the kernel had accepted it), the rest
                # never does, and this journal stops acting, exactly
                # like the process dying inside write(2).
                writer.fh.write(frame[:keep])
                writer.fh.flush()
                self._dead = True
                return
            writer.fh.write(frame)
            writer.fh.flush()
        except (OSError, ValueError):
            self._dead = True
            return
        writer.bytes += len(frame)
        writer.unsynced += 1
        writer.segment_keys.setdefault(writer.segment, {})
        seg_keys = writer.segment_keys[writer.segment]
        prev = seg_keys.get(key)
        if prev is None or epoch > prev:
            seg_keys[key] = epoch
        if kind == _SNAP:
            seg_snaps = writer.segment_snaps.setdefault(writer.segment, {})
            prev_snap = seg_snaps.get(key)
            if prev_snap is None or epoch > prev_snap:
                seg_snaps[key] = epoch
        # Keep a loaded recovery index current with our own appends —
        # a same-node recover() after journaling must see them without
        # a rescan (cross-node growth is handled by invalidate_cache on
        # membership/table changes).
        cached = self._recover_cache.get((type_name, shard))
        if cached is not None:
            records = cached.setdefault(key, [])
            records.append((epoch, seq, kind, blob, self.fence, self.node_safe))
            if len(records) > 1 and records[-2][:2] > (epoch, seq):
                records.sort(key=lambda r: (r[0], r[1]))
        self.appended_records += 1
        self.appended_bytes += len(frame)
        if self.fsync == "always":
            try:
                os.fsync(writer.fh.fileno())
            except (OSError, ValueError):
                pass
            writer.unsynced = 0
            writer.last_sync = time.monotonic()
        if writer.bytes >= self.segment_bytes:
            self._roll_locked(type_name, shard, writer)

    def _roll_locked(self, type_name: str, shard: int, writer: _Writer) -> None:
        old_segment = writer.segment
        writer.roll()
        # Keys whose CURRENT epoch still starts in a now-old segment
        # need a fresh snapshot before those segments can compact.
        for (t, k), state in self._live.items():
            if t == type_name and state[2] == shard and state[3] <= old_segment:
                self._resnap_due.add((type_name, shard, k))
        self._maybe_compact_locked(writer)

    def _maybe_compact_locked(self, writer: _Writer) -> None:
        """Delete OWN old segments every record of which is superseded
        by a COMMITTED SNAPSHOT at a strictly higher epoch in a newer
        segment.  Bare commands of a bumped epoch never supersede —
        until their snapshot lands, recovery's base may still live in
        the old segment.  Conservative: a key we no longer track
        (migrated away, never reclaimed) pins its segments forever —
        someone else's recovery source."""
        for segment in sorted(writer.segment_keys):
            if segment == writer.segment:
                break
            seg_keys = writer.segment_keys[segment]
            superseded = True
            for key, epoch in seg_keys.items():
                newer_snap = 0
                for other, snaps in writer.segment_snaps.items():
                    if other > segment and snaps.get(key, 0) > newer_snap:
                        newer_snap = snaps[key]
                if newer_snap <= epoch:
                    superseded = False
                    break
            if not superseded:
                break  # keep deletion prefix-contiguous (simplest proof)
            try:
                os.unlink(writer._path(segment))
            except OSError:
                break
            del writer.segment_keys[segment]
            writer.segment_snaps.pop(segment, None)

    # -- region-facing API ---------------------------------------- #

    def open_epoch(
        self,
        type_name: str,
        shard: int,
        key: str,
        state_blob: Optional[bytes],
        min_epoch: int = 0,
    ) -> int:
        """Activation-time snapshot: open a fresh epoch one past the
        highest epoch visible for the key and write its base record.

        ``min_epoch`` is a causal floor the fresh epoch must strictly
        exceed — the migration path passes the SOURCE's capture epoch,
        because "highest epoch visible" is a (cached) disk scan and the
        wall-clock floor only has millisecond grain: a handoff applied
        in the same millisecond as the source's capture, with a stale
        scan, could otherwise open an epoch <= the capture's, and the
        recovery merge would then sort the source's capture snapshot
        PAST the destination's later acked commands and drop them."""
        known = self._known_epoch(type_name, shard, key)
        with self._lock:
            live = self._live.get((type_name, key))
            if live is not None and live[0] > known:
                known = live[0]
            epoch = max(known + 1, _epoch_floor(), min_epoch + 1)
            writer = self._writer(type_name, shard)
            self._live[(type_name, key)] = [epoch, 0, shard, writer.segment]
            self._append(type_name, shard, key, epoch, 0, _SNAP, state_blob)
            return epoch

    def note_command(
        self, type_name: str, shard: int, key: str, blob: bytes
    ) -> bool:
        """Append one delivered command; True when a snapshot is due
        (count reached, or a segment roll queued a re-snapshot)."""
        with self._lock:
            live = self._live.get((type_name, key))
            if live is None:
                # Command for a key whose epoch was never opened here
                # (defensive; activation paths open epochs under the
                # region lock, so this should be unreachable).  Start a
                # fresh SNAPSHOT-LESS epoch at the wall floor: replay
                # then applies these commands on top of whatever older
                # base exists — a blank implicit snapshot here would
                # instead SUPERSEDE real state with nothing.
                writer = self._writer(type_name, shard)
                epoch = max(
                    self._known_epoch_locked(type_name, shard, key),
                    _epoch_floor(),
                )
                live = self._live[(type_name, key)] = [
                    epoch,
                    0,
                    shard,
                    writer.segment,
                ]
            live[1] += 1
            self._append(type_name, shard, key, live[0], live[1], _CMD, blob)
            if live[1] >= self.snapshot_every:
                return True
            if (type_name, shard, key) in self._resnap_due:
                return True
            return False

    def begin_snapshot(self, type_name: str, shard: int, key: str) -> int:
        """Bump the key's epoch at ENQUEUE time (caller holds its region
        lock, so commands journaled before this call are exactly the
        snapshot's contents).  Returns the epoch the eventual
        :meth:`commit_snapshot` must carry."""
        with self._lock:
            live = self._live.get((type_name, key))
            if live is None:
                live = self._live[(type_name, key)] = [
                    self._known_epoch_locked(type_name, shard, key),
                    0,
                    shard,
                    self._writer(type_name, shard).segment,
                ]
            live[0] = max(live[0] + 1, _epoch_floor())
            live[1] = 0
            live[3] = self._writer(type_name, shard).segment
            self._resnap_due.discard((type_name, shard, key))
            return live[0]

    def commit_snapshot(
        self,
        type_name: str,
        shard: int,
        key: str,
        epoch: int,
        state_blob: Optional[bytes],
    ) -> None:
        """Entity-thread completion of a begun snapshot."""
        with self._lock:
            self._append(type_name, shard, key, epoch, 0, _SNAP, state_blob)

    def continue_epoch(self, type_name: str, shard: int, key: str) -> int:
        """Fallback when an activation could NOT produce a base
        snapshot (the state failed to encode): instead of opening a
        blank epoch — which would supersede a perfectly valid prior
        image — keep extending the highest existing epoch, so recovery
        still replays the old snapshot plus every command since.
        Returns the epoch being extended."""
        known = self._known_epoch(type_name, shard, key)
        with self._lock:
            live = self._live.get((type_name, key))
            if live is not None:
                return live[0]
            cache = self._recover_cache.get((type_name, shard), {})
            records = cache.get(key) or ()
            seq = max(
                (r[1] for r in records if r[0] == known), default=0
            )
            writer = self._writer(type_name, shard)
            self._live[(type_name, key)] = [known, seq, shard, writer.segment]
            return known

    def set_fence(self, fence: int) -> None:
        """Adopt a (higher) partition era; stamped on every later
        record.  Monotone — a stale adoption is ignored."""
        with self._lock:
            if fence > self.fence:
                self.fence = fence

    def freeze(self) -> None:
        """The arbiter downed this node: refuse every later append
        (counted + reported per attempt).  The quarantine drain's final
        snapshots land BEFORE the freeze — the region sequences it."""
        with self._lock:
            self._frozen = True

    def unfreeze(self, fence: int) -> None:
        """Heal-time rejoin: adopt the survivor's fence and resume the
        append plane under it."""
        with self._lock:
            self._frozen = False
            if fence > self.fence:
                self.fence = fence

    @property
    def frozen(self) -> bool:
        return self._frozen

    def forget(self, type_name: str, key: str) -> None:
        """The key left this node (migrated away / shipped): stop
        tracking it.  Its records remain — superseded by the new
        owner's epoch, or someone's recovery source."""
        with self._lock:
            self._live.pop((type_name, key), None)

    def resnap_due(self) -> List[Tuple[str, int, str]]:
        """(type, shard, key) triples owed a re-snapshot after segment
        rolls; CONSUMED by the cluster tick — a triple whose key is no
        longer active here is simply dropped (any future activation
        opens a fresh epoch, which supersedes harder than a snapshot
        would), so stale entries cannot accumulate across churn."""
        with self._lock:
            due = list(self._resnap_due)
            self._resnap_due.clear()
        return due

    def checkpoint(self) -> int:
        """Flush + fsync every open segment (the drain lifecycle's
        journal-checkpoint step).  Returns segments synced."""
        with self._lock:
            writers = list(self._writers.values())
        n = 0
        for writer in writers:
            try:
                writer.fh.flush()
                os.fsync(writer.fh.fileno())
                writer.unsynced = 0
                writer.last_sync = time.monotonic()
                n += 1
            except (OSError, ValueError):
                pass
        return n

    def flush_due(self) -> None:
        """Interval-mode fsync sweep (driven by the cluster tick)."""
        if self.fsync != "interval":
            return
        now = time.monotonic()
        with self._lock:
            writers = [
                w
                for w in self._writers.values()
                if w.unsynced and now - w.last_sync >= self.fsync_interval_s
            ]
        for writer in writers:
            try:
                writer.fh.flush()
                os.fsync(writer.fh.fileno())
                writer.unsynced = 0
                writer.last_sync = now
            except (OSError, ValueError):
                pass

    def unsynced_records(self) -> int:
        """Journal lag: records appended but not yet fsynced."""
        with self._lock:
            return sum(w.unsynced for w in self._writers.values())

    def live_keys(self) -> int:
        with self._lock:
            return len(self._live)

    def segment_count(self) -> int:
        with self._lock:
            return sum(len(w.segment_keys) for w in self._writers.values())

    def close(self) -> None:
        with self._lock:
            writers = list(self._writers.values())
            self._writers.clear()
            self._live.clear()
        for writer in writers:
            writer.close()

    # ------------------------------------------------------------- #
    # Recovery plane
    # ------------------------------------------------------------- #

    def invalidate_cache(self) -> None:
        """Membership changed: peer files may have grown since the last
        scan — reread on next recovery."""
        with self._lock:
            self._recover_cache.clear()

    def invalidate_shard(self, type_name: str, shard: int) -> None:
        """Drop one shard's scan cache so the next recovery reads the
        freshest possible peer state (the on-demand activation path:
        a stale scan there can resurrect an older incarnation over a
        live owner's later acked appends)."""
        with self._lock:
            self._recover_cache.pop((type_name, shard), None)

    def shards(self, type_name: str) -> List[int]:
        """Shard ids with any journal presence for ``type_name``."""
        type_dir = os.path.join(self.base_dir, _safe_component(type_name))
        try:
            names = os.listdir(type_dir)
        except OSError:
            return []
        out = []
        for name in names:
            try:
                out.append(int(name))
            except ValueError:
                continue
        return sorted(out)

    def _scan_file_cached(self, path: str) -> List[tuple]:
        """Parsed records of one segment file, revalidated by stat:
        an unchanged (size, mtime_ns) on an append-only file means the
        parse is current.  A vanished file (compacted away) drops its
        entry."""
        try:
            st = os.stat(path)
        except OSError:
            with self._lock:
                self._file_cache.pop(path, None)
            return []
        stamp = (st.st_size, st.st_mtime_ns)
        with self._lock:
            cached = self._file_cache.get(path)
            if cached is not None and cached[0] == stamp:
                return cached[1]
        records = self._scan_file(path)
        with self._lock:
            self._file_cache[path] = (stamp, records)
        return records

    def _scan_file(self, path: str) -> List[tuple]:
        """All valid records of one segment file, stopping cleanly at
        the first torn frame."""
        records: List[tuple] = []
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            return records
        pos = 0
        size = len(data)
        while pos + _HEADER.size <= size:
            magic, length, crc = _HEADER.unpack_from(data, pos)
            body_start = pos + _HEADER.size
            if (
                magic != _MAGIC
                or body_start + length > size
                or zlib.crc32(data[body_start : body_start + length]) != crc
            ):
                self._report_torn(path, pos)
                return records
            try:
                record = pickle.loads(data[body_start : body_start + length])
                # 5-tuple = pre-fencing era (fence 0); 6-tuple carries
                # the writer's fence.  Tolerant both directions.
                key, epoch, seq, kind, blob = record[:5]
                fence = int(record[5]) if len(record) > 5 else 0
            except Exception:
                self._report_torn(path, pos)
                return records
            records.append((str(key), int(epoch), int(seq), kind, blob, fence))
            pos = body_start + length
        if pos != size:
            self._report_torn(path, pos)
        return records

    def _report_torn(self, path: str, offset: int) -> None:
        self.torn_records += 1
        if events.recorder.enabled:
            events.recorder.commit(
                events.JOURNAL_TORN, path=path, offset=offset
            )

    def _load_shard(self, type_name: str, shard: int) -> Dict[str, list]:
        """key -> (epoch, seq, kind, blob) records, merged over every
        file of the shard (all writers), sorted per key.  The returned
        dict is SHARED with the appender's incremental maintenance —
        read it only under ``self._lock`` (the snapshot helpers below);
        the file scan itself runs off-lock."""
        with self._lock:
            cached = self._recover_cache.get((type_name, shard))
        if cached is not None:
            return cached
        dirpath = self._shard_dir(type_name, shard)
        try:
            names = sorted(n for n in os.listdir(dirpath) if n.endswith(".uj"))
        except OSError:
            names = []
        # Evict parse-cache entries for segments compaction deleted —
        # they are no longer listed, so the stat-side eviction in
        # _scan_file_cached never sees them, and each would otherwise
        # pin its full parsed record list forever.
        live = {os.path.join(dirpath, name) for name in names}
        prefix = dirpath + os.sep
        with self._lock:
            for path in [
                p
                for p in self._file_cache
                if p.startswith(prefix) and p not in live
            ]:
                del self._file_cache[path]
        by_key: Dict[str, list] = {}
        for name in names:
            # The segment filename carries the WRITER node — the merge
            # needs it to tell a same-writer epoch continuing across a
            # fence adoption from two writers colliding on one
            # wall-clock epoch behind a partition.
            # rsplit: the segment name is '<node_safe>.<NNNNN>.uj' and
            # node_safe may itself contain dots ('10.0.0.5' survives
            # _safe_component) — splitting from the LEFT would truncate
            # such prefixes and alias distinct writers.
            writer = name.rsplit(".", 2)[0]
            for key, epoch, seq, kind, blob, fence in self._scan_file_cached(
                os.path.join(dirpath, name)
            ):
                by_key.setdefault(key, []).append(
                    (epoch, seq, kind, blob, fence, writer)
                )
        for records in by_key.values():
            records.sort(key=lambda r: (r[0], r[1]))
        with self._lock:
            # A concurrent loader (or an appender that re-created the
            # entry) wins: its copy already carries later appends.
            existing = self._recover_cache.get((type_name, shard))
            if existing is not None:
                return existing
            self._recover_cache[(type_name, shard)] = by_key
        return by_key

    def keys_for_shard(self, type_name: str, shard: int) -> List[str]:
        cache = self._load_shard(type_name, shard)
        with self._lock:
            return sorted(cache)

    def known_epoch(self, type_name: str, shard: int, key: str) -> int:
        """Highest epoch visible for the key (as fresh as the last
        cache invalidation) — the staleness probe the migration-apply
        path uses: a shipped capture whose epoch is BELOW this predates
        state some later incarnation already journaled."""
        return self._known_epoch(type_name, shard, key)

    def recover(
        self, type_name: str, shard: int, key: str
    ) -> Optional[Tuple[Optional[bytes], List[bytes]]]:
        """(state_blob, [command_blobs]) for the key, or None when the
        journal holds nothing for it.  Base = the LAST snapshot record;
        every later command (same epoch seq>0, plus commands of newer
        epochs whose snapshot never landed) replays on top.

        Fence resolution: when the key's records span more than one
        partition era, the highest fence is authoritative.  A survivor's
        activation opens a FRESH epoch (hybrid-logical ``known+1``)
        that strictly exceeds every lower-fence epoch it could SEE, so
        any lower-fence record whose epoch reaches that fresh base was
        written concurrently behind the partition — dual activation.
        Those records are QUARANTINED out of the replay (counted +
        reported), never merged; lower-fence history below the base
        replays normally, which is exactly the healed minority's
        non-conflicting suffix surviving.

        An epoch with records at BOTH fences FROM THE SAME WRITER is
        something else entirely: that incarnation kept journaling
        across a fence adoption (a survivor's live entity at the
        verdict — set_fence changes the stamp, not the epoch).  Such
        continuation epochs anchor no conflict and are never
        conflicting themselves — without the carve-out a survivor's
        own pre-verdict snapshot would read as 'stale era at the base
        epoch' and be quarantined, silently losing acked state.  The
        writer identity matters: two DIFFERENT writers landing on one
        wall-clock epoch across the fence split (the quarantine drain
        and the survivor's activation inside the same millisecond) is
        dual activation, not continuation."""
        cache = self._load_shard(type_name, shard)
        with self._lock:
            records = list(cache.get(key) or ())
        if not records:
            return None
        max_fence = max(r[4] for r in records)
        if max_fence > min(r[4] for r in records):
            low_pairs = {(r[5], r[0]) for r in records if r[4] < max_fence}
            high_pairs = {(r[5], r[0]) for r in records if r[4] == max_fence}
            # Continuation is a (writer, epoch) property: only the
            # SAME writer's lower-fence records in a shared epoch are
            # the pre-adoption half of one incarnation.  A DIFFERENT
            # writer landing in that epoch at a lower fence wrote
            # behind the partition — conflict, exactly what the
            # carve-out must not excuse.
            continuation = low_pairs & high_pairs
            # The base anchor is the min epoch seen at the top fence,
            # continuation or fresh: the top-fence writer was live in
            # that epoch through the verdict, so any OTHER writer's
            # lower-fence record at or past it is concurrent-behind-
            # the-partition even when no fresh activation ever opened.
            fence_base_epoch = min(e for (_w, e) in high_pairs)
            conflicting = [
                r
                for r in records
                if r[4] < max_fence
                and r[0] >= fence_base_epoch
                and (r[5], r[0]) not in continuation
            ]
            if conflicting:
                dropped = set(conflicting)
                records = [r for r in records if r not in dropped]
                with self._lock:
                    self.fence_conflicts += len(conflicting)
                if events.recorder.enabled:
                    events.recorder.commit(
                        events.FENCE_REJECTED,
                        site="recovery",
                        key=key,
                        type=type_name,
                        count=len(conflicting),
                        max_fence=max_fence,
                    )
            if not records:
                return None
        base_idx = None
        for i in range(len(records) - 1, -1, -1):
            if records[i][2] == _SNAP:
                base_idx = i
                break
        state_blob: Optional[bytes] = None
        start = 0
        if base_idx is not None:
            state_blob = records[base_idx][3]
            start = base_idx + 1
        cmds = [r[3] for r in records[start:] if r[2] == _CMD and r[3] is not None]
        return state_blob, cmds

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "appended_records": self.appended_records,
                "appended_bytes": self.appended_bytes,
                "unsynced_records": sum(
                    w.unsynced for w in self._writers.values()
                ),
                "segments": sum(
                    len(w.segment_keys) for w in self._writers.values()
                ),
                "live_keys": len(self._live),
                "recovered_entities": self.recovered_entities,
                "torn_records": self.torn_records,
                "dead": self._dead,
                "fence": self.fence,
                "frozen": self._frozen,
                "fence_conflicts": self.fence_conflicts,
                "fence_rejected_appends": self.fence_rejected_appends,
            }

    # -- internals ------------------------------------------------- #

    def _known_epoch(self, type_name: str, shard: int, key: str) -> int:
        """Highest epoch visible for the key across every file (disk
        scan, cached per shard) — what a fresh epoch must exceed so a
        re-activation always supersedes prior incarnations.  Must be
        called OUTSIDE ``self._lock`` (the load may scan files)."""
        cache = self._load_shard(type_name, shard)
        with self._lock:
            records = cache.get(key)
            if not records:
                return 0
            return max(r[0] for r in records)

    def _known_epoch_locked(self, type_name: str, shard: int, key: str) -> int:
        # caller holds self._lock; the disk scan takes no journal state
        records = self._recover_cache.get((type_name, shard), {}).get(key)
        if records:
            return max(r[0] for r in records)
        return 0
