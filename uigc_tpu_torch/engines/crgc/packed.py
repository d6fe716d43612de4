"""Copy of ``uigc_tpu/engines/crgc/packed.py`` (pure Python), with one
fault of the reference repaired: its ``PackedPlane.drain`` empties the
rings one after another, so a drain could take a row while missing a row
of another ring that was committed before it.  An actor with more than
``entry-field-size`` children flushes a busy row carrying its creation
edge from the spawning thread, then an idle row from its dispatcher
thread; folding the idle row without the busy one interns the actor with
no in-edge, and the collector kills it while it is still referenced.
Here every commit and the drain's cut of all rings share one lock, so a
drain takes, from every ring, exactly the rows committed before one
instant (``PackedPlane.drain``).

Packed mutator->collector entry plane.

The object ``Entry`` snapshot (state.py, reference: crgc/Entry.java:5-37)
is the differential oracle's plane and the multi-node plane (delta graphs
need refob identity).  This module is the single-node hot path the SURVEY
§7 design calls for: a flush writes one packed int64 row into a
per-thread ring buffer, and the collector's drain is array slicing — no
per-entry Python object walk anywhere on the Bookkeeper thread (the
system's single fold bottleneck; the mutator threads, which scale with
the dispatcher pool, pay the flattening instead).

Row layout (width = 4 + 5*E, E = entry-field-size, -1 = empty field):

    col 0          seq       global flush order (busy/root bits are
                             last-writer-wins per actor, so cross-thread
                             total order must be restorable at the fold)
    col 1          self uid  ``ActorCell.uid`` (dense per system)
    col 2          bits      bit0 busy, bit1 root
    col 3          recv      messages received this period
    cols 4..4+2E   E created (owner_uid, target_uid) pairs
    next E         E spawned child uids
    next 2E        E updated (target_uid, packed refob info) pairs

Uids, not slots: slot assignment stays single-writer on the collector
(ArrayShadowGraph.merge_packed maps uids through a dense ``uid -> slot``
array and interns only unseen uids).  The plane's ``uid_strong`` dict
pins every cell named by an in-flight row so the collector can always
resolve it; pins live until the actor's slot is swept
(ArrayShadowGraph._free_slots_batch pops them) — interning alone does
not release a pin, it only makes future lookups bypass it.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional

import numpy as np

ROW_FIXED = 4  # seq, self uid, busy/root bits, recv count


def row_width(entry_field_size: int) -> int:
    return ROW_FIXED + 5 * entry_field_size


class PackedRing:
    """SPSC ring of packed rows: one writer (the mutator thread that owns
    it), one reader (the Bookkeeper).  The writer fills a row with no
    lock — under the GIL the row store completes before the ``w``
    publish, and the reader never reads at or past ``w`` — and publishes
    it under the plane's ``cut_lock``, which the drain's cut holds too.
    ``lock`` serializes the two buffer-wide operations: writer grow and
    reader drain."""

    __slots__ = ("buf", "cap", "r", "w", "lock", "cut_lock", "committed",
                 "taken")

    def __init__(self, width: int, cap: int = 1 << 12,
                 cut_lock: Optional[threading.Lock] = None):
        assert cap & (cap - 1) == 0
        self.buf = np.empty((cap, width), dtype=np.int64)
        self.cap = cap
        self.r = 0  # read cursor (reader-owned), monotonic
        self.w = 0  # write cursor (writer-owned), monotonic
        self.lock = threading.Lock()
        #: the plane's lock that orders commits against drain cuts
        self.cut_lock = cut_lock if cut_lock is not None else threading.Lock()
        #: rows ever committed (writer) and ever drained (reader); unlike
        #: ``r``/``w`` they survive a grow, so a cut can name a count
        self.committed = 0
        self.taken = 0

    def begin(self) -> np.ndarray:
        """The next row's buffer view; the reader cannot see it until
        :meth:`commit`.  Stale contents from a previous lap — the caller
        must fill every column."""
        if self.w - self.r >= self.cap:
            # A stale ``r`` read only over-estimates fullness (r is
            # monotonic), so a spurious grow is possible but an
            # overwrite of unread rows is not.
            with self.lock:
                self._grow()
        return self.buf[self.w & (self.cap - 1)]

    def commit(self) -> None:
        with self.cut_lock:
            self.w += 1
            self.committed += 1

    def _grow(self) -> None:
        # Reader excluded by the lock; relinearize [r, w) from 0.
        cap, r, w = self.cap, self.r, self.w
        new = np.empty((cap * 2, self.buf.shape[1]), dtype=np.int64)
        idx = (np.arange(r, w) & (cap - 1))
        count = w - r
        new[:count] = self.buf[idx]
        self.buf = new
        self.cap = cap * 2
        self.r = 0
        self.w = count

    def drain(self, upto: Optional[int] = None) -> Optional[np.ndarray]:
        """Copy out the committed rows (None if empty): all of them, or
        those up to the ``upto``-th commit ever (a cut's count)."""
        with self.lock:
            r, w = self.r, self.w
            if upto is not None:
                w = r + (upto - self.taken)
            if r == w:
                return None
            cap = self.cap
            i0 = r & (cap - 1)
            i1 = w & (cap - 1)
            if i0 < i1:
                out = self.buf[i0:i1].copy()
            else:  # wrapped (or exactly full)
                out = np.concatenate([self.buf[i0:], self.buf[:i1]])
            self.taken += w - r
            self.r = w
            return out


class PackedPlane:
    """Per-engine bundle: one ring per mutator thread, the global flush
    sequence, and the strong uid->cell pin set."""

    def __init__(self, entry_field_size: int):
        self.entry_field_size = entry_field_size
        self.width = row_width(entry_field_size)
        #: itertools.count.__next__ is a single C call — atomic under
        #: the GIL, so concurrent flushes get distinct ordered stamps.
        self._seq = itertools.count()
        #: cells named by in-flight rows; dict.setdefault / .pop are
        #: individually atomic under the GIL.  Pins persist until the
        #: collector SWEEPS the actor's slot (_free_slots_batch), not
        #: until intern: the graph's cells[] also pins an interned cell,
        #: so the extra pin is redundant but harmless, and releasing it
        #: only at sweep keeps the release single-writer.
        self.uid_strong: Dict[int, object] = {}
        self._rings: Dict[int, PackedRing] = {}
        self._lock = threading.Lock()
        #: held by every commit and by the drain's cut (PackedRing.commit)
        self._cut_lock = threading.Lock()
        self._tl = threading.local()

    def next_seq(self) -> int:
        return next(self._seq)

    def ring(self) -> PackedRing:
        r = getattr(self._tl, "ring", None)
        if r is None:
            r = PackedRing(self.width, cut_lock=self._cut_lock)
            with self._lock:
                # Keyed by ring identity, not thread id: thread-id reuse
                # after a worker dies must not alias two rings.  A dead
                # thread's drained-empty ring is a small, bounded leak
                # (the dispatcher pool is fixed-size).
                self._rings[id(r)] = r
            self._tl.ring = r
        return r

    def drain(self) -> Optional[np.ndarray]:
        """The rows committed to every ring before one instant, unsorted
        (merge_packed restores flush order from the seq column).

        The cut is taken under the lock every commit holds, so a row
        committed before a taken row, on whatever ring, is taken too:
        the fold never sees an actor's later flush without its earlier
        ones (the reference drains ring by ring and can)."""
        # The ring list is read inside the cut: a ring registers before
        # its first commit, so every ring with a row before the cut is in
        # it (read first, a ring registered and committed to between the
        # two reads would be missed while later rows on others were cut).
        with self._cut_lock:
            with self._lock:
                rings = list(self._rings.values())
            cut = [(ring, ring.committed) for ring in rings]
        parts = [p for p in (ring.drain(upto) for ring, upto in cut)
                 if p is not None]
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else np.concatenate(parts)
