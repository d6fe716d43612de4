"""Port of ``uigc_tpu/ops/slotmap.py`` (pure numpy); the port's incremental
layout (``ops/cuda_incremental.py``) and the mesh's layout plane
(``engines/crgc/mesh.py``) key their slot maps with it.  Where the
reference folds a log and resolves a batch with per-key dict and set
work, the port does both as array work: a log becomes one int64 array
(:func:`log_columns`), its net effect per key comes from one stable sort
(:func:`net_log`), and the bulk lookup is a per-source index into the
sorted keys with tombstones as a flag array.

Packed-int64 slot maps: O(E) numpy storage for pair -> slot lookups.

The incremental layouts need a map from a live propagation pair to the
slot holding it, so that a later deletion can mask the slot in place.
A Python dict keyed by (src, dst, kind) tuples costs hundreds of bytes
per pair — multiple GB of host objects at the 10M-actor/30M-pair target,
and most of the rebuild stall measured in BENCH_PACK_r02 was that dict's
construction.

This map instead stores the bulk mapping as two sorted int64 numpy arrays
(16 bytes per pair) built vectorized at rebuild time, plus one int64
offset per source (the first bulk index of each source's run) and one
tombstone flag per pair.  A batch lookup finds each key's source run
through the offsets and binary-searches inside the runs together, so its
cost follows the longest run in the batch, not the bulk's size.
Inserts after the rebuild go to an overlay (an ``I64Map``) whose size is
bounded by churn since the rebuild, which the layouts already bound by
repacking.

Keys pack (src, dst, kind) into one int64: src in bits 32..62, dst in
bits 1..31, kind in bit 0 — node ids must stay below 2^31, which the
graph's int32 slot arrays already guarantee.  Values are whatever the
caller packs into a non-negative int64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .i64map import I64Map


def pack_keys(src, dst, kind) -> np.ndarray:
    """Vectorized (src, dst, kind) -> int64 key."""
    return (
        (np.asarray(src, dtype=np.int64) << 32)
        | (np.asarray(dst, dtype=np.int64) << 1)
        | np.asarray(kind, dtype=np.int64)
    )


def pack_key(src: int, dst: int, kind: int) -> int:
    return (src << 32) | (dst << 1) | kind


def unpack_keys(karr: np.ndarray):
    """Vectorized int64 key -> (src, dst) arrays (kind = karr & 1)."""
    karr = np.asarray(karr, dtype=np.int64)
    return karr >> 32, (karr >> 1) & 0x7FFFFFFF


def log_columns(log) -> np.ndarray:
    """A pair-transition log [(insert?, src, dst, kind), ...] as one
    (4, len(log)) int64 array: rows insert?, src, dst, kind."""
    out = np.empty((4, len(log)), dtype=np.int64)
    for row, col in zip(out, zip(*log)):
        row[:] = col
    return out


def net_log(cols: np.ndarray):
    """The distinct packed keys of a log in :func:`log_columns` form,
    sorted, and the log positions of each key's first and last op:
    ``(keys, first, last)``.

    A pair's transitions strictly alternate (graph layers only log
    dead<->live flips), so the first and last op, and whether there are
    more than one, determine the net effect:

    - first op a remove: remove from the current home (absence is caller
      drift: count an anomaly);
    - insert first but remove last: a net no-op for a fresh pair, but if
      the key was *already live* the insert was anomalous drift and the
      remove is real: remove and count an anomaly, matching the
      sequential scalar replay;
    - last op an insert: insert after the removals (a key already live
      whose first insert was drift leaves its home for the live tier
      when a remove came between)."""
    keys = pack_keys(cols[1], cols[2], cols[3])
    m = keys.size
    order = np.argsort(keys)
    ks = keys[order]
    start = np.ones(m, dtype=bool)
    start[1:] = ks[1:] != ks[:-1]
    starts = np.nonzero(start)[0]
    if m == 0:
        return ks, starts, starts
    # a key's ops in the log: the least and greatest of its positions
    first = np.minimum.reduceat(order, starts)
    last = np.maximum.reduceat(order, starts)
    return ks[starts], first, last


def fold_log(log):
    """Fold an alternating pair-transition log [(insert?, src, dst, kind),
    ...] into its net effect per packed key (:func:`net_log`), as lists
    of keys in order of first appearance: ``(removes, cond_removes,
    inserts)`` — first op a remove; insert first but remove last; last
    op an insert."""
    cols = log_columns(log)
    keys, first, last = net_log(cols)
    o = np.argsort(first)
    keys, first, last = keys[o], first[o], last[o]
    first_ins, last_ins = cols[0][first] != 0, cols[0][last] != 0
    return (
        keys[~first_ins].tolist(),
        keys[first_ins & ~last_ins].tolist(),
        keys[last_ins].tolist(),
    )


class PackedSlotMap:
    """int64 key -> int64 value map: sorted bulk arrays, a per-source
    index into them, tombstone flags and a churn overlay."""

    __slots__ = ("_keys", "_vals", "_start", "_dead", "_n_dead", "_extra")

    def __init__(
        self,
        keys: Optional[np.ndarray] = None,
        vals: Optional[np.ndarray] = None,
    ):
        if keys is None or keys.size == 0:
            self._keys = np.zeros(0, dtype=np.int64)
            self._vals = np.zeros(0, dtype=np.int64)
        else:
            order = np.argsort(keys)
            self._keys = np.ascontiguousarray(keys[order])
            self._vals = np.ascontiguousarray(vals[order])
        #: _start[s] .. _start[s + 1]: the bulk run of the keys of source s
        src = self._keys >> 32
        self._start = np.zeros(
            int(src[-1]) + 2 if src.size else 1, dtype=np.int64
        )
        np.cumsum(np.bincount(src), out=self._start[1:])
        self._dead = np.zeros(self._keys.size, dtype=bool)  # tombstones
        self._n_dead = 0
        self._extra = I64Map(16)  # post-rebuild inserts

    def __len__(self) -> int:
        return self._keys.size - self._n_dead + len(self._extra)

    def _bulk_find(self, key: int) -> int:
        """Index of the live bulk ``key``, or -1."""
        return int(self._bulk_find_batch(np.array([key], dtype=np.int64))[0])

    def _bulk_find_batch(self, karr: np.ndarray) -> np.ndarray:
        """Indices of the live bulk keys in ``karr`` (-1 = absent): every
        key's source run from the offsets, then one lower-bound search
        over all the runs together, as many steps as the longest run
        needs."""
        out = np.full(karr.size, -1, dtype=np.int64)
        if karr.size == 0 or self._keys.size == 0:
            return out
        src = karr >> 32
        q = np.nonzero(src + 1 < self._start.size)[0]
        kq = karr[q]
        lo = self._start[src[q]]
        end = hi = self._start[src[q] + 1]
        top = self._keys.size - 1
        for _ in range(int((hi - lo).max(initial=0)).bit_length()):
            mid = (lo + hi) >> 1
            act = lo < hi
            go = act & (self._keys[np.minimum(mid, top)] < kq)
            lo = np.where(go, mid + 1, lo)
            hi = np.where(act & ~go, mid, hi)
        at = np.minimum(lo, top)
        hit = (lo < end) & (self._keys[at] == kq) & ~self._dead[at]
        out[q[hit]] = lo[hit]
        return out

    def __contains__(self, key: int) -> bool:
        return key in self._extra or self._bulk_find(key) >= 0

    def get(self, key: int) -> Optional[int]:
        val = self._extra.get(key)
        if val is not None:
            return val
        i = self._bulk_find(key)
        return None if i < 0 else int(self._vals[i])

    def add(self, key: int, val: int) -> None:
        """Insert; the key must not be present (callers check first).
        A tombstoned bulk key may be re-added — the overlay wins on
        lookup, and the tombstone keeps the stale bulk slot hidden."""
        self._extra[key] = val

    def pop(self, key: int) -> Optional[int]:
        val = self._extra.pop(key)
        if val is not None:
            return val
        i = self._bulk_find(key)
        if i < 0:
            return None
        self._dead[i] = True
        self._n_dead += 1
        return int(self._vals[i])

    # --------------------------------------------------------------- #
    # Batched point ops: the overlay's batch probe and one search over
    # the bulk's source runs for a whole churn batch.
    # --------------------------------------------------------------- #

    def _lookup_batch(self, karr: np.ndarray, remove: bool) -> np.ndarray:
        # Precondition: keys within one batch are unique (callers dedup
        # via net_log).  A duplicated bulk key would otherwise be
        # tombstoned once but resolved for every occurrence — e.g. a
        # double-free of the same column downstream.
        out = np.full(karr.size, -1, dtype=np.int64)
        if karr.size == 0:
            return out
        assert np.unique(karr).size == karr.size, "batch keys must be unique"
        rest = np.arange(karr.size)
        if len(self._extra):
            ev = (self._extra.pop_batch(karr) if remove
                  else self._extra.get_batch(karr))
            hit = ev >= 0
            out[hit] = ev[hit]
            rest = rest[~hit]
        idx = self._bulk_find_batch(karr[rest])
        found = idx >= 0
        idx = idx[found]
        out[rest[found]] = self._vals[idx]
        if remove:
            self._dead[idx] = True
            self._n_dead += idx.size
        return out

    def pop_batch(self, karr: np.ndarray) -> np.ndarray:
        """Pop every key in ``karr``; returns int64 values, -1 = absent."""
        return self._lookup_batch(np.asarray(karr, dtype=np.int64), remove=True)

    def get_batch(self, karr: np.ndarray) -> np.ndarray:
        """Look up every key in ``karr``; returns int64 values, -1 = absent."""
        return self._lookup_batch(np.asarray(karr, dtype=np.int64), remove=False)
