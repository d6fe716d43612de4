"""Copy of ``uigc_tpu/ops/i64map.py`` (pure Python).

Vectorized open-addressing int64 -> int64 hash map.

The shadow graph's edge map (``owner << 32 | target`` -> edge id) is the
last Python dict on the collector's fold path: a drained batch can carry
hundreds of thousands of unique edge keys, and ``dict.get`` per key costs
more than the entire vectorized scatter-apply it feeds
(profile: ~70% of `_apply_edge_deltas` time).  This map keeps keys and
values in flat numpy arrays and probes a whole batch per step, so a
600k-key lookup is a handful of gathers instead of 600k interpreter
round-trips.

Linear probing over a power-of-two table with a multiplicative
(splitmix-style) hash.  Batch inserts use scatter-and-verify: colliding
keys that lose a claimed slot simply continue probing — the standard
GPU-hash-building technique, which maps exactly onto numpy scatters.

Keys must be non-negative (bit 63 clear); -1 marks an empty slot and -2
a tombstone.  Scalar dict-compatible operations (`get`/`pop`/`[]`/`in`/
`items`) are provided for the non-batch paths and the tests.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Tuple

import numpy as np

_C_I64_P = ctypes.POINTER(ctypes.c_int64)

EMPTY = -1
TOMBSTONE = -2

_MULT = np.uint64(0x9E3779B97F4A7C15)
_SHIFT = np.uint64(29)

#: native probe kernels (uigc_tpu/native/crgc_shadow.cpp): serial C
#: loops beat the numpy scatter-and-verify rounds once batches are big
#: enough to amortize the call.  None = not probed yet, False = no
#: toolchain (pure-numpy fallback).  The C side uses the identical hash
#: and probe order, so both sides can operate on the same table.
_native = None
_NATIVE_MIN_BATCH = 64


def _native_lib():
    global _native
    if _native is None:
        try:
            from ..native import load

            _native = load()
        except Exception:
            _native = False
    return _native or None


def _native_lib_checked():
    """Load + one-time hash-equivalence check: the C probes MUST agree
    with _h_batch/_h_scalar on every slot choice (both sides operate on
    the same table), so a retuned _MULT/_SHIFT here must refuse the
    native path rather than silently mis-probe."""
    lib = _native_lib()
    if lib is None:
        return None
    global _native
    if not getattr(_native_lib_checked, "_verified", False):
        probe = np.array([0, 1, 0x7FFF_FFFF_FFFF_FFFF, 12345678901], np.int64)
        mask = np.int64(1023)
        expect = ((probe.astype(np.uint64) * _MULT) >> _SHIFT).astype(
            np.int64
        ) & mask
        tab = np.full(1024, EMPTY, dtype=np.int64)
        vals = np.arange(1024, dtype=np.int64)
        # the four probe keys hash to distinct slots at mask 1023, so a
        # correct C hash fills exactly the expected slot set
        lib.uigc_map_put_batch_new(
            _ptr(tab), _ptr(vals), mask, _ptr(probe), _ptr(probe), probe.size
        )
        if not np.array_equal(np.sort(np.nonzero(tab >= 0)[0]), np.sort(expect)):
            _native = False
            return None
        _native_lib_checked._verified = True
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_C_I64_P)


class I64Map:
    """int64 key -> int64 value open-addressing table."""

    __slots__ = ("keys", "vals", "cap", "mask", "size", "tombs")

    def __init__(self, cap: int = 1024):
        cap = max(16, cap)
        if cap & (cap - 1):
            cap = 1 << (cap - 1).bit_length()
        self.keys = np.full(cap, EMPTY, dtype=np.int64)
        self.vals = np.empty(cap, dtype=np.int64)
        self.cap = cap
        self.mask = cap - 1
        self.size = 0
        self.tombs = 0

    @classmethod
    def build(cls, keys: np.ndarray, vals: np.ndarray) -> "I64Map":
        """Bulk-construct from unique keys."""
        m = cls(cap=max(16, int(keys.size * 2)))
        if keys.size:
            m.put_batch_new(
                np.asarray(keys, dtype=np.int64),
                np.asarray(vals, dtype=np.int64),
            )
        return m

    # -- hashing ---------------------------------------------------- #

    def _h_batch(self, karr: np.ndarray) -> np.ndarray:
        return (
            ((karr.astype(np.uint64) * _MULT) >> _SHIFT).astype(np.int64)
            & self.mask
        )

    def _h_scalar(self, k: int) -> int:
        # Python-int modular arithmetic: no numpy scalar overflow
        # warnings, and faster than boxing to uint64.
        return ((k * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF) >> 29) & self.mask

    # -- batch operations ------------------------------------------- #

    def get_batch(self, karr: np.ndarray) -> np.ndarray:
        """Values for ``karr`` (-1 where absent).  Keys need not be
        unique."""
        karr = np.ascontiguousarray(karr, dtype=np.int64)
        n = karr.size
        out = np.full(n, -1, dtype=np.int64)
        if n == 0 or self.size == 0:
            return out
        if n >= _NATIVE_MIN_BATCH:
            lib = _native_lib_checked()
            if lib is not None:
                lib.uigc_map_get_batch(
                    _ptr(self.keys), _ptr(self.vals), self.mask,
                    _ptr(karr), n, _ptr(out),
                )
                return out
        idx = self._h_batch(karr)
        pending = np.arange(n)
        keys = self.keys
        mask = self.mask
        while pending.size:
            ia = idx[pending]
            tk = keys[ia]
            hit = tk == karr[pending]
            if hit.any():
                out[pending[hit]] = self.vals[ia[hit]]
            done = hit | (tk == EMPTY)
            pending = pending[~done]
            idx[pending] = (idx[pending] + 1) & mask
        return out

    def put_batch_new(self, karr: np.ndarray, varr: np.ndarray) -> None:
        """Insert keys known to be UNIQUE and ABSENT (the fold path
        learns absence from get_batch first).  Scatter-and-verify:
        losers of a slot race keep probing."""
        karr = np.ascontiguousarray(karr, dtype=np.int64)
        varr = np.ascontiguousarray(varr, dtype=np.int64)
        n = karr.size
        if n == 0:
            return
        self._maybe_grow(n)
        if n >= _NATIVE_MIN_BATCH:
            lib = _native_lib_checked()
            if lib is not None:
                freed = lib.uigc_map_put_batch_new(
                    _ptr(self.keys), _ptr(self.vals), self.mask,
                    _ptr(karr), _ptr(varr), n,
                )
                self.size += n
                self.tombs -= int(freed)
                return
        keys = self.keys
        mask = self.mask
        idx = self._h_batch(karr)
        pending = np.arange(n)
        claimed = 0
        freed_tombs = 0
        while pending.size:
            ia = idx[pending]
            tk = keys[ia]
            free = tk < 0
            if free.any():
                cand = pending[free]
                slots = ia[free]
                prev = tk[free]
                keys[slots] = karr[cand]
                won = keys[slots] == karr[cand]
                ws = slots[won]
                wi = cand[won]
                self.vals[ws] = varr[wi]
                claimed += int(won.sum())
                freed_tombs += int((prev[won] == TOMBSTONE).sum())
                done = np.zeros(pending.size, dtype=bool)
                free_idx = np.nonzero(free)[0]
                done[free_idx[won]] = True
                pending = pending[~done]
            idx[pending] = (idx[pending] + 1) & mask
        self.size += claimed
        self.tombs -= freed_tombs

    def pop_batch(self, karr: np.ndarray) -> np.ndarray:
        """Remove ``karr`` (unique); returns their values (-1 where
        absent)."""
        karr = np.ascontiguousarray(karr, dtype=np.int64)
        n = karr.size
        out = np.full(n, -1, dtype=np.int64)
        if n == 0 or self.size == 0:
            return out
        if n >= _NATIVE_MIN_BATCH:
            lib = _native_lib_checked()
            if lib is not None:
                removed = lib.uigc_map_pop_batch(
                    _ptr(self.keys), _ptr(self.vals), self.mask,
                    _ptr(karr), n, _ptr(out),
                )
                self.size -= int(removed)
                self.tombs += int(removed)
                return out
        keys = self.keys
        mask = self.mask
        idx = self._h_batch(karr)
        pending = np.arange(n)
        removed = 0
        while pending.size:
            ia = idx[pending]
            tk = keys[ia]
            hit = tk == karr[pending]
            if hit.any():
                slots = ia[hit]
                out[pending[hit]] = self.vals[slots]
                keys[slots] = TOMBSTONE
                removed += int(hit.sum())
            done = hit | (tk == EMPTY)
            pending = pending[~done]
            idx[pending] = (idx[pending] + 1) & mask
        self.size -= removed
        self.tombs += removed
        return out

    # -- scalar dict-compatible operations -------------------------- #

    def get(self, k: int, default=None):
        keys = self.keys
        mask = self.mask
        i = self._h_scalar(k)
        while True:
            tk = int(keys[i])
            if tk == k:
                return int(self.vals[i])
            if tk == EMPTY:
                return default
            i = (i + 1) & mask

    def __getitem__(self, k: int) -> int:
        v = self.get(k)
        if v is None:
            raise KeyError(k)
        return v

    def __setitem__(self, k: int, v: int) -> None:
        """Scalar upsert: scan the chain for the key, remembering the
        first free slot to claim if the key is absent."""
        self._maybe_grow(1)
        keys = self.keys
        mask = self.mask
        i = self._h_scalar(k)
        first_free = -1
        while True:
            tk = int(keys[i])
            if tk == k:
                self.vals[i] = v
                return
            if tk == EMPTY:
                j = first_free if first_free >= 0 else i
                was_tomb = int(keys[j]) == TOMBSTONE
                keys[j] = k
                self.vals[j] = v
                self.size += 1
                if was_tomb:
                    self.tombs -= 1
                return
            if tk == TOMBSTONE and first_free < 0:
                first_free = i
            i = (i + 1) & mask

    def pop(self, k: int, default=None):
        keys = self.keys
        mask = self.mask
        i = self._h_scalar(k)
        while True:
            tk = int(keys[i])
            if tk == k:
                keys[i] = TOMBSTONE
                self.size -= 1
                self.tombs += 1
                return int(self.vals[i])
            if tk == EMPTY:
                return default
            i = (i + 1) & mask

    def __contains__(self, k: int) -> bool:
        return self.get(k) is not None

    def __len__(self) -> int:
        return self.size

    def items(self) -> Iterator[Tuple[int, int]]:
        live = np.nonzero(self.keys >= 0)[0]
        for i in live.tolist():
            yield int(self.keys[i]), int(self.vals[i])

    def keys_live(self) -> np.ndarray:
        """All live keys (unordered)."""
        return self.keys[self.keys >= 0].copy()

    def key_set(self) -> set:
        return set(self.keys_live().tolist())

    # -- growth ----------------------------------------------------- #

    def _maybe_grow(self, incoming: int) -> None:
        # keep load (live + tombstones + incoming) under 2/3
        if (self.size + self.tombs + incoming) * 3 <= self.cap * 2:
            return
        live = self.keys >= 0
        old_keys = self.keys[live]
        old_vals = self.vals[live]
        newcap = self.cap
        while (self.size + incoming) * 3 > newcap * 2:
            newcap *= 2
        self.keys = np.full(newcap, EMPTY, dtype=np.int64)
        self.vals = np.empty(newcap, dtype=np.int64)
        self.cap = newcap
        self.mask = newcap - 1
        self.size = 0
        self.tombs = 0
        if old_keys.size:
            self.put_batch_new(old_keys, old_vals)


class IntStack:
    """LIFO free-list backed by a flat int64 array: batch push/pop are
    slice copies instead of list extend/del (the sweep frees hundreds of
    thousands of ids per batch)."""

    __slots__ = ("buf", "n")

    def __init__(self, init: Optional[np.ndarray] = None, cap: int = 64):
        if init is not None:
            init = np.asarray(init, dtype=np.int64)
            cap = max(cap, init.size)
        self.buf = np.empty(cap, dtype=np.int64)
        self.n = 0
        if init is not None and init.size:
            self.buf[: init.size] = init
            self.n = init.size

    @classmethod
    def from_range(cls, lo: int, hi: int) -> "IntStack":
        """Stack holding hi-1 .. lo (so pops come lowest-first, matching
        ``list(range(hi-1, lo-1, -1)).pop()`` order)."""
        return cls(np.arange(hi - 1, lo - 1, -1, dtype=np.int64))

    def _ensure(self, extra: int) -> None:
        need = self.n + extra
        if need > self.buf.shape[0]:
            newcap = max(need, self.buf.shape[0] * 2)
            nb = np.empty(newcap, dtype=np.int64)
            nb[: self.n] = self.buf[: self.n]
            self.buf = nb

    def push(self, v: int) -> None:
        self._ensure(1)
        self.buf[self.n] = v
        self.n += 1

    def push_batch(self, arr: np.ndarray) -> None:
        arr = np.asarray(arr, dtype=np.int64)
        self._ensure(arr.size)
        self.buf[self.n : self.n + arr.size] = arr
        self.n += arr.size

    def push_range(self, lo: int, hi: int) -> None:
        """Push hi-1 .. lo (list(range(hi-1, lo-1, -1)) order)."""
        self.push_batch(np.arange(hi - 1, lo - 1, -1, dtype=np.int64))

    def pop(self) -> int:
        self.n -= 1
        return int(self.buf[self.n])

    def pop_batch(self, k: int) -> np.ndarray:
        self.n -= k
        return self.buf[self.n : self.n + k].copy()

    def __len__(self) -> int:
        return self.n

    def __bool__(self) -> bool:
        return self.n > 0
