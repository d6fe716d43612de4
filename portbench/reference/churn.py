"""The plain reference of a churning shadow graph: the generated graph as
a shadow graph holds it, the seeded log of every collector wake, and the
replay of those logs into a pair-weight array whose full fixpoint
(``trace.reference_marks``) is the truth after each wake.

A shadow graph keys a ref by (src, dst), so the generated graph's
duplicate edges are merged (:func:`merged_graph`).  One wake's log is what
the mutators did since the last wake (``LocalGC.scala:144-186``: a
``Wakeup`` drains the entries, merges them, then traces):

- ``removed_refs`` refs released, drawn uniformly among the live refs;
- up to ``new_refs`` refs created, each inside its source's partition
  (live to live, garbage to garbage) and never a ref that is live;
- ``halts`` actors halted (any actor), ``busy_flips`` live actors that
  turn busy or idle, ``recv_resets`` live actors whose receive count
  drops to zero;
- every ``root_swap_every``-th wake, one root released and one live
  actor made a root.

Each wake draws from its own stream of the seed, with work in proportion
to the log, not to the graph: a sorted key array and ``searchsorted``,
plus the refs appended since set-up.  The same seed gives the same logs
to whoever replays them.  Pure numpy and torch; nothing here knows the
program's layouts or its decremental wake: the full fixpoint over the
pairs alive after a wake is the verdict that wake must give.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import graphgen as gg
from . import trace as ref


def merged_graph(g: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The generated graph's refs with duplicate (src, dst) edges merged,
    sorted by key ``src << 32 | dst``: ``keys`` (int64), ``src`` and
    ``dst`` (int32)."""
    keys = np.sort((g["edge_src"].astype(np.int64) << 32)
                   | g["edge_dst"].astype(np.int64))
    # a sort and a compare: np.unique may hash, which is far slower at
    # 50M keys
    keys = keys[np.concatenate([[True], keys[1:] != keys[:-1]])]
    return {"keys": keys, "src": (keys >> 32).astype(np.int32),
            "dst": (keys & 0xFFFFFFFF).astype(np.int32)}


class Wake:
    """One wake's inputs: ref indices (into the plan's pair arrays) and
    actor ids, int64 arrays."""

    __slots__ = ("k", "removed", "inserted", "halts", "busy", "resets",
                 "root_off", "root_on")

    def flag_groups(self):
        return (self.halts, self.busy, self.resets, self.root_off,
                self.root_on)


def apply_flags(flags, recv, halts, busy, resets, root_off, root_on) -> None:
    """One wake's flag and receive-count changes, in place; ``flags`` and
    ``recv`` are host arrays or device tensors, the groups index arrays
    or tensors of the same kind.  ``busy`` holds no actor twice, and the
    roots released and made differ."""
    flags[halts] |= int(gg.FLAG_HALTED)
    flags[busy] ^= int(gg.FLAG_BUSY)
    recv[resets] = 0
    flags[root_off] &= 0xFF ^ int(gg.FLAG_ROOT)
    flags[root_on] |= int(gg.FLAG_ROOT)


class WakePlan:
    """The logs of every wake, drawn one wake after another from the
    seed, and the refs they leave: ``src``/``dst`` of every ref known so
    far (the merged graph's, then the ones created, in order) and
    ``weight`` (1 live, 0 released).  A released ref created again comes
    back at its own index."""

    def __init__(self, merged: Dict[str, np.ndarray], g: Dict[str, np.ndarray],
                 seed: int, traffic: Dict[str, int]):
        self.seed = seed
        self.tr = traffic
        self.n = int(g["flags"].shape[0])
        self.n_live = int(g["n_live"])
        self.base_keys = merged["keys"]
        e = int(self.base_keys.size)
        cap = e + max(1024, e // 8)
        self._src = np.empty(cap, np.int32)
        self._dst = np.empty(cap, np.int32)
        self._src[:e] = merged["src"]
        self._dst[:e] = merged["dst"]
        self._weight = np.zeros(cap, np.uint8)
        self._weight[:e] = 1
        self.n_pairs = e
        self.n_alive = e
        #: key -> index of each ref created since set-up
        self.created: Dict[int, int] = {}
        self.roots = np.nonzero(g["flags"] & gg.FLAG_ROOT)[0].astype(np.int64)
        self.k = 0

    @property
    def src(self) -> np.ndarray:
        return self._src[:self.n_pairs]

    @property
    def dst(self) -> np.ndarray:
        return self._dst[:self.n_pairs]

    @property
    def weight(self) -> np.ndarray:
        return self._weight[:self.n_pairs]

    def _append(self, keys: np.ndarray) -> np.ndarray:
        """New refs at the end of the pair arrays; their indices."""
        i, c = self.n_pairs, keys.size
        if i + c > self._src.size:
            grow = max(1024, i // 4, c)
            self._src = np.concatenate([self._src, np.empty(grow, np.int32)])
            self._dst = np.concatenate([self._dst, np.empty(grow, np.int32)])
            self._weight = np.concatenate([self._weight,
                                           np.zeros(grow, np.uint8)])
        self._src[i:i + c] = keys >> 32
        self._dst[i:i + c] = keys & 0xFFFFFFFF
        self.n_pairs = i + c
        idx = np.arange(i, i + c, dtype=np.int64)
        self.created.update(zip(keys.tolist(), idx.tolist()))
        return idx

    def _index_of(self, keys: np.ndarray) -> np.ndarray:
        """Each key's ref index, -1 for a ref never seen; ``keys``
        sorted."""
        idx = np.full(keys.size, -1, np.int64)
        if self.base_keys.size:
            pos = np.searchsorted(self.base_keys, keys)
            pos = np.minimum(pos, self.base_keys.size - 1)
            hit = self.base_keys[pos] == keys
            idx[hit] = pos[hit]
        miss = np.nonzero(idx < 0)[0]
        get = self.created.get
        idx[miss] = [get(k, -1) for k in keys[miss].tolist()]
        return idx

    def _draw_removed(self, rng, m: int) -> np.ndarray:
        m = min(m, self.n_alive)
        chosen = np.empty(0, np.int64)
        while chosen.size < m:
            cand = rng.integers(0, self.n_pairs, 2 * (m - chosen.size) + 16)
            cand = np.concatenate([chosen, cand[self.weight[cand] > 0]])
            _, first = np.unique(cand, return_index=True)
            chosen = cand[np.sort(first)][:m]
        return chosen

    def _draw_created(self, rng, m: int) -> np.ndarray:
        n, n_live = self.n, self.n_live
        src = rng.integers(0, n, m)
        if n > n_live:
            dst = np.where(src < n_live, rng.integers(0, n_live, m),
                           rng.integers(n_live, n, m))
        else:
            dst = rng.integers(0, n_live, m)
        keys = np.sort((src << 32) | dst)
        keys = keys[np.concatenate([[True], keys[1:] != keys[:-1]])]
        idx = self._index_of(keys)
        known = idx >= 0
        dead = np.ones(keys.size, bool)
        dead[known] = self.weight[idx[known]] == 0
        idx = idx[dead]
        new = idx < 0
        idx[new] = self._append(keys[dead][new])
        self._weight[idx] = 1
        return idx

    def next(self) -> Wake:
        """Draw wake ``self.k``'s log and apply it to the refs."""
        tr = self.tr
        rng = gg.rng_for(self.seed, 3, self.k)
        w = Wake()
        w.k = self.k
        w.removed = self._draw_removed(rng, tr["removed_refs"])
        self._weight[w.removed] = 0
        self.n_alive -= int(w.removed.size)
        w.inserted = self._draw_created(rng, tr["new_refs"])
        self.n_alive += int(w.inserted.size)
        w.halts = rng.integers(0, self.n, tr["halts"])
        w.busy = rng.choice(self.n_live, min(tr["busy_flips"], self.n_live),
                            replace=False).astype(np.int64)
        w.resets = rng.integers(0, self.n_live, tr["recv_resets"])
        w.root_off = w.root_on = np.empty(0, np.int64)
        if (self.k + 1) % tr["root_swap_every"] == 0 and self.roots.size:
            j = int(rng.integers(0, self.roots.size))
            new = int(rng.integers(0, self.n_live))
            while new in self.roots:
                new = int(rng.integers(0, self.n_live))
            w.root_off = self.roots[j:j + 1].copy()
            w.root_on = np.array([new], np.int64)
            self.roots[j] = new
        self.k += 1
        return w


def check_verdicts(g: Dict[str, np.ndarray], merged: Dict[str, np.ndarray],
                   seed: int, traffic: Dict[str, int],
                   kept: Dict[int, np.ndarray], dev, pairs: tuple) -> int:
    """Verdicts of the kept wakes (``np.packbits`` of each) that differ
    from the reference's: the logs replayed from the seed into a fresh
    plan, and at each kept wake the full fixpoint, on ``dev``, over the
    refs alive then and the supervisor pairs.  ``pairs`` is (src, dst) of
    every ref the run's own plan knew at its end, a superset in the same
    order."""
    n = int(g["flags"].shape[0])
    plan = WakePlan(merged, g, seed, traffic)
    flags = g["flags"].copy()
    recv = g["recv_count"].copy()
    sup = g["supervisor"]
    child = np.nonzero(sup >= 0)[0]
    sup_src = torch.from_numpy(child.astype(np.int64)).to(dev)
    sup_dst = torch.from_numpy(sup[child].astype(np.int64)).to(dev)
    src_d = torch.from_numpy(pairs[0].astype(np.int64)).to(dev)
    dst_d = torch.from_numpy(pairs[1].astype(np.int64)).to(dev)
    bad = 0
    for k in sorted(kept):
        while plan.k <= k:
            w = plan.next()
            apply_flags(flags, recv, *w.flag_groups())
        alive = np.zeros(src_d.shape[0], bool)
        alive[:plan.n_pairs] = plan.weight > 0
        alive_d = torch.from_numpy(alive).to(dev)
        psrc = torch.cat([src_d[alive_d], sup_src])
        pdst = torch.cat([dst_d[alive_d], sup_dst])
        f = torch.from_numpy(flags).to(dev)
        recv_d = torch.from_numpy(recv).to(dev)
        want = ref.garbage_of(f, ref.reference_marks(f, recv_d, psrc, pdst))
        got = np.unpackbits(kept[k], count=n).astype(bool)
        bad += int(np.count_nonzero(want.cpu().numpy() != got))
    return bad


def log_pairs(plan: WakePlan, w: Wake) -> List[tuple]:
    """The wake's ref changes as (created?, src, dst) in log order: the
    releases, then the refs created."""
    src, dst = plan.src, plan.dst
    out = [(False, s, d) for s, d in zip(src[w.removed].tolist(),
                                         dst[w.removed].tolist())]
    out += [(True, s, d) for s, d in zip(src[w.inserted].tolist(),
                                        dst[w.inserted].tolist())]
    return out
