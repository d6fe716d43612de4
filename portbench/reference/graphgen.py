"""Frozen copy of the power-law actor graph generator (the north star's
10M-actor reference graph, BASELINE config 5).

The benchmark owns this copy so that a later change to the program's own
generator cannot change what the benchmark measures.  Pure numpy; imports
nothing of the program.

Node flags are the collector's bit layout (the reference's
ShadowGraph.java pseudoroot bits), restated here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

FLAG_ROOT = np.uint8(1)
FLAG_BUSY = np.uint8(2)
FLAG_INTERNED = np.uint8(4)
FLAG_LOCAL = np.uint8(8)
FLAG_HALTED = np.uint8(16)
FLAG_IN_USE = np.uint8(32)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` (any integer, negative or past 64
    bits) and an optional stream path, so that one seed gives several
    independent, reproducible streams."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & ((1 << 64) - 1), *stream])
    )


def powerlaw_actor_graph(
    n: int,
    rng: np.random.Generator,
    garbage_fraction: float = 0.5,
    avg_degree: float = 3.0,
    alpha: float = 2.1,
    num_roots: int = 64,
) -> Dict[str, np.ndarray]:
    """A power-law refob graph of ``n`` actors.

    Slots ``[0, n_live)`` are the live partition, reachable from the
    ``num_roots`` root actors in its first slots; the rest is the garbage
    partition, connected only internally and closed by a cyclic spine.
    Out-degrees follow zipf(alpha) clipped to [1, 1000] and scaled to a
    mean of ``avg_degree``; targets are biased toward low slots
    (preferential attachment).  Every non-root live actor has a
    supervisor in a lower live slot and one guaranteed edge from it."""
    n_garbage = int(n * garbage_fraction)
    n_live = n - n_garbage
    if n_live < 1:
        n_live, n_garbage = 1, n - 1
    num_roots = max(1, min(num_roots, n_live))

    flags = np.full(n, FLAG_IN_USE | FLAG_INTERNED | FLAG_LOCAL, dtype=np.uint8)
    flags[:num_roots] |= FLAG_ROOT
    recv_count = np.zeros(n, dtype=np.int64)
    supervisor = np.full(n, -1, dtype=np.int32)

    live_ids = np.arange(1, n_live)
    supervisor[live_ids] = (rng.random(n_live - 1) * live_ids).astype(np.int32)
    if n_garbage > 1:
        g_ids = np.arange(n_live + 1, n)
        rel = g_ids - n_live
        supervisor[g_ids] = (n_live + (rng.random(n_garbage - 1) * rel)).astype(
            np.int32
        )
    if n_garbage > 0:
        supervisor[n_live] = 0

    degrees = np.minimum(rng.zipf(alpha, size=n), 1000)
    scale = avg_degree / max(degrees.mean(), 1e-9)
    degrees = np.maximum(1, (degrees * scale)).astype(np.int64)
    total_edges = int(degrees.sum())

    src = np.repeat(np.arange(n, dtype=np.int32), degrees)
    u = rng.random(total_edges)
    src_is_live = src < n_live
    tgt_live = (u * u * n_live).astype(np.int32)
    tgt_garbage = (n_live + (u * u * n_garbage)).astype(np.int32)
    dst = np.where(src_is_live, tgt_live, tgt_garbage).astype(np.int32)

    chain_src = supervisor[1:n_live].astype(np.int32)
    chain_dst = np.arange(1, n_live, dtype=np.int32)
    if n_garbage > 1:
        g = np.arange(n_live, n, dtype=np.int32)
        spine_src, spine_dst = g, np.roll(g, -1)
    else:
        spine_src = spine_dst = np.empty(0, dtype=np.int32)

    edge_src = np.concatenate([src, chain_src, spine_src])
    edge_dst = np.concatenate([dst, chain_dst, spine_dst])
    edge_weight = np.ones(edge_src.shape[0], dtype=np.int64)
    return {
        "flags": flags,
        "recv_count": recv_count,
        "supervisor": supervisor,
        "edge_src": edge_src,
        "edge_dst": edge_dst,
        "edge_weight": edge_weight,
        "n_live": n_live,
        "n_garbage": n_garbage,
        "num_roots": num_roots,
    }
