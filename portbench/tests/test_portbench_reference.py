"""The plain reference against the program's own numpy oracle
(``trace_marks_np``) on small seeded graphs: trees, rings, power-law
graphs, with halted, busy and messaged actors.  The test may import the
program; the reference may not."""

import numpy as np
import pytest

from portbench.reference import graphgen as gg
from portbench.reference import trace as ref


def oracle(g):
    from uigc_tpu_torch.ops.trace import trace_marks_np

    return trace_marks_np(g["flags"], g["recv_count"], g["supervisor"],
                          g["edge_src"], g["edge_dst"], g["edge_weight"])


def reference(g, short_by=0):
    psrc, pdst = ref.propagation_pairs(g["edge_src"], g["edge_dst"],
                                       g["edge_weight"], g["supervisor"])
    return ref.reference_marks(g["flags"], g["recv_count"], psrc, pdst,
                               short_by=short_by).numpy()


def perturb(g, seed):
    """Halt, busy, message, unintern and free a few actors; zero a few
    edge weights."""
    rng = np.random.default_rng(seed)
    n = g["flags"].size
    f = g["flags"]
    f[rng.integers(0, n, max(1, n // 50))] |= gg.FLAG_HALTED
    f[rng.integers(0, n, max(1, n // 50))] |= gg.FLAG_BUSY
    f[rng.integers(0, n, max(1, n // 200))] &= ~gg.FLAG_INTERNED
    f[rng.integers(0, n, max(1, n // 200))] &= ~gg.FLAG_IN_USE
    g["recv_count"][rng.integers(0, n, max(1, n // 100))] = 3
    g["edge_weight"][rng.integers(0, g["edge_weight"].size,
                                  max(1, g["edge_weight"].size // 20))] = 0
    return g


def tree_graph(size, fanout):
    parent = (np.arange(size) - 1) // fanout  # breadth first; the top's is -1
    n = size + 1  # slot 0: the root actor holding the tree's top
    flags = np.full(n, gg.FLAG_IN_USE | gg.FLAG_INTERNED | gg.FLAG_LOCAL, np.uint8)
    flags[0] |= gg.FLAG_ROOT
    sup = np.concatenate([[-1], np.where(parent < 0, 0, parent + 1)]).astype(np.int32)
    src = sup[1:].astype(np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    return {"flags": flags, "recv_count": np.zeros(n, np.int64), "supervisor": sup,
            "edge_src": src, "edge_dst": dst, "edge_weight": np.ones(size, np.int64)}


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
@pytest.mark.parametrize("shaken", [False, True])
def test_powerlaw_graphs(seed, shaken):
    g = gg.powerlaw_actor_graph(3000, gg.rng_for(seed, 0))
    if shaken:
        perturb(g, seed)
    assert np.array_equal(reference(g), oracle(g))


@pytest.mark.parametrize("live_rings", [False, True])
@pytest.mark.parametrize("shaken", [False, True])
def test_rings(live_rings, shaken):
    from uigc_tpu_torch.models.graphgen import ring_graph

    g = ring_graph(40, 25, live=live_rings)
    if shaken:
        perturb(g, 7)
    assert np.array_equal(reference(g), oracle(g))


@pytest.mark.parametrize("size,fanout", [(1, 8), (500, 8), (2000, 3)])
@pytest.mark.parametrize("shaken", [False, True])
def test_trees(size, fanout, shaken):
    g = tree_graph(size, fanout)
    if shaken:
        perturb(g, size)
    assert np.array_equal(reference(g), oracle(g))


def test_short_by_one_stops_early():
    g = gg.powerlaw_actor_graph(3000, gg.rng_for(3, 0))
    full, short = reference(g), reference(g, short_by=1)
    assert (short <= full).all() and short.sum() < full.sum()
