"""The port's device SCC (uigc_tpu_torch/ops/scc.py) against the JAX
package's: ``scc_labels_torch`` on the CPU must equal ``scc_labels_jax``
and the Tarjan oracle ``scc_labels_np`` label for label, on the same
seeded numpy graphs.

The graphs are padded to a few fixed (n, m) shapes, as the MAC detector
pads its inputs, so the JAX side compiles each shape once.
"""

import numpy as np
import pytest
import torch

from uigc_tpu.ops import scc as ref_scc
from uigc_tpu_torch.ops import scc

torch.set_num_threads(1)

#: (n_pad, m_pad) of the seeded graphs
SHAPES = ((64, 256), (128, 512))


def seeded_graph(seed, n_pad, m_pad):
    """tests/test_scc.py's generator inside a fixed padded shape: n real
    nodes (the rest inactive), up to 3n random edges, -1 padding, and a
    few endpoints out of range on both sides (they must be ignored)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, n_pad + 1))
    m = int(rng.integers(0, min(3 * n, m_pad) + 1))
    src = np.full(m_pad, -1, np.int32)
    dst = np.full(m_pad, -1, np.int32)
    src[:m] = rng.integers(0, n, m)
    dst[:m] = rng.integers(0, n, m)
    bad = rng.integers(0, m_pad, 3)
    src[bad[0]] = n_pad + 3
    dst[bad[1]] = -7
    src[bad[2]] = 1 << 30
    active = np.zeros(n_pad, bool)
    active[:n] = rng.random(n) < 0.8
    return src, dst, active


@pytest.mark.parametrize("n_pad,m_pad", SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scc_torch_equals_jax_and_tarjan(seed, n_pad, m_pad):
    for k in range(6):
        src, dst, active = seeded_graph(seed * 100 + k, n_pad, m_pad)
        want = ref_scc.scc_labels_np(n_pad, src, dst, active)
        assert np.array_equal(scc.scc_labels_np(n_pad, src, dst, active), want)
        jax_labels = ref_scc.scc_labels_jax(n_pad, src, dst, active)
        got = scc.scc_labels_torch(n_pad, src, dst, active, device="cpu")
        assert got.dtype == np.int32 and got.shape == (n_pad,)
        assert np.array_equal(jax_labels, want)
        assert np.array_equal(got, want)


def test_scc_ring_and_chain():
    # One 5-ring plus a 5-chain: the ring is one SCC, chain nodes are
    # singletons (tests/test_scc.py's case).
    ring = np.arange(5, dtype=np.int32)
    src = np.concatenate([ring, np.arange(5, 9, dtype=np.int32)])
    dst = np.concatenate([np.roll(ring, -1), np.arange(6, 10, dtype=np.int32)])
    labels = scc.scc_labels_torch(10, src, dst, device="cpu")
    assert (labels[:5] == 4).all()
    assert (labels[5:] == np.arange(5, 10)).all()
    assert np.array_equal(labels, ref_scc.scc_labels_jax(10, src, dst))
    assert np.array_equal(labels, scc.scc_labels_np(10, src, dst))


def test_scc_stats_count_every_host_read():
    """Each round ends in one read of any(~assigned) (plus the last one
    that ends the loop), each sweep in one read of its changed flag."""
    src, dst, active = seeded_graph(7, *SHAPES[1])
    labels, stats = scc.scc_labels_torch(SHAPES[1][0], src, dst, active,
                                         device="cpu", with_stats=True)
    want = scc.scc_labels_np(SHAPES[1][0], src, dst, active)
    assert np.array_equal(labels, want)
    n_sccs = np.unique(want[active]).size
    assert 1 <= stats["rounds"] <= n_sccs
    assert stats["sweeps"] >= 2 * stats["rounds"]  # >= 1 forward + 1 backward
    assert stats["host_reads"] == stats["sweeps"] + stats["rounds"] + 1


def test_scc_with_nothing_active_reads_once():
    src = np.array([0, 1, -1], np.int32)
    dst = np.array([1, 0, -1], np.int32)
    labels, stats = scc.scc_labels_torch(4, src, dst, np.zeros(4, bool),
                                         device="cpu", with_stats=True)
    assert np.array_equal(labels, np.arange(4))
    assert stats == {"rounds": 0, "sweeps": 0, "host_reads": 1}


def test_scc_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = np.array([0, 1], np.int32)
    dst = np.array([1, 0], np.int32)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scc.scc_labels_torch(2, src, dst, device=device)
