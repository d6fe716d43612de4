"""The jump step's kernel on the card (``csrc/propagate.cu``
``jump_sweep_kernel``): held bit for bit against its plain twin
(``ops/cuda_trace.py`` ``jump_sweep`` and ``pack_bools``), and the
fixpoint and the decremental wake that launch it held against the CPU
path's marks and sweep counts.

Every test here needs a CUDA card and skips without one.  On a machine
with a card and no JAX, run it without the repo's conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_jump.py -q

This file imports neither jax nor uigc_tpu for that reason.
"""

import numpy as np
import pytest
import torch

from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import propagate as prop
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.ops.cuda_decremental import DecrementalTracer
from uigc_tpu_torch.ops.cuda_incremental import EDGE

pytestmark = pytest.mark.cuda

JUMP_MODES = ("jump", "auto")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the jump kernel has no CPU mode)")
    return torch.device("cuda")


def parents_mix(rng, n, jp=None):
    """(n + 1,) int32 parents in [0, n]: min-source parents (of random
    pairs, or ``jp``), with the sentinel n, self-parents and a chain
    v -> v - 1 mixed in; entry n is n."""
    if jp is None:
        m = max(2 * n, 4)
        jp = ct.jump_parents(rng.integers(0, n, m), rng.integers(0, n, m), n)
    jp = jp.copy()
    kind = rng.integers(0, 8, n)
    v = np.arange(n)
    jp[:n] = np.where(kind == 1, n, jp[:n])
    jp[:n] = np.where(kind == 2, v, jp[:n])
    lo, hi = n // 4, n // 2
    jp[lo + 1:hi] = v[lo:hi - 1]
    return jp.astype(np.int32)


def rand_words(rng, r_rows):
    return torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (r_rows, ct.LANE), dtype=np.int64
    ).astype(np.int32))


def graph_parents(n):
    g = powerlaw_actor_graph(n, seed=5, garbage_fraction=0.5)
    return ct.jump_parents_from_graph(g["edge_src"], g["edge_dst"],
                                      g["edge_weight"], g["supervisor"], n)


@pytest.mark.parametrize("n,source", [
    (1, "pairs"), (31, "pairs"), (33, "pairs"), (131_072 + 5, "pairs"),
    (1 << 20, "powerlaw")])
def test_kernel_equals_plain_twin(dev, n, source):
    """hit_words and new_jump_j bit for bit against the twin, random
    transparent and in-use words, the caller's parents untouched, one
    launch counted a call."""
    rng = np.random.default_rng(n)
    r_rows = -(-n // (ct.LANE * 32)) + 1  # a spare row of words past n
    jp = parents_mix(rng, n, graph_parents(n) if source == "powerlaw" else None)
    table, trans, iu = (rand_words(rng, r_rows) for _ in range(3))
    want_w, want_j = ct.jump_sweep_words(table, torch.from_numpy(jp), trans,
                                         iu, n)
    operands = [x.to(dev) for x in (table, torch.from_numpy(jp), trans, iu)]
    kept = operands[1].clone()
    before = prop.launches["jump"]
    got_w, got_j = ct.jump_sweep_words(*operands, n)
    torch.cuda.synchronize()
    assert prop.launches["jump"] == before + 1
    assert torch.equal(got_w.cpu(), want_w) and torch.equal(got_j.cpu(), want_j)
    if n > 1000:  # the draw holds hits and parents that move
        assert bool(want_w.any())
        assert not torch.equal(want_j, torch.from_numpy(jp))
    assert torch.equal(operands[1], kept)
    assert got_w.shape == table.shape and got_j.shape == (n + 1,)


def trace_operands(g, mode, dev):
    n = g["flags"].shape[0]
    src, dst, w, sup = (g["edge_src"], g["edge_dst"], g["edge_weight"],
                        g["supervisor"])
    lay = ct.layout_to_device(ct.prepare_chunks(src, dst, w, sup, n), dev)
    jp = ct.jump_parents_from_graph(src, dst, w, sup, n)
    args = (torch.from_numpy(g["flags"]).to(dev),
            torch.from_numpy(g["recv_count"]).to(dev),
            torch.from_numpy(jp).to(dev), *ct.device_args(lay))
    return ct.get_trace_fn(lay, mode=mode, with_stats=True), args


@pytest.mark.parametrize("mode", JUMP_MODES)
def test_trace_on_the_card_matches_the_cpu_path(dev, mode):
    """The full fixpoint: the card's marks and sweeps are the CPU
    path's, and the jump kernel launches once a sweep."""
    g = powerlaw_actor_graph(1 << 16, seed=4, garbage_fraction=0.5)
    fn_cpu, args_cpu = trace_operands(g, mode, torch.device("cpu"))
    want, st_cpu = fn_cpu(*args_cpu)
    fn, args = trace_operands(g, mode, dev)
    jump_before = args[2].clone()
    fn(*args)  # the first call on a card builds the kernels
    prop.reset_launches()
    got, st = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert st["n_sweeps"] == st_cpu["n_sweeps"] >= 2
    assert prop.launches["jump"] == st["n_sweeps"]
    assert torch.equal(args[2], jump_before)
    oracle = trace_ops.trace_marks_np(
        g["flags"], g["recv_count"], g["supervisor"], g["edge_src"],
        g["edge_dst"], g["edge_weight"])
    assert np.array_equal(want.numpy(), oracle)


@pytest.mark.parametrize("mode", JUMP_MODES)
def test_decremental_wake_on_the_card_matches_the_cpu_path(dev, mode):
    """The decremental wake over five wakes of deletions and halts: the
    card's marks and repair sweeps are the CPU path's."""
    rng = np.random.default_rng(6)
    n = 1 << 14
    g = powerlaw_actor_graph(n, seed=2, garbage_fraction=0.5)
    keys = np.unique((g["edge_src"].astype(np.int64) << 32)
                     | g["edge_dst"].astype(np.int64))
    src = (keys >> 32).astype(np.int32)
    dst = (keys & 0xFFFFFFFF).astype(np.int32)
    w = np.ones(src.size, np.int64)
    flags, recv, sup = g["flags"].copy(), g["recv_count"], g["supervisor"]
    tracers = [DecrementalTracer(n, s_rows=8, device=d, freeze_threshold=64,
                                 mode=mode)
               for d in (torch.device("cpu"), dev)]
    for tr in tracers:
        tr.rebuild(src, dst, w, sup)
        tr.collect_stats = True
    launched = 0
    for wake in range(5):
        if wake:
            gone = rng.choice(np.nonzero(w > 0)[0], 100, replace=False)
            w[gone] = 0
            log = [(False, int(src[i]), int(dst[i]), EDGE) for i in gone]
            for tr in tracers:
                tr.apply_log(log)
            flags[rng.integers(0, n, 20)] |= trace_ops.FLAG_HALTED
        before = prop.launches["jump"]
        cpu, card = (tr.marks(flags, recv) for tr in tracers)
        launched += prop.launches["jump"] - before
        assert np.array_equal(card, cpu)
        assert np.array_equal(cpu, trace_ops.trace_marks_np(
            flags, recv, sup, src, dst, w))
        sweeps = [int(tr.last_stats["n_sweeps"]) for tr in tracers]
        assert sweeps[0] == sweeps[1]
        assert prop.launches["jump"] - before == sweeps[1]
    assert launched > 0
