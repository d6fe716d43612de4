"""The sharded trace across CUDA cards: the mesh on several cards against
the same shards on one card and the single-device trace, and a live mesh
system across the cards.

Every test here needs at least two CUDA cards and skips with fewer.  On
a machine with the cards and no JAX, run it without the repo's conftest
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_mesh.py -q

This file imports neither jax nor uigc_tpu for that reason.
"""

import time

import numpy as np
import pytest
import torch

from uigc_tpu_torch.models import run_tree
from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import propagate as prop
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.ops.cuda_incremental import IncrementalCudaLayout
from uigc_tpu_torch.parallel import (Mesh, make_sharded_cuda_trace,
                                     make_sharded_decremental_wake,
                                     pack_shard_layouts, to_host)

pytestmark = pytest.mark.cuda
N = 200_000
S_ROWS = 32


@pytest.fixture
def cards():
    """The cards of the mesh: min(4, visible), at least 2."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        pytest.skip(f"needs 2 CUDA cards, {count} visible")
    return min(4, count)


def sharded_inputs(shards, seed=0):
    """A power-law graph padded to whole shards, a tenth of its pairs
    held back into the insert buckets."""
    rng = np.random.default_rng(seed)
    g = powerlaw_actor_graph(N, seed=seed, garbage_fraction=0.5)
    chunk = shards * S_ROWS * 128
    n_pad = -(-N // chunk) * chunk
    flags = np.zeros(n_pad, np.uint8)
    flags[:N] = g["flags"]
    recv = np.zeros(n_pad, np.int64)
    recv[:N] = g["recv_count"]
    psrc, pdst, _ = IncrementalCudaLayout.pairs_from_graph(
        g["edge_src"], g["edge_dst"], g["edge_weight"], g["supervisor"])
    order = rng.permutation(psrc.size)
    ins, base = order[: psrc.size // 10], order[psrc.size // 10:]
    stacked, meta, _ = pack_shard_layouts(psrc[base], pdst[base], n_pad,
                                          shards, s_rows=S_ROWS)
    ss = meta["shard_size"]
    owner = pdst[ins] // ss
    m = int(np.bincount(owner, minlength=shards).max())
    bsrc = np.full((shards, m), n_pad, np.int32)
    bdst = np.zeros((shards, m), np.int32)
    for d in range(shards):
        sel = ins[owner == d]
        bsrc[d, : sel.size] = psrc[sel]
        bdst[d, : sel.size] = pdst[sel] - d * ss
    jp = ct.jump_parents(psrc, pdst, n_pad)
    return dict(graph=g, n_pad=n_pad, meta=meta, m=m, jp=jp,
                args=(flags, recv, stacked["bmeta1"], stacked["bmeta2"],
                      stacked["row_pos"], stacked["emeta"], bsrc, bdst))


def geometry(inp, mesh):
    meta = inp["meta"]
    return (mesh, inp["n_pad"], meta["shard_size"], meta["n_blocks"],
            meta["r_rows"], S_ROWS, inp["m"])


def p50_ms(fn, args, reps=3):
    """The median host-clock ms of fn(*args), every card synchronised."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def test_trace_across_cards_equals_one_card(cards):
    inp = sharded_inputs(cards)
    g = inp["graph"]
    want = trace_ops.trace_marks_np(g["flags"], g["recv_count"],
                                    g["supervisor"], g["edge_src"],
                                    g["edge_dst"], g["edge_weight"])
    single = ct.trace_marks_cuda(g["flags"], g["recv_count"], g["supervisor"],
                                 g["edge_src"], g["edge_dst"],
                                 g["edge_weight"], mode="auto",
                                 device="cuda:0")
    assert np.array_equal(single, want)
    across = Mesh([f"cuda:{i}" for i in range(cards)])
    one_card = Mesh(["cuda:0"] * cards)
    assert len(across.distinct) == cards and len(one_card.distinct) == 1
    for mode in ("push", "auto"):
        jump = (inp["jp"],) if mode == "auto" else ()
        marks = {}
        for label, mesh in (("across", across), ("one card", one_card)):
            prop.reset_launches()
            fn = make_sharded_cuda_trace(*geometry(inp, mesh), mode=mode,
                                         with_stats=True)
            mark, stats = fn(*inp["args"], *jump)
            torch.cuda.synchronize()
            assert [m.device for m in mark] == list(mesh.devices)
            assert prop.launches["propagate_gated"] == cards * stats["n_sweeps"]
            # the jump kernel once a distinct card a sweep (auto only)
            jumps = len(mesh.distinct) * stats["n_sweeps"] if jump else 0
            assert prop.launches["jump"] == jumps
            marks[label] = to_host(mark)[:N]
            ms = p50_ms(fn, inp["args"] + jump)
            print(f"[mesh-cards] n={N} shards={cards} mode={mode} "
                  f"{label}: sweeps={stats['n_sweeps']} p50_ms={ms:.3f}")
        assert np.array_equal(marks["across"], marks["one card"]), mode
        assert np.array_equal(marks["across"], want), mode


def test_decremental_wake_across_cards_equals_one_card(cards):
    """A cold wake (zero previous state, the full derivation) and a wake
    after base-slot deletions, across the cards and on one card."""
    inp = sharded_inputs(cards, seed=1)
    n_words = inp["n_pad"] // 32
    zeros = np.zeros(n_words, np.int32)
    fresh = np.zeros(n_words, np.int32)
    dels = np.zeros(n_words, np.uint32)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, N, 500)
    np.bitwise_or.at(dels, ids >> 5, np.uint32(1) << (ids & 31).astype(np.uint32))
    outs = {}
    for label, mesh in (("across", Mesh([f"cuda:{i}" for i in range(cards)])),
                        ("one card", Mesh(["cuda:0"] * cards))):
        wake = make_sharded_decremental_wake(*geometry(inp, mesh), mode="auto")
        cold = wake(inp["args"][0], inp["args"][1], zeros, fresh,
                    *([zeros] * 5), *inp["args"][2:], inp["jp"])
        warm = wake(inp["args"][0], inp["args"][1], dels.view(np.int32),
                    fresh, *cold[1:], *inp["args"][2:], inp["jp"])
        outs[label] = [to_host(o) for o in cold + warm]
    for a, b in zip(outs["across"], outs["one card"]):
        assert np.array_equal(a, b)


def test_live_mesh_across_cards(cards):
    prop.reset_launches()
    r = run_tree(10_000, fanout=8, timeout_s=120.0, hold_wakes=10, config={
        "uigc.crgc.shadow-graph": "mesh", "uigc.crgc.device": "cuda",
        "uigc.crgc.mesh-devices": cards, "uigc.crgc.wakeup-interval": 10})
    assert r["n_collected"] == 10_000 and r["held_wakes"] >= 10
    assert prop.launches["propagate_gated"] > 0
