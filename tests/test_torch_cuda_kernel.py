"""The port's hand-written kernel on the card: held against its plain
PyTorch version, and the CUDA trace held against the numpy oracle.

Every test here needs a CUDA card and skips without one.  On a machine
with a card and no JAX, run it without the repo's conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernel.py -q

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
from uigc_tpu_torch.ops.cuda_incremental import EDGE, IncrementalCudaLayout

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the propagate kernel has no CPU mode)")
    return torch.device("cuda")


def shuffle_blocks(lay, seed):
    """The same layout blocks in another order (rows and metadata move
    together, so every slot keeps its row class)."""
    perm = torch.from_numpy(
        np.random.default_rng(seed).permutation(lay["n_blocks"])
    ).to(lay["bmeta1"].device)
    out = dict(lay)
    for k in ("bmeta1", "bmeta2"):
        out[k] = lay[k][perm].contiguous()
    for k in ("row_pos", "emeta"):
        blocks = lay[k].reshape(lay["n_blocks"], -1)
        out[k] = blocks[perm].reshape(lay[k].shape).contiguous()
    return out


def words_both(lay, table, d, gate):
    """Both versions of one layout's sweep into fresh zeroed planes; the
    kernel's launch is counted once on its form."""
    args = ct.device_args(lay)
    kw = dict(n_super=lay["n_super"], s_rows=lay["s_rows"], sub=lay["sub"],
              group=lay["group"], gate=gate,
              super_ids=args[4] if len(args) > 4 else None)
    before = dict(prop.launches)
    got = prop.propagate_words(d, *args[:2], table, *args[2:4],
                               torch.zeros_like(table), **kw)
    torch.cuda.synchronize()
    form = "propagate_gated" if gate is not None else "propagate"
    assert prop.launches[form] == before[form] + 1
    want = prop.propagate_words_torch(d, *args[:2], table, *args[2:4],
                                      torch.zeros_like(table), **kw)
    return got, want


@pytest.mark.parametrize("compact", [False, True])
def test_kernel_equals_plain_version(dev, compact):
    """Both forms against propagate_words_torch, exactly, on all-dirty and
    partial dirty sets, on a block-shuffled copy of the layout, and (the
    compact layout) with pad tiles mapped to supertile 0."""
    rng = np.random.default_rng(int(compact))
    n, n_src = 20_000, 1 << 20
    psrc = rng.integers(0, n_src, 100_000)
    pdst = np.where(rng.random(psrc.size) < 0.05, 3,
                    rng.integers(0, n, psrc.size))
    if compact:
        keep = (pdst % 9000) < 1000  # 5 supertiles, padded to 8
        psrc, pdst = psrc[keep], pdst[keep]
    prep = ct.prepare_pairs(psrc, pdst, n, n_src=n_src, s_rows=8,
                            compact_supers=compact, pad_blocks_pow2=compact)
    if compact:
        assert prep["out_supers"] > np.unique(prep["super_ids"]).size
    lay = ct.layout_to_device(prep, dev)
    shuffled = shuffle_blocks(lay, 7)
    n_chunks = prep["r_rows"] // ct.ROWS
    table = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (prep["r_rows"], ct.LANE),
                     dtype=np.int64).astype(np.int32)
    ).to(dev)
    for dirty in (np.ones(n_chunks, np.int32),
                  (np.arange(n_chunks) % 2).astype(np.int32)):
        d = torch.from_numpy(
            np.concatenate([[0], np.cumsum(dirty)]).astype(np.int32)
        ).to(dev)
        for gate in (None, torch.from_numpy(
                rng.integers(0, 3, prep["n_super"]).astype(np.int32)).to(dev)):
            got, want = words_both(lay, table, d, gate)
            assert torch.equal(got, want) and bool(want.any())
            got_s, want_s = words_both(shuffled, table, d, gate)
            assert torch.equal(got_s, want) and torch.equal(want_s, want)


@pytest.mark.parametrize("mode", ["push", "pull", "jump", "auto"])
def test_cuda_trace_matches_oracle(dev, mode):
    n = 1 << 16
    g = powerlaw_actor_graph(n, seed=4, garbage_fraction=0.5)
    args = (g["flags"], g["recv_count"], g["supervisor"], g["edge_src"],
            g["edge_dst"], g["edge_weight"])
    got = ct.trace_marks_cuda(*args, mode=mode, device=dev)
    assert np.array_equal(got, trace_ops.trace_marks_np(*args))


def test_incremental_and_decremental_on_the_card(dev):
    rng = np.random.default_rng(3)
    n = 1 << 14
    g = powerlaw_actor_graph(n, seed=2, garbage_fraction=0.5)
    keys = np.unique((g["edge_src"].astype(np.int64) << 32)
                     | g["edge_dst"].astype(np.int64))
    src = (keys >> 32).astype(np.int32)
    dst = (keys & 0xFFFFFFFF).astype(np.int32)
    w = np.ones(src.size, np.int64)
    flags, recv, sup = g["flags"].copy(), g["recv_count"], g["supervisor"]
    inc = IncrementalCudaLayout(n, s_rows=8, device=dev, freeze_threshold=64)
    dec = DecrementalTracer(n, s_rows=8, device=dev, freeze_threshold=64)
    for tr in (inc, dec):
        tr.rebuild(src, dst, w, sup)
    for wake in range(5):
        if wake:
            gone = rng.choice(np.nonzero(w > 0)[0], 100, replace=False)
            w[gone] = 0
            log = [(False, int(src[i]), int(dst[i]), EDGE) for i in gone]
            inc.apply_log(log)
            dec.apply_log(log)
            flags[rng.integers(0, n, 20)] |= trace_ops.FLAG_HALTED
        want = trace_ops.trace_marks_np(flags, recv, sup, src, dst, w)
        assert np.array_equal(inc.trace(flags, recv), want)
        assert np.array_equal(dec.marks(flags, recv), want)


@pytest.mark.parametrize("backend,pipelined", [
    ("device", False), ("decremental", False), ("decremental", True)])
def test_live_collector_traces_through_the_kernel(dev, backend, pipelined):
    """A live actor system on the card: a released tree is collected,
    nothing is stopped while held, and the kernel launched inside the
    collector."""
    from uigc_tpu_torch.models import run_tree

    prop.reset_launches()
    r = run_tree(3000, 8, timeout_s=60.0, hold_wakes=10, config={
        "uigc.crgc.shadow-graph": backend, "uigc.crgc.device": "cuda",
        "uigc.crgc.pipelined": pipelined, "uigc.crgc.wakeup-interval": 10})
    assert r["n_collected"] == 3000 and r["held_wakes"] >= 10
    assert prop.launches["propagate_gated"] > 0
