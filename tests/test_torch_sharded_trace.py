"""Port parity: the port's sharded trace against the JAX package's.

The JAX side runs as ``tests/test_sharded_trace.py`` runs it: on the
8-device virtual CPU mesh the repo conftest gives JAX, with the Pallas
kernel in interpret mode.  The port runs the same shard count on the CPU
(``build_mesh(n, "cpu")``), where the propagate kernel runs as its plain
PyTorch version.  The same seeded numpy inputs go to both, and results
must be equal, exactly: the bool fixpoint over ``shard_graph``'s
buckets, the per-shard packer, the kernel trace in every mode (against
the reference and the numpy oracle), the in-place fold and mask, and the
decremental wake over a churn schedule.
"""

import numpy as np
import pytest
import torch

from uigc_tpu import parallel as ref_par
from uigc_tpu.models import powerlaw_actor_graph, ring_graph
from uigc_tpu.ops import pallas_incremental as pinc
from uigc_tpu.ops import pallas_trace as ref_pt
from uigc_tpu_torch import parallel as par
from uigc_tpu_torch.ops import cuda_trace as pt
from uigc_tpu_torch.ops import trace as trace_ops

torch.set_num_threads(1)
D = 8  # the reference conftest's virtual CPU devices
S_ROWS = 8  # 1024-node supertiles: shards span several at these sizes


def oracle(graph):
    return trace_ops.trace_marks_np(
        graph["flags"], graph["recv_count"], graph["supervisor"],
        graph["edge_src"], graph["edge_dst"], graph["edge_weight"])


GRAPHS = [
    pytest.param(lambda: powerlaw_actor_graph(4000, seed=3,
                                              garbage_fraction=0.4),
                 id="powerlaw"),
    pytest.param(lambda: ring_graph(n_rings=20, ring_size=13, live=False),
                 id="rings-garbage"),
    pytest.param(lambda: ring_graph(n_rings=20, ring_size=13, live=True),
                 id="rings-live"),
]


@pytest.mark.parametrize("make", GRAPHS)
def test_bool_trace_matches_reference(make):
    graph = make()
    n = graph["flags"].shape[0]
    packed = par.shard_graph(graph, D)
    ref_packed = ref_par.shard_graph(graph, D)
    for key in ("flags", "recv_count", "pair_src", "pair_dst"):
        assert np.array_equal(packed[key], ref_packed[key]), key
    mesh = par.build_mesh(D, "cpu")
    args = (packed["flags"], packed["recv_count"], packed["pair_src"],
            packed["pair_dst"])
    mark = par.to_host(par.make_sharded_trace(mesh)(*args))
    ref_mark = np.asarray(ref_par.make_sharded_trace(ref_par.build_mesh(D))(
        *args))
    assert mark.shape == (packed["n_pad"],)
    assert np.array_equal(mark, ref_mark)
    assert np.array_equal(mark[:n], oracle(graph))


def sharded_inputs(seed, n_devices=D, hold_back=10):
    """tests/test_sharded_trace.py's operands: a 20k-node power-law graph
    padded to whole shards, 1/``hold_back`` of its pairs held back into
    the insert buckets."""
    rng = np.random.default_rng(seed)
    graph = powerlaw_actor_graph(20_000, seed=seed, garbage_fraction=0.4)
    n = graph["flags"].shape[0]
    chunk = n_devices * S_ROWS * 128
    n_pad = ((n + chunk - 1) // chunk) * chunk
    flags = np.zeros(n_pad, np.uint8)
    flags[:n] = graph["flags"]
    recv = np.zeros(n_pad, np.int64)
    recv[:n] = graph["recv_count"]
    psrc, pdst, _ = pinc.IncrementalPallasLayout.pairs_from_graph(
        graph["edge_src"], graph["edge_dst"], graph["edge_weight"],
        graph["supervisor"])
    cut = psrc.size // hold_back
    order = rng.permutation(psrc.size)
    base, ins = order[cut:], order[:cut]
    stacked, meta, _ = par.pack_shard_layouts(
        psrc[base], pdst[base], n_pad, n_devices, s_rows=S_ROWS, sub=1,
        group=1)
    ss = meta["shard_size"]
    owner = pdst[ins] // ss
    counts = np.bincount(owner, minlength=n_devices)
    m = max(64, int(counts.max(initial=1)))
    bsrc = np.full((n_devices, m), n_pad, np.int32)
    bdst = np.zeros((n_devices, m), np.int32)
    starts = np.zeros(n_devices, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    so = np.argsort(owner, kind="stable")
    col = np.arange(ins.size) - starts[owner[so]]
    bsrc[owner[so], col] = psrc[ins][so]
    bdst[owner[so], col] = pdst[ins][so] - owner[so] * ss
    return dict(graph=graph, n=n, n_pad=n_pad, flags=flags, recv=recv,
                psrc=psrc, pdst=pdst, stacked=stacked, meta=meta, bsrc=bsrc,
                bdst=bdst, m=m)


def operands(inp, mode):
    st = inp["stacked"]
    jump = ((pt.jump_parents(inp["psrc"], inp["pdst"], inp["n_pad"]),)
            if mode in ("jump", "auto") else ())
    return (inp["flags"], inp["recv"], st["bmeta1"], st["bmeta2"],
            st["row_pos"], st["emeta"], inp["bsrc"], inp["bdst"]) + jump


def port_trace(inp, mode, n_devices=D, with_stats=False):
    meta = inp["meta"]
    fn = par.make_sharded_cuda_trace(
        par.build_mesh(n_devices, "cpu"), meta["n_pad"], meta["shard_size"],
        meta["n_blocks"], meta["r_rows"], S_ROWS, inp["m"], sub=meta["sub"],
        group=meta["group"], mode=mode, with_stats=with_stats)
    return fn(*operands(inp, mode))


@pytest.mark.parametrize("n_devices", [8, 4])
def test_pack_shard_layouts_matches_reference(n_devices):
    inp = sharded_inputs(0, n_devices)
    psrc, pdst, n_pad = inp["psrc"], inp["pdst"], inp["n_pad"]
    stacked, meta, slots = par.pack_shard_layouts(
        psrc, pdst, n_pad, n_devices, s_rows=S_ROWS, sub=1, group=1)
    # the reference takes (sub, group) from its interpret flag: (1, 1)
    ref_stacked, ref_meta, ref_slots = ref_par.pack_shard_layouts(
        psrc, pdst, n_pad, n_devices, s_rows=S_ROWS, interpret=True)
    assert meta == ref_meta
    for key in ("bmeta1", "bmeta2", "row_pos", "emeta"):
        assert np.array_equal(stacked[key], ref_stacked[key]), key
    assert np.array_equal(slots, ref_slots)


@pytest.mark.parametrize("mode", ["push", "auto"])
def test_cuda_trace_matches_reference(mode):
    inp = sharded_inputs(0)
    meta = inp["meta"]
    marks, stats = port_trace(inp, mode, with_stats=True)
    ref_fn = ref_par.make_sharded_pallas_trace(
        ref_par.build_mesh(D), meta["n_pad"], meta["shard_size"],
        meta["n_blocks"], meta["r_rows"], S_ROWS, inp["m"], sub=meta["sub"],
        group=meta["group"], mode=mode)
    ref_ops = operands(inp, mode)
    if mode == "auto":  # the reference's own jump parents
        ref_ops = ref_ops[:-1] + (
            ref_pt.jump_parents(inp["psrc"], inp["pdst"], inp["n_pad"]),)
    ref_mark = np.asarray(ref_fn(*ref_ops))
    assert np.array_equal(par.to_host(marks), ref_mark)
    # one gated kernel call per shard per sweep, one host read per sweep
    assert stats["launches_per_shard"] == [stats["n_sweeps"]] * D
    assert stats["host_syncs"] == stats["n_sweeps"] + 1
    assert len(stats["dirty_chunks"]) == stats["n_sweeps"] > 0


@pytest.mark.parametrize(
    "seed,mode",
    [(0, "push"), (1, "push"), (0, "pull"), (0, "jump"), (0, "auto")],
)
def test_cuda_trace_matches_oracle(seed, mode):
    inp = sharded_inputs(seed)
    mark = par.to_host(port_trace(inp, mode))[: inp["n"]]
    assert np.array_equal(mark, oracle(inp["graph"]))


def test_shard_count_does_not_change_the_marks():
    """4 shards and 8 shards of the same pairs: equal marks (the 4-shard
    layout is a different packing of the same graph)."""
    a = par.to_host(port_trace(sharded_inputs(2, 8), "auto"))
    b = par.to_host(port_trace(sharded_inputs(2, 4), "auto", n_devices=4))
    n = min(a.size, b.size)
    assert np.array_equal(a[:n], b[:n])


def test_devices_may_repeat_in_a_mesh():
    """An explicit device tuple with repeats (several shards on one
    device, as chip_smoke.py puts 4 shards on one card) is a mesh."""
    mesh = par.Mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.distinct == (torch.device("cpu"),)
    inp = sharded_inputs(0, 4)
    meta = inp["meta"]
    fn = par.make_sharded_cuda_trace(
        ["cpu"] * 4, meta["n_pad"], meta["shard_size"], meta["n_blocks"],
        meta["r_rows"], S_ROWS, inp["m"], mode="push")
    mark = par.to_host(fn(*operands(inp, "push")))[: inp["n"]]
    assert np.array_equal(mark, oracle(inp["graph"]))


def test_fold_and_mask_match_reference():
    """The in-place fold and mask against the reference's donated ones,
    with the reference's padded batches (sink slot = shard size, sink row
    = layout rows): the port drops the padding on the host."""
    inp = sharded_inputs(4)
    ss, rows = inp["meta"]["shard_size"], inp["stacked"]["row_pos"].shape[1]
    rng = np.random.default_rng(4)
    k = 40
    slot = np.full((D, k + 3), ss, np.int32)
    recv_delta = np.zeros((D, k + 3), np.int64)
    flag_set = np.zeros((D, k + 3), np.uint8)
    flag_clear = np.zeros((D, k + 3), np.uint8)
    ri = np.full((D, k + 3), rows, np.int32)
    col = np.zeros((D, k + 3), np.int32)
    for d in range(D):
        slot[d, :k] = rng.choice(ss, k, replace=False)
        recv_delta[d, :k] = rng.integers(-3, 4, k)
        flag_set[d, :k] = rng.integers(0, 64, k)
        flag_clear[d, :k] = rng.integers(0, 64, k)
        ri[d, :k] = rng.integers(0, rows, k)
        col[d, :k] = rng.integers(0, 128, k)
    mesh = par.build_mesh(D, "cpu")
    flags, recv = par.make_sharded_fold(mesh)(
        inp["flags"], inp["recv"], slot, recv_delta, flag_set, flag_clear)
    ref_flags, ref_recv = ref_par.make_sharded_fold(ref_par.build_mesh(D))(
        inp["flags"], inp["recv"], slot, recv_delta, flag_set, flag_clear)
    assert np.array_equal(par.to_host(flags), np.asarray(ref_flags))
    assert np.array_equal(par.to_host(recv), np.asarray(ref_recv))

    st = inp["stacked"]
    row_pos = par.put_stacked(mesh, st["row_pos"])
    emeta = par.put_stacked(mesh, st["emeta"])
    out = par.make_sharded_mask(mesh)(row_pos, emeta, ri, col)
    assert all(a is b for a, b in zip(out[0] + out[1], row_pos + emeta))
    from uigc_tpu.parallel.sharded_trace import make_sharded_mask
    import jax.numpy as jnp

    ref_rp, ref_em = make_sharded_mask(ref_par.build_mesh(D))(
        jnp.asarray(st["row_pos"]), jnp.asarray(st["emeta"]), ri, col)
    assert np.array_equal(np.stack([t.numpy() for t in row_pos]),
                          np.asarray(ref_rp))
    assert np.array_equal(np.stack([t.numpy() for t in emeta]),
                          np.asarray(ref_em))


@pytest.mark.parametrize("mode", ["push", "auto"])
def test_decremental_wakes_match_reference(mode):
    """The closure+repair wake against the reference's over
    tests/test_sharded_trace.py's churn: flag churn (halts, de-seeding,
    frees, slots coming alive), bucket inserts and base-slot masks across
    wakes, the jump parents maintained as the mesh backend does.  Every
    output word array equals the reference's, and the marks the oracle."""
    rng = np.random.default_rng(5)
    graph = powerlaw_actor_graph(20_000, seed=5, garbage_fraction=0.4)
    n = graph["flags"].shape[0]
    chunk = D * S_ROWS * 128
    n_pad = ((n + chunk - 1) // chunk) * chunk
    flags = np.zeros(n_pad, np.uint8)
    flags[:n] = graph["flags"]
    recv = np.zeros(n_pad, np.int64)
    recv[:n] = graph["recv_count"]
    psrc, pdst, _ = pinc.IncrementalPallasLayout.pairs_from_graph(
        graph["edge_src"], graph["edge_dst"], graph["edge_weight"],
        graph["supervisor"])
    stacked, meta, slot_vals = par.pack_shard_layouts(
        psrc, pdst, n_pad, D, s_rows=S_ROWS)
    ss = meta["shard_size"]
    m = 64
    bsrc = np.full((D, m), n_pad, np.int32)
    bdst = np.zeros((D, m), np.int32)
    bcount = np.zeros(D, np.int64)
    geom = (n_pad, ss, meta["n_blocks"], meta["r_rows"], S_ROWS, m)
    kw = dict(sub=meta["sub"], group=meta["group"], mode=mode)
    wake = par.make_sharded_decremental_wake(par.build_mesh(D, "cpu"),
                                             *geom, **kw)
    ref_wake = ref_par.make_sharded_decremental_wake(ref_par.build_mesh(D),
                                                     *geom, **kw)
    use_jump = mode == "auto"
    jp = pt.jump_parents(psrc, pdst, n_pad) if use_jump else None
    n_words = n_pad // 32
    state = [np.zeros(n_words, np.int32)] * 5
    live_pairs = list(zip(psrc.tolist(), pdst.tolist()))
    bucket_pairs = []

    def words_of(ids):
        w = np.zeros(n_words, np.uint32)
        ids = np.asarray(sorted(set(ids)), np.int64)
        if ids.size:
            np.bitwise_or.at(
                w, ids >> 5, np.uint32(1) << (ids & 31).astype(np.uint32))
        return w.view(np.int32)

    def run_wake(del_ids, fresh_ids):
        nonlocal state
        args = (flags, recv, words_of(del_ids), words_of(fresh_ids), *state,
                stacked["bmeta1"], stacked["bmeta2"], stacked["row_pos"],
                stacked["emeta"], bsrc, bdst) + ((jp,) if use_jump else ())
        out = [par.to_host(o) for o in wake(*args)]
        ref_out = [np.asarray(o) for o in ref_wake(*args)]
        for name, a, b in zip(("mark", "mark_w", "seed_w", "halted_w", "iu_w",
                               "active_w"), out, ref_out):
            assert np.array_equal(a, b), name
        state = out[1:]
        return out[0][:n]

    def expected():
        allp = [p for p in live_pairs if p is not None] + bucket_pairs
        s = np.array([p[0] for p in allp], np.int32)
        d = np.array([p[1] for p in allp], np.int32)
        return trace_ops.trace_marks_np(
            flags[:n], recv[:n], np.full(n, -1, np.int32), s, d,
            np.ones(len(allp), np.int64))

    assert np.array_equal(run_wake([], []), expected())  # cold start
    for wk in range(3):
        del_ids, fresh_ids = [], []
        for _ in range(20):
            i = int(rng.integers(0, n))
            r = rng.random()
            if r < 0.3:
                flags[i] |= trace_ops.FLAG_HALTED
            elif r < 0.5:
                flags[i] ^= trace_ops.FLAG_BUSY
            elif r < 0.7:
                recv[i] = 0 if recv[i] else 2
            elif r < 0.85:
                flags[i] = 0  # freed
            else:
                flags[i] = trace_ops.FLAG_IN_USE | trace_ops.FLAG_INTERNED
        for _ in range(10):
            s_, d_ = int(rng.integers(0, n)), int(rng.integers(0, n))
            sh = d_ // ss
            c = int(bcount[sh])
            if c >= m or (s_, d_) in bucket_pairs:
                continue
            bsrc[sh, c] = s_
            bdst[sh, c] = d_ - sh * ss
            bcount[sh] = c + 1
            bucket_pairs.append((s_, d_))
            fresh_ids.append(d_)
            if use_jump and s_ < jp[d_]:
                jp[d_] = s_
        for _ in range(10):
            j = int(rng.integers(0, len(live_pairs)))
            if live_pairs[j] is None:
                continue
            s_, d_ = live_pairs[j]
            live_pairs[j] = None
            if use_jump and jp[d_] == s_:
                jp[d_] = n_pad
            sv = int(slot_vals[j])
            sh, ri, col = sv >> 40, (sv >> 8) & 0xFFFFFFFF, sv & 0xFF
            stacked["row_pos"][sh, ri, col] = pt._PAD_ROW
            stacked["emeta"][sh, ri, col] = 0
            del_ids.append(d_)
        got = run_wake(del_ids, fresh_ids)
        want = expected()
        assert np.array_equal(got, want), (
            f"wake {wk}: {int((got != want).sum())} mismatches")
