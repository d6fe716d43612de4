"""Port parity: the CUDA trace fixpoint (uigc_tpu_torch.ops.cuda_trace)
against the reference's Pallas fixpoint (uigc_tpu.ops.pallas_trace).

The port runs with device="cpu", so every sweep goes through the plain
version of the propagate kernel; the reference runs its Pallas kernel in
interpret mode.  Both read the same packed layout.  Marks, sweep counts
and the per-sweep frontier stats are integers or booleans, so every
comparison is exact.  The last tests pin the three invariants the
fixpoint rests on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uigc_tpu.models.graphgen import powerlaw_actor_graph
from uigc_tpu.ops import pallas_trace as ref
from uigc_tpu.ops import trace as ref_trace
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.utils.validation import InvariantViolation

from test_torch_trace import random_graph

F = trace_ops
MODES = ("push", "pull", "jump", "auto")


def graph_case(name):
    if name == "random":
        g = random_graph(np.random.default_rng(1), 1500, 6000)
    else:
        p = powerlaw_actor_graph(1 << 12, seed=0, garbage_fraction=0.5)
        g = (p["flags"], p["recv_count"], p["supervisor"],
             p["edge_src"].astype(np.int32), p["edge_dst"].astype(np.int32),
             p["edge_weight"])
    flags, recv, sup, src, dst, w = g
    n = flags.shape[0]
    prep = ref.prepare_chunks(src, dst, w, sup, n, s_rows=8)
    jp = ref.jump_parents_from_graph(src, dst, w, sup, n)
    return g, prep, jp


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("graph", ["random", "powerlaw"])
def test_modes_match_reference(graph, mode):
    g, prep, jp = graph_case(graph)
    flags, recv = g[0], g[1]
    want_m, want_s = ref.trace_marks_layouts(
        flags, recv, [prep], mode=mode, jump_parent=jp, with_stats=True
    )
    got_m, got_s = ct.trace_marks_layouts(
        flags, recv, [prep], device="cpu", mode=mode, jump_parent=jp,
        with_stats=True,
    )
    assert np.array_equal(got_m, want_m)
    assert np.array_equal(got_m, ref_trace.trace_marks_np(*g))
    for k, v in want_s.items():
        assert np.array_equal(got_s[k], v), k
    # one read of the dirty count before the loop and one per sweep
    assert int(got_s["host_syncs"]) == int(got_s["n_sweeps"]) + 1


def test_multi_layout_tiers_match_reference():
    """Dense base + compact frozen delta + raw-pair (xla) tier, combined
    before thresholding, in auto mode: the union of the tiers' pairs
    propagates exactly as the reference's multi-layout trace does."""
    g = random_graph(np.random.default_rng(4), 2500, 9000)
    flags, recv, sup, src, dst, w = g
    n = flags.shape[0]
    psrc, pdst, _ = ref_inc_pairs(src, dst, w, sup)
    rng = np.random.default_rng(0)
    tier = rng.integers(0, 3, psrc.size)
    base = ref.prepare_pairs(psrc[tier == 0], pdst[tier == 0], n, s_rows=8,
                             pad_blocks_pow2=True)
    frozen = ref.prepare_pairs(psrc[tier == 1], pdst[tier == 1], n, s_rows=8,
                               pad_blocks_pow2=True, compact_supers=True)
    # n = 2500 is not a multiple of the supertile, so sink pads stay
    # inside the table; the test below covers the one-past-the-table case
    live = ref.xla_tier(psrc[tier == 2], pdst[tier == 2], n, 1 << 12)
    preps = [base, frozen, live]
    jp = ref.jump_parents(psrc, pdst, n)
    want_m, want_s = ref.trace_marks_layouts(
        flags, recv, preps, mode="auto", jump_parent=jp, with_stats=True
    )
    got_m, got_s = ct.trace_marks_layouts(
        flags, recv, preps, device="cpu", mode="auto", jump_parent=jp,
        with_stats=True,
    )
    assert np.array_equal(got_m, want_m)
    assert np.array_equal(got_m, ref_trace.trace_marks_np(*g))
    assert int(got_s["n_sweeps"]) == int(want_s["n_sweeps"])


@pytest.mark.parametrize("gated", [False, True])
def test_multi_layout_sweep_matches_reference_packed(gated):
    """One sweep over a dense, a compact and an xla tier: the port's word
    plane is the reference sweep's hits plane, packed, for a seeded
    table, dirty set and global gate."""
    rng = np.random.default_rng(12)
    n, n_src = 5000, 1 << 17
    pdst = rng.integers(0, n, 12000)
    tier = rng.integers(0, 3, pdst.size)
    # packed tiers draw sources from every walk group; the xla tier reads
    # sources below n only
    psrc = np.where(tier == 2, rng.integers(0, n, pdst.size),
                    rng.integers(0, n_src, pdst.size))
    kw = dict(s_rows=8, n_src=n_src, pad_blocks_pow2=True)
    base = ref.prepare_pairs(psrc[tier == 0], pdst[tier == 0], n, **kw)
    keep = (tier == 1) & (pdst % 2500 < 600)
    frozen = ref.prepare_pairs(psrc[keep], pdst[keep], n,
                               compact_supers=True, **kw)
    live = ref.xla_tier(psrc[tier == 2], pdst[tier == 2], n, 1 << 12)
    preps = [base, frozen, live]
    assert frozen["out_supers"] > np.unique(frozen["super_ids"]).size
    specs = tuple(ref.layout_spec(p) for p in preps)
    r_rows, n_super = base["r_rows"], base["n_super"]
    n_chunks = r_rows // ref.ROWS
    table = rng.integers(-(1 << 31), 1 << 31, (r_rows, ref.LANE),
                         dtype=np.int64).astype(np.int32)
    dirty = (rng.random(n_chunks) < 0.5).astype(np.int32)
    dirty[0] = 1
    d = np.concatenate([[0], np.cumsum(dirty)]).astype(np.int32)
    l = np.zeros(n_chunks, np.int32)
    l[: dirty.sum()] = np.nonzero(dirty)[0]
    gate = (rng.integers(0, 3, n_super).astype(np.int32) if gated else None)
    args = [a for p in preps for a in ref.device_args(p)]
    ref_sweep = ref.build_sweep_contribs(
        specs,
        ref.build_layout_propagates(specs, n_super, r_rows, 8, True,
                                    dst_gate=gated),
        n, n_super, 8, jnp,
    )
    want = np.asarray(ref.pack_hits_table(
        ref_sweep(jnp.asarray(table), d, l, [jnp.asarray(a) for a in args],
                  gate=None if gate is None else jnp.asarray(gate)),
        r_rows, jnp))
    sweep = ct.build_sweep_contribs(specs, n, n_super, 8)
    got = sweep(torch.from_numpy(table), torch.from_numpy(d),
                [torch.from_numpy(np.ascontiguousarray(a)) for a in args],
                gate=None if gate is None else torch.from_numpy(gate))
    assert got.dtype == torch.int32 and got.shape == (r_rows, ref.LANE)
    assert np.array_equal(got.numpy(), want)
    assert (want != 0).any()


def ref_inc_pairs(src, dst, w, sup):
    from uigc_tpu.ops.pallas_incremental import IncrementalPallasLayout

    return IncrementalPallasLayout.pairs_from_graph(src, dst, w, sup)


def test_xla_tier_sink_pad_past_the_table():
    """n a multiple of the 4096-node supertile and n_super a multiple of
    the 8-row walk group: a sink pad (src = n) addresses the word row one
    past the table, which must read as 0 (torch would raise where JAX
    clamps)."""
    n = 8 * 4096
    flags = np.full(n, F.FLAG_IN_USE | F.FLAG_INTERNED, np.uint8)
    flags[0] |= F.FLAG_ROOT
    recv = np.zeros(n, np.int64)
    base = ct.prepare_pairs(np.array([0]), np.array([1]), n)
    live = ct.xla_tier(np.array([1, 2]), np.array([2, 3]), n, 64)
    assert (live["xla_src"][2:] >> 5 >> 7 == base["r_rows"]).all()
    marks = ct.trace_marks_layouts(flags, recv, [base, live], device="cpu")
    assert marks[:4].all() and not marks[4:].any()


@pytest.mark.parametrize("mode", MODES)
def test_multi_chunk_fixpoint_matches_oracle(mode):
    """Port only, at a size whose table spans several walk groups, so the
    dirty-group skip and the pull gates act on real partial frontiers."""
    n = 1 << 17
    p = powerlaw_actor_graph(n, seed=2, garbage_fraction=0.5)
    args = (p["flags"], p["recv_count"], p["supervisor"], p["edge_src"],
            p["edge_dst"], p["edge_weight"])
    prep = ct.prepare_chunks(p["edge_src"], p["edge_dst"], p["edge_weight"],
                             p["supervisor"], n)
    assert prep["r_rows"] // ct.ROWS >= 4
    jp = ct.jump_parents_from_graph(p["edge_src"], p["edge_dst"],
                                    p["edge_weight"], p["supervisor"], n)
    marks, stats = ct.trace_marks_layouts(
        p["flags"], p["recv_count"], [prep], device="cpu", mode=mode,
        jump_parent=jp, with_stats=True,
    )
    assert np.array_equal(marks, trace_ops.trace_marks_np(*args))
    garbage, _ = trace_ops.garbage_and_kills_np(p["flags"], p["supervisor"],
                                                marks)
    assert np.array_equal(garbage, p["expected_garbage"])
    sweeps = int(stats["n_sweeps"])
    dirty = stats["dirty_chunks"][:sweeps]
    assert dirty.min() < prep["r_rows"] // ct.ROWS  # a partial frontier
    if mode in ("jump", "auto"):
        assert sweeps <= 6


def test_trace_marks_cuda_runs_on_cpu_when_asked():
    g = random_graph(np.random.default_rng(2), 800, 3000)
    for mode in MODES:
        got = ct.trace_marks_cuda(*g, mode=mode, device="cpu")
        assert np.array_equal(got, ref_trace.trace_marks_np(*g)), mode


def test_layout_to_device_takes_either_packer():
    g = random_graph(np.random.default_rng(6), 600, 2000)
    flags, recv, sup, src, dst, w = g
    n = flags.shape[0]
    for prep in (ref.prepare_chunks(src, dst, w, sup, n),
                 ct.prepare_chunks(src, dst, w, sup, n)):
        lay = ct.layout_to_device(prep, "cpu")
        assert all(a.dtype == torch.int32 for a in ct.device_args(lay))
        fn = ct.get_trace_fn(lay)
        marks = fn(torch.from_numpy(flags), torch.from_numpy(recv),
                   *ct.device_args(lay))
        assert np.array_equal(marks.numpy(), ref_trace.trace_marks_np(*g))
    bad = dict(prep, bmeta1=prep["bmeta1"].copy())
    bad["bmeta1"][-1] = prep["n_super"] << 1  # a block past the output
    with pytest.raises(InvariantViolation, match="block maps past"):
        ct.layout_to_device(bad, "cpu")


# --------------------------------------------------------------------- #
# The invariants the fixpoint rests on
# --------------------------------------------------------------------- #


def multi_chunk_sweep(seed):
    rng = np.random.default_rng(seed)
    n = 1 << 17
    psrc = rng.integers(0, n, 20000)
    pdst = rng.integers(0, n, 20000)
    prep = ct.prepare_pairs(psrc, pdst, n, s_rows=8)
    lay = ct.layout_to_device(prep, "cpu")
    n_chunks = prep["r_rows"] // ct.ROWS
    sweep = ct.build_sweep_contribs((ct.layout_spec(prep),), n,
                                    prep["n_super"], prep["s_rows"])

    def run(table, table_prev):
        d, _ = ct.dirty_group_lists(table, table_prev, n_chunks, ct.ROWS)
        return sweep(table, d, ct.device_args(lay))

    def pack(active):
        return ct.pack_bools(torch.from_numpy(active), n, prep["r_rows"])

    return rng, n, n_chunks, run, pack


def test_clean_chunk_skip_is_exact_only_under_monotone_or():
    """Walking only the groups whose words changed is exact when the
    table only grew: what the clean groups contribute is already in the
    marks from the sweep that last walked them.  After a bit is CLEARED
    the skip is not exact — the old contribution of the cleared source
    survives in the marks — which is why the decremental wake forces a
    FULL walk on its repair region."""
    rng, n, n_chunks, run, pack = multi_chunk_sweep(3)
    chunk_nodes = ct.ROWS * ct.LANE * ct.WORD_BITS
    prev = rng.random(n) < 0.2
    zero = pack(np.zeros(n, bool))
    full_prev = run(pack(prev), zero)
    # monotone growth confined to walk group 1
    grown = prev.copy()
    grown[chunk_nodes:2 * chunk_nodes] |= rng.random(chunk_nodes) < 0.3
    d, _ = ct.dirty_group_lists(pack(grown), pack(prev), n_chunks, ct.ROWS)
    assert int(d[-1]) == 1  # one dirty group of n_chunks
    skip = run(pack(grown), pack(prev))
    assert torch.equal(full_prev | skip, run(pack(grown), zero))
    # non-monotone: clear group 2's sources; the skip keeps stale hits
    shrunk = prev.copy()
    shrunk[2 * chunk_nodes:3 * chunk_nodes] = False
    stale = full_prev | run(pack(shrunk), pack(prev))
    exact = run(pack(shrunk), zero)
    assert bool((stale & ~exact).any()) and not bool((exact & ~stale).any())


def test_contributions_are_not_carried_across_sweeps():
    """Each sweep's hit words are computed from that sweep's table alone:
    the sweep ORs into a plane it zeroes every call, so a sweep over an
    empty table, or a SKIP-gated tile, contributes nothing whatever an
    earlier sweep produced."""
    rng, n, n_chunks, run, pack = multi_chunk_sweep(5)
    hot = run(pack(rng.random(n) < 0.5), pack(np.zeros(n, bool)))
    assert bool(hot.any())
    cold = run(pack(np.zeros(n, bool)), pack(rng.random(n) < 0.5))
    assert not bool(cold.any())
    prep = ct.prepare_pairs(np.arange(64), np.arange(64) * 2048, 1 << 17,
                            s_rows=8)
    lay = ct.layout_to_device(prep, "cpu")
    table = ct.pack_bools(torch.ones(1 << 17, dtype=torch.bool), 1 << 17,
                          prep["r_rows"])
    d = torch.arange(prep["r_rows"] // ct.ROWS + 1, dtype=torch.int32)
    gate = torch.zeros(prep["n_super"], dtype=torch.int32)
    args = dict(n_super=prep["n_super"], s_rows=8, sub=1, group=1)
    sweep = ct.build_sweep_contribs((ct.layout_spec(prep),), 1 << 17,
                                    prep["n_super"], 8)
    first = sweep(table, d, ct.device_args(lay), gate=gate)
    gate[:] = ct.GATE_SKIP
    second = sweep(table, d, ct.device_args(lay), gate=gate)
    assert torch.equal(first, ct.propagate_words(
        d, *ct.device_args(lay)[:2], table, *ct.device_args(lay)[2:],
        torch.zeros_like(table), gate=gate * 0, **args))
    assert int(ct.unpack_table(first, 1 << 17).sum()) == 64
    assert not bool(second.any())


def test_jump_pointer_never_outlives_its_pair():
    """A removed pair invalidates the pointer built from it, also when
    the same batch inserted it; with the pointers folded so, the jump
    trace over the post-removal layout matches the oracle, while a
    stale pointer would carry marks across the dead edge."""
    n = 300
    flags = np.full(n, F.FLAG_IN_USE | F.FLAG_INTERNED, np.uint8)
    flags[0] |= F.FLAG_ROOT
    recv = np.zeros(n, np.int64)
    sup = np.full(n, -1, np.int32)
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    w = np.ones(n - 1, np.int64)
    jp = ct.jump_parents_from_graph(src, dst, w, sup, n)
    assert np.array_equal(jp, ref.jump_parents_from_graph(src, dst, w, sup, n))
    stale = jp.copy()
    log = [(False, 150, 151, 0), (True, 10, 200, 0), (False, 10, 200, 0)]
    want = jp.copy()
    ref.fold_jump_log(want, log, n)
    writes = {}
    ct.fold_jump_log(jp, log, n, writes)
    assert np.array_equal(jp, want)
    assert jp[151] == n and jp[200] == 199 and writes == {151: n}
    # every remaining pointer is a live pair
    w_cut = w.copy()
    w_cut[150] = 0
    live = {(int(s), int(d)) for s, d in zip(src[w_cut > 0], dst[w_cut > 0])}
    assert all((int(jp[d]), d) in live for d in range(n) if jp[d] != n)
    prep = ct.prepare_chunks(src, dst, w_cut, sup, n)
    oracle = trace_ops.trace_marks_np(flags, recv, sup, src, dst, w_cut)
    got = ct.trace_marks_layouts(flags, recv, [prep], device="cpu",
                                 mode="jump", jump_parent=jp)
    assert np.array_equal(got, oracle) and not oracle[151:].any()
    bad = ct.trace_marks_layouts(flags, recv, [prep], device="cpu",
                                 mode="jump", jump_parent=stale)
    assert bad[151:].any()  # the stale pointer crosses the dead edge
