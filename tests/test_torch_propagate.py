"""Port parity: the propagate kernel's plain version and the sweep glue
against the reference's Pallas kernel and jnp glue.

``propagate_words_torch`` is the contract the hand-written Hopper kernel
is held to on the card (``chip_smoke.py``); here it, and the f32 count
contract ``propagate_torch`` it is built on, are held against
``uigc_tpu.ops.pallas_trace.build_propagate`` run in Pallas interpret
mode, on operands from the reference's own packer.  Every comparison is
exact: contribution planes are integer counts in f32, word tables are
int32 and dirty lists are indices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uigc_tpu.ops import pallas_trace as ref
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import propagate as prop

from test_torch_cuda_jump import parents_mix


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def make_layout(seed, kind, sub=1, group=1, n=2048, n_src=1 << 17,
                m=5000, s_rows=8):
    """A reference-packed layout whose table spans several walk groups
    (n_src sources, so the dirty lists have real granularity at a
    small size) and whose destinations span several supertiles."""
    rng = np.random.default_rng(seed)
    psrc = rng.integers(0, n_src, m)
    # a hub destination so per-destination counts exceed 1
    pdst = np.where(rng.random(m) < 0.1, 5, rng.integers(0, n, m))
    if kind == "compact":
        keep = (pdst % 3000) < 700  # a few supertiles only
        psrc, pdst = psrc[keep], pdst[keep]
    prep = ref.prepare_pairs(
        psrc, pdst, n, s_rows=s_rows, n_src=n_src, sub=sub, group=group,
        compact_supers=kind == "compact", pad_blocks_pow2=kind == "compact",
    )
    if kind == "masked":
        # incremental-style deletions: sentinel rows in the middle
        live = np.argwhere(prep["row_pos"] != ref._PAD_ROW)
        pick = live[rng.random(len(live)) < 0.2]
        prep["row_pos"][pick[:, 0], pick[:, 1]] = ref._PAD_ROW
        prep["emeta"][pick[:, 0], pick[:, 1]] = 0
    return prep


def dirty_lists(n_chunks, dirty):
    """The kernel ABI's (D, L) for a dirty mask."""
    d = np.concatenate([[0], np.cumsum(dirty)]).astype(np.int32)
    l = np.zeros(n_chunks, np.int32)
    idx = np.nonzero(dirty)[0]
    l[: idx.size] = idx
    return d, l


def run_both(prep, table, dirty, gate):
    sub, group, s_rows = prep["sub"], prep["group"], prep["s_rows"]
    out_tiles = prep.get("out_supers", prep["n_super"])
    n_chunks = prep["r_rows"] // (ref.ROWS * group)
    d, l = dirty_lists(n_chunks, dirty)
    kern = ref.build_propagate(
        prep["n_blocks"], out_tiles, prep["r_rows"], s_rows, True,
        sub=sub, group=group, dst_gate=gate is not None,
    )
    meta = (prep["bmeta1"], prep["bmeta2"])
    ops = (table, prep["row_pos"], prep["emeta"])
    if gate is None:
        want = kern(d, l, *meta, *ops)
    else:
        want = kern(d, l, gate, *meta, *ops)
    got = prop.propagate_torch(
        t(d), t(prep["bmeta1"]), t(prep["bmeta2"]), t(table),
        t(prep["row_pos"]), t(prep["emeta"]), out_tiles=out_tiles,
        s_rows=s_rows, sub=sub, group=group,
        gate=None if gate is None else t(gate),
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dirty_kind", ["all", "partial"])
@pytest.mark.parametrize("kind", ["dense", "compact", "masked"])
def test_propagate_torch_matches_pallas(kind, dirty_kind, gated):
    prep = make_layout(11, kind)
    rng = np.random.default_rng(5)
    n_chunks = prep["r_rows"] // ref.ROWS
    assert n_chunks >= 4
    table = rng.integers(-(1 << 31), 1 << 31, (prep["r_rows"], ref.LANE),
                         dtype=np.int64).astype(np.int32)
    if dirty_kind == "all":
        dirty = np.ones(n_chunks, np.int32)
    else:
        dirty = (np.arange(n_chunks) % 2).astype(np.int32)
    gate = None
    if gated:
        out_tiles = prep.get("out_supers", prep["n_super"])
        gate = rng.integers(0, 3, out_tiles).astype(np.int32)
        gate[:3] = [ref.GATE_PUSH, ref.GATE_FULL, ref.GATE_SKIP][:out_tiles]
    got, want = run_both(prep, table, dirty, gate)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert got.max() > 1  # the hub destination sums several sources


@pytest.mark.parametrize("sub,group", [(2, 2), (4, 1)])
def test_propagate_torch_wide_geometry(sub, group):
    prep = make_layout(3, "dense", sub=sub, group=group)
    rng = np.random.default_rng(9)
    n_chunks = prep["r_rows"] // (ref.ROWS * group)
    table = rng.integers(-(1 << 31), 1 << 31, (prep["r_rows"], ref.LANE),
                         dtype=np.int64).astype(np.int32)
    dirty = np.zeros(n_chunks, np.int32)
    dirty[1] = 1
    gate = rng.integers(0, 3, prep["n_super"]).astype(np.int32)
    got, want = run_both(prep, table, dirty, gate)
    assert np.array_equal(got, want)


def test_propagate_rejects_bad_operands():
    prep = make_layout(2, "dense")
    n_chunks = prep["r_rows"] // ref.ROWS
    d, _ = dirty_lists(n_chunks, np.ones(n_chunks, np.int32))
    args = dict(n_super=prep["n_super"], s_rows=8, sub=1, group=1)
    table = np.zeros((prep["r_rows"], ref.LANE), np.int32)
    layout = (t(prep["bmeta1"]), t(prep["bmeta2"]), t(table),
              t(prep["row_pos"]), t(prep["emeta"]))
    out = torch.zeros_like(t(table))
    with pytest.raises(ValueError):  # wrong dtype
        prop.propagate_words(t(d).long(), *layout, out, **args)
    with pytest.raises(ValueError):  # gate of the wrong size
        prop.propagate_words(t(d), *layout, out,
                             gate=torch.zeros(1, dtype=torch.int32), **args)
    with pytest.raises(ValueError):  # a word plane short of the supertiles
        prop.propagate_words(t(d), *layout, out.reshape(-1)[:7], **args)
    with pytest.raises(ValueError):  # a float plane
        prop.propagate_words(t(d), *layout, out.float(), **args)


# --------------------------------------------------------------------- #
# The words contract: the Pallas kernel's planes, thresholded and packed
# --------------------------------------------------------------------- #


def reference_words(prep, table, dirty, gate):
    """The reference's hit words for one layout: its Pallas kernel run
    in interpret mode (on the per-tile gate ``gate[super_ids]`` where the
    layout is compact, as the reference's sweep does), thresholded,
    scattered to global supertiles and packed with its own
    ``pack_hits_table``."""
    s_rows = prep["s_rows"]
    sid = prep.get("super_ids")
    local_gate = None if gate is None or sid is None else gate[sid]
    _, counts = run_both(prep, table, dirty,
                         gate if local_gate is None else local_gate)
    if sid is not None:
        glob = np.zeros((prep["n_super"] * s_rows, ref.LANE), np.float32)
        rows = (sid[:, None].astype(np.int64) * s_rows
                + np.arange(s_rows)[None, :]).reshape(-1)
        np.add.at(glob, rows, counts)
        counts = glob
    return np.asarray(ref.pack_hits_table(jnp.asarray(counts > 0),
                                          prep["r_rows"], jnp))


def port_words(prep, table, dirty, gate, out=None):
    n_chunks = prep["r_rows"] // (ref.ROWS * prep["group"])
    d, _ = dirty_lists(n_chunks, dirty)
    sid = prep.get("super_ids")
    if out is None:
        out = torch.zeros((prep["r_rows"], ref.LANE), dtype=torch.int32)
    return prop.propagate_words_torch(
        t(d), t(prep["bmeta1"]), t(prep["bmeta2"]), t(table),
        t(prep["row_pos"]), t(prep["emeta"]), out, n_super=prep["n_super"],
        s_rows=prep["s_rows"], sub=prep["sub"], group=prep["group"],
        gate=None if gate is None else t(gate),
        super_ids=None if sid is None else t(sid),
    ).numpy()


#: destinations of the words tests: 16 supertiles of 1,024 nodes, so a
#: compact layout maps some of them and its packer adds pad tiles
WORDS_N = 1 << 14


def words_case(prep, seed, dirty_kind, gated):
    """A seeded table, dirty mask and GLOBAL gate (one per supertile)."""
    rng = np.random.default_rng(seed)
    n_chunks = prep["r_rows"] // (ref.ROWS * prep["group"])
    table = rand_words(rng, (prep["r_rows"], ref.LANE))
    if dirty_kind == "all":
        dirty = np.ones(n_chunks, np.int32)
    else:
        dirty = (np.arange(n_chunks) % 2).astype(np.int32)
    gate = None
    if gated:
        gate = rng.integers(0, 3, prep["n_super"]).astype(np.int32)
        touched = prep.get("super_ids", np.arange(prep["n_super"]))
        # a PUSH, a FULL and a SKIP tile the layout really maps to
        for g, tile in zip((ref.GATE_PUSH, ref.GATE_FULL, ref.GATE_SKIP),
                           np.unique(touched)):
            gate[tile] = g
    return table, dirty, gate


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dirty_kind", ["all", "partial"])
@pytest.mark.parametrize("kind", ["dense", "compact", "masked"])
def test_propagate_words_torch_matches_pallas(kind, dirty_kind, gated):
    """propagate_words_torch == pack(Pallas plane > 0), scattered to the
    global supertiles, bit for bit; compact layouts index the global gate
    through super_ids."""
    prep = make_layout(11, kind, n=WORDS_N)
    table, dirty, gate = words_case(prep, 5, dirty_kind, gated)
    want = reference_words(prep, table, dirty, gate)
    got = port_words(prep, table, dirty, gate)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert (got != 0).any()
    if kind == "compact":
        # the packer padded the tile count with tiles mapped to supertile 0
        assert prep["out_supers"] > np.unique(prep["super_ids"]).size


@pytest.mark.parametrize("sub,group", [(2, 2), (4, 1)])
def test_propagate_words_torch_wide_geometry(sub, group):
    prep = make_layout(3, "dense", sub=sub, group=group, n=WORDS_N)
    table, _, gate = words_case(prep, 9, "all", True)
    n_chunks = prep["r_rows"] // (ref.ROWS * group)
    dirty = np.zeros(n_chunks, np.int32)
    dirty[1] = 1
    want = reference_words(prep, table, dirty, gate)
    assert np.array_equal(port_words(prep, table, dirty, gate), want)


def permute_blocks(prep, seed):
    """The same layout blocks in another order: each block keeps its rows
    (a multiple of 8, so every slot keeps its row class) and metadata."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(prep["n_blocks"])
    rows = ref.ROWS * prep["sub"]
    out = dict(prep)
    out["bmeta1"] = prep["bmeta1"][perm]
    out["bmeta2"] = prep["bmeta2"][perm]
    for k in ("row_pos", "emeta"):
        blocks = prep[k].reshape(prep["n_blocks"], rows, ref.LANE)
        out[k] = np.ascontiguousarray(blocks[perm].reshape(prep[k].shape))
    return out


@pytest.mark.parametrize("kind", ["dense", "compact"])
def test_propagate_words_block_order_does_not_matter(kind):
    """OR is order-free: permuting a layout's blocks leaves the words
    unchanged, and a second layout ORs into a plane already holding the
    first's hits exactly as into its own."""
    prep = make_layout(17, kind, n=WORDS_N)
    table, dirty, gate = words_case(prep, 2, "partial", True)
    want = port_words(prep, table, dirty, gate)
    shuffled = permute_blocks(prep, 4)
    assert not np.array_equal(shuffled["bmeta1"], prep["bmeta1"])
    assert np.array_equal(port_words(shuffled, table, dirty, gate), want)
    other = make_layout(18, "dense", n=WORDS_N)
    both = port_words(prep, table, dirty, gate,
                      out=torch.from_numpy(port_words(other, table, dirty,
                                                      gate)))
    assert np.array_equal(both, want | port_words(other, table, dirty, gate))


# --------------------------------------------------------------------- #
# The sweep glue, against the reference's jnp expressions
# --------------------------------------------------------------------- #


def rand_words(rng, shape):
    return rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64).astype(
        np.int32
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_and_unpack_match(seed):
    rng = np.random.default_rng(seed)
    r_rows, n = 16, 16 * 128 * 32 - 77
    hits2d = rng.random((12, ref.LANE)) < 0.5
    hits2d[:, 31::32] = True  # bit 31: the word's sign bit
    got = ct.pack_hits_words(t(hits2d)).numpy()
    want = np.asarray(ref.pack_hits_words(jnp.asarray(hits2d), jnp))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (got < 0).any()
    active = rng.random(n) < 0.3
    got = ct.pack_bools(t(active), n, r_rows).numpy()
    want = np.asarray(ref.pack_bools(jnp.asarray(active), n, r_rows, jnp))
    assert np.array_equal(got, want)
    words = rand_words(rng, (r_rows, ref.LANE))
    got = ct.unpack_table(t(words), n).numpy()
    want = np.asarray(ref.unpack_table(jnp.asarray(words), n, jnp))
    assert np.array_equal(got, want)
    assert np.array_equal(ct.unpack_table(ct.pack_bools(t(active), n, r_rows),
                                          n).numpy(), active)


@pytest.mark.parametrize("group_rows", [8, 16])
def test_dirty_lists_match(group_rows):
    rng = np.random.default_rng(group_rows)
    r_rows = 64
    n_chunks = r_rows // group_rows
    prev = rand_words(rng, (r_rows, ref.LANE))
    table = prev.copy()
    for c in (0, 2, n_chunks - 1):
        table[c * group_rows + 3, 17] ^= np.int32(-(1 << 31))
    n_super, sup_words = 4, 8 * 4
    got = ct.hier_dirty_lists(t(table), t(prev), n_chunks, group_rows,
                              n_super, sup_words)
    d, _l, changed, super_changed = ref.hier_dirty_lists(
        jnp.asarray(table), jnp.asarray(prev), n_chunks, group_rows, n_super,
        sup_words, jnp,
    )
    # the reference's compacted list L is not built: the kernel reads D
    for g, w in zip(got, (d, changed, super_changed)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][-1]) == 3
    d, changed = ct.dirty_group_lists(t(prev), t(prev), n_chunks, group_rows)
    assert not bool(changed) and int(d[-1]) == 0


def test_saturated_tiles_and_bits_at_match():
    rng = np.random.default_rng(4)
    r_rows, n_super, sup_words = 16, 8, 32
    iu = rand_words(rng, (r_rows, ref.LANE))
    mark = rand_words(rng, (r_rows, ref.LANE)) | iu
    mark[0, :40] = iu[0, :40] & 0x7  # unmarked in-use bits in tiles 0, 1
    got = ct.saturated_tiles(t(mark), t(iu), n_super, sup_words).numpy()
    want = np.asarray(ref.saturated_tiles(jnp.asarray(mark), jnp.asarray(iu),
                                          n_super, sup_words, jnp))
    assert np.array_equal(got, want) and 0 < got.sum() < n_super
    n = r_rows * ref.LANE * 32 - 5
    ids = np.concatenate([rng.integers(0, n, 500), [n, n + 3]]).astype(np.int32)
    got = ct.bits_at(t(mark), t(ids), n).numpy()
    want = np.asarray(ref.bits_at(jnp.asarray(mark), jnp.asarray(ids), n, jnp))
    assert np.array_equal(got, want)


def test_jump_sweep_matches():
    rng = np.random.default_rng(8)
    n = 3000
    psrc = rng.integers(0, n, 6000)
    pdst = rng.integers(0, n, 6000)
    jp = ref.jump_parents(psrc, pdst, n)
    assert np.array_equal(ct.jump_parents(psrc, pdst, n), jp)
    r_rows = 8
    table = rand_words(rng, (r_rows, ref.LANE))
    trans = rand_words(rng, (r_rows, ref.LANE))
    hits, j2 = ct.jump_sweep(t(table), t(jp), t(trans), n)
    w_hits, w_j2 = ref.jump_sweep(jnp.asarray(table), jnp.asarray(jp),
                                  jnp.asarray(trans), n, jnp)
    assert np.array_equal(hits.numpy(), np.asarray(w_hits))
    assert np.array_equal(j2.numpy(), np.asarray(w_j2))


@pytest.mark.parametrize("n", [1, 31, 33, 3000, 8 * ref.LANE * 32])
def test_jump_sweep_words_matches(n):
    """The jump step's plain twin against the reference's jump_sweep,
    pack_bools and the in-use mask, on every kind of parent."""
    rng = np.random.default_rng(n)
    r_rows = 8
    jp = parents_mix(rng, n)
    table, trans, iu = (rand_words(rng, (r_rows, ref.LANE)) for _ in range(3))
    got_w, got_j = ct.jump_sweep_words(t(table), t(jp), t(trans), t(iu), n)
    hits, want_j = ref.jump_sweep(jnp.asarray(table), jnp.asarray(jp),
                                  jnp.asarray(trans), n, jnp)
    want_w = np.asarray(ref.pack_bools(hits, n, r_rows, jnp)) & iu
    assert got_w.dtype == torch.int32 and got_j.dtype == torch.int32
    assert np.array_equal(got_w.numpy(), want_w)
    assert np.array_equal(got_j.numpy(), np.asarray(want_j))
    assert int(got_j[n]) == n
    assert np.array_equal(jp, parents_mix(np.random.default_rng(n), n))


def jump_operands():
    n, r_rows = 3000, 8
    rng = np.random.default_rng(1)
    words = [t(rand_words(rng, (r_rows, ref.LANE))) for _ in range(3)]
    return [*words[:1], t(parents_mix(rng, n)), *words[1:], n]


@pytest.mark.parametrize("fault", [
    "dtype_table", "dtype_jump", "shape_trans", "shape_iu", "short_jump",
    "table_not_lanes", "n_past_table", "device", "strided_jump",
    "strided_table"])
def test_jump_sweep_words_refuses_bad_operands(fault):
    table, jump_j, trans, iu, n = jump_operands()
    if fault == "dtype_table":
        table = table.long()
    elif fault == "dtype_jump":
        jump_j = jump_j.long()
    elif fault == "shape_trans":
        trans = trans[:4]
    elif fault == "shape_iu":
        iu = iu.reshape(-1)
    elif fault == "short_jump":
        jump_j = jump_j[:n]
    elif fault == "table_not_lanes":
        table = table.reshape(-1, ref.LANE // 2)
    elif fault == "n_past_table":
        n = table.numel() * 32 + 1
        jump_j = torch.full((n + 1,), n, dtype=torch.int32)
    elif fault == "device":
        iu = torch.empty(iu.shape, dtype=torch.int32, device="meta")
    elif fault == "strided_jump":
        jump_j = torch.stack([jump_j, jump_j], dim=1)[:, 0]
    elif fault == "strided_table":
        table = torch.cat([table, table], dim=1)[:, ::2]
    with pytest.raises(ValueError):
        ct.jump_sweep_words(table, jump_j, trans, iu, n)


def test_jump_sweep_words_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        prop.jump_sweep_words_cuda(*jump_operands())


@pytest.mark.parametrize("compact", [False, True])
def test_packer_copy_matches_reference(compact):
    """The port's packer is the reference's: the same rows, block map and
    spans, and the same slot contents up to the order of pairs with
    equal sort keys (which the two argsorts may break differently)."""
    rng = np.random.default_rng(21)
    n = 5000
    psrc = rng.integers(0, n, 9000)
    pdst = rng.integers(0, n, 9000)
    kw = dict(s_rows=8, compact_supers=compact, pad_blocks_pow2=compact,
              sub=1, group=1)
    got = ct.prepare_pairs(psrc, pdst, n, **kw)
    want = ref.prepare_pairs(psrc, pdst, n, **kw)
    assert ct.layout_spec(got) == ref.layout_spec(want)
    for k in ("row_pos", "bmeta1", "bmeta2", "super_ids"):
        if k in want:
            assert np.array_equal(got[k], want[k]), k
    key = lambda p: np.sort(  # noqa: E731
        (p["row_pos"].astype(np.int64) << 32) | p["emeta"].view(np.uint32)
    , axis=None)
    assert np.array_equal(key(got), key(want))
