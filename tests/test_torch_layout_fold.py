"""The layout fold as batch array work (``ops/cuda_incremental.py``,
``ops/slotmap.py``, ``ops/cuda_trace.py`` ``fold_jump_cols``, the
decremental tracer's suspect ids), held against plain models.

``Model`` is the sequential scalar replay: a dict per home (the live
tier, the frozen tiers, the base), taken from the layout before each
fold, and the insert/remove rules applied one log entry at a time with
their anomaly counts and masked slots.  The random logs give every key an
alternating run of transitions that may start with either op, so they
hold every anomaly class: a duplicate insert of a live key, the removal
of an absent key, insert-then-remove and remove-then-insert of one key in
one batch, the removal of a frozen key, and the re-insert of a removed
base key.  Small thresholds drive freezes and consolidations between the
folds.  The jump parents are held against the batch rule written as a
loop.  Nothing here needs a card or JAX.
"""

import numpy as np
import pytest

from uigc_tpu_torch.ops import cuda_decremental as cdec
from uigc_tpu_torch.ops import cuda_incremental as cinc
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import slotmap
from uigc_tpu_torch.utils import events

N = 3000
S_ROWS = 8  # 1024-node supertiles, so N spans three


def packed(slots):
    """(row, col) pairs -> packed row << 8 | col."""
    return {(int(r) << 8) | int(c) for r, c in slots}


class Model:
    """The sequential scalar replay of the layout's bookkeeping, from a
    snapshot of the layout."""

    def __init__(self, layout, universe):
        self.pending = set(layout.pending.tolist())
        keys, tier, ri, col = layout.frozen_slots.items()
        self.frozen = {int(k): (int(t), int(r), int(c))
                       for k, t, r, c in zip(keys, tier, ri, col)}
        vals = layout.base_slot.get_batch(universe)
        self.base = {int(k): (int(v) >> 8, int(v) & 0xFF)
                     for k, v in zip(universe, vals) if v >= 0}
        self.homes = {}
        for k in self.pending:
            self.homes.setdefault(k, "pending")
        for k in self.frozen:
            self.homes.setdefault(k, "frozen")
        for k in self.base:
            self.homes.setdefault(k, "base")
        self.anomalies = 0
        self.masked = {"base": [], **{t: [] for t in range(len(layout.frozen))}}

    def insert(self, k):
        if k in self.pending or k in self.frozen or k in self.base:
            self.anomalies += 1
        else:
            self.pending.add(k)

    def remove(self, k):
        if k in self.pending:
            self.pending.discard(k)
        elif k in self.frozen:
            t, r, c = self.frozen.pop(k)
            self.masked[t].append((r, c))
        elif k in self.base:
            self.masked["base"].append(self.base.pop(k))
        else:
            self.anomalies += 1


def jump_oracle(jp, log, n):
    """The batch rule of fold_jump_cols as a loop: invalidate pointers
    built from removed pairs, then fold by minimum the inserts whose
    (src, dst) pair the batch does not also remove."""
    jp = jp.copy()
    removed = {(s, d) for ins, s, d, _ in log if not ins and s < n and d < n}
    for s, d in removed:
        if jp[d] == s:
            jp[d] = n
    for ins, s, d, _ in log:
        if ins and s < n and d < n and (s, d) not in removed:
            jp[d] = min(jp[d], s)
    return jp


def random_log(rng, layout, universe, fresh, k):
    """Alternating runs of 1 to 3 transitions on ``k`` keys drawn from
    every home and from fresh keys, interleaved keeping each key's
    order."""
    pools = [layout.pending, layout.frozen_slots.items()[0],
             universe[layout.base_slot.get_batch(universe) >= 0], universe,
             fresh]
    picked = set()
    for pool in pools:
        if pool.size:
            picked.update(rng.choice(pool, min(k // 5, pool.size),
                                     replace=False).tolist())
    runs = []
    for key in picked:
        op = bool(rng.random() < 0.5)
        run = []
        for _ in range(int(rng.integers(1, 4))):
            run.append((op, key >> 32, (key >> 1) & 0x7FFFFFFF, key & 1))
            op = not op
        runs.append(run)
    order = rng.permutation(np.repeat(np.arange(len(runs)),
                                      [len(r) for r in runs]))
    cursor = [0] * len(runs)
    log = []
    for i in order.tolist():
        log.append(runs[i][cursor[i]])
        cursor[i] += 1
    return log


def random_graph(rng):
    """(edge_src, edge_dst, edge_weight, supervisor) of N actors."""
    src = rng.integers(0, N, 6 * N).astype(np.int32)
    dst = rng.integers(0, N, 6 * N).astype(np.int32)
    sup = np.full(N, -1, np.int32)
    kids = np.nonzero(rng.random(N) < 0.3)[0]
    sup[kids] = rng.integers(0, N, kids.size)
    return src, dst, np.ones(src.size, np.int64), sup


def setup_layout(seed, mode):
    """A rebuilt layout over a random graph; the keys of its pairs and of
    as many random others (the universe), and those of the others that
    are no pair of the graph (fresh)."""
    rng = np.random.default_rng(seed)
    graph = random_graph(rng)
    src, dst, _, sup = graph
    kids = np.nonzero(sup >= 0)[0]
    layout = cinc.IncrementalCudaLayout(
        N, s_rows=S_ROWS, device="cpu", mode=mode, freeze_threshold=40,
        max_frozen=2)
    layout.rebuild(*graph)
    base = np.unique(np.concatenate([
        slotmap.pack_keys(src, dst, 0), slotmap.pack_keys(kids, sup[kids], 1)]))
    extra = slotmap.pack_keys(rng.integers(0, N, 2 * N),
                              rng.integers(0, N, 2 * N),
                              rng.integers(0, 2, 2 * N))
    universe = np.union1d(base, extra)
    return rng, layout, universe, np.setdiff1d(extra, base)


def check_frozen_slots(layout):
    """Each live frozen key's slot holds that pair in its tier, and every
    other slot of the tier is masked or padding."""
    keys, tier, ri, col = layout.frozen_slots.items()
    assert np.unique(keys).size == keys.size
    src, dst = slotmap.unpack_keys(keys)
    super_sz = S_ROWS * ct.LANE
    for t, prep in enumerate(layout.frozen):
        sel = tier == t
        r, c, s, d = ri[sel], col[sel], src[sel], dst[sel]
        assert np.array_equal(prep["row_pos"][r, c], (s >> 5) >> 7)
        d_local = d % super_sz
        want = ((s >> 5) & 127) | ((s & 31) << 7) | ((d_local & 127) << 12) \
            | ((d_local >> 7) << 19)
        assert np.array_equal(prep["emeta"][r, c], want)
        block = r // (ct.ROWS * prep["sub"])
        tile = prep["bmeta1"][block] >> 1
        assert np.array_equal(prep["super_ids"][tile], d // super_sz)
        assert int((prep["row_pos"] != ct._PAD_ROW).sum()) == int(sel.sum())


@pytest.mark.parametrize("mode", ["auto", "push"])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_fold_equals_the_sequential_replay(seed, mode):
    rng, layout, universe, fresh = setup_layout(seed, mode)
    layout.prepare_device_wake()  # the mirrors, so writes are queued
    if layout.use_jump:
        layout.jump_device()
    seen = {"frozen": 0, "consolidations": 0, "homes": set()}
    for _ in range(14):
        log = random_log(rng, layout, universe, fresh, 60)
        model = Model(layout, universe)
        for ins, s, d, kind in log:
            key = slotmap.pack_key(s, d, kind)
            (model.insert if ins else model.remove)(key)
        preps = [layout.base] + layout.frozen
        before = [(p["row_pos"].copy(), p["emeta"].copy()) for p in preps]
        jp_want = jump_oracle(layout.jump_parent, log, N)
        jp_before = layout.jump_parent.copy()
        stats = dict(layout.stats)
        masked = (layout.masked_base, layout.masked_frozen)

        layout.apply_log(log)

        assert np.array_equal(layout.pending, np.sort(list(model.pending)))
        keys, tier, ri, col = layout.frozen_slots.items()
        assert {int(k): (int(t), int(r), int(c)) for k, t, r, c in
                zip(keys, tier, ri, col)} == model.frozen
        vals = layout.base_slot.get_batch(universe)
        assert {int(k): (int(v) >> 8, int(v) & 0xFF) for k, v in
                zip(universe, vals) if v >= 0} == model.base
        assert layout.stats["anomalies"] - stats["anomalies"] \
            == model.anomalies
        n_base, n_frozen = len(model.masked["base"]), sum(
            len(v) for t, v in model.masked.items() if t != "base")
        assert (layout.masked_base - masked[0],
                layout.masked_frozen - masked[1]) == (n_base, n_frozen)
        for t, prep in zip(["base"] + list(range(len(layout.frozen))), preps):
            rows, emeta = before.pop(0)
            slots = np.array(model.masked[t], np.int64).reshape(-1, 2)
            rows[slots[:, 0], slots[:, 1]] = ct._PAD_ROW
            emeta[slots[:, 0], slots[:, 1]] = 0
            assert np.array_equal(prep["row_pos"], rows)
            assert np.array_equal(prep["emeta"], emeta)
            writes = layout._dev_writes[prep["_mirror_token"]]
            assert set(np.concatenate(writes + [cinc._EMPTY]).tolist()) \
                == packed(model.masked[t])
        if layout.use_jump:
            assert np.array_equal(layout.jump_parent, jp_want)
            queued = set(np.concatenate(layout._jump_writes
                                        + [cinc._EMPTY]).tolist())
            assert set(np.nonzero(jp_want != jp_before)[0].tolist()) <= queued
            assert np.array_equal(layout.jump_device().numpy(),
                                  layout.jump_parent)
        else:
            assert np.array_equal(layout.jump_parent, jp_before)

        # the fold's counter: the net log's distinct keys, by home
        distinct = {slotmap.pack_key(s, d, k) for _, s, d, k in log}
        homes = [model.homes.get(k, "missing") for k in distinct]
        got = {k: layout.stats[k] - stats[k] for k in
               ("fold_keys", "fold_pending", "fold_frozen", "fold_base",
                "fold_missing")}
        assert got == {"fold_keys": len(distinct),
                       **{f"fold_{h}": homes.count(h) for h in
                          ("pending", "frozen", "base", "missing")}}
        seen["homes"].update(h for h in homes)

        layout.prepare_device_wake()  # freezes and consolidates
        check_frozen_slots(layout)
        for p in [layout.base] + layout.frozen:
            mirror = layout._dev_mirror[p["_mirror_token"]]
            assert np.array_equal(mirror["row_pos"].numpy(), p["row_pos"])
        seen["frozen"] = max(seen["frozen"], len(layout.frozen))
    assert layout.stats["freezes"] > 2 and layout.stats["consolidations"] > 0
    assert layout.stats["anomalies"] > 0
    assert seen["homes"] == {"pending", "frozen", "base", "missing"}


def test_frozen_slots_through_freeze_removal_consolidation_and_rebuild():
    rng, layout, universe, fresh = setup_layout(5, "auto")
    new = np.sort(rng.choice(fresh, 100, replace=False))
    src, dst = slotmap.unpack_keys(new)
    layout.apply_log([(True, int(s), int(d), int(k & 1))
                      for s, d, k in zip(src, dst, new)])
    assert np.array_equal(layout.pending, new)
    layout.prepare_wake()  # 100 > 40: the live tier freezes
    assert layout.pending.size == 0 and len(layout.frozen) == 1
    keys, tier, ri, col = layout.frozen_slots.items()
    prep = ct.prepare_pairs(src, dst, N, s_rows=S_ROWS, pad_blocks_pow2=True,
                            want_slots=True, compact_supers=True,
                            sub=layout.sub, group=layout.group)
    # the slots the packer gave the tier's keys, key for key
    assert np.array_equal(keys, new) and not tier.any()
    assert np.array_equal(ri, prep["slot_ri"])
    assert np.array_equal(col, prep["slot_col"])
    check_frozen_slots(layout)

    gone = new[::3]
    s, d = slotmap.unpack_keys(gone)
    layout.apply_log([(False, int(a), int(b), int(k & 1))
                      for a, b, k in zip(s, d, gone)])
    assert len(layout.frozen_slots) == new.size - gone.size
    assert layout.masked_frozen == gone.size
    check_frozen_slots(layout)

    for _ in range(2):  # a second tier, then a third: the chain consolidates
        more = np.sort(rng.choice(np.setdiff1d(fresh, new), 50,
                                  replace=False))
        new = np.union1d(new, more)
        s, d = slotmap.unpack_keys(more)
        layout.apply_log([(True, int(a), int(b), int(k & 1))
                          for a, b, k in zip(s, d, more)])
        layout.prepare_wake()
    assert layout.stats["consolidations"] == 1
    assert len(layout.frozen) == 1 and layout.masked_frozen == 0
    keys, tier, _, _ = layout.frozen_slots.items()
    assert np.array_equal(keys, np.setdiff1d(new, gone)) and not tier.any()
    check_frozen_slots(layout)
    assert layout.churn == keys.size + layout.masked_base

    src, dst, w = (np.arange(10, dtype=np.int32),
                   np.arange(1, 11, dtype=np.int32), np.ones(10, np.int64))
    layout.rebuild(src, dst, w, np.full(N, -1, np.int32))
    assert len(layout.frozen_slots) == 0 and layout.frozen == []
    assert layout.pending.size == 0 and layout.churn == 0


def oracle_fold_log(log):
    """The net effect by dicts, in order of first appearance."""
    first, last = {}, {}
    for ins, src, dst, kind in log:
        k = slotmap.pack_key(src, dst, kind)
        first.setdefault(k, ins)
        last[k] = ins
    return ([k for k, i in first.items() if not i],
            [k for k, i in first.items() if i and not last[k]],
            [k for k, i in last.items() if i])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_net_log_equals_the_dict_fold(seed):
    rng = np.random.default_rng(seed)
    log = [(bool(rng.random() < 0.5), int(rng.integers(0, 40)),
            int(rng.integers(0, 40)), int(rng.integers(0, 2)))
           for _ in range(int(rng.integers(0, 400)))]
    assert slotmap.fold_log(log) == oracle_fold_log(log)
    cols = slotmap.log_columns(log)
    assert cols.shape == (4, len(log))
    keys, first, last = slotmap.net_log(cols)
    assert np.array_equal(keys, np.unique(keys)) and keys.size == len(
        {slotmap.pack_key(s, d, k) for _, s, d, k in log})
    for k, f, la in zip(keys.tolist(), first.tolist(), last.tolist()):
        at = [i for i, (_, s, d, kind) in enumerate(log)
              if slotmap.pack_key(s, d, kind) == k]
        assert (f, la) == (at[0], at[-1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_jump_cols_equals_the_rule(seed):
    rng = np.random.default_rng(seed)
    n = 50
    jp = rng.integers(0, n + 1, n + 1).astype(np.int32)
    log = [(bool(rng.random() < 0.5), int(rng.integers(0, n + 3)),
            int(rng.integers(0, n + 3)), 0) for _ in range(120)]
    want = jump_oracle(jp, [e for e in log], n)
    got = jp.copy()
    changed = ct.fold_jump_cols(got, slotmap.log_columns(log), n)
    assert np.array_equal(got, want)
    assert set(np.nonzero(want != jp)[0].tolist()) <= set(changed.tolist())
    writes = {}
    again = jp.copy()
    ct.fold_jump_log(again, log, n, writes)
    assert np.array_equal(again, want)
    assert writes == {d: int(want[d]) for d in changed.tolist()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_packed_slot_map_equals_a_dict(seed):
    """Bulk lookups (a long run of one source among short ones), the
    overlay the mesh fills with ``add`` (after a tombstone too), and
    ``pop`` from it, scalar and batched, against a dict."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.full(1500, 7), rng.integers(0, 400, 3000)])
    keys = np.unique(slotmap.pack_keys(src, rng.integers(0, 5000, src.size),
                                       rng.integers(0, 2, src.size)))
    vals = rng.integers(0, 1 << 40, keys.size)
    m = slotmap.PackedSlotMap(keys[::-1].copy(), vals[::-1].copy())
    truth = dict(zip(keys.tolist(), vals.tolist()))
    absent = slotmap.pack_keys(rng.integers(0, 500, 800),
                               rng.integers(0, 5000, 800), 0)
    pool = np.unique(np.concatenate([keys, absent]))
    for _ in range(40):
        op = rng.integers(0, 5)
        q = rng.choice(pool, int(rng.integers(0, 60)), replace=False)
        if op == 0:
            got = m.get_batch(q)
            assert got.tolist() == [truth.get(k, -1) for k in q.tolist()]
        elif op == 1:
            got = m.pop_batch(q)
            assert got.tolist() == [truth.pop(k, -1) for k in q.tolist()]
        elif op == 2:  # the mesh's overlay: add keys absent now
            for k in q.tolist():
                if k not in truth:
                    v = int(rng.integers(0, 1 << 40))
                    m.add(k, v)
                    truth[k] = v
        elif op == 3:
            for k in q.tolist():
                assert m.pop(k) == truth.pop(k, None)
        else:
            for k in q.tolist():
                assert m.get(k) == truth.get(k)
                assert (k in m) == (k in truth)
        assert len(m) == len(truth)
    assert len(m._extra) > 0 and m._dead.any()
    empty = slotmap.PackedSlotMap()
    assert len(empty) == 0 and empty.get_batch(keys[:5]).tolist() == [-1] * 5
    assert empty.get(int(keys[0])) is None and empty.pop(int(keys[0])) is None


def id_words(ids, r_rows):
    words = np.zeros(r_rows * ct.LANE, np.uint32)
    for i in ids:
        words[i >> 5] |= np.uint32(1 << (i & 31))
    return words.view(np.int32).reshape(r_rows, ct.LANE)


@pytest.mark.parametrize("seed", [0, 1])
def test_tracer_batch_fold_equals_the_scalar_replay(seed):
    """The tracer's batch fold against its own scalar insert/remove, entry
    by entry: the same layout state and the same suspect id words, which
    name the destination of every entry."""
    rng, _, universe, fresh = setup_layout(seed, "push")
    graph = random_graph(np.random.default_rng(seed))  # setup_layout's
    tracers = [cdec.DecrementalTracer(N, device="cpu", s_rows=S_ROWS,
                                      mode="push", freeze_threshold=40,
                                      max_frozen=2) for _ in range(2)]
    for tr in tracers:
        tr.rebuild(*graph)
    batch, scalar = tracers
    r_rows = batch.layout.base["r_rows"]
    for _ in range(6):
        log = random_log(rng, batch.layout, universe, fresh, 60)
        batch.apply_log(log)
        for ins, s, d, k in log:
            (scalar.insert if ins else scalar.remove)(s, d, k)
        for name in ("_pending_del_dst", "_pending_fresh_dst"):
            want = id_words([d for ins, _, d, _ in log
                             if ins == (name == "_pending_fresh_dst")], r_rows)
            for tr in tracers:
                assert np.array_equal(
                    tr._id_words(getattr(tr, name), r_rows).numpy(), want)
        a, b = batch.layout, scalar.layout
        assert np.array_equal(a.pending, b.pending)
        for x, y in zip(a.frozen_slots.items(), b.frozen_slots.items()):
            assert np.array_equal(x, y)
        assert np.array_equal(a.base_slot.get_batch(universe),
                              b.base_slot.get_batch(universe))
        assert np.array_equal(a.base["row_pos"], b.base["row_pos"])
        assert (a.masked_base, a.masked_frozen, a.stats["anomalies"]) == (
            b.masked_base, b.masked_frozen, b.stats["anomalies"])
        for tr in tracers:
            tr._pending_del_dst.clear()
            tr._pending_fresh_dst.clear()
            tr.layout.prepare_wake()
    assert a.stats["freezes"] > 0 and a.stats["anomalies"] > 0


def test_fold_span_off_costs_no_record(monkeypatch):
    """Off, apply_log hands its counts to the shared no-op span."""
    _, layout, _, fresh = setup_layout(3, "auto")

    def refuse(name):
        raise AssertionError(f"a profiler record was made for {name}")

    monkeypatch.setattr(events, "_RecordFunctionFast", refuse)
    s, d = slotmap.unpack_keys(fresh[:10])
    layout.apply_log([(True, int(a), int(b), int(k & 1))
                      for a, b, k in zip(s, d, fresh[:10])])
    assert layout.stats["fold_keys"] == layout.stats["fold_missing"] == 10
    assert np.array_equal(layout.pending, fresh[:10])
