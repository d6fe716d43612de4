"""Port parity: the decremental wake (uigc_tpu_torch.ops.cuda_decremental)
against the reference's DecrementalTracer and the from-scratch numpy
oracle, wake for wake.

The churn schedules are those of tests/test_pallas_decremental.py
(random pair insertions/removals plus busy/root toggles, recv drains,
halts, freed and reused slots), re-created here.  The port runs with
device="cpu"; the reference tracer runs in lockstep, in Pallas interpret
mode, where ``ref=True``.  Marks are booleans, so every comparison is
exact.
"""

import numpy as np
import pytest

from uigc_tpu.ops import pallas_decremental as ref_dec
from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_decremental as cdec
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.ops.cuda_incremental import EDGE, SUP
from uigc_tpu_torch.parallel import sharded_trace as par

F = trace_ops


class OracleGraph:
    """Host-side mutable truth the tracers' wakes are diffed against."""

    def __init__(self, rng, n, n_edges):
        self.n = n
        self.flags = np.zeros(n, dtype=np.uint8)
        self.flags[rng.random(n) < 0.9] |= F.FLAG_IN_USE
        self.flags[rng.random(n) < 0.85] |= F.FLAG_INTERNED
        self.flags[rng.random(n) < 0.1] |= F.FLAG_BUSY
        self.flags[rng.random(n) < 0.05] |= F.FLAG_ROOT
        self.flags[rng.random(n) < 0.05] |= F.FLAG_HALTED
        self.recv = np.zeros(n, dtype=np.int64)
        self.recv[rng.random(n) < 0.1] = rng.integers(1, 5)
        self.pairs = {}
        src = rng.integers(0, n, n_edges)
        dst = rng.integers(0, n, n_edges)
        for s, d in zip(src.tolist(), dst.tolist()):
            self.pairs[(s, d, EDGE)] = None
        for c in np.nonzero(rng.random(n) < 0.3)[0].tolist():
            self.pairs[(c, int(rng.integers(0, n)), SUP)] = None

    def arrays(self):
        ek = [k for k in self.pairs if k[2] == EDGE]
        src = np.array([k[0] for k in ek] or [0], dtype=np.int32)
        dst = np.array([k[1] for k in ek] or [0], dtype=np.int32)
        w = np.ones(len(ek) or 1, dtype=np.int64)
        if not ek:
            w[0] = 0
        sup = np.full(self.n, -1, np.int32)
        for k in self.pairs:
            if k[2] == SUP:
                sup[k[0]] = k[1]
        return src, dst, w, sup

    def oracle_marks(self):
        src, dst, w, sup = self.arrays()
        return trace_ops.trace_marks_np(self.flags, self.recv, sup, src, dst, w)


def rand_schedule(rng, g, tracers, k):
    """One wake's worth of random churn, applied to every side."""
    log = []
    keys = list(g.pairs)
    for _ in range(min(k, len(keys))):
        key = keys[rng.integers(0, len(keys))]
        if key in g.pairs:
            del g.pairs[key]
            log.append((False, key[0], key[1], key[2]))
    for _ in range(k):
        key = (int(rng.integers(0, g.n)), int(rng.integers(0, g.n)), EDGE)
        if key not in g.pairs:
            g.pairs[key] = None
            log.append((True, key[0], key[1], key[2]))
    for tr in tracers:
        tr.apply_log(log)
    for _ in range(k // 2):
        i = int(rng.integers(0, g.n))
        r = rng.random()
        if r < 0.25:
            g.flags[i] ^= F.FLAG_BUSY
        elif r < 0.4:
            g.flags[i] ^= F.FLAG_ROOT
        elif r < 0.55:
            g.recv[i] = 0 if g.recv[i] else 3
        elif r < 0.7:
            g.flags[i] |= F.FLAG_HALTED
        elif r < 0.85:
            g.flags[i] |= F.FLAG_IN_USE | F.FLAG_INTERNED
        else:
            g.flags[i] &= ~(F.FLAG_IN_USE | F.FLAG_HALTED)


def drive(seed, n, wakes, k=40, ref=False, **kw):
    rng = np.random.default_rng(seed)
    g = OracleGraph(rng, n, n_edges=4 * n)
    port = cdec.DecrementalTracer(n, device="cpu", **kw)
    port.collect_stats = True
    tracers = [port]
    if ref:
        tracers.append(ref_dec.DecrementalTracer(n, **kw))
    src, dst, w, sup = g.arrays()
    for tr in tracers:
        tr.rebuild(src, dst, w, sup)
    full = 0
    for wake in range(wakes + 1):  # wake 0 is the cold-start derivation
        if wake:
            rand_schedule(rng, g, tracers, k)
        expected = g.oracle_marks()
        for tr in tracers:
            got = tr.marks(g.flags, g.recv)
            assert np.array_equal(got, expected), (
                f"{type(tr).__module__} seed {seed} wake {wake}: "
                f"{int((got != expected).sum())} mismatched marks"
            )
        full += int(port.last_stats["full_tiles"])
    for tr in tracers:
        assert tr.layout.stats["anomalies"] == 0
    return port, full


@pytest.mark.parametrize("seed,ref", [(0, True), (1, False), (2, False),
                                      (3, False)])
def test_decremental_wakes_match_reference_and_oracle(seed, ref):
    n = 1 << 10 if ref else 1 << 11
    port, full = drive(seed, n, wakes=4 if ref else 8, ref=ref,
                       freeze_threshold=64, max_frozen=2)
    assert full > 0  # the forced repair sweep ran with FULL-gated tiles


@pytest.mark.parametrize("mode,ref", [("push", False), ("pull", True),
                                      ("jump", False)])
def test_decremental_modes_match_oracle(mode, ref):
    drive(7, 1 << 10, wakes=2 if ref else 6, ref=ref, freeze_threshold=64,
          max_frozen=2, mode=mode)


def test_decremental_wide_geometry():
    drive(1, 1 << 11, wakes=4, freeze_threshold=64, max_frozen=2, sub=4,
          group=8)


def test_selective_gating_at_scale():
    """Many supertiles, little churn: the suspect/fresh gates cover a
    small fraction of the graph, so an under-approximated suspect set
    cannot hide behind whole-graph re-derivation."""
    drive(0, 1 << 15, wakes=4, k=8, s_rows=1, freeze_threshold=64,
          max_frozen=2)


def small_tracer(n, pairs, sup=None):
    src = np.array([p[0] for p in pairs], np.int32)
    dst = np.array([p[1] for p in pairs], np.int32)
    tracer = cdec.DecrementalTracer(n, device="cpu")
    tracer.rebuild(src, dst, np.ones(len(pairs), np.int64),
                   np.full(n, -1, np.int32) if sup is None else sup)
    flags = np.full(n, F.FLAG_IN_USE | F.FLAG_INTERNED, np.uint8)
    flags[0] |= F.FLAG_ROOT
    return tracer, flags, np.zeros(n, np.int64)


def test_released_cycle_dies():
    pairs = [(0, 10)] + [(10 + i, 10 + (i + 1) % 10) for i in range(10)]
    tracer, flags, recv = small_tracer(256, pairs)
    got = tracer.marks(flags, recv)
    assert got[0] and got[10:20].all()
    tracer.apply_log([(False, 0, 10, EDGE)])
    got = tracer.marks(flags, recv)
    assert got[0] and not got[10:20].any()


def test_halt_cascade():
    tracer, flags, recv = small_tracer(
        128, [(0, 1), (1, 2), (2, 3), (0, 4), (4, 3)]
    )
    assert tracer.marks(flags, recv)[[0, 1, 2, 3, 4]].all()
    flags[1] |= F.FLAG_HALTED
    got = tracer.marks(flags, recv)
    assert got[0] and got[1] and not got[2] and got[3] and got[4]


def test_additive_only_wakes():
    tracer, flags, recv = small_tracer(512, [(0, 1)])
    got = tracer.marks(flags, recv)
    assert got[0] and got[1] and not got[2]
    tracer.apply_log([(True, 1, 2, EDGE), (True, 2, 3, EDGE)])
    assert tracer.marks(flags, recv)[[0, 1, 2, 3]].all()


def test_freed_relay_unmarks_downstream():
    tracer, flags, recv = small_tracer(128, [(0, 1), (1, 2)])
    assert tracer.marks(flags, recv)[[0, 1, 2]].all()
    flags[1] = 0
    got = tracer.marks(flags, recv)
    assert got[0] and not got[1] and not got[2]


def test_rebuild_invalidates_previous_fixpoint():
    tracer, flags, recv = small_tracer(128, [(0, 1), (1, 2)])
    assert tracer.marks(flags, recv)[[0, 1, 2]].all()
    tracer.rebuild(np.array([0], np.int32), np.array([1], np.int32),
                   np.ones(1, np.int64), np.full(128, -1, np.int32))
    got = tracer.marks(flags, recv)
    assert got[0] and got[1] and not got[2]


def test_newly_in_use_node_gets_marked():
    tracer, flags, recv = small_tracer(128, [(0, 1), (1, 2)])
    flags[2] = 0
    got = tracer.marks(flags, recv)
    assert got[0] and got[1] and not got[2]
    flags[2] = F.FLAG_IN_USE | F.FLAG_INTERNED
    assert tracer.marks(flags, recv)[[0, 1, 2]].all()


def cold_wake_is_full_trace_one_device(g, mode):
    n = g["flags"].shape[0]
    args = (g["edge_src"], g["edge_dst"], g["edge_weight"], g["supervisor"])
    jp = (ct.jump_parents_from_graph(*args, n)
          if mode in (ct.MODE_JUMP, ct.MODE_AUTO) else None)
    full, st = ct.trace_marks_layouts(
        g["flags"], g["recv_count"], [ct.prepare_chunks(*args, n)],
        device="cpu", mode=mode, jump_parent=jp, with_stats=True)
    tracer = cdec.DecrementalTracer(n, device="cpu", mode=mode)
    tracer.rebuild(*args)
    tracer.collect_stats = True
    cold = tracer.marks(g["flags"], g["recv_count"])
    wake = tracer.last_stats
    assert wake["closure_sweeps"] == 0
    assert wake["n_sweeps"] == st["n_sweeps"] > 0
    assert wake["host_syncs"] == st["host_syncs"] + 1  # the empty closure
    return full, cold


def cold_wake_is_full_trace_mesh(g, mode, shards=4):
    n = g["flags"].shape[0]
    chunk = shards * ct.S_ROWS * ct.LANE
    n_pad = -(-n // chunk) * chunk
    flags = np.zeros(n_pad, np.uint8)
    flags[:n] = g["flags"]
    recv = np.zeros(n_pad, np.int64)
    recv[:n] = g["recv_count"]
    live = g["edge_weight"] > 0
    sup_src = np.nonzero(g["supervisor"] >= 0)[0]
    psrc = np.concatenate([g["edge_src"][live], sup_src])
    pdst = np.concatenate([g["edge_dst"][live], g["supervisor"][sup_src]])
    stacked, meta, _ = par.pack_shard_layouts(psrc, pdst, n_pad, shards)
    bucket_m = 64
    layout = (stacked["bmeta1"], stacked["bmeta2"], stacked["row_pos"],
              stacked["emeta"], np.full((shards, bucket_m), n_pad, np.int32),
              np.zeros((shards, bucket_m), np.int32))
    if mode in (ct.MODE_JUMP, ct.MODE_AUTO):
        layout += (ct.jump_parents(psrc, pdst, n_pad),)
    mesh = par.build_mesh(shards, "cpu")
    geom = (mesh, n_pad, meta["shard_size"], meta["n_blocks"], meta["r_rows"],
            meta["s_rows"], bucket_m)
    full = par.make_sharded_cuda_trace(*geom, mode=mode)(flags, recv, *layout)
    zero = np.zeros(n_pad // 32, np.int32)
    cold = par.make_sharded_decremental_wake(*geom, mode=mode)(
        flags, recv, *[zero] * 7, *layout)[0]
    return par.to_host(full)[:n], par.to_host(cold)[:n]


@pytest.mark.parametrize("plane,mode", [
    ("one device", "push"), ("one device", "pull"), ("one device", "jump"),
    ("one device", "auto"), ("mesh", "push"), ("mesh", "auto")])
def test_cold_wake_is_the_full_trace(plane, mode):
    """A wake from zero previous state is the full trace: an empty
    closure, then a repair that sweeps as the full trace sweeps, on one
    device and on a CPU mesh of 4 shards, to the oracle's marks."""
    g = powerlaw_actor_graph(50_000, seed=7, garbage_fraction=0.5)
    if plane == "mesh":
        full, cold = cold_wake_is_full_trace_mesh(g, mode)
    else:
        full, cold = cold_wake_is_full_trace_one_device(g, mode)
    assert np.array_equal(cold, full)
    assert np.array_equal(full, trace_ops.trace_marks_np(
        g["flags"], g["recv_count"], g["supervisor"], g["edge_src"],
        g["edge_dst"], g["edge_weight"]))
