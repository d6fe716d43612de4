"""The ``wakes`` driver rehearsed at 20,000 actors through the program's
``device="cpu"`` path, with each wake's log scaled to the graph (40 refs
released and up to 40 created of about 80,000, 4 halts, busy flips and
receive resets; the cell's 2,000 of 40M would be 4 here): its verdicts
against ``reference/churn.py``, its control, two faults planted in the
program, the log generator, the readers of its three metrics and the
configuration beside the full cell's."""

import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import churn
from portbench.reference import graphgen as gg
from portbench.tests.rehearsal import rehearse

SCALED = {"removed_refs": 40, "new_refs": 40, "halts": 4, "busy_flips": 4,
          "recv_resets": 4}
WAKES = dict(cell="powerlaw10m.wake", sizes={"actors": 20000},
             traffic=SCALED)


def test_wakes_sound():
    r = rehearse(seed=2**31 + 11, seconds=1.5, **WAKES)
    assert r["correct"], r["checks"]
    assert r["attempted"] == len(r["samples"]["pass_ms"]) > 0
    assert r["failed"] == 0
    assert set(r["metrics"]) == {"detect_p95_ms", "garbage_per_s", "setup_s"}
    c = r["counters"]
    assert c["n_actors"] == 20000 and c["n_pairs"] > 80000
    assert c["repacks"] == 0 and c["draw_s"] > 0


def test_wakes_traced():
    r = rehearse(seed=12, seconds=1.5, trace=True,
                 traffic=dict(SCALED, profile_s=0.6),
                 cell="powerlaw10m.wake", sizes={"actors": 20000})
    assert r["correct"], r["checks"]
    # nothing ran on a device, so no device metric has anything to read,
    # but the profile holds the spans the wake's readers count
    assert r["metrics"] == {}
    wakes = r["counters"]["profiled_passes"]
    hc = r["trace"]["host_counts"]
    assert wakes > 0 and hc["uigc.wake"] == wakes
    assert hc["uigc.wake.closure.sweep"] + hc["uigc.wake.repair.sweep"] > 0
    assert hc["uigc.layout.fold"] == hc["uigc.layout.tiers"] == wakes


def test_control_is_not_correct():
    r = rehearse(seed=13, seconds=1.0, control=True, **WAKES)
    assert not r["correct"], r["checks"]


def plant_wake_fault(monkeypatch, fault):
    from uigc_tpu_torch.ops import cuda_decremental as cdec

    if fault == "suspects_dropped":
        # no suspect seeds: no released ref's destination, no seed lost,
        # no new halt, so the closure is empty and no mark is cleared
        real = cdec.get_wake_fn

        def get(*a, **kw):
            fn = real(*a, **kw)

            def wrapped(flags, recv, del_w, fresh_w, mark_w, seed_w,
                        halted_w, iu_w, table, *rest):
                none = torch.zeros_like(del_w)
                return fn(flags, recv, none, fresh_w, mark_w, none,
                          torch.full_like(halted_w, -1), iu_w, table, *rest)
            return wrapped

        monkeypatch.setattr(cdec, "get_wake_fn", get)
        return
    real_wake = cdec.DecrementalTracer.wake_device
    previous = []

    def stale(self, flags, recv):  # "stale_verdict": the last wake's marks
        now = real_wake(self, flags, recv).clone()
        previous.append(now)
        return previous[-2] if len(previous) > 1 else now

    monkeypatch.setattr(cdec.DecrementalTracer, "wake_device", stale)


@pytest.mark.parametrize("fault", ["suspects_dropped", "stale_verdict"])
def test_wakes_fault_is_not_correct(monkeypatch, fault):
    plant_wake_fault(monkeypatch, fault)
    # a window of one wake (a loaded host) must show the fault too: the
    # logs are the seed's, and with 40 halts a wake the first window
    # wake's verdict differs from the last warm-up wake's
    r = rehearse(seed=14, seconds=0.01, cell="powerlaw10m.wake",
                 sizes={"actors": 20000}, traffic=dict(SCALED, halts=40))
    assert not r["correct"], (fault, r["checks"])


# ------------------------------------------------------------------ #
# The log generator
# ------------------------------------------------------------------ #

TRAFFIC = dict(SCALED, root_swap_every=4)


def small_plan(seed, n=5000):
    g = gg.powerlaw_actor_graph(n, gg.rng_for(1, 0))
    return g, churn.WakePlan(churn.merged_graph(g), g, seed, TRAFFIC)


def test_merged_graph_has_each_ref_once():
    g, _ = small_plan(1)
    m = churn.merged_graph(g)
    keys = (g["edge_src"].astype(np.int64) << 32) | g["edge_dst"]
    assert np.array_equal(m["keys"], np.unique(keys))
    assert np.array_equal((m["src"].astype(np.int64) << 32) | m["dst"],
                          m["keys"])


def test_generator_is_deterministic_per_seed():
    def wakes(seed):
        _, plan = small_plan(seed)
        return [plan.next() for _ in range(12)]

    a, b, c = wakes(2**31 + 5), wakes(2**31 + 5), wakes(2**31 + 6)
    for x, y in zip(a, b):
        for name in churn.Wake.__slots__:
            assert np.array_equal(getattr(x, name), getattr(y, name))
    assert any(not np.array_equal(x.removed, z.removed) for x, z in zip(a, c))


def test_generator_keeps_to_the_live_refs_and_partitions():
    g, plan = small_plan(7)
    n_live, swaps = g["n_live"], 0
    for _ in range(40):
        before = plan.weight.copy()
        keys = {(int(s) << 32) | int(d): i for i, (s, d)
                in enumerate(zip(plan.src, plan.dst)) if before[i]}
        w = plan.next()
        assert w.removed.size == TRAFFIC["removed_refs"]
        assert np.unique(w.removed).size == w.removed.size
        assert before[w.removed].all()  # never a released ref released
        gone = w.removed[~np.isin(w.removed, w.inserted)]
        assert (plan.weight[gone] == 0).all()
        created = (plan.src[w.inserted].astype(np.int64) << 32) \
            | plan.dst[w.inserted]
        assert np.unique(created).size == created.size
        released = set(w.removed.tolist())
        for key, i in zip(created.tolist(), w.inserted.tolist()):
            # never a duplicate of a ref live when it is created
            assert key not in keys or keys[key] in released
        assert (plan.weight[w.inserted] == 1).all()
        src, dst = plan.src[w.inserted], plan.dst[w.inserted]
        assert ((src < n_live) == (dst < n_live)).all()
        assert (w.busy < n_live).all() and (w.resets < n_live).all()
        assert np.unique(w.busy).size == w.busy.size
        if w.root_off.size:
            swaps += 1
            assert w.root_off[0] != w.root_on[0] and w.root_on[0] < n_live
    assert swaps == 10
    assert plan.n_alive == int(plan.weight.sum())


# ------------------------------------------------------------------ #
# Readers and the configuration
# ------------------------------------------------------------------ #


def test_wake_readers():
    sweeps = harness.reader("wake.sweeps")
    syncs = harness.reader("wake.host_syncs")
    fold = harness.reader("wake.fold_idle")
    trace = {"busy_s": 0.4, "window_s": 1.0,
             "host_counts": {"uigc.wake.closure.sweep": 30,
                             "uigc.wake.repair.sweep": 12,
                             "uigc.layout.fold": 3,
                             "cudaStreamSynchronize": 90},
             "idle_gaps": [["uigc.layout.fold", 0.05],
                           ["uigc.wake.ids", 0.01],
                           ["uigc.layout.consolidate", 0.04],
                           ["uigc.wake.wait", 0.2]]}
    r = {"trace": trace, "counters": {"profiled_passes": 3}}
    assert sweeps(r) == 14
    assert syncs(r) == 30
    assert fold(r) == pytest.approx(10.0)
    # the parent's program opens none of the wake's spans: nothing read
    bare = dict(trace, host_counts={"cudaStreamSynchronize": 90},
                idle_gaps=[["host: no torch op open", 0.6]])
    parent = {"trace": bare, "counters": {"profiled_passes": 3}}
    assert sweeps(parent) is None and fold(parent) is None
    assert syncs(parent) == 30
    for read in (sweeps, syncs, fold):
        assert read({"trace": None, "counters": {}}) is None


def test_configuration_beside_the_full_cell():
    manifest = harness.load_manifest()
    plan = harness.cell_plan(manifest, "powerlaw10m.wake")
    full = harness.cell_plan(manifest, "powerlaw10m.full")
    cfg = plan["config"]
    assert cfg["kind"] == full["config"]["kind"] and cfg["reduced"] == {}
    assert {k: v for k, v in cfg["sizes"].items() if k != "pairs"} \
        == full["config"]["sizes"]
    assert cfg["program"]["uigc.crgc.shadow-graph"] == "decremental"
    for key in ("removed_refs", "new_refs", "halts", "busy_flips",
                "recv_resets", "root_swap_every"):
        assert key in cfg["assumed"] and key in plan["traffic"]
    assert plan["traffic"]["driver"] == "wakes"
    assert {m["name"] for m in plan["per_layer"]} == {
        "wake.sweeps", "wake.host_syncs", "wake.fold_idle"}
    assert {m["name"] for m in plan["end_to_end"]} == {
        "detect_p95_ms", "garbage_per_s", "setup_s"}
    assert json.loads((harness.ROOT / "BENCHMARK.json").read_text()) \
        == manifest
