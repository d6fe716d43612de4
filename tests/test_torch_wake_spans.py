"""The spans of the port's decremental wake and of its layout fold
(``ops/cuda_decremental.py``, ``ops/cuda_incremental.py``, through
``utils/events.py`` ``span``).

Each case folds seeded churn logs into a ``DecrementalTracer`` over a
20k-actor power-law graph with its duplicate refs merged, as a shadow
graph holds it.  Under torch.profiler the wake's spans count its sweeps
and changed-flag waits exactly as its stats do; inside a ``Tracer`` span
the wake's span carries the same counts as args; the freeze and
consolidation spans open when those tiers are packed; off, every site
gets the shared no-op span; and the marks, spans on or off, are the
oracle's in every trace mode.

The ``cuda`` case needs a card and skips without one.  On a machine with
a card and no JAX, run this file without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_wake_spans.py -q

It imports neither jax nor uigc_tpu for that reason.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_decremental as cdec
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.ops.cuda_incremental import EDGE
from uigc_tpu_torch.telemetry.tracing import Tracer
from uigc_tpu_torch.utils import events

F = trace_ops
N = 20_000
MODES = ("push", "pull", "jump", "auto")
DEVICES = ("cpu", pytest.param("cuda", marks=pytest.mark.cuda))
WAKE_SPANS = ("uigc.wake", "uigc.wake.ids", "uigc.wake.closure.sweep",
              "uigc.wake.repair.sweep", "uigc.wake.wait", "uigc.layout.fold",
              "uigc.layout.tiers")


class Churn:
    """A merged power-law graph and its seeded churn: each wake releases
    ``k`` live refs, creates up to ``k`` within their partition, halts a
    few actors, flips a few live actors busy, and every third wake
    releases a root.  The host arrays are the oracle's truth."""

    def __init__(self, seed, k=60):
        g = powerlaw_actor_graph(N, seed=seed, garbage_fraction=0.5)
        keys = np.unique((g["edge_src"].astype(np.int64) << 32)
                         | g["edge_dst"].astype(np.int64))
        self.src = (keys >> 32).astype(np.int32)
        self.dst = (keys & 0xFFFFFFFF).astype(np.int32)
        self.w = np.ones(keys.size, np.int64)
        self.live = set(keys.tolist())
        self.flags = g["flags"].copy()
        self.recv = g["recv_count"].copy()
        self.sup = g["supervisor"]
        self.n_live = g["n_live"]
        self.roots = np.nonzero(self.flags & F.FLAG_ROOT)[0]
        self.rng = np.random.default_rng(seed)
        self.k = k
        self.wake = 0

    def tracer(self, dev="cpu", **kw):
        tr = cdec.DecrementalTracer(N, device=dev, **kw)
        tr.rebuild(self.src, self.dst, self.w, self.sup)
        tr.collect_stats = True
        return tr

    def next_log(self):
        rng, k = self.rng, self.k
        log = []
        for i in rng.choice(np.nonzero(self.w > 0)[0], k, replace=False):
            self.w[i] = 0
            s, d = int(self.src[i]), int(self.dst[i])
            self.live.discard((s << 32) | d)
            log.append((False, s, d, EDGE))
        new_s = rng.integers(0, N, k)
        new_d = np.where(new_s < self.n_live, rng.integers(0, self.n_live, k),
                         rng.integers(self.n_live, N, k))
        for s, d in zip(new_s.tolist(), new_d.tolist()):
            if (s << 32) | d not in self.live:
                self.live.add((s << 32) | d)
                self.src = np.append(self.src, np.int32(s))
                self.dst = np.append(self.dst, np.int32(d))
                self.w = np.append(self.w, 1)
                log.append((True, s, d, EDGE))
        self.flags[rng.integers(0, N, k // 10)] |= F.FLAG_HALTED
        self.flags[rng.choice(self.n_live, k // 10, replace=False)] ^= \
            F.FLAG_BUSY
        if self.wake % 3 == 2:
            self.flags[self.roots[self.wake % self.roots.size]] &= ~F.FLAG_ROOT
        self.wake += 1
        return log

    def oracle(self):
        return trace_ops.trace_marks_np(self.flags, self.recv, self.sup,
                                        self.src, self.dst, self.w)

    def inputs(self, dev):
        return (torch.from_numpy(self.flags.copy()).to(dev),
                torch.from_numpy(self.recv).to(dev))


def device_of(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the propagate kernel has no CPU mode)")
    return torch.device(name)


def profiled(dev, fn):
    """fn() under torch.profiler: (result, names of the ``uigc.*`` host
    events it recorded)."""
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    spans = [e for e in prof.events() if e.name.startswith("uigc.")]
    assert all(not e.is_user_annotation for e in spans)
    assert all(str(e.device_type).endswith("CPU") for e in spans)
    return out, Counter(e.name for e in spans)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("mode", MODES)
def test_spans_count_the_wakes_sweeps_and_waits(mode, device):
    dev = device_of(device)
    ch = Churn(seed=11)
    tr = ch.tracer(dev, mode=mode)
    tr.marks(*ch.inputs("cpu"))  # the cold wake, and the kernel built
    closure = repair = 0
    for _ in range(3):
        log = ch.next_log()
        flags, recv = ch.inputs(dev)

        def wake():
            tr.apply_log(log)
            return tr.unpack_marks(tr.wake_device(flags, recv))

        marks, counts = profiled(dev, wake)
        st = tr.last_stats
        assert np.array_equal(marks, ch.oracle())
        assert counts["uigc.wake"] == 1
        assert counts["uigc.wake.ids"] == 2  # the released and created dsts
        assert counts["uigc.layout.fold"] == 1
        assert counts["uigc.layout.tiers"] == 1
        assert counts["uigc.wake.closure.sweep"] == st["closure_sweeps"]
        assert counts["uigc.wake.repair.sweep"] == st["n_sweeps"]
        assert counts["uigc.wake.wait"] == st["host_syncs"]
        assert st["host_syncs"] >= st["closure_sweeps"] + st["n_sweeps"] + 2
        assert not any(name.startswith("uigc.fixpoint.")
                       and name != "uigc.fixpoint.propagate" for name in counts)
        closure += st["closure_sweeps"]
        repair += st["n_sweeps"]
    assert closure > 0 and repair > 0


def test_wake_span_args_in_a_tracer():
    ch = Churn(seed=12)
    tr = ch.tracer()
    tr.marks(*ch.inputs("cpu"))
    tracer = Tracer("uigc://n1", enabled=True)
    for _ in range(3):
        tr.apply_log(ch.next_log())
        tracer.clear()
        with tracer.span("gc_wave"):
            tr.wake_device(*ch.inputs("cpu"))
        st = tr.last_stats
        spans = tracer.spans()
        by_id = {s["span_id"]: s for s in spans}
        (wake,) = [s for s in spans if s["name"] == "uigc.wake"]
        assert wake["args"] == {"closure_sweeps": st["closure_sweeps"],
                                "repair_sweeps": st["n_sweeps"],
                                "waits": st["host_syncs"]}
        assert by_id[wake["parent_id"]]["name"] == "gc_wave"
        names = Counter(s["name"] for s in spans)
        assert names["uigc.wake.wait"] == st["host_syncs"]
        for s in spans:
            if s["name"] in ("uigc.wake.ids", "uigc.layout.tiers",
                             "uigc.wake.closure.sweep",
                             "uigc.wake.repair.sweep"):
                assert by_id[s["parent_id"]]["name"] == "uigc.wake", s["name"]


def test_fold_span_carries_the_fold_counts():
    """The fold's span ends with the counts ``layout.stats`` gained: the
    log's distinct keys, by the home each resolved in."""
    ch = Churn(seed=16)
    tr = ch.tracer(freeze_threshold=64, max_frozen=1)
    tr.marks(*ch.inputs("cpu"))
    stats = tr.layout.stats
    homes = ("fold_pending", "fold_frozen", "fold_base", "fold_missing")
    tracer = Tracer("uigc://n1", enabled=True)
    seen = Counter()
    for _ in range(6):
        log = ch.next_log()
        before = {k: stats[k] for k in ("fold_keys",) + homes}
        tracer.clear()
        with tracer.span("gc_wave"):
            tr.apply_log(log)
        (fold,) = [s for s in tracer.spans() if s["name"] == "uigc.layout.fold"]
        assert fold["args"] == {k: stats[k] - v for k, v in before.items()}
        assert fold["args"]["fold_keys"] == len({e[1:] for e in log})
        assert sum(fold["args"][k] for k in homes) == fold["args"]["fold_keys"]
        seen.update(fold["args"])
        marks = tr.unpack_marks(tr.wake_device(*ch.inputs("cpu")))
        assert np.array_equal(marks, ch.oracle())
    # releases resolve in the base, creations nowhere (the other homes'
    # counts: tests/test_torch_layout_fold.py)
    assert seen["fold_base"] > 0 and seen["fold_missing"] > 0


def test_freeze_and_consolidate_spans_open_with_their_tiers():
    ch = Churn(seed=13)
    tr = ch.tracer(freeze_threshold=64, max_frozen=1)
    tr.marks(*ch.inputs("cpu"))
    stats = tr.layout.stats
    tracer = Tracer("uigc://n1", enabled=True)
    seen = Counter()
    for _ in range(6):
        before = (stats["freezes"], stats["consolidations"])
        tracer.clear()
        with tracer.span("gc_wave"):
            tr.apply_log(ch.next_log())
            marks = tr.unpack_marks(tr.wake_device(*ch.inputs("cpu")))
        assert np.array_equal(marks, ch.oracle())
        names = Counter(s["name"] for s in tracer.spans())
        assert names["uigc.layout.freeze"] == stats["freezes"] - before[0]
        assert (names["uigc.layout.consolidate"]
                == stats["consolidations"] - before[1])
        by_id = {s["span_id"]: s for s in tracer.spans()}
        for s in tracer.spans():
            if s["name"] in ("uigc.layout.freeze", "uigc.layout.consolidate"):
                assert by_id[s["parent_id"]]["name"] == "uigc.layout.tiers"
        seen.update(names)
    assert seen["uigc.layout.freeze"] > 0
    assert seen["uigc.layout.consolidate"] > 0


def test_off_hands_out_the_no_op_span(monkeypatch):
    ch = Churn(seed=14)
    tr = ch.tracer(freeze_threshold=64, max_frozen=1)

    def refuse(name):
        raise AssertionError(f"a profiler record was made for {name}")

    monkeypatch.setattr(events, "_RecordFunctionFast", refuse)
    for name in WAKE_SPANS + ("uigc.layout.freeze", "uigc.layout.consolidate"):
        assert events.span(name) is events._NO_SPAN
    for _ in range(4):  # a freeze and a consolidation among them
        tr.apply_log(ch.next_log())
        marks = tr.marks(ch.flags, ch.recv)
        assert np.array_equal(marks, ch.oracle())
    assert tr.layout.stats["freezes"] > 0
    assert tr.layout.stats["consolidations"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_marks_are_unchanged_by_the_spans(mode, monkeypatch):
    ch = Churn(seed=15)
    on = ch.tracer(mode=mode, freeze_threshold=64, max_frozen=2)
    off = ch.tracer(mode=mode, freeze_threshold=64, max_frozen=2)
    tracer = Tracer("uigc://n1", enabled=True)
    for _ in range(4):
        log = ch.next_log()
        with profile(activities=[ProfilerActivity.CPU]), \
                tracer.span("gc_wave"):
            on.apply_log(log)
            with_spans = on.marks(ch.flags, ch.recv)
        with monkeypatch.context() as m:
            m.setattr(events, "span", lambda name, **args: events._NO_SPAN)
            off.apply_log(log)
            without = off.marks(ch.flags, ch.recv)
        assert np.array_equal(with_spans, without)
        assert np.array_equal(with_spans, ch.oracle())
        assert on.last_stats["n_sweeps"] == off.last_stats["n_sweeps"]
        assert (on.last_stats["closure_sweeps"]
                == off.last_stats["closure_sweeps"])
    assert on.layout.stats["anomalies"] == off.layout.stats["anomalies"] == 0
