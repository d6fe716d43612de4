"""The spans inside the port's mark fixpoint (``utils/events.py`` ``span``).

Each case runs the port's trace fn (``ops/cuda_trace.py``) on a small
power-law graph.  Off, a span leaves nothing behind and the marks are
the oracle's; under torch.profiler the spans are host events at function
scope that count the fixpoint's sweeps and changed-flag waits exactly as
its ``with_stats`` form does, and add no host read; inside a ``Tracer``
span they are its descendants, on the profiler's clock.

The ``cuda`` cases need a card and skip without one.  On a machine with
a card and no JAX, run this file without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fixpoint_spans.py -q

It imports neither jax nor uigc_tpu for that reason.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uigc_tpu_torch.engines.crgc import arrays
from uigc_tpu_torch.engines.crgc.state import CrgcContext
from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.telemetry.tracing import Tracer
from uigc_tpu_torch.utils import events

MODES = ("push", "pull", "jump", "auto")
DEVICES = ("cpu", pytest.param("cuda", marks=pytest.mark.cuda))
SCALAR_READ = "aten::_local_scalar_dense"


@pytest.fixture(scope="module")
def graph():
    return powerlaw_actor_graph(1 << 12, seed=3, garbage_fraction=0.5)


def device_of(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the propagate kernel has no CPU mode)")
    return torch.device(name)


def trace_fns(g, mode, dev):
    """The trace fn, its ``with_stats`` form, and their operands."""
    n = g["flags"].shape[0]
    src, dst, w, sup = (g["edge_src"], g["edge_dst"], g["edge_weight"],
                        g["supervisor"])
    lay = ct.layout_to_device(ct.prepare_chunks(src, dst, w, sup, n), dev)
    jump = []
    if mode in (ct.MODE_JUMP, ct.MODE_AUTO):
        jp = ct.jump_parents_from_graph(src, dst, w, sup, n)
        jump = [torch.from_numpy(jp).to(dev)]
    args = (torch.from_numpy(g["flags"]).to(dev),
            torch.from_numpy(g["recv_count"]).to(dev),
            *jump, *ct.device_args(lay))
    return (ct.get_trace_fn(lay, mode=mode),
            ct.get_trace_fn(lay, mode=mode, with_stats=True), args)


def oracle(g):
    return trace_ops.trace_marks_np(
        g["flags"], g["recv_count"], g["supervisor"], g["edge_src"],
        g["edge_dst"], g["edge_weight"])


def activities(dev):
    if dev.type == "cuda":
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def profiled(fn, args, dev):
    """fn(*args) under torch.profiler: (result, profile)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with profile(activities=activities(dev)) as prof:
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return out, prof


def no_spans(monkeypatch):
    """Every span site given the off span, whatever listens."""
    monkeypatch.setattr(events, "span", lambda name, **args: events._NO_SPAN)


def refuse_profiler_records(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler record was made for {name}")
    monkeypatch.setattr(events, "_RecordFunctionFast", refuse)


@pytest.mark.parametrize("mode", MODES)
def test_off_leaves_no_record_and_the_same_marks(graph, mode, monkeypatch):
    fn, _, args = trace_fns(graph, mode, torch.device("cpu"))
    tracer = Tracer("uigc://n1", enabled=True)
    with profile(activities=[ProfilerActivity.CPU]), tracer.span("gc_wave"):
        on = fn(*args).numpy()  # both sinks listening
    with monkeypatch.context() as m:
        refuse_profiler_records(m)
        tracer.clear()
        assert events.span("uigc.fixpoint", mode=mode) is events._NO_SPAN
        off = fn(*args).numpy()
        assert tracer.spans() == []
    with monkeypatch.context() as m:
        no_spans(m)
        without = fn(*args).numpy()
    assert np.array_equal(off, without)
    assert np.array_equal(off, on)
    assert np.array_equal(off, oracle(graph))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("mode", MODES)
def test_profiler_counts_sweeps_and_waits(graph, mode, device, monkeypatch):
    dev = device_of(device)
    fn, fn_stats, args = trace_fns(graph, mode, dev)
    want_marks, stats = fn_stats(*args)
    sweeps = int(stats["n_sweeps"])
    assert sweeps >= 2
    fn(*args)  # the first call on a card builds the kernel

    marks, prof = profiled(fn, args, dev)
    assert torch.equal(marks, want_marks)
    evs = prof.events()
    spans = [e for e in evs if e.name.startswith("uigc.")]
    counts = Counter(e.name for e in spans)
    assert counts["uigc.fixpoint"] == 1
    assert counts["uigc.fixpoint.seed"] == 1
    assert counts["uigc.fixpoint.unpack"] == 1
    assert counts["uigc.fixpoint.sweep"] == sweeps
    assert counts["uigc.fixpoint.wait"] == sweeps + 1
    assert counts["uigc.fixpoint.dirty"] == sweeps
    assert counts["uigc.fixpoint.propagate"] == sweeps  # one layout
    assert counts["uigc.fixpoint.jump"] == (sweeps if mode in ("jump", "auto")
                                            else 0)
    assert counts["uigc.fixpoint.gate"] == (sweeps if mode in ("pull", "auto")
                                            else 0)
    # host events only: no user annotation, nothing on the device
    assert all(not e.is_user_annotation for e in spans)
    assert all(str(e.device_type).endswith("CPU") for e in spans)

    with monkeypatch.context() as m:
        no_spans(m)
        _, bare = profiled(fn, args, dev)
    reads_on = sum(e.name == SCALAR_READ for e in evs)
    reads_off = sum(e.name == SCALAR_READ for e in bare.events())
    assert reads_on == reads_off >= sweeps + 1
    assert not any(e.name.startswith("uigc.") for e in bare.events())


def ancestry(span, by_id):
    """Names from the span's parent up to the root of its trace."""
    out = []
    parent = by_id.get(span["parent_id"])
    while parent is not None:
        out.append(parent["name"])
        parent = by_id.get(parent["parent_id"])
    return out


def test_tracer_children_on_the_profilers_clock(graph):
    dev = torch.device("cpu")
    fn, fn_stats, args = trace_fns(graph, "auto", dev)
    sweeps = int(fn_stats(*args)[1]["n_sweeps"])
    tracer = Tracer("uigc://n1", enabled=True)

    def wave():
        with tracer.span("gc_wave"):
            return fn(*args)

    _, prof = profiled(wave, (), dev)
    spans = tracer.spans()
    by_id = {s["span_id"]: s for s in spans}
    (root,) = [s for s in spans if s["name"] == "gc_wave"]
    (fixpoint,) = [s for s in spans if s["name"] == "uigc.fixpoint"]
    assert fixpoint["parent_id"] == root["span_id"]
    assert fixpoint["args"] == {"layouts": 1, "mode": "auto",
                                "sweeps": sweeps, "waits": sweeps + 1}
    parents = {"uigc.fixpoint.seed": "uigc.fixpoint",
               "uigc.fixpoint.sweep": "uigc.fixpoint",
               "uigc.fixpoint.unpack": "uigc.fixpoint",
               "uigc.fixpoint.gate": "uigc.fixpoint.sweep",
               "uigc.fixpoint.propagate": "uigc.fixpoint.sweep",
               "uigc.fixpoint.jump": "uigc.fixpoint.sweep",
               "uigc.fixpoint.dirty": "uigc.fixpoint.sweep"}
    inner = [s for s in spans if s["name"].startswith("uigc.")]
    assert Counter(s["name"] for s in inner)["uigc.fixpoint.sweep"] == sweeps
    for s in inner:
        assert s["trace_id"] == root["trace_id"]
        assert ancestry(s, by_id)[-1] == "gc_wave"
        up = by_id[s["parent_id"]]["name"]
        if s["name"] == "uigc.fixpoint.wait":
            assert up in ("uigc.fixpoint", "uigc.fixpoint.sweep")
        elif s["name"] != "uigc.fixpoint":
            assert up == parents[s["name"]], s["name"]
    dirty = [s["args"]["dirty_groups"] for s in inner
             if s["name"] == "uigc.fixpoint.sweep"]
    assert all(isinstance(k, int) and k > 0 for k in dirty)
    jumps = [s["args"] for s in inner if s["name"] == "uigc.fixpoint.jump"]
    assert jumps == [{"form": "torch"}] * sweeps  # the plain twin on the CPU

    # The ring's clock (time.time) and the profile's share an epoch.
    base_s = prof.profiler.kineto_results.trace_start_ns() * 1e-9
    on_profile = {}
    for e in prof.events():
        if e.name.startswith("uigc."):
            on_profile.setdefault(e.name, []).append(
                base_s + e.time_range.start * 1e-6)
    in_ring = {}
    for s in inner:
        in_ring.setdefault(s["name"], []).append(s["ts"])
    assert set(in_ring) == set(on_profile)
    for name, starts in in_ring.items():
        for ring_ts, prof_ts in zip(sorted(starts), sorted(on_profile[name])):
            assert abs(ring_ts - prof_ts) < 1e-3, name


class StubSystem:
    address = "uigc://spans"


class StubCell:
    system = StubSystem()


def small_shadow_graph(mode):
    g = arrays.ArrayShadowGraph(
        CrgcContext(delta_graph_size=64, entry_field_size=4), "uigc://spans",
        use_device=True, trace_mode=mode, device="cpu")
    slots = [g.slot_for(StubCell()) for _ in range(300)]
    for i, s in enumerate(slots):
        g.flags[s] |= trace_ops.FLAG_INTERNED | trace_ops.FLAG_LOCAL
        if i % 50 == 0:
            g.flags[s] |= trace_ops.FLAG_ROOT
        if i:
            g._update_edge(slots[(i * 7) % i], s, 1)
    return g, slots


@pytest.mark.parametrize("mode", MODES)
def test_compute_marks_spans_in_a_wave(mode):
    g, slots = small_shadow_graph(mode)
    tracer = Tracer("uigc://n1", enabled=True)
    rebuilt = []
    for wake in range(2):
        tracer.clear()
        with tracer.span("gc_wave"):
            marks = g.compute_marks()
        spans = tracer.spans()
        by_id = {s["span_id"]: s for s in spans}
        names = Counter(s["name"] for s in spans)
        assert names["uigc.marks.layout_sync"] == 1
        assert names["uigc.marks.upload"] == 1
        assert names["uigc.fixpoint"] == 1
        assert names["uigc.marks.readback"] == 1
        for s in spans:
            if s["name"].startswith("uigc.marks."):
                assert by_id[s["parent_id"]]["name"] == "gc_wave"
        (sync,) = [s for s in spans if s["name"] == "uigc.marks.layout_sync"]
        rebuilt.append(sync["args"]["rebuilt"])
        (read,) = [s for s in spans if s["name"] == "uigc.marks.readback"]
        assert read["args"] == {"site": "marks.cuda", "bytes": marks.nbytes}
        g._update_edge(slots[1], slots[-1], 1)  # a fold, not a rebuild
    assert rebuilt == [True, False]
