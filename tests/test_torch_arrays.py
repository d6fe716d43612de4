"""Port parity: the port's ArrayShadowGraph against the JAX package's.

One seeded, numpy-made script of shadow-graph mutations goes to both
graphs through the graph's own mutators (``slot_for``, ``_update_edge``,
``_set_supervisor``, plus flag and receive-count writes): slot interning
past the initial 1,024 slots (so capacity grows and the device layouts
rebuild), edge weights that go live, change and die, supervisor changes,
and busy/root/halt/receive churn.  After each of several wakes the marks,
the garbage and kill slot sets of ``trace(should_kill=False)`` and the
freed slots must be equal, exactly.

The JAX side runs as the reference's own tests run it on the CPU: its
``device`` backend takes ``trace_marks_jax`` and its ``decremental``
backend the Pallas kernel in interpret mode.  The port runs with
``device="cpu"``: the same incremental layout and decremental tracer as
on the card, over the kernel's plain PyTorch version.
"""

import numpy as np
import pytest
import torch

from uigc_tpu.engines.crgc import arrays as ref_arrays
from uigc_tpu.engines.crgc.state import CrgcContext as RefContext
from uigc_tpu.ops import pallas_trace
from uigc_tpu_torch.engines.crgc import arrays as port_arrays
from uigc_tpu_torch.engines.crgc.state import CrgcContext
from uigc_tpu_torch.ops import cuda_trace
from uigc_tpu_torch.ops import trace as trace_ops

torch.set_num_threads(1)
F = trace_ops


class StubSystem:
    address = "uigc://parity"


class StubCell:
    """What ``slot_for`` reads of a cell: its system's address."""

    system = StubSystem()

    def __init__(self, i):
        self.i = i


def make_pair(backend, mode="auto"):
    kw = dict(use_device=backend != "array",
              decremental=backend == "decremental", trace_mode=mode)
    ref = ref_arrays.ArrayShadowGraph(
        RefContext(delta_graph_size=64, entry_field_size=4), "uigc://parity",
        **kw)
    port = port_arrays.ArrayShadowGraph(
        CrgcContext(delta_graph_size=64, entry_field_size=4), "uigc://parity",
        device="cpu", **kw)
    return ref, port


class Script:
    """Seeded mutation script applied identically to every graph."""

    def __init__(self, seed, graphs):
        self.rng = np.random.default_rng(seed)
        self.graphs = graphs
        self.cells = []

    def intern(self, k, folded=True):
        """k new actors, 5% of them roots.  ``folded`` marks them interned
        and local, as a fold of their own entry does; without it they are
        what ``slot_for`` alone leaves, uninterned pseudoroots."""
        for _ in range(k):
            cell = StubCell(len(self.cells))
            self.cells.append(cell)
            root = self.rng.random() < 0.05
            for g in self.graphs:
                s = g.slot_for(cell)
                if not folded:
                    continue
                g.flags[s] |= F.FLAG_INTERNED | F.FLAG_LOCAL
                if root:
                    g.flags[s] |= F.FLAG_ROOT

    def live_slots(self):
        g = self.graphs[0]
        return sorted(g.slot_of.values())

    def churn(self, k):
        rng = self.rng
        slots = np.array(self.live_slots())
        if slots.size < 2:
            return
        for _ in range(k):
            r = rng.random()
            a, b = (int(x) for x in rng.choice(slots, 2))
            if r < 0.45:
                # weight changes: creations, extra sends, deactivations
                delta = int(rng.choice([1, 1, 1, 2, -1, -1]))
                for g in self.graphs:
                    g._update_edge(a, b, delta)
            elif r < 0.6:
                sup = -1 if rng.random() < 0.3 else b
                for g in self.graphs:
                    g._set_supervisor(a, sup)
            elif r < 0.75:
                for g in self.graphs:
                    g.flags[a] ^= F.FLAG_BUSY
            elif r < 0.82:
                for g in self.graphs:
                    g.flags[a] ^= F.FLAG_ROOT
            elif r < 0.95:
                v = int(rng.integers(-2, 3))
                for g in self.graphs:
                    g.recv_count[a] = v
            else:
                for g in self.graphs:
                    g.flags[a] |= F.FLAG_HALTED


def wake_and_compare(ref, port, monkeypatch, what):
    """compute_marks, then trace(should_kill=False): marks, garbage and
    kill slot sets (as the trace's own sweep decided them) and freed
    slots must be equal."""
    m_ref = ref.compute_marks()
    m_port = port.compute_marks()
    assert m_port.dtype == bool and m_port.shape == (port.capacity,)
    assert np.array_equal(m_ref, m_port), (
        f"{what}: {int((m_ref != m_port).sum())} marks differ")
    seen = {}
    for name, g in (("ref", ref), ("port", port)):
        mod = ref_arrays if g is ref else port_arrays
        orig = mod.trace_ops.garbage_and_kills_np

        def spy(flags, sup, mark, _orig=orig, _name=name):
            out = _orig(flags, sup, mark)
            seen[_name] = out
            return out

        monkeypatch.setattr(mod.trace_ops, "garbage_and_kills_np", spy)
    before = {id(g): dict(g.slot_of) for g in (ref, port)}
    n_ref = ref.trace(should_kill=False)
    n_port = port.trace(should_kill=False)
    monkeypatch.undo()
    assert n_ref == n_port, what
    (g_ref, k_ref), (g_port, k_port) = seen["ref"], seen["port"]
    assert np.array_equal(np.nonzero(g_ref)[0], np.nonzero(g_port)[0]), what
    assert np.array_equal(np.nonzero(k_ref)[0], np.nonzero(k_port)[0]), what
    freed = [sorted(s for c, s in before[id(g)].items() if c not in g.slot_of)
             for g in (ref, port)]
    assert freed[0] == freed[1], what
    assert np.array_equal(ref.flags, port.flags), what
    assert np.array_equal(ref.edge_weight, port.edge_weight), what
    return n_port


def drive(backend, mode, monkeypatch, seed=0, wakes=3):
    ref, port = make_pair(backend, mode)
    script = Script(seed, [ref, port])
    script.intern(700)
    script.churn(1500)
    garbage = wake_and_compare(ref, port, monkeypatch, "wake 0")
    for w in range(1, wakes + 1):
        script.intern(600)  # the first churn wake crosses 1,024 slots
        script.churn(600)
        garbage += wake_and_compare(ref, port, monkeypatch, f"wake {w}")
    assert port.capacity == ref.capacity == 2048
    assert garbage > 0
    return port


@pytest.mark.parametrize("mode", pallas_trace.TRACE_MODES)
def test_device_backend_matches_reference(mode, monkeypatch):
    port = drive("device", mode, monkeypatch)
    assert port.rebuilds >= 2  # the first build and the capacity growth


def test_decremental_backend_matches_reference(monkeypatch):
    port = drive("decremental", "auto", monkeypatch, seed=1)
    assert port.rebuilds >= 2


def test_host_array_backend_matches_reference(monkeypatch):
    drive("array", "auto", monkeypatch, seed=2)


def test_pipelined_wake_equals_synchronous_trace(monkeypatch):
    """A launch_trace/harvest_trace pair on the port sweeps what the
    reference's synchronous trace sweeps, with the capacity growing
    between launch and harvest."""
    ref, port = make_pair("decremental")
    script = Script(3, [ref, port])
    script.intern(900)
    script.churn(2000)
    wake_and_compare(ref, port, monkeypatch, "warm-up")
    script.churn(800)
    port.launch_trace()
    assert port.has_pending_wake and port.harvest_ready()  # CPU: ready
    # past 1,024 slots: the capacity grows before the harvest.  The new
    # actors are not folded yet, so they seed and the verdicts agree.
    script.intern(1024 - len(port.slot_of) + 100, folded=False)
    assert port.capacity == ref.capacity == 2048
    before = dict(port.slot_of)
    n_port = port.harvest_trace(should_kill=False)
    n_ref = ref.trace(should_kill=False)
    assert n_port == n_ref > 0
    freed = sorted(s for c, s in before.items() if c not in port.slot_of)
    assert freed == sorted(set(before.values()) - set(ref.slot_of.values()))
    assert np.array_equal(ref.flags, port.flags)
    # and the next synchronous wake agrees again
    script.churn(400)
    wake_and_compare(ref, port, monkeypatch, "after harvest")


def test_marking_parents_match_reference_and_numpy():
    from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph

    for seed in (0, 1):
        g = powerlaw_actor_graph(3000, seed=seed, garbage_fraction=0.3)
        args = (g["flags"], g["recv_count"], g["supervisor"], g["edge_src"],
                g["edge_dst"], g["edge_weight"])
        mark, parent = cuda_trace.marking_parents_torch(*args, device="cpu")
        ref_mark, ref_parent = pallas_trace.marking_parents_jax(*args)
        np_mark, np_parent = trace_ops.trace_marks_np_parents(*args)
        assert np.array_equal(mark, ref_mark) and np.array_equal(mark, np_mark)
        assert np.array_equal(parent, ref_parent)
        assert np.array_equal(parent, np_parent)
        assert parent.dtype == np.int32 and (parent >= 0).any()


def test_parent_capture_in_the_graph(monkeypatch):
    """capture_parents routes the device backend's trace through
    marking_parents_torch: same marks and parents as the reference's."""
    ref, port = make_pair("device")
    script = Script(4, [ref, port])
    script.intern(600)
    script.churn(1200)
    for g in (ref, port):
        g.capture_parents = True
    n_ref = ref.trace(should_kill=False)
    n_port = port.trace(should_kill=False)
    assert n_ref == n_port
    assert np.array_equal(ref.last_parents_mark, port.last_parents_mark)
    assert np.array_equal(ref.last_parents, port.last_parents)


@pytest.mark.parametrize("backend", ["device", "decremental"])
def test_sweep_stats_stamp_the_trace_event(backend):
    """With ``sweep_stats`` on (what the wake profiler asks for), the
    device trace stamps its per-sweep frontier on the DEVICE_TRACE event;
    the decremental wake's equal the reference's."""
    from uigc_tpu.utils import events as ref_events
    from uigc_tpu_torch.utils import events

    ref, port = make_pair(backend)
    script = Script(5, [ref, port])
    script.intern(800)
    script.churn(1600)
    seen = {}
    for name, rec, g in (("ref", ref_events.recorder, ref),
                         ("port", events.recorder, port)):
        def grab(event, payload, _name=name):
            if event == events.DEVICE_TRACE:
                seen[_name] = payload

        g.sweep_stats = True
        rec.add_listener(grab)
        rec.enable()
        try:
            g.compute_marks()
        finally:
            rec.disable()
            rec.remove_listener(grab)
    got = seen["port"]
    assert got["trace_mode"] == "auto" and got["n_sweeps"] > 0
    assert len(got["sweep_dirty_chunks"]) == got["n_sweeps"]
    if backend == "decremental":
        want = seen["ref"]
        for key in ("n_sweeps", "sweep_dirty_chunks", "sweep_tiles_skipped",
                    "sweep_pull_on"):
            assert got[key] == want[key], key
