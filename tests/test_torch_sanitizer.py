"""The port's sanitizer (uigcsan) and race detector against the JAX
package's (``uigc_tpu/analysis``).

- A seeded churn (links, pings, drops, cycles, then a release of
  everything) runs on every single-node backend of the port with the
  sanitizer on and the device backends on the CPU
  (``uigc.crgc.device: "cpu"``): zero violations, verdicts checked, every
  actor collected.  The same script on the reference's host backend
  comes out the same.
- The planted faults of ``tests/test_analysis.py`` (a double release, a
  dropped recv fact, a reordered undo fold, a premature terminate), in
  their single-node form, are flagged by both packages with the same
  rule and payload.
- The race detector reports the same races as the reference's on the
  same seeded ``sched.*`` streams, and none on a live run.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import uigc_tpu
import uigc_tpu.analysis as ref_analysis
import uigc_tpu.engines.crgc.state as ref_state
import uigc_tpu.engines.crgc.undo as ref_undo
import uigc_tpu.engines.engine as ref_engine
import uigc_tpu.engines.crgc.messages as ref_messages
import uigc_tpu_torch
import uigc_tpu_torch.analysis as port_analysis
import uigc_tpu_torch.engines.crgc.messages as port_messages
import uigc_tpu_torch.engines.crgc.state as port_state
import uigc_tpu_torch.engines.crgc.undo as port_undo
import uigc_tpu_torch.engines.engine as port_engine
from uigc_tpu.utils import events as ref_events
from uigc_tpu_torch.utils import events as port_events

torch.set_num_threads(1)

PKGS = {
    "ref": (uigc_tpu, ref_analysis, ref_state, ref_undo, ref_engine,
            ref_messages, ref_events),
    "port": (uigc_tpu_torch, port_analysis, port_state, port_undo,
             port_engine, port_messages, port_events),
}
BASE = {"uigc.crgc.wakeup-interval": 10, "uigc.analysis.sanitizer": True,
        "uigc.crgc.device": "cpu"}


def settle(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return bool(pred())


# --------------------------------------------------------------------- #
# Seeded churn on every backend
# --------------------------------------------------------------------- #


def churn_schedule(seed, n_workers=24, steps=6, ops_per_step=30):
    """Per step: (op, a, b) rows; op 0 = give worker a a ref to worker b,
    1 = ping a (it pokes every actor it holds), 2 = a drops its refs."""
    rng = np.random.default_rng(seed)
    return [
        np.stack([rng.choice(3, ops_per_step, p=[0.5, 0.35, 0.15]),
                  rng.integers(0, n_workers, ops_per_step),
                  rng.integers(0, n_workers, ops_per_step)], 1).tolist()
        for _ in range(steps)
    ], n_workers


def run_churn(pkg, config, seed=7):
    """The churn on ``pkg``'s runtime; returns (collected, n, report,
    quiescent violations)."""
    schedule, n = churn_schedule(seed)
    done = threading.Semaphore(0)

    class Share(pkg.Message):
        def __init__(self, ref):
            self.ref = ref

        @property
        def refs(self):
            return (self.ref,)

    class Ping(pkg.NoRefs):
        pass

    class Poke(pkg.NoRefs):
        pass

    class DropAll(pkg.NoRefs):
        pass

    class Step(pkg.NoRefs):
        def __init__(self, ops):
            self.ops = ops

    class Release(pkg.NoRefs):
        pass

    class Peer(pkg.AbstractBehavior):
        def __init__(self, ctx):
            super().__init__(ctx)
            self.held = []

        def on_message(self, msg):
            if isinstance(msg, Share):
                self.held.append(msg.ref)
            elif isinstance(msg, Ping):
                for ref in self.held:
                    ref.tell(Poke(), self.context)
            elif isinstance(msg, DropAll) and self.held:
                self.context.release(*self.held)
                self.held = []
            return self

        def on_signal(self, signal):
            if signal is pkg.PostStop:
                done.release()
            return None

    class Root(pkg.AbstractBehavior):
        def __init__(self, ctx):
            super().__init__(ctx)
            self.workers = [ctx.spawn(pkg.Behaviors.setup(Peer), f"w{i}")
                            for i in range(n)]

        def on_message(self, msg):
            ctx = self.context
            if isinstance(msg, Step):
                for op, a, b in msg.ops:
                    wa, wb = self.workers[a], self.workers[b]
                    if op == 0:
                        wa.tell(Share(ctx.create_ref(wb, wa)), ctx)
                    elif op == 1:
                        wa.tell(Ping(), ctx)
                    else:
                        wa.tell(DropAll(), ctx)
            elif isinstance(msg, Release) and self.workers:
                ctx.release(*self.workers)
                self.workers = []
            return self

    kit = pkg.ActorTestKit(dict(BASE, **config))
    try:
        san = kit.system.sanitizer
        root = kit.spawn(pkg.Behaviors.setup_root(Root), "root")
        for ops in schedule:
            root.tell(Step(ops))
            time.sleep(0.03)
        root.tell(Release())
        collected = 0
        deadline = time.monotonic() + 30.0
        while collected < n and time.monotonic() < deadline:
            if done.acquire(timeout=0.1):
                collected += 1
        assert settle(lambda: san.checks > 2)
        quiescent = san.check_quiescent()
        return collected, n, san.report(), san.violations, quiescent
    finally:
        kit.shutdown()


PORT_BACKENDS = [
    {"uigc.crgc.shadow-graph": "oracle"},
    {"uigc.crgc.shadow-graph": "array"},
    {"uigc.crgc.shadow-graph": "device", "uigc.crgc.trace-mode": "push"},
    {"uigc.crgc.shadow-graph": "device"},
    {"uigc.crgc.shadow-graph": "decremental"},
    {"uigc.crgc.shadow-graph": "decremental", "uigc.crgc.pipelined": True},
    {"uigc.crgc.shadow-graph": "mesh", "uigc.crgc.mesh-devices": 2},
    {"uigc.crgc.shadow-graph": "mesh-decremental",
     "uigc.crgc.mesh-devices": 2, "uigc.crgc.pipelined": True},
]


@pytest.mark.parametrize("config", PORT_BACKENDS, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_churn_on_every_backend_has_zero_violations(config):
    collected, n, report, violations, quiescent = run_churn(
        uigc_tpu_torch, config)
    assert violations == [] and quiescent == [], report
    assert report["checks"] > 0
    assert collected == n


def test_churn_agrees_with_the_reference_on_a_host_backend():
    config = {"uigc.crgc.shadow-graph": "array"}
    ref = run_churn(uigc_tpu, config)
    port = run_churn(uigc_tpu_torch, config)
    for collected, n, report, violations, quiescent in (ref, port):
        assert violations == [] and quiescent == [], report
        assert collected == n and report["checks"] > 0
    # the mutator-side ground truth of one seeded script: same totals
    assert ref[2]["tap"] == port[2]["tap"]
    assert set(ref[2]) == set(port[2])


def test_mac_gets_the_taps_only():
    kit = uigc_tpu_torch.ActorTestKit({"uigc.engine": "mac",
                                       "uigc.analysis.sanitizer": True})
    try:
        san = kit.system.sanitizer
        assert san is not None and san.oracle is None
        assert san.violations == [] and san.check_quiescent() == []
    finally:
        kit.shutdown()


class _Coord:
    """The (system.address, uid) coordinates the oracle and cell_key read."""

    __slots__ = ("system", "uid", "path")

    def __init__(self, address, uid):
        self.system = types.SimpleNamespace(address=address)
        self.uid = uid
        self.path = f"{address}/c{uid}"


def _seeded_oracle(name, seed, n_cells=60, n_ops=200):
    """``name``'s sanitizer over a bare stub system, its oracle folded
    from a seeded delta script (two addresses, every fold kind)."""
    pkg = PKGS[name][0]
    mods = {"ref": ("uigc_tpu", ref_analysis), "port": ("uigc_tpu_torch",
                                                      port_analysis)}
    root, analysis = mods[name]
    delta_mod = __import__(f"{root}.engines.crgc.delta", fromlist=["x"])
    shadow_mod = __import__(f"{root}.engines.crgc.shadow", fromlist=["x"])
    state = PKGS[name][2]
    system = types.SimpleNamespace(
        engine=None, address="uigc://a",
        config=pkg.Config({"uigc.analysis.sanitizer": True}))
    san = analysis.Sanitizer(system)
    ctx = state.CrgcContext(delta_graph_size=512, entry_field_size=4)
    san.oracle = shadow_mod.ShadowGraph(ctx, "uigc://a")
    rng = np.random.default_rng(seed)
    cells = [_Coord(("uigc://a", "uigc://b")[i % 2], 5 + 3 * i)
             for i in range(n_cells)]
    graph = delta_mod.DeltaGraph("uigc://a", ctx)
    for op, a, b, k in rng.integers(0, n_cells, (n_ops, 4)).tolist():
        a, b = cells[a], cells[b]
        if op % 5 == 0:
            graph.fold_self(a, k % 4, bool(k % 2), k % 7 == 0)
        elif op % 5 == 1:
            graph.fold_created(a, b)
        elif op % 5 == 2:
            graph.fold_spawned(a, b)
        elif op % 5 == 3:
            graph.fold_sends(a, k % 3)
        else:
            graph.fold_deactivate(a, b)
    san.oracle.merge_delta(graph)
    return san


def test_distributed_paths_raise_naming_the_roadmap_item():
    """The distributed collector's sanitizer paths, which raised (naming
    ROADMAP item 7c) until the collector was ported: ``oracle_slice``
    and ``_reset_partition`` give the reference's slices on a seeded
    ``PartitionMap`` over the same seeded oracle."""
    import uigc_tpu.parallel.partition as ref_partition
    import uigc_tpu_torch.parallel.partition as port_partition

    members = ["uigc://a", "uigc://b", "uigc://c"]
    for seed in range(3):
        sans = {name: _seeded_oracle(name, seed) for name in ("ref", "port")}
        pmaps = {name: mod.PartitionMap(members, 16, fence=seed,
                                        self_address="uigc://a")
                 for name, mod in (("ref", ref_partition),
                                   ("port", port_partition))}
        before = sans["port"].oracle_slice(None)
        assert before == sans["ref"].oracle_slice(None)
        owned = sans["port"].oracle_slice(pmaps["port"])
        assert owned == sans["ref"].oracle_slice(pmaps["ref"])
        assert 0 < len(owned) < len(before)
        gained = set(range(0, 16, 2))
        for name in ("ref", "port"):
            sans[name]._reset_partition(gained, pmaps[name])
            sans[name]._reset_partition(gained, None)  # single node: no-op
        after = sans["port"].oracle_slice(None)
        assert after == sans["ref"].oracle_slice(None)
        assert after != before
        cleared = [k for k in after
                   if pmaps["port"].partition_of(k) in gained]
        assert cleared
        for k in cleared:
            assert not after[k]["interned"] and not after[k]["outgoing"]


# --------------------------------------------------------------------- #
# Planted faults (tests/test_analysis.py's mutations, single node)
# --------------------------------------------------------------------- #


def owner_kit(name):
    """A kit on ``name``'s package with a root that owns one worker."""
    pkg = PKGS[name][0]

    class Ping(pkg.NoRefs):
        pass

    class DoubleDrop(pkg.NoRefs):
        pass

    class Worker(pkg.AbstractBehavior):
        def on_message(self, msg):
            return self

    class Owner(pkg.AbstractBehavior):
        def __init__(self, ctx):
            super().__init__(ctx)
            self.worker = ctx.spawn(pkg.Behaviors.setup(Worker), "worker")

        def on_message(self, msg):
            if isinstance(msg, Ping) and self.worker is not None:
                self.worker.tell(Ping(), self.context)
            elif isinstance(msg, DoubleDrop) and self.worker is not None:
                self.context.release(self.worker)
                self.context.release(self.worker)  # the planted fault
                self.worker = None
            return self

    kit = pkg.ActorTestKit(dict(BASE, **{"uigc.crgc.shadow-graph": "array"}))
    owner = kit.spawn(pkg.Behaviors.setup_root(Owner), "owner")
    return kit, owner, Ping, DoubleDrop


def double_release(name):
    kit, owner, Ping, DoubleDrop = owner_kit(name)
    try:
        owner.tell(Ping())
        time.sleep(0.2)
        owner.tell(DoubleDrop())
        san = kit.system.sanitizer
        assert settle(lambda: san.by_rule("release.double"))
        v = san.by_rule("release.double")[0]
        return v.rule, v.payload["target"].split("/")[-1]
    finally:
        kit.shutdown()


def dropped_recv_fact(name):
    state_mod = PKGS[name][2]
    orig = state_mod.CrgcState.record_message_received
    dropped = {"done": False}

    def mutated(self):
        if not dropped["done"] and self.self_ref.target.path.endswith("/worker"):
            dropped["done"] = True
            return
        orig(self)

    state_mod.CrgcState.record_message_received = mutated
    try:
        kit, owner, Ping, _ = owner_kit(name)
        try:
            for _ in range(10):
                owner.tell(Ping())
                time.sleep(0.005)
            san = kit.system.sanitizer
            assert settle(lambda: bool(san.check_quiescent()))
            v = san.by_rule("balance.nonzero_recv")[0]
            return (v.rule, v.payload["balance"],
                    v.payload["tap_recvs"] == v.payload["tap_sends"])
        finally:
            kit.shutdown()
    finally:
        state_mod.CrgcState.record_message_received = orig


def reordered_undo_fold(name):
    """The collector folds a dead node's undo log on every wake: before
    its finalization quorum (nobody finalized it), and again."""
    undo = PKGS[name][3]
    kit, owner, Ping, _ = owner_kit(name)
    try:
        bookkeeper = kit.system.engine.bookkeeper
        orig_collect = bookkeeper.collect
        ghost = "uigc://ghost"

        def mutated():
            count = orig_collect()
            bookkeeper.shadow_graph.merge_undo_log(undo.UndoLog(ghost))
            return count

        bookkeeper.collect = mutated
        owner.tell(Ping())
        san = kit.system.sanitizer
        assert settle(lambda: san.by_rule("undo.double_fold"))
        premature = san.by_rule("undo.premature_fold")[0]
        double = san.by_rule("undo.double_fold")[0]
        return (premature.payload["address"], premature.payload["missing"],
                premature.payload["finalized_by"], double.payload["address"])
    finally:
        kit.shutdown()


def premature_terminate(name):
    engine_mod, messages = PKGS[name][4], PKGS[name][5]
    kit, owner, Ping, _ = owner_kit(name)
    try:
        for _ in range(5):
            owner.tell(Ping())
        time.sleep(0.3)  # the worker is interned and provably live now
        engine = kit.system.engine
        orig_on_idle = engine.on_idle

        def mutated(msg, state, ctx):
            if (isinstance(msg, messages.AppMsg)
                    and ctx.cell.path.endswith("/worker")):
                return engine_mod.TerminationDecision.SHOULD_STOP
            return orig_on_idle(msg, state, ctx)

        engine.on_idle = mutated
        owner.tell(Ping())
        san = kit.system.sanitizer
        assert settle(lambda: san.by_rule("terminate.premature"))
        v = san.by_rule("terminate.premature")[0]
        return v.rule, v.payload["actor"].split("/")[-1]
    finally:
        kit.shutdown()


@pytest.mark.parametrize("mutation", [double_release, dropped_recv_fact,
                                      reordered_undo_fold,
                                      premature_terminate],
                         ids=lambda f: f.__name__)
def test_planted_fault_is_flagged_as_the_reference_flags_it(mutation):
    port = mutation("port")
    assert port == mutation("ref")
    if mutation is reordered_undo_fold:
        assert port[0] == "uigc://ghost" and port[1] and port[2] == []


def test_violations_raise_in_raise_mode():
    kit = uigc_tpu_torch.ActorTestKit(
        dict(BASE, **{"uigc.analysis.sanitizer-raise": True}))
    try:
        with pytest.raises(port_analysis.SanitizerViolation):
            kit.system.sanitizer.record("verdict.mismatch", "planted")
        assert [v.rule for v in kit.system.sanitizer.violations] == [
            "verdict.mismatch"]
    finally:
        kit.shutdown()


# --------------------------------------------------------------------- #
# Race detector
# --------------------------------------------------------------------- #

SCHED_KINDS = ("SCHED_ENQUEUE", "SCHED_BATCH_START", "SCHED_INVOKE",
               "SCHED_BATCH_END", "SCHED_SPAWN", "SCHED_POSTSTOP",
               "SCHED_TERMINATED")


def sched_stream(events_mod, seed, length=400, cells=5, threads=3):
    """A seeded stream of ``sched.*`` events over a few cells and
    threads, in random order: every kind of race shows up in it."""
    rng = np.random.default_rng(seed)
    out = []
    for seq in range(1, length + 1):
        kind = SCHED_KINDS[rng.integers(len(SCHED_KINDS))]
        cell = int(rng.integers(1, cells + 1))
        fields = {"seq": seq, "cell": cell, "path": f"/u/c{cell}",
                  "thread": f"t{rng.integers(threads)}"}
        if kind in ("SCHED_ENQUEUE", "SCHED_INVOKE"):
            fields["kind"] = ("sys", "app")[rng.integers(2)]
        if kind == "SCHED_SPAWN":
            fields["parent"] = int(rng.integers(1, cells + 1))
        out.append((getattr(events_mod, kind), fields))
    return out


def races(analysis, events_mod, seed):
    found = analysis.RaceDetector().feed(
        sched_stream(events_mod, seed)).analyze()
    return [(v.rule, v.payload) for v in found]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_race_detector_reports_the_reference_races(seed):
    ref = races(ref_analysis, ref_events, seed)
    port = races(port_analysis, port_events, seed)
    assert port == ref
    assert {rule for rule, _ in port} >= {"sched.overlap",
                                          "sched.sys_after_app"}


def test_vector_clock_matches_the_reference():
    rng = np.random.default_rng(3)
    clocks = {}
    for name, analysis in (("ref", ref_analysis), ("port", port_analysis)):
        vcs = [analysis.VectorClock() for _ in range(4)]
        out = []
        for a, b, t in rng.integers(0, 4, (60, 3)).tolist():
            vcs[a].tick(f"t{t}")
            vcs[b].join(vcs[a])
            out.append((vcs[a].happened_before(vcs[b]),
                        vcs[b].concurrent_with(vcs[(a + 1) % 4])))
        clocks[name] = out
        rng = np.random.default_rng(3)
    assert clocks["ref"] == clocks["port"]


def test_race_detector_clean_on_a_live_port_run():
    port_events.recorder.enable()
    detector = port_analysis.RaceDetector().attach()
    try:
        kit = uigc_tpu_torch.ActorTestKit({
            "uigc.crgc.wakeup-interval": 10,
            "uigc.analysis.sched-events": True,
        })
        try:
            class Worker(uigc_tpu_torch.AbstractBehavior):
                def on_message(self, msg):
                    return self

            class Nudge(uigc_tpu_torch.NoRefs):
                pass

            class Owner(uigc_tpu_torch.AbstractBehavior):
                def __init__(self, ctx):
                    super().__init__(ctx)
                    self.worker = ctx.spawn(
                        uigc_tpu_torch.Behaviors.setup(Worker), "worker")

                def on_message(self, msg):
                    if self.worker is not None:
                        self.worker.tell(Nudge(), self.context)
                    return self

            owner = kit.spawn(uigc_tpu_torch.Behaviors.setup_root(Owner),
                              "owner")
            for _ in range(30):
                owner.tell(Nudge())
            time.sleep(0.3)
        finally:
            kit.shutdown()
    finally:
        detector.detach()
        port_events.recorder.disable()
        port_events.recorder.reset()
    assert detector.event_count() > 50
    assert detector.analyze() == []
