"""The port's MAC and DRL engines (uigc_tpu_torch/engines/{mac,drl}).

- Detector parity: the reference's ``CycleDetector`` and the port's read
  the same seeded protocol queue (BLK snapshots, then UNBs and ACKs) over
  several scans, on the device SCC path (threshold 0; the port's SCC on
  the CPU, the reference's in JAX) and on host Tarjan, and must probe the
  same member sets, kill the same cells and count the same cycles.
- The live shapes of tests/test_mac.py, tests/test_scc.py and
  tests/test_drl.py on the port's ActorTestKit, with the detector's
  device SCC on the CPU (``uigc.mac.device: "cpu"``).
- BASELINE config 2 (``run_tree(engine="mac")``, flat) and MAC rings with
  cycle detection through the port's workloads.
- ``uigc.mac.device: "cuda"`` with no card raises when the system is
  built, and leaves nothing running.
"""

import random
import threading
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from uigc_tpu.config import Config as RefConfig
from uigc_tpu.engines.mac import detector as ref_detector
from uigc_tpu.engines.mac import engine as ref_engine
from uigc_tpu.ops import scc as ref_scc
from uigc_tpu_torch import (AbstractBehavior, ActorSystem, ActorTestKit,
                            Behaviors, Message, NoRefs, PostStop)
from uigc_tpu_torch.config import Config
from uigc_tpu_torch.engines.mac import detector as port_detector
from uigc_tpu_torch.engines.mac import engine as port_engine
from uigc_tpu_torch.models import run_rings, run_tree
from uigc_tpu_torch.ops import scc as port_scc

torch.set_num_threads(1)

CYCLES = {
    "uigc.engine": "mac",
    "uigc.mac.cycle-detection": True,
    "uigc.mac.wakeup-interval": 10,
    "uigc.mac.device": "cpu",
}
RC_INC = port_engine.RC_INC


# --------------------------------------------------------------------- #
# Detector parity on a seeded protocol queue
# --------------------------------------------------------------------- #


class FakeCell:
    """An actor cell that records what it is told."""

    __slots__ = ("name", "told")

    def __init__(self, name):
        self.name = name
        self.told = []

    def tell(self, msg):
        self.told.append(msg)


def ring_blks(rng, first, size, extra_rc=0, children=0):
    """A ring's BLK snapshots as (name, rc, [(target, weight)], children):
    each member holds its self entry and a weight to the next member, and
    its rc is what its predecessor holds (plus ``extra_rc`` on member 0,
    an outside holder that leaves the ring open)."""
    names = list(range(first, first + size))
    weights = [int(rng.integers(1, 6)) for _ in names]
    blks = []
    for i, name in enumerate(names):
        rc = weights[i - 1] + (extra_rc if i == 0 else 0)
        amap = [(name, RC_INC), (names[(i + 1) % size], weights[i])]
        blks.append([name, rc, amap, children if i == 0 else 0])
    return blks


def protocol(seed):
    """The seeded scenario: closed rings, rings left open by an outside
    weight, rings whose head has a child, chords between rings, a
    closed singleton, zero-weight entries and refs to cells that never
    block.  Returns (blks, open_rings).

    The chords a <-> b merge two rings into one closed SCC; the chord
    c -> d leaves c closed and d open (its rc counts c's weight)."""
    rng = np.random.default_rng(seed)
    blks, open_rings, rings = [], [], []
    name = 0
    for kind in ["closed"] * 6 + ["open"] * 3 + ["children"] * 2 + ["chord"] * 4:
        size = int(rng.integers(2, 7))
        ring = ring_blks(rng, name, size,
                         extra_rc=3 if kind == "open" else 0,
                         children=1 if kind == "children" else 0)
        if kind == "open":
            open_rings.append(ring)
        if kind == "chord":
            rings.append(ring)
        blks.extend(ring)
        name += size
    a, b, c, d = rings
    for src, dst in ((a, b), (b, a), (c, d)):
        s = src[int(rng.integers(len(src)))]
        t = dst[int(rng.integers(len(dst)))]
        w = int(rng.integers(1, 4))
        s[2].append((t[0], w))
        t[1] += w  # the chord's weight counts in the target's rc
    blks.append([name, 0, [(name, RC_INC)], 0])  # a closed singleton
    blks[0][2].append((blks[3][0], 0))  # a zero weight: no edge
    blks[1][2].append((10_000, 2))  # a cell that never blocks
    return blks, open_rings


class Side:
    """One detector (the reference's or the port's) over its own cells."""

    def __init__(self, detector_mod, engine_mod, config, threshold):
        self.mod = detector_mod
        self.eng = engine_mod
        engine = SimpleNamespace(system=SimpleNamespace(config=config),
                                 queue=deque(), collect_cycles=True)
        self.detector = detector_mod.CycleDetector(engine)
        self.detector.device_scc_threshold = threshold
        self.queue = engine.queue
        self.cells = {}

    def cell(self, name):
        if name not in self.cells:
            self.cells[name] = FakeCell(name)
        return self.cells[name]

    def blk(self, name, rc, amap, children):
        self.queue.append(self.mod.BLK(
            self.cell(name), rc, [(self.cell(t), w) for t, w in amap],
            children))

    def unb(self, name):
        self.queue.append(self.mod.UNB(self.cell(name)))

    def ack(self, name, token):
        self.queue.append(self.mod.ACK(self.cell(name), token))

    def scan(self):
        """One scan; returns the probes it sent ({member names: token}),
        the cells it killed and its cycle count."""
        for cell in self.cells.values():
            cell.told.clear()
        self.detector.scan()
        probes, killed = {}, set()
        for cell in self.cells.values():
            for msg in cell.told:
                if isinstance(msg, self.eng.CNF):
                    probes.setdefault(msg.token, set()).add(cell.name)
                elif msg is self.eng.KillMsg:
                    killed.add(cell.name)
        by_members = {frozenset(m): t for t, m in probes.items()}
        assert len(by_members) == len(probes)
        return by_members, killed, self.detector.total_cycles_collected


@pytest.mark.parametrize("threshold", [0, 1 << 30], ids=["device", "tarjan"])
@pytest.mark.parametrize("seed", [0, 1])
def test_detector_parity_with_the_reference(seed, threshold, monkeypatch):
    calls = {"jax": 0, "torch": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(ref_scc, "scc_labels_jax",
                        counted("jax", ref_scc.scc_labels_jax))
    monkeypatch.setattr(port_scc, "scc_labels_torch",
                        counted("torch", port_scc.scc_labels_torch))
    ref = Side(ref_detector, ref_engine, RefConfig(), threshold)
    port = Side(port_detector, port_engine,
                Config({"uigc.mac.device": "cpu"}), threshold)
    assert port.detector.device == torch.device("cpu")
    sides = (ref, port)
    blks, open_rings = protocol(seed)
    order = np.random.default_rng(seed + 10).permutation(len(blks))
    for i in order:
        for side in sides:
            side.blk(*blks[i])

    rng = random.Random(seed)
    tokens = ({}, {})  # per side: probed members -> their latest token
    late = []  # (members, name): ACKs held back by one scan
    unblocked = []  # members that sent UNB and will block again
    all_killed = set()
    for step in range(6):
        results = [side.scan() for side in sides]
        (ref_probes, ref_killed, ref_cycles), (probes, killed, cycles) = results
        assert set(probes) == set(ref_probes), f"scan {step}: probed sets"
        assert killed == ref_killed, f"scan {step}: killed cells"
        assert cycles == ref_cycles, f"scan {step}: cycles collected"
        assert {c.name for c in port.detector.blocked} == {
            c.name for c in ref.detector.blocked}, f"scan {step}: blocked"
        all_killed |= killed
        for side_tokens, side_probes in zip(tokens, (ref_probes, probes)):
            side_tokens.update(side_probes)

        def ack(members, name):
            for side, side_tokens in zip(sides, tokens):
                side.ack(name, side_tokens[members])

        for members, name in late:
            ack(members, name)
        late = []
        # The members of each new probe answer it the same way on both
        # sides: one unblocks (the probe is void), one ACKs a scan late,
        # or all ACK now.
        for members in sorted(probes, key=sorted):
            names = sorted(members)
            choice = rng.random()
            if choice < 0.2:
                quitter = rng.choice(names)
                for side in sides:
                    side.unb(quitter)
                unblocked.append(quitter)
                continue
            slow = rng.choice(names) if choice < 0.4 else None
            for name in names:
                if name == slow:
                    late.append((members, name))
                else:
                    ack(members, name)
        # Unblocked members block again with their old snapshot; after
        # scan 2 the open rings' outside holder lets go (UNB, then a BLK
        # without the outside weight), which closes them.
        for name in unblocked:
            blk = next(b for b in blks if b[0] == name)
            for side in sides:
                side.blk(*blk)
        unblocked = []
        if step == 2:
            for ring in open_rings:
                head = ring[0]
                for side in sides:
                    side.unb(head[0])
                    side.blk(head[0], head[1] - 3, head[2], head[3])
    assert ref.detector.total_cycles_collected > 0
    assert all_killed
    if threshold == 0:
        assert calls["jax"] > 0 and calls["torch"] == calls["jax"]
    else:
        assert calls == {"jax": 0, "torch": 0}


class CountingDict(dict):
    """A dict that counts the walks over its items."""

    walks = 0

    def items(self):
        self.walks += 1
        return super().items()


def test_unb_voids_its_probe_without_walking_the_others():
    """A release wave's UNBs meet thousands of pending probes.  The
    reference's detector walks every pending probe for each UNB (one walk
    per UNB, quadratic in a wave); the port's voids only the UNB's own
    probe, through its member index, and walks the probes once per scan,
    to kill.  Both void the same probes."""
    sides = (Side(ref_detector, ref_engine, RefConfig(), 1 << 30),
             Side(port_detector, port_engine,
                  Config({"uigc.mac.device": "cpu"}), 1 << 30))
    n_probes, n_unbs = 300, 3000
    for side in sides:
        for r in range(n_probes):
            a, b = 2 * r, 2 * r + 1
            side.blk(a, 1, [(a, RC_INC), (b, 1)], 0)
            side.blk(b, 1, [(b, RC_INC), (a, 1)], 0)
        probes, _, _ = side.scan()
        assert len(probes) == n_probes
        side.detector.pending = CountingDict(side.detector.pending)
        for u in range(n_unbs):
            side.unb(10**6 + u)  # cells that were never probed
        for r in range(0, 20, 2):
            side.unb(2 * r)  # one member of each of 10 probes
        probes, killed, _ = side.scan()
        assert not probes and not killed
        assert len(side.detector.pending) == n_probes - 10
    ref, port = (side.detector for side in sides)
    assert ref.pending.keys() == port.pending.keys()
    assert ref.pending.walks >= n_unbs
    assert port.pending.walks == 1
    assert len(port._token_of) == 2 * (n_probes - 10)


# --------------------------------------------------------------------- #
# Live shapes (tests/test_mac.py, tests/test_scc.py, tests/test_drl.py)
# --------------------------------------------------------------------- #


class Share(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,) if self.ref is not None else ()


class Drop(NoRefs):
    pass


class CountdownInit(NoRefs):
    def __init__(self, n):
        self.n = n


class Countdown(NoRefs):
    def __init__(self, n):
        self.n = n


class Stopped(NoRefs):
    def __init__(self, name=None):
        self.name = name

    def __eq__(self, other):
        return isinstance(other, Stopped)

    def __hash__(self):
        return hash("Stopped")


class Worker(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        self.peer = None
        self.count = 0

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Share):
            self.peer = msg.ref
        elif isinstance(msg, Countdown):
            self.count += 1
            if msg.n > 0:
                ctx.self.tell(Countdown(msg.n - 1), ctx)
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe.ref.tell(Stopped(self.context.name))
        return None


class Root(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        factory = Behaviors.setup(lambda ctx: Worker(ctx, probe))
        self.a = context.spawn(factory, "a")
        self.b = context.spawn(factory, "b")

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Drop):
            ctx.release(self.a, self.b)
        elif isinstance(msg, Share):
            # Build the cycle a <-> b; the root still owns both.
            self.a.tell(Share(ctx.create_ref(self.b, self.a)), ctx)
            self.b.tell(Share(ctx.create_ref(self.a, self.b)), ctx)
        elif isinstance(msg, CountdownInit):
            self.a.tell(Countdown(msg.n), ctx)
            ctx.release(self.a)
        return self


def mac_kit(**extra):
    return ActorTestKit(dict({"uigc.engine": "mac"}, **extra))


def spawn_root(kit, probe):
    return kit.spawn(Behaviors.setup_root(lambda c: Root(c, probe)), "root")


def test_mac_acyclic_collection():
    kit = mac_kit()
    try:
        probe = kit.create_test_probe()
        root = spawn_root(kit, probe)
        probe.expect_no_message(0.2)
        root.tell(Drop())
        probe.expect_message_type(Stopped)
        probe.expect_message_type(Stopped)
    finally:
        kit.shutdown()


def test_mac_pending_self_messages_block_termination():
    kit = mac_kit()
    try:
        probe = kit.create_test_probe(timeout_s=30.0)
        root = spawn_root(kit, probe)
        root.tell(CountdownInit(5000))
        assert probe.expect_message_type(Stopped).name.endswith("/a")
    finally:
        kit.shutdown()


def test_mac_cycle_not_collected_without_detection(monkeypatch):
    """Cycle detection off: the released cycle leaks, and MAC never asks
    for a device (no card needed even with uigc.mac.device "cuda")."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kit = mac_kit(**{"uigc.mac.cycle-detection": False})
    try:
        assert kit.system.engine.detector is None
        probe = kit.create_test_probe()
        root = spawn_root(kit, probe)
        root.tell(Share(None))
        time.sleep(0.2)
        root.tell(Drop())
        probe.expect_no_message(0.5)
    finally:
        kit.shutdown()


@pytest.mark.parametrize("threshold", [4096, 0], ids=["tarjan", "device"])
def test_mac_cycle_collected_with_detection(threshold):
    """The a <-> b cycle is found, confirmed by CNF/ACK and killed; with
    threshold 0 through the device SCC (tests/test_scc.py's live case)."""
    kit = ActorTestKit(dict(CYCLES, **{
        "uigc.mac.device-scc-threshold": threshold}))
    try:
        probe = kit.create_test_probe(timeout_s=30.0)
        root = spawn_root(kit, probe)
        root.tell(Share(None))
        time.sleep(0.2)
        root.tell(Drop())
        probe.expect_message_type(Stopped)
        probe.expect_message_type(Stopped)
        detector = kit.system.engine.detector
        assert detector.total_cycles_collected >= 1
        assert detector.device == torch.device("cpu")
    finally:
        kit.shutdown()


def test_mac_live_cycle_not_collected():
    """A cycle still owned by the root survives: the root's weight shows
    up in the members' rc, so the cycle is not closed."""
    kit = ActorTestKit(dict(CYCLES, **{"uigc.mac.device-scc-threshold": 0}))
    try:
        probe = kit.create_test_probe()
        root = spawn_root(kit, probe)
        root.tell(Share(None))
        probe.expect_no_message(0.5)
        assert kit.system.engine.detector.scans > 0
    finally:
        kit.shutdown()


class GetRef(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


class Hello(NoRefs):
    def __eq__(self, other):
        return isinstance(other, Hello)

    def __hash__(self):
        return hash("Hello")


class SendC(NoRefs):
    def __init__(self, msg):
        self.msg = msg


class SendB(NoRefs):
    def __init__(self, msg):
        self.msg = msg


class TellBAboutC(NoRefs):
    pass


class ReleaseC(NoRefs):
    pass


class ReleaseB(NoRefs):
    pass


class StartCountdown(NoRefs):
    def __init__(self, n):
        self.n = n


class ActorB(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        self.actor_c = None

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, GetRef):
            self.actor_c = msg.ref
        elif isinstance(msg, SendC):
            self.actor_c.tell(msg.msg, ctx)
        elif isinstance(msg, ReleaseC):
            ctx.release(self.actor_c)
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe.ref.tell(Stopped())
        return None


class ActorC(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe

    def on_message(self, msg):
        if isinstance(msg, Hello):
            self.probe.ref.tell(Hello())
        elif isinstance(msg, Countdown) and msg.n > 0:
            self.context.self.tell(Countdown(msg.n - 1), self.context)
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe.ref.tell(Stopped())
        return None


class ActorA(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.actor_b = context.spawn(
            Behaviors.setup(lambda c: ActorB(c, probe)), "actorB")
        self.actor_c = context.spawn(
            Behaviors.setup(lambda c: ActorC(c, probe)), "actorC")

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, TellBAboutC):
            self.actor_b.tell(
                GetRef(ctx.create_ref(self.actor_c, self.actor_b)), ctx)
        elif isinstance(msg, SendB):
            self.actor_b.tell(msg.msg, ctx)
        elif isinstance(msg, ReleaseC):
            ctx.release(self.actor_c)
        elif isinstance(msg, ReleaseB):
            ctx.release(self.actor_b)
        elif isinstance(msg, StartCountdown):
            self.actor_c.tell(Countdown(msg.n), ctx)
            ctx.release(self.actor_c)
        return self


def drl_root(kit, probe):
    return kit.spawn(Behaviors.setup_root(lambda c: ActorA(c, probe)), "root")


def test_drl_shared_ref_lifecycle():
    kit = ActorTestKit({"uigc.engine": "drl"})
    try:
        probe = kit.create_test_probe()
        root = drl_root(kit, probe)
        root.tell(TellBAboutC())
        root.tell(SendB(SendC(Hello())))
        probe.expect_message(Hello())
        # C has two owners; releasing one must not kill it.
        root.tell(ReleaseC())
        probe.expect_no_message(0.3)
        root.tell(SendB(SendC(Hello())))
        probe.expect_message(Hello())
        # The last owner releases: C terminates; then B.
        root.tell(SendB(ReleaseC()))
        probe.expect_message(Stopped())
        root.tell(ReleaseB())
        probe.expect_message(Stopped())
    finally:
        kit.shutdown()


def test_drl_pending_self_messages():
    kit = ActorTestKit({"uigc.engine": "drl"})
    try:
        probe = kit.create_test_probe(timeout_s=30.0)
        root = drl_root(kit, probe)
        root.tell(StartCountdown(2000))
        probe.expect_message(Stopped())  # C, only after the countdown drains
    finally:
        kit.shutdown()


# --------------------------------------------------------------------- #
# BASELINE config 2 and MAC rings (models/workloads.py)
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("engine", ["mac", "drl"])
def test_run_tree_flat_collects_every_actor(engine):
    """Config 2: with no collector, the hold waits its wakeup intervals
    on the host clock (10 x 10 ms) and no actor may stop meanwhile."""
    t0 = time.monotonic()
    r = run_tree(2000, fanout=1 << 30, engine=engine, timeout_s=60.0,
                 hold_wakes=10)
    assert r["n_collected"] == 2000 and r["held_wakes"] == 10
    assert time.monotonic() - t0 >= 0.1
    assert "scans" not in r and "wakes" not in r


@pytest.mark.parametrize("threshold", [4096, 0], ids=["tarjan", "device"])
def test_run_rings_mac_collects_every_cycle(threshold, monkeypatch):
    calls = []
    plain = port_scc.scc_labels_torch

    def checked(n, src, dst, active=None, device=None):
        labels = plain(n, src, dst, active, device=device)
        calls.append(np.array_equal(
            labels, port_scc.scc_labels_np(n, src, dst, active)))
        return labels

    monkeypatch.setattr(port_scc, "scc_labels_torch", checked)
    r = run_rings(200, 10, timeout_s=60.0, hold_wakes=10, config=dict(
        CYCLES, **{"uigc.mac.device-scc-threshold": threshold}))
    assert r["n_collected"] == 2000 and r["held_wakes"] >= 10
    assert r["total_cycles_collected"] == 200 and r["scans"] >= 10
    assert all(calls)
    assert bool(calls) == (threshold == 0)


# --------------------------------------------------------------------- #
# No silent fallback
# --------------------------------------------------------------------- #


def test_mac_device_raises_without_a_card(monkeypatch):
    """uigc.mac.device "cuda" (the default) with cycle detection on and
    no card: building the system raises, and no thread is left."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ActorSystem(None, name="nocard", config={
            "uigc.engine": "mac", "uigc.mac.cycle-detection": True})
    deadline = time.monotonic() + 5.0
    while threading.active_count() > threads and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= threads
