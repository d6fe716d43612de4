"""The port's collectors in separate OS processes over real TCP sockets
(``uigc_tpu_torch/runtime/node.py``), with ``kill -9`` and a silent
death as the crash injections: the port's counterpart of
``tests/test_multiprocess.py``, on the ``device`` backend with its plain
trace (``uigc.crgc.device`` "cpu").

- A worker on node B (a child process) kept alive only by a ref held on
  node C (another child) is collected once C is killed, clean and with
  C's pings to B dropped; the driver (node A) sees it through its probe.
- A remote spawn into a child process, released by the driver, is
  collected there.
- BASELINE config 4 across three processes, at a small size: B owns
  200 workers pinned by refs on C; C is stopped (``SIGSTOP``: a wedged
  peer that sends no EOF) and the heartbeat's phi-accrual verdict, not
  an EOF, drives ``MemberRemoved``; every worker is collected after and
  none before, with A and B on shared-memory rings.  The shape of
  ``chip_smoke.py`` phase 11.

The roles live in ``uigc_tpu_torch/models/nodeproc.py``, imported under
one name in every process.
"""

import signal
import time
from pathlib import Path

import pytest

from uigc_tpu_torch.models import nodeproc
from uigc_tpu_torch.models.nodeproc import (BASE, Child, DropCmd, Ping,
                                            ProbeForwarder, Spawned, Stopped)
from uigc_tpu_torch.runtime.behaviors import AbstractBehavior, Behaviors
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.runtime.system import ActorSystem
from uigc_tpu_torch.runtime.testkit import TestProbe
from uigc_tpu_torch.utils import events

REPO = str(Path(__file__).resolve().parent.parent)
DEVICE = {"uigc.crgc.shadow-graph": "device", "uigc.crgc.device": "cpu"}


def child(spec):
    return Child(spec, cwd=REPO)


@pytest.mark.parametrize("with_drops", [False, True], ids=["clean", "drops"])
def test_multiprocess_three_node_crash_recovery(with_drops):
    config = dict(BASE, **DEVICE)
    fabric = NodeFabric()
    system = ActorSystem(None, name="procA", config=config, fabric=fabric)
    child_b = child_c = None
    try:
        probe = TestProbe(default_timeout_s=30.0)
        probe_cell = system.spawn_system_raw(ProbeForwarder(probe), "probe-fwd")
        fabric.register_name("probe", probe_cell)
        fabric.listen()
        child_c = child({"role": "holder", "address": "procC",
                         "config": DEVICE})
        child_b = child({"role": "owner", "address": "procB", "config": DEVICE,
                         "with_drops": with_drops, "probe": True})
        # full mesh: A dials both children; B dials C
        fabric.connect("127.0.0.1", child_b.port)
        fabric.connect("127.0.0.1", child_c.port)
        child_b.ask(f"connect 127.0.0.1:{child_c.port}", "CONNECTED")
        child_b.ask("spawn_owner procC procA", "OWNER_SPAWNED")
        spawned = probe.expect_message_type(Spawned)
        child_b.ask("share", "SHARED")  # the only surviving ref goes to C
        time.sleep(0.5)
        child_b.ask("drop", "DROPPED")  # only C's ref keeps the worker
        probe.expect_no_message(0.5)
        # C vanishes mid-protocol: the survivors see the dead socket,
        # finalize the dead links, reach quorum, fold the undo log.
        child_c.kill9()
        stopped = probe.expect_message_type(Stopped)
        assert stopped.name == spawned.name
    finally:
        for c in (child_b, child_c):
            if c is not None:
                c.shutdown()
        system.terminate()


class SpawningRoot(AbstractBehavior):
    """Managed root on the driver: spawns a worker in the child process
    through its RemoteSpawner, pings it, releases on command."""

    def __init__(self, ctx, spawner_proxy):
        super().__init__(ctx)
        self.spawner = spawner_proxy
        self.remote_worker = None

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Ping):  # the "go" trigger
            self.remote_worker = ctx.spawn_remote("worker", self.spawner)
            for _ in range(3):
                self.remote_worker.tell(Ping(), ctx)
        elif isinstance(msg, DropCmd):
            ctx.release(self.remote_worker)
        return self


def test_multiprocess_remote_spawn_and_collect():
    """The blocking spawn ask crosses the socket as a wire frame and the
    reply returns the spawned cell's token; releasing the only ref on
    the driver collects the worker in the child process."""
    config = dict(BASE, **DEVICE, **{"uigc.crgc.num-nodes": 2})
    fabric = NodeFabric()
    system = ActorSystem(None, name="procA", config=config, fabric=fabric)
    child_b = None
    try:
        probe = TestProbe(default_timeout_s=30.0)
        probe_cell = system.spawn_system_raw(ProbeForwarder(probe), "probe-fwd")
        fabric.register_name("probe", probe_cell)
        fabric.listen()
        child_b = child({"role": "spawner", "address": "procB",
                         "config": dict(DEVICE, **{"uigc.crgc.num-nodes": 2})})
        fabric.connect("127.0.0.1", child_b.port)
        spawner = fabric.lookup("uigc://procB", "spawner")
        root = system.spawn_root(Behaviors.setup_root(
            lambda ctx: SpawningRoot(ctx, spawner)), "root")
        root.tell(Ping())
        spawned = probe.expect_message_type(Spawned)
        assert spawned.name.startswith("/system/RemoteSpawner/remote-")
        time.sleep(0.4)
        root.tell(DropCmd())  # the driver releases the only ref
        stopped = probe.expect_message_type(Stopped)
        assert stopped.name == spawned.name
    finally:
        if child_b is not None:
            child_b.shutdown()
        system.terminate()


def count(node):
    """(workers spawned, workers stopped) on ``node``."""
    spawned, stopped = node.ask("count", "COUNT").split()[1:]
    return int(spawned), int(stopped)


def test_config4_silent_death_across_processes():
    """Config 4 at 200 workers with the heartbeat on, shm rings and C
    stopped rather than killed: only the phi-accrual verdict can end C's
    membership.  No worker stops while C lives; every one after; A's and
    B's collectors each took C down by the heartbeat."""
    n = 200
    config = dict(DEVICE, **{
        "uigc.node.heartbeat-interval": 50,
        "uigc.node.heartbeat-pause": 500,
        "uigc.node.shm-transport": True,
    })
    links = nodeproc.LinkTally().attach()
    fabric = NodeFabric()
    system = ActorSystem(None, name="procA", config=dict(BASE, **config),
                         fabric=fabric)
    child_b = child_c = None
    try:
        fabric.listen()
        child_c = child({"role": "holder", "address": "procC",
                         "config": config})
        child_b = child({"role": "owner", "address": "procB",
                         "config": config, "with_drops": True,
                         "n_workers": n})
        fabric.connect("127.0.0.1", child_b.port)
        fabric.connect("127.0.0.1", child_c.port)
        child_b.ask(f"connect 127.0.0.1:{child_c.port}", "CONNECTED")
        child_b.ask("spawn_owner procC procA", "OWNER_SPAWNED")
        child_b.ask("share", "SHARED")
        deadline = time.monotonic() + 30
        while int(child_c.ask("held", "HELD").split()[1]) < n:
            assert time.monotonic() < deadline, "the hand-off timed out"
            time.sleep(0.05)
        child_b.ask("drop", "DROPPED")
        time.sleep(1.0)  # many collector wakes: C's refs hold every worker
        assert count(child_b) == (n, 0)
        child_c.signal(signal.SIGSTOP)
        deadline = time.monotonic() + 20
        while count(child_b) != (n, n):
            assert time.monotonic() < deadline, count(child_b)
            time.sleep(0.05)
        stats_b = child_b.stats()
        stats_a = nodeproc.node_stats(system, fabric, links)
        for stats in (stats_a, stats_b):
            assert stats["down"] == {"uigc://procC": "heartbeat"}, stats
            assert stats["downed"] == ["uigc://procC"]
            assert stats["roots_alive"]
        assert stats_a["shm"]["uigc://procB"] and stats_b["shm"]["uigc://procA"]
        assert stats_a["frames"]["uigc://procB"][0] > 0
    finally:
        links.detach()
        events.recorder.disable()
        events.recorder.reset()
        if child_c is not None:
            child_c.kill9()
        if child_b is not None:
            child_b.shutdown()
        system.terminate()
