"""Process roles for a cluster of port nodes: one ``ActorSystem`` on a
``NodeFabric`` (``runtime/node.py``) per OS process, driven over pipes.

The port's counterpart of the reference's ``tests/nodeproc_common.py``
and ``tests/nodeproc_child.py``, plus BASELINE config 4 across
processes: ``run_cluster_recovery``'s roles with node B owning
``n_workers`` workers, each pinned only by a ref that node C holds.

Every process must resolve a pickled application message to the same
class, so the roles live here, under one module name, and a child runs
``python -m uigc_tpu_torch.models.nodeproc '<spec json>'`` (which calls
``main`` of this module imported by name) or any entry point that calls
``run_child``.  A child prints ``READY <port>`` once it listens, then
follows one command per line on stdin and answers on stdout:

- ``connect host:port`` -> ``CONNECTED <peer>``
- ``spawn_owner <holder node> <probe node>`` -> ``OWNER_SPAWNED``
  (node B: the owner and its workers; the holder and the probe are
  looked up by name on the peers)
- ``share`` -> ``SHARED``, ``drop`` -> ``DROPPED`` (node B)
- ``held`` -> ``HELD <n>`` (node C), ``count`` -> ``COUNT <spawned>
  <stopped>`` (node B)
- ``stats`` -> ``STATS {json}``: the collector's wakes, the membership,
  frames and bytes sent per peer, the peers declared down and why, the
  shm links, whether the roots run, and what the ``stats`` hook of
  ``run_child`` adds
- ``exit``

A spec is ``{"role": "holder" | "owner" | "spawner", "address": name,
"config": {...}, "n_workers": n, "with_drops": bool, "probe": bool}``.
With ``probe`` the workers report ``Spawned`` and ``Stopped`` to the
driver's probe (the reference's one-worker shape); B counts them either
way.  With ``with_drops`` node B drops every ``Ping`` that arrives from
the holder's node, as ``run_cluster_recovery`` does.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from queue import Empty, Queue
from typing import Any, Callable, Dict, List, Optional

from ..interfaces import Message, NoRefs
from ..runtime.behaviors import AbstractBehavior, Behaviors, RawBehavior
from ..runtime.signals import PostStop
from ..runtime.system import ActorSystem
from ..utils import events
from .workloads import _roots_alive

BASE = {
    "uigc.crgc.wakeup-interval": 10,
    "uigc.crgc.egress-finalize-interval": 5,
    "uigc.crgc.num-nodes": 3,
}


class Ping(NoRefs):
    pass


class Share(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,) if self.ref is not None else ()


class DropCmd(NoRefs):
    pass


class Spawned(NoRefs):
    def __init__(self, name):
        self.name = name


class Stopped(NoRefs):
    def __init__(self, name):
        self.name = name


class Tally:
    """This process's counts of workers spawned and stopped and refs
    held."""

    def __init__(self):
        self.spawned = 0
        self.stopped = 0
        self.held = 0
        self._lock = threading.Lock()

    def add(self, what: str) -> None:
        with self._lock:
            setattr(self, what, getattr(self, what) + 1)


TALLY = Tally()


class RemoteProbe:
    """Probe facade whose ``.ref`` is a ProxyCell of the driver's probe
    forwarder cell."""

    def __init__(self, cell):
        self.ref = cell


class Worker(AbstractBehavior):
    def __init__(self, context, probe=None):
        super().__init__(context)
        self.probe = probe
        TALLY.add("spawned")
        if probe is not None:
            probe.ref.tell(Spawned(context.name))

    def on_message(self, msg):
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            TALLY.add("stopped")
            if self.probe is not None:
                self.probe.ref.tell(Stopped(self.context.name))
        return None


class Holder(AbstractBehavior):
    """Root on the doomed node, holding the only refs to remote
    workers; it pings each worker it is handed, so dropped pings skew
    the admitted counts on the doomed link."""

    def __init__(self, context):
        super().__init__(context)
        self.held: List[Any] = []

    def on_message(self, msg):
        if isinstance(msg, Share):
            self.held.append(msg.ref)
            msg.ref.tell(Ping(), self.context)
            TALLY.add("held")
        return self


class Owner(AbstractBehavior):
    """Root on node B owning ``n`` workers: hands a ref to each to the
    doomed node's holder, then releases its own."""

    def __init__(self, context, probe, holder_ref, n: int = 1):
        super().__init__(context)

        def setup(ctx):
            return Worker(ctx, probe)

        names = ["worker"] if n == 1 else [f"w{i}" for i in range(n)]
        self.workers = [context.spawn(Behaviors.setup(setup), name)
                        for name in names]
        self.holder_ref = holder_ref

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Share):
            for w in self.workers:
                self.holder_ref.tell(Share(ctx.create_ref(w, self.holder_ref)),
                                     ctx)
        elif isinstance(msg, DropCmd):
            ctx.release(*self.workers)
            self.workers = []
        return self


class ProbeForwarder(RawBehavior):
    """Unmanaged cell on the driver node that funnels raw cross-process
    messages into an in-process ``TestProbe``."""

    def __init__(self, probe):
        self.probe = probe

    def on_message(self, msg):
        self.probe._offer(msg)
        return None


class LinkTally:
    """Frames and bytes this node flushed to each peer (the writer's
    ``FRAME_BATCH`` events) and its peers' death verdicts
    (``NODE_DOWN``).  Turns the event recorder on while it is
    attached."""

    def __init__(self):
        self.frames: Dict[str, List[int]] = {}
        self.down: Dict[str, str] = {}
        self._lock = threading.Lock()

    def __call__(self, name, fields):
        if name == events.FRAME_BATCH:
            with self._lock:
                cell = self.frames.setdefault(str(fields.get("dst")), [0, 0])
                cell[0] += int(fields.get("size", 0))
                cell[1] += int(fields.get("bytes", 0))
        elif name == events.NODE_DOWN:
            with self._lock:
                self.down[str(fields.get("address"))] = str(
                    fields.get("reason"))

    def attach(self) -> "LinkTally":
        events.recorder.enable()
        events.recorder.add_listener(self)
        return self

    def detach(self) -> None:
        events.recorder.remove_listener(self)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"frames": {k: list(v) for k, v in self.frames.items()},
                    "down": dict(self.down)}


def node_stats(system: ActorSystem, fabric, links: LinkTally) -> Dict[str, Any]:
    """One node's side of a run: the collector's wakes, membership, the
    per-peer frames and death verdicts, the shm links, its roots."""
    bk = getattr(system.engine, "bookkeeper", None)
    peers = sorted(set(fabric._peers))
    out = {
        "address": system.address,
        "wakes": getattr(bk, "wakes", None),
        "members": fabric.members(),
        "downed": sorted(getattr(bk, "downed_gcs", ())),
        "shm": {p: fabric.shm_active(p) for p in peers},
        "roots_alive": _roots_alive(system),
        "spawned": TALLY.spawned,
        "stopped": TALLY.stopped,
        "held": TALLY.held,
    }
    out.update(links.snapshot())
    return out


def _say(line: str) -> None:
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _lookup(fabric, address: str, name: str, timeout_s: float = 30.0):
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return fabric.lookup(address, name)
        except KeyError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def run_child(spec: Dict[str, Any],
              stats: Optional[Callable[[], Dict[str, Any]]] = None) -> None:
    """Child process main: build the node, listen, then follow stdin
    commands from the driver (module note).  ``stats`` adds its dict to
    every ``STATS`` answer.  Exits the process at ``exit`` or EOF."""
    from ..runtime.node import NodeFabric
    from ..runtime.remote import RemoteSpawner

    role = spec["role"]
    address = spec["address"]
    config = dict(BASE)
    config.update(spec.get("config", {}))
    links = LinkTally().attach()
    fabric = NodeFabric()
    system = ActorSystem(None, name=address, config=config, fabric=fabric)
    owner = None
    if role == "holder":
        holder = system.spawn_root(Behaviors.setup_root(Holder), "holder")
        fabric.register_name("holder", holder.cell)
    elif role == "spawner":
        probe_addr = f"uigc://{spec.get('probe_node', 'procA')}"

        def worker_setup(ctx):
            # the probe is looked up at spawn time: the driver's hello,
            # which carries the name, has arrived by then
            return Worker(ctx, RemoteProbe(fabric.lookup(probe_addr, "probe")))

        spawner = RemoteSpawner.spawn_service(
            system, {"worker": Behaviors.setup(worker_setup)})
        fabric.register_name("spawner", spawner)
    port = fabric.listen()
    _say(f"READY {port}")

    for raw in sys.stdin:
        parts = raw.strip().split()
        if not parts:
            continue
        cmd = parts[0]
        try:
            if cmd == "connect":
                host, p = parts[1].rsplit(":", 1)
                _say(f"CONNECTED {fabric.connect(host, int(p))}")
            elif cmd == "spawn_owner":
                holder_addr = f"uigc://{parts[1]}"
                holder = _lookup(fabric, holder_addr, "holder")
                probe = None
                if spec.get("probe"):
                    probe = RemoteProbe(
                        _lookup(fabric, f"uigc://{parts[2]}", "probe"))
                if spec.get("with_drops"):
                    fabric.set_inbound_drop_filter(
                        holder_addr,
                        lambda m: isinstance(getattr(m, "payload", None),
                                             Ping))
                n = int(spec.get("n_workers", 1))

                def make_owner(ctx):
                    return Owner(ctx, probe, ctx.engine.to_root_refob(holder),
                                 n)

                owner = system.spawn_root(Behaviors.setup_root(make_owner),
                                          "owner")
                _say("OWNER_SPAWNED")
            elif cmd == "share":
                owner.tell(Share(None))
                _say("SHARED")
            elif cmd == "drop":
                owner.tell(DropCmd())
                _say("DROPPED")
            elif cmd == "held":
                _say(f"HELD {TALLY.held}")
            elif cmd == "count":
                _say(f"COUNT {TALLY.spawned} {TALLY.stopped}")
            elif cmd == "stats":
                out = node_stats(system, fabric, links)
                if stats is not None:
                    out.update(stats())
                _say("STATS " + json.dumps(out, sort_keys=True))
            elif cmd == "exit":
                break
        except Exception as exc:  # the driver reads it and fails the run
            _say(f"ERROR {cmd}: {type(exc).__name__}: {exc}")
    sys.stdout.flush()
    os._exit(0)


class Child:
    """The driver's handle on one node child process: line-based
    commands on its stdin, answers read from its stdout."""

    def __init__(self, spec: Dict[str, Any], argv: Optional[List[str]] = None,
                 cwd: Optional[str] = None, wait: bool = True):
        argv = argv or [sys.executable, "-m", "uigc_tpu_torch.models.nodeproc"]
        self.spec = spec
        self.proc = subprocess.Popen(
            argv + [json.dumps(spec)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            bufsize=1, cwd=cwd)
        self._lines: Queue = Queue()
        self._err: List[str] = []
        threading.Thread(target=self._pump, daemon=True).start()
        threading.Thread(target=self._pump_err, daemon=True).start()
        self.port: Optional[int] = None
        if wait:
            self.wait_ready()

    def wait_ready(self, timeout_s: float = 120.0) -> int:
        """Wait for ``READY <port>``; several children can start at once
        and be waited for in turn."""
        if self.port is None:
            self.port = int(self.expect("READY", timeout_s).split()[1])
        return self.port

    def _pump(self):
        for line in self.proc.stdout:
            self._lines.put(line.strip())
        self._lines.put(None)

    def _pump_err(self):
        for line in self.proc.stderr:
            self._err.append(line)
            del self._err[:-200]

    def stderr_tail(self) -> str:
        return "".join(self._err[-40:])

    def send(self, cmd: str) -> None:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()

    def expect(self, prefix: str, timeout_s: float = 30.0) -> str:
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise AssertionError(
                    f"node {self.spec.get('address')} did not print "
                    f"{prefix!r} in {timeout_s} s; stderr:\n"
                    + self.stderr_tail())
            try:
                line = self._lines.get(timeout=remaining)
            except Empty:
                continue
            if line is None:
                self._lines.put(None)
                raise AssertionError(
                    f"node {self.spec.get('address')} exited (rc "
                    f"{self.proc.wait()}) before {prefix!r}; stderr:\n"
                    + self.stderr_tail())
            if line.startswith(prefix):
                return line
            if line.startswith("ERROR"):
                raise AssertionError(
                    f"node {self.spec.get('address')}: {line}")

    def ask(self, cmd: str, prefix: str, timeout_s: float = 30.0) -> str:
        self.send(cmd)
        return self.expect(prefix, timeout_s)

    def stats(self, timeout_s: float = 30.0) -> Dict[str, Any]:
        line = self.ask("stats", "STATS", timeout_s)
        return json.loads(line[len("STATS "):])

    def signal(self, sig: int) -> None:
        os.kill(self.proc.pid, sig)

    def kill9(self) -> None:
        if self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=10)

    def shutdown(self) -> None:
        """Ask the child to exit; kill it if it does not within 5 s (a
        stopped child is killed at once)."""
        if self.proc.poll() is None:
            try:
                self.send("exit")
                self.proc.wait(timeout=5)
            except Exception:
                self.proc.kill()
                self.proc.wait(timeout=5)


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    run_child(json.loads(argv[0]))


if __name__ == "__main__":
    # Run the roles under this module's package name, not as __main__:
    # a pickled message must resolve to the same class in every process.
    from uigc_tpu_torch.models import nodeproc

    nodeproc.main()
