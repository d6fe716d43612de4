"""Copy of ``uigc_tpu/runtime/system.py`` (pure Python).  What differs
from the reference: an engine or backend the port cannot build raises
after the dispatcher and timers are stopped, so a refused system leaves
nothing running; and a spawned cell resolves by uid (``resolve_cell``)
while its setup runs, not only once it is registered.  A setup that
spawns many children flushes entries naming its cell before
``register_cell``, and a serialized fabric decodes the delta graph that
carries them (``runtime/fabric.py`` says what the reference does then).

The actor system: spawning, guardians, engine extension, shutdown.

Mirrors the reference's ``uigc.ActorSystem`` + ``UIGC`` extension factory
(reference: ActorSystem.scala:13-27, UIGC.scala:12-19): the engine is a
per-system singleton chosen by ``uigc.engine`` config, and the guardian is
bootstrapped with root spawn info.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Dict, Mapping, Optional

from ..config import Config
from ..utils import events
from .behaviors import ActorFactory, RawBehavior
from .cell import ActorCell
from .context import ActorContext
from .dispatcher import Dispatcher, PinnedDispatcher, TimerService


class RawRef:
    """External (unmanaged) handle to an actor — what ``testKit.spawn``
    returns in the reference tests.  Sends raw payloads; at a root actor
    they get wrapped by the engine's root adapter."""

    __slots__ = ("cell",)

    def __init__(self, cell: ActorCell):
        self.cell = cell

    def tell(self, msg: Any) -> None:
        self.cell.tell(msg)

    @property
    def path(self) -> str:
        return self.cell.path

    @property
    def is_terminated(self) -> bool:
        return self.cell.is_terminated

    def __repr__(self) -> str:
        return f"RawRef({self.cell.path})"


class _GuardianBehavior(RawBehavior):
    def on_message(self, msg: Any) -> Any:
        return None


class ActorSystem:
    """A single node's actor system."""

    def __init__(
        self,
        guardian: Optional[ActorFactory] = None,
        name: str = "uigc",
        config: Optional[Mapping[str, Any]] = None,
        address: Optional[str] = None,
        fabric: Optional[Any] = None,
    ):
        self.name = name
        self.config = config if isinstance(config, Config) else Config(config)
        self.address = address or f"uigc://{name}"
        #: Multi-node fabric this system is attached to (None = single node).
        self.fabric = fabric
        self._uid_counter = itertools.count(1)
        self._uid_lock = threading.Lock()
        self.throughput = self.config.get_int("uigc.runtime.throughput")
        #: bounded-mailbox defaults every cell copies at construction
        #: (uigc_tpu/runtime/cell.py admission; 0 = unbounded legacy)
        self.mailbox_limit = self.config.get_int("uigc.runtime.mailbox-limit")
        self.overflow_policy = self.config.get_string(
            "uigc.runtime.overflow-policy"
        )
        self.mailbox_block_s = (
            self.config.get_int("uigc.runtime.mailbox-block-ms") / 1000.0
        )
        #: emit ``sched.*`` scheduling events from the cell layer (for
        #: the race detector, analysis/race.py); read by every cell on
        #: its hot path, so it is a plain attribute, not a config lookup.
        self.sched_events = self.config.get_bool("uigc.analysis.sched-events")
        self.dispatcher = Dispatcher(
            self.config.get_int("uigc.runtime.num-workers"),
            name=f"{name}-dispatcher",
            origin=self.address,
        )
        self.timers = TimerService(name=f"{name}-timers", origin=self.address)
        self._pinned: list = []
        self._cells: Dict[int, ActorCell] = {}
        # Weak uid -> cell map covering stopped actors too: the wire
        # codec must resolve refs to actors that have already terminated
        # (their tell() dead-letters, like Akka's resolve of a dead path).
        self._cells_ever = weakref.WeakValueDictionary()
        self._cells_lock = threading.Lock()
        self.dead_letters = 0
        self._terminated = threading.Event()
        #: Telemetry subsystem (uigc_tpu_torch/telemetry), attached below
        #: when any ``uigc.telemetry.*`` key is on.  Declared BEFORE the
        #: guardians/engine exist: dispatcher threads read this
        #: attribute as soon as the first cell processes a message.
        self.telemetry: Optional[Any] = None
        #: Cluster-sharding subsystem (uigc_tpu/cluster), attached via
        #: ``ClusterSharding.attach(system)`` — API-driven (it needs
        #: entity factories), unlike the config-driven attachments.
        self.cluster: Optional[Any] = None

        # Top-level guardians (raw).
        self._system_guardian = self._make_raw_cell("system", None)
        self._user_guardian = self._make_raw_cell("user", None)

        # Engine extension: one per system, chosen by config
        # (reference: UIGC.scala:12-19).  An engine or backend the port
        # cannot build raises here; the threads started above are stopped
        # first, so a refused system leaves nothing running.
        from ..engines import create_engine

        try:
            self.engine = create_engine(self)
        except BaseException:
            self._stop_machinery()
            raise

        #: Online sanitizer (uigcsan), attached on request — it wraps
        #: the engine's hooks and collector graph with an independent
        #: oracle and cross-checks every collection cycle.
        self.sanitizer: Optional[Any] = None
        if self.config.get_bool("uigc.analysis.sanitizer"):
            from ..analysis import Sanitizer

            self.sanitizer = Sanitizer.attach(self)

        # Telemetry attach: metrics registry + exporters, causal tracer,
        # collector wake profiler.  The runtime's hot paths read
        # ``system.telemetry`` directly (None = zero overhead).  Inline
        # key check so the package (http.server etc.) is only imported
        # when some telemetry is actually switched on.
        if (
            self.config.get_bool("uigc.telemetry.metrics")
            or self.config.get_bool("uigc.telemetry.tracing")
            or self.config.get_bool("uigc.telemetry.wake-profile")
            or self.config.get_bool("uigc.telemetry.inspect")
            or self.config.get_bool("uigc.telemetry.timeseries")
            or self.config.get_bool("uigc.telemetry.device")
            or self.config.get_int("uigc.telemetry.http-port") >= 0
            or bool(self.config.get_string("uigc.telemetry.jsonl-path"))
        ):
            from ..telemetry import Telemetry

            self.telemetry = Telemetry.attach(self)

        if fabric is not None:
            fabric.register_system(self)

        # User guardian actor, bootstrapped with root spawn info
        # (reference: ActorSystem.scala:24-27).
        self.guardian_ref: Optional[RawRef] = None
        if guardian is not None:
            cell = self.spawn_cell(
                guardian, "guardian", self._user_guardian, self.engine.root_spawn_info()
            )
            self.guardian_ref = RawRef(cell)

    # --------------------------------------------------------------- #
    # Spawning
    # --------------------------------------------------------------- #

    def spawn_cell(
        self,
        factory: ActorFactory,
        name: str,
        parent: ActorCell,
        spawn_info: Any,
    ) -> ActorCell:
        """Create and start a managed actor cell. The behavior's
        constructor runs synchronously; no message is processed before it
        returns."""
        cell = ActorCell(
            self, name, parent, is_root=factory.is_root, is_managed=True
        )
        if name in parent.children:
            raise ValueError(f"duplicate actor name {name!r} under {parent.path}")
        parent.children[name] = cell
        if self.sched_events and events.recorder.enabled:
            events.recorder.commit(
                events.SCHED_SPAWN,
                cell=cell.uid,
                path=cell.path,
                parent=parent.uid,
                thread=threading.get_ident(),
            )
        ctx = ActorContext(cell, spawn_info)
        cell.context = ctx
        # Resolvable while its setup runs: the entries a setup flushes
        # name this cell, and a wire decode of them must find it.
        with self._cells_lock:
            self._cells_ever[cell.uid] = cell
        cell.behavior = factory.setup_fn(ctx)
        self.register_cell(cell)
        cell.start()
        return cell

    def spawn_root(self, factory: ActorFactory, name: str) -> RawRef:
        """Spawn a top-level root actor (what ``testKit.spawn`` does in the
        reference tests).  ``factory`` must come from
        ``Behaviors.setup_root`` (or ``with_timers`` around it)."""
        if not factory.is_root:
            raise ValueError("spawn_root requires a Behaviors.setup_root factory")
        cell = self.spawn_cell(
            factory, name, self._user_guardian, self.engine.root_spawn_info()
        )
        return RawRef(cell)

    def spawn_system_raw(
        self, behavior: RawBehavior, name: str, pinned: bool = False
    ) -> ActorCell:
        """Spawn an unmanaged system actor (the Bookkeeper/CycleDetector
        path; reference: CRGC.scala:54-58 uses a pinned dispatcher)."""
        dispatcher = None
        if pinned:
            dispatcher = PinnedDispatcher(
                f"{self.name}-{name}-pinned", origin=self.address
            )
            self._pinned.append(dispatcher)
        cell = ActorCell(
            self,
            name,
            self._system_guardian,
            is_root=False,
            is_managed=False,
            dispatcher=dispatcher,
        )
        self._system_guardian.children[name] = cell
        cell.behavior = behavior
        if hasattr(behavior, "bind"):
            behavior.bind(cell)
        self.register_cell(cell)
        cell.start()
        return cell

    def _make_raw_cell(self, name: str, parent: Optional[ActorCell]) -> ActorCell:
        cell = ActorCell(self, name, parent, is_managed=False)
        cell.behavior = _GuardianBehavior()
        self.register_cell(cell)
        cell.start()
        return cell

    # --------------------------------------------------------------- #
    # Registry / bookkeeping
    # --------------------------------------------------------------- #

    def allocate_uid(self) -> int:
        with self._uid_lock:
            return next(self._uid_counter)

    def register_cell(self, cell: ActorCell) -> None:
        with self._cells_lock:
            self._cells[cell.uid] = cell
            self._cells_ever[cell.uid] = cell

    def unregister_cell(self, cell: ActorCell) -> None:
        with self._cells_lock:
            self._cells.pop(cell.uid, None)

    def resolve_cell(self, uid: int):
        """Resolve a wire uid to its cell (live or stopped-but-reachable);
        None when the cell is truly gone."""
        with self._cells_lock:
            cell = self._cells.get(uid)
            if cell is None:
                cell = self._cells_ever.get(uid)
            return cell

    def record_dead_letter(self, cell: ActorCell, msg: Any) -> None:
        """Route one undeliverable message through the engine's
        dead-letter accounting.  ``cell`` may be a live-but-terminated
        ActorCell or a remote/tombstone proxy (runtime/node.py routes
        post-mortem frames here keyed by the uid's cached proxy)."""
        self.dead_letters += 1
        events.recorder.commit(
            events.DEAD_LETTER,
            address=self.address,
            path=getattr(cell, "path", "?"),
        )
        engine = getattr(self, "engine", None)
        if engine is not None:
            engine.on_dead_letter(cell, msg)

    def record_dead_letters_dropped(self, cell: ActorCell, count: int) -> None:
        """Count messages that were dropped without individual
        accounting (e.g. a stopping actor draining its own mailbox —
        the engine already folded their effects in bulk)."""
        self.dead_letters += count

    @property
    def live_actor_count(self) -> int:
        with self._cells_lock:
            return len(self._cells)

    # --------------------------------------------------------------- #
    # Shutdown
    # --------------------------------------------------------------- #

    def terminate(self, timeout_s: float = 10.0) -> None:
        """Stop the user guardian tree, then system actors, then the
        machinery."""
        import time

        if self.cluster is not None:
            # Stop cluster timers/handlers before the guardian teardown
            # so no rebalance or passivation races the entity stops.
            self.cluster.close()
        self._user_guardian.stop()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not self._user_guardian.is_terminated:
            time.sleep(0.005)
        if hasattr(self.engine, "shutdown"):
            self.engine.shutdown()
        self._system_guardian.stop()
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and not self._system_guardian.is_terminated:
            time.sleep(0.005)
        self._stop_machinery()
        if self.fabric is not None:
            self.fabric.unregister_system(self)
        if self.telemetry is not None:
            self.telemetry.close()
        self._terminated.set()

    def _stop_machinery(self) -> None:
        self.timers.shutdown()
        for pinned in self._pinned:
            pinned.shutdown()
        self.dispatcher.shutdown()

    def when_terminated(self, timeout_s: Optional[float] = None) -> bool:
        return self._terminated.wait(timeout_s)
