"""Copy of ``uigc_tpu/engines/crgc/engine.py`` (pure Python).  The backend
table keeps its names: "oracle", "array", "device", "decremental",
"native", "mesh" and "mesh-decremental" are built (the device and mesh
backends on ``uigc.crgc.device``, the mesh over ``uigc.crgc.mesh-devices``
shards); ``uigc.crgc.distributed`` builds the partitioned collector
(``distributed.py``) as in the reference.

The CRGC engine: conflict-replicated garbage collection.

Mirrors the reference's default engine (reference: crgc/CRGC.scala:16-242):
every managed actor continuously records local facts into a bounded
``CrgcState``; snapshots flush through a shared queue to the per-node
Bookkeeper; capacity or saturation forces early flushes.  Detection
requires no message ordering and tolerates drops and downed nodes.
"""

from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Dict, Iterable, Optional

from ...interfaces import GCMessage, Refob, SpawnInfo
from ...runtime.signals import _PostStop
from ...utils import events
from ..engine import Engine, TerminationDecision
from .collector import Bookkeeper
from .messages import AppMsg, StopMsg, WaveMsg, _StopMsg, _WaveMsg
from .refob import CrgcRefob
from .state import CrgcContext, CrgcState, Entry

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell
    from ...runtime.context import ActorContext
    from ...runtime.system import ActorSystem


class CrgcSpawnInfo(SpawnInfo):
    """(reference: CRGC.scala:22-24)"""

    __slots__ = ("creator",)

    def __init__(self, creator: Optional[CrgcRefob]):
        self.creator = creator


class CRGC(Engine):
    """(reference: crgc/CRGC.scala:34-242)"""

    def __init__(self, system: "ActorSystem"):
        super().__init__(system)
        config = system.config
        self.collection_style: str = config.get_string("uigc.crgc.collection-style")
        if self.collection_style not in ("on-idle", "on-block", "wave"):
            raise ValueError(f"bad collection-style {self.collection_style!r}")
        self.crgc_context = CrgcContext(
            delta_graph_size=config.get_int("uigc.crgc.delta-graph-size"),
            entry_field_size=config.get_int("uigc.crgc.entry-field-size"),
        )
        self.num_nodes = config.get_int("uigc.crgc.num-nodes")
        self.wakeup_interval_ms = config.get_int("uigc.crgc.wakeup-interval")
        self.wave_frequency_ms = config.get_int("uigc.crgc.wave-frequency")
        self.egress_finalize_interval_ms = config.get_int(
            "uigc.crgc.egress-finalize-interval"
        )
        self.shadow_graph_impl = config.get_string("uigc.crgc.shadow-graph")
        self.pipelined = config.get_bool("uigc.crgc.pipelined")
        # Distributed (partitioned) collection: each node owns only its
        # shadow-graph slice and cross-node cycles resolve via the
        # dmark wave protocol (engines/crgc/distributed.py).  Only
        # meaningful multi-node; single-node configs fall back to the
        # local collector so one config can serve both shapes.
        self.distributed = (
            config.get_bool("uigc.crgc.distributed") and self.num_nodes > 1
        )
        #: per-address incarnation era as THIS node counts it: bumped
        #: when a downed address rejoins, read by the ingress gateways
        #: so a rejoined incarnation's windows key as (peer, fence) and
        #: never merge with its pre-death stream (gateways.py)
        self._link_fences: Dict[str, int] = {}

        # Mutator->collector channel + entry free list.  CPython deque
        # append/popleft are atomic, giving the lock-free MPSC hand-off the
        # reference gets from ConcurrentLinkedQueue (CRGC.scala:18,52).
        self.queue: deque = deque()
        self.entry_pool: deque = deque()
        self.packed_plane = None

        self.bookkeeper = self.make_bookkeeper()
        self.bookkeeper_cell = system.spawn_system_raw(
            self.bookkeeper, "Bookkeeper", pinned=True
        )

        # Packed entry plane (packed.py): the single-node hot path.
        # Gated off when a fabric is attached — the multi-node fold
        # additionally builds delta graphs from object entries — and for
        # backends without the array fold (the oracle, the native graph).
        graph = self.bookkeeper.shadow_graph
        if (
            config.get_bool("uigc.crgc.packed-entries")
            and system.fabric is None
            and hasattr(graph, "merge_packed")
        ):
            from .packed import PackedPlane

            self.packed_plane = PackedPlane(self.crgc_context.entry_field_size)
            graph.attach_packed_plane(self.packed_plane, system.resolve_cell)

    # Factory hooks so the multi-node engine can substitute richer parts.

    def make_bookkeeper(self) -> Bookkeeper:
        if self.distributed:
            from .distributed import DistributedBookkeeper

            return DistributedBookkeeper(self)
        return Bookkeeper(self)

    def make_shadow_graph(self) -> Any:
        if self.distributed:
            # The partitioned plane: authoritative state only for the
            # owned slice, mirrors for boundary endpoints.  The local
            # fixpoint runs the pointer plane; the device backends keep
            # sharding *within* the node (mesh) and plug in behind the
            # same dmark interface as a follow-on.
            from .distributed import PartitionedShadowGraph

            return PartitionedShadowGraph(self.crgc_context, self.system.address)
        if self.shadow_graph_impl == "oracle":
            from .shadow import ShadowGraph

            return ShadowGraph(self.crgc_context, self.system.address)
        elif self.shadow_graph_impl in ("array", "device", "decremental"):
            from .arrays import ArrayShadowGraph

            return ArrayShadowGraph(
                self.crgc_context,
                self.system.address,
                use_device=(self.shadow_graph_impl in ("device", "decremental")),
                decremental=(self.shadow_graph_impl == "decremental"),
                trace_mode=self.system.config.get_string("uigc.crgc.trace-mode"),
                pull_density=self.system.config.get_float(
                    "uigc.crgc.pull-density"
                ),
                device=self.system.config.get_string("uigc.crgc.device"),
            )
        elif self.shadow_graph_impl == "native":
            from ...native import NativeShadowGraph

            return NativeShadowGraph(self.crgc_context, self.system.address)
        elif self.shadow_graph_impl in ("mesh", "mesh-decremental"):
            from .mesh import MeshShadowGraph

            config = self.system.config
            return MeshShadowGraph(
                self.crgc_context,
                self.system.address,
                n_devices=config.get_int("uigc.crgc.mesh-devices"),
                decremental=(self.shadow_graph_impl == "mesh-decremental"),
                trace_mode=config.get_string("uigc.crgc.trace-mode"),
                pull_density=config.get_float("uigc.crgc.pull-density"),
                device=config.get_string("uigc.crgc.device"),
            )
        raise ValueError(f"bad shadow-graph impl {self.shadow_graph_impl!r}")

    # ----------------------------------------------------------------- #
    # Root support
    # ----------------------------------------------------------------- #

    def root_message(self, payload: Any, refs: Iterable[Refob]) -> GCMessage:
        return AppMsg(payload, refs, external=True)

    def root_spawn_info(self) -> SpawnInfo:
        return CrgcSpawnInfo(creator=None)

    def to_root_refob(self, cell: "ActorCell") -> Refob:
        return CrgcRefob(cell)

    # ----------------------------------------------------------------- #
    # Lifecycle
    # ----------------------------------------------------------------- #

    def init_state(self, cell: "ActorCell", spawn_info: CrgcSpawnInfo) -> CrgcState:
        """(reference: CRGC.scala:69-92)"""
        self_refob = CrgcRefob(cell)
        state = CrgcState(self_refob, self.crgc_context)
        state.record_new_refob(self_refob, self_refob)
        if spawn_info.creator is not None:
            state.record_new_refob(spawn_info.creator, self_refob)
        else:
            state.mark_as_root()

        if self.collection_style == "on-block":
            cell.on_finished_processing = lambda: self.send_entry(state, is_busy=False)
        if (self.collection_style == "wave" and state.is_root) or (
            self.collection_style == "on-idle"
        ):
            self.send_entry(state, is_busy=False)
        return state

    def get_self_ref(self, state: CrgcState, cell: "ActorCell") -> Refob:
        return state.self_ref

    def spawn(
        self,
        factory: Callable[[SpawnInfo], "ActorCell"],
        state: CrgcState,
        ctx: "ActorContext",
    ) -> Refob:
        """(reference: CRGC.scala:100-112)"""
        child = factory(CrgcSpawnInfo(creator=state.self_ref))
        ref = CrgcRefob(child)
        # "onCreate" is only recorded at the child, not the parent.
        if not state.can_record_new_actor():
            self.send_entry(state, is_busy=True)
        state.record_new_actor(ref)
        return ref

    # ----------------------------------------------------------------- #
    # Message path
    # ----------------------------------------------------------------- #

    def send_message(
        self,
        ref: CrgcRefob,
        msg: Any,
        refs: Iterable[Refob],
        state: CrgcState,
        ctx: "ActorContext",
    ) -> None:
        """(reference: CRGC.scala:208-221)"""
        if not ref.can_inc_send_count() or not state.can_record_updated_refob(ref):
            self.send_entry(state, is_busy=True)
        ref.inc_send_count()
        state.record_updated_refob(ref)
        app_msg = AppMsg(msg, refs)
        target = ref.target
        fabric = self.system.fabric
        tel = self.system.telemetry
        if tel is not None and tel.tracer.enabled:
            app_msg.trace_ctx = tel.tracer.on_send(
                target=target.path, uid=target.uid
            )
        tap = self.tap
        if tap is not None:
            tap.on_send(
                target, remote=fabric is not None and target.system is not self.system
            )
        if fabric is not None and target.system is not self.system:
            # Cross-node send: route through the link's egress/ingress
            # interceptors (reference: streams/Egress.scala:19-20).
            fabric.deliver(self.system, target, app_msg)
        else:
            target.tell(app_msg)

    def on_message(
        self, msg: GCMessage, state: CrgcState, ctx: "ActorContext"
    ) -> Optional[Any]:
        """(reference: CRGC.scala:114-127)"""
        if isinstance(msg, AppMsg):
            if not msg.external:
                tap = self.tap
                if tap is not None:
                    tap.on_recv(ctx.cell, crossed=msg.window_id >= 0)
                if not state.can_record_message_received():
                    self.send_entry(state, is_busy=True)
                state.record_message_received()
            return msg.payload
        return None

    def on_idle(
        self, msg: GCMessage, state: CrgcState, ctx: "ActorContext"
    ) -> TerminationDecision:
        """(reference: CRGC.scala:129-149)"""
        if isinstance(msg, _StopMsg):
            return TerminationDecision.SHOULD_STOP
        if isinstance(msg, _WaveMsg):
            self.send_entry(state, is_busy=False)
            for child in ctx.children:
                child.tell(WaveMsg)
            return TerminationDecision.SHOULD_CONTINUE
        if self.collection_style == "on-idle":
            self.send_entry(state, is_busy=False)
        return TerminationDecision.SHOULD_CONTINUE

    # ----------------------------------------------------------------- #
    # Reference management
    # ----------------------------------------------------------------- #

    def create_ref(
        self, target: CrgcRefob, owner: Refob, state: CrgcState, ctx: "ActorContext"
    ) -> Refob:
        """(reference: CRGC.scala:151-162)"""
        ref = CrgcRefob(target.target, target.target_shadow)
        tap = self.tap
        if tap is not None:
            tap.on_create(owner.target, target.target)
        if not state.can_record_new_refob():
            self.send_entry(state, is_busy=True)
        state.record_new_refob(owner, target)
        return ref

    def release(
        self, releasing: Iterable[CrgcRefob], state: CrgcState, ctx: "ActorContext"
    ) -> None:
        """(reference: CRGC.scala:164-177)"""
        tap = self.tap
        for ref in releasing:
            if tap is not None:
                # Before deactivation, so the tap can see a double release.
                tap.on_release(ref, already_released=(ref.info & 1) == 1)
            if not state.can_record_updated_refob(ref):
                self.send_entry(state, is_busy=True)
            ref.deactivate()
            state.record_updated_refob(ref)

    # ----------------------------------------------------------------- #
    # Entry flushing
    # ----------------------------------------------------------------- #

    def _obtain_entry(self) -> Entry:
        """Pop a pooled entry or allocate (reference: CRGC.scala:185-189)."""
        try:
            entry = self.entry_pool.popleft()
            allocated = False
        except IndexError:
            entry = Entry(self.crgc_context)
            allocated = True
        if events.recorder.enabled:
            events.recorder.commit(events.ENTRY_SEND, allocated_memory=allocated)
        return entry

    def send_entry(self, state: CrgcState, is_busy: bool) -> None:
        """(reference: CRGC.scala:179-193)"""
        plane = self.packed_plane
        if plane is not None:
            state.flush_to_ring(is_busy, plane)
            if events.recorder.enabled:
                events.recorder.commit(events.ENTRY_SEND, allocated_memory=False)
            return
        entry = self._obtain_entry()
        state.flush_to_entry(is_busy, entry)
        self.queue.append(entry)

    # ----------------------------------------------------------------- #
    # Remoting interception (reference: CRGC.scala:223-241)
    # ----------------------------------------------------------------- #

    def link_fence(self, address: "str | None") -> int:
        """The incarnation era of ``address`` (0 until it ever rejoins)."""
        return self._link_fences.get(address, 0)

    def bump_link_fence(self, address: str) -> int:
        fence = self._link_fences.get(address, 0) + 1
        self._link_fences[address] = fence
        return fence

    def spawn_egress(self, link: Any) -> Any:
        from .gateways import Egress

        return Egress(link)

    def spawn_ingress(self, link: Any) -> Any:
        from .gateways import Ingress

        return Ingress(link, self)

    # ----------------------------------------------------------------- #
    # Death accounting (divergence from the reference, deliberately)
    # ----------------------------------------------------------------- #
    # The reference's dying actors do not flush their remaining facts,
    # relying on its forked mailbox hook's timing; an actor killed between
    # a send and its flush would leave the recipient's receive balance
    # permanently nonzero (a liveness leak).  We instead account death
    # explicitly: drain-and-count the remaining mailbox, release carried
    # refs, flush a final entry — and account post-mortem arrivals through
    # the dead-letter hook, the single-node analogue of the reference's
    # per-link admitted counts (reference: IngressEntry.java:91-100).

    def pre_signal(self, signal: Any, state: CrgcState, ctx: "ActorContext") -> None:
        if not isinstance(signal, _PostStop):
            return
        leftovers = ctx.cell.drain_mailbox()
        app_msgs = [m for m in leftovers if isinstance(m, AppMsg)]
        if app_msgs:
            # They were never delivered to the user handler; count them in
            # the system's dead-letter metric like any undelivered message.
            self.system.record_dead_letters_dropped(ctx.cell, len(app_msgs))
        for msg in app_msgs:
            if not msg.external:
                if not state.can_record_message_received():
                    self.send_entry(state, is_busy=True)
                state.record_message_received()
            self.release(msg.refs, state, ctx)
        # A stopped actor is no longer a root: without this, a dead root's
        # final entry would leave its shadow a pseudoroot forever, leaking
        # everything it still referenced.
        state.is_root = False
        self.send_entry(state, is_busy=False)

    def on_dead_letter(self, cell: Any, msg: Any) -> None:
        """Account an AppMsg that arrived after the recipient terminated:
        one synthetic receive plus the release of every carried ref, folded
        as an entry on the dead actor's behalf.  ``cell`` may be a
        tombstone ProxyCell when the frame crossed a process boundary and
        the uid no longer resolves — the entry then folds under the same
        stable (address, uid) key the sender's claims fold under, so the
        balances cancel once both sides' facts arrive."""
        if not isinstance(msg, AppMsg):
            return
        refs = list(msg.refs)
        field_size = self.crgc_context.entry_field_size
        first = True
        while first or refs:
            entry = self._obtain_entry()
            entry.self_ref = CrgcRefob(cell)
            entry.recv_count = 1 if first else 0
            batch, refs = refs[:field_size], refs[field_size:]
            for i, ref in enumerate(batch):
                ref.deactivate()
                entry.updated_refs[i] = ref
                entry.updated_infos[i] = ref.info
            self.queue.append(entry)
            first = False

    # ----------------------------------------------------------------- #

    def shutdown(self) -> None:
        self.bookkeeper.stop_timers()

    def on_crash(self) -> None:
        self.bookkeeper.stop_timers()
        # Stop the collector cell: the stop rides the system-message
        # channel, so pending membership events are never processed —
        # an abrupt death, not a graceful leave.
        self.bookkeeper_cell.stop()
