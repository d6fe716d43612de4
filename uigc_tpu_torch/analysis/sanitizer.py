"""Copy of ``uigc_tpu/analysis/sanitizer.py`` (pure Python), held against
it by ``tests/test_torch_sanitizer.py`` (on a NodeFabric, by
``tests/test_torch_node_telemetry.py``).  What differs: beside a
partitioned collector the oracle folds undo logs as that collector does,
stickily (``engines/crgc/shadow.py`` ``sticky_undo``; ROADMAP.md Queue
3), and re-applies them to the slices the absorb path resets; a rejoined
address's actors are no longer halted on sight.

uigcsan: an online GC-soundness sanitizer.

The reference debugged its collector by folding the same entry stream
into two graphs and asserting equality (reference:
ShadowGraph.java:176-199 ``assertEquals``).  uigcsan makes that
discipline a wrappable runtime facility: :meth:`Sanitizer.attach` hooks
a live :class:`~uigc_tpu.runtime.system.ActorSystem` so that

- every fact the collector folds (object entries, packed rows, peer
  delta graphs, undo logs) is *also* folded into an independent
  pointer-based oracle (:class:`~uigc_tpu.engines.crgc.shadow.ShadowGraph`);
- every collection cycle cross-checks the engine's quiescence verdict
  against the oracle's (``verdict.mismatch``);
- the engine-hook taps (:class:`~uigc_tpu.engines.engine.EngineTap`)
  observe sends/receives/creates/releases on the mutator side, giving a
  ground truth the folded facts must reconcile with;
- fold discipline is checked online: undo logs fold exactly once and
  only after the finalization quorum, delta gossip sequence numbers are
  monotone per peer, packed flush stamps are unique per drained batch.

Violations are **structured diagnostics**, never bare asserts: each is
a :class:`SanitizerViolation` carrying the mismatching entries in its
payload, recorded on the sanitizer (and emitted as an
``analysis.violation`` event) — and additionally *raised* at the point
of detection when ``uigc.analysis.sanitizer-raise`` is on.  Raise mode
is fail-fast debugging, not clean propagation: a raise from an engine
hook or collector fold lands in the cell batch's default supervision,
which prints the traceback and stops the affected actor (the
Bookkeeper, for collector-side checks — halting GC loudly).  The
record-first ordering means ``system.sanitizer.violations`` keeps the
evidence either way.

Violation catalog (``rule`` values):

==========================  ==============================================
``verdict.mismatch``        engine and oracle disagree on a cycle's
                            garbage count
``release.double``          a refob was released twice without an
                            intervening flush
``terminate.premature``     the engine stopped an actor the oracle still
                            proves reachable
``undo.premature_fold``     an undo log folded before its finalization
                            quorum was satisfied
``undo.double_fold``        an undo log folded twice for the same node
``delta.seq_regression``    a peer's delta gossip arrived with a
                            non-increasing sequence number
``packed.seq_duplicate``    two packed rows in one drained batch carry
                            the same flush stamp
``balance.nonzero_recv``    a receive balance failed to return to zero at
                            quiescence (dropped recv fact, duplicate
                            frame tally, lost send claim)
``edges.negative``          a reference edge is persistently negative at
                            quiescence (double release across flushes)
``balance.recv_without_send``  an actor received more local messages than
                            were ever sent to it (duplicate delivery)
==========================  ==============================================

Engines other than CRGC (MAC, DRL, manual) get the engine-hook taps
only — the oracle mirror requires CRGC's entry stream.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Set

from ..engines.engine import EngineTap
from ..utils import events
from ..utils.validation import InvariantViolation

if TYPE_CHECKING:  # pragma: no cover
    from ..runtime.system import ActorSystem


class SanitizerViolation(InvariantViolation):
    """A GC-soundness invariant the sanitizer watches did not hold."""


def _path(cell: Any) -> str:
    return getattr(cell, "path", repr(cell))


class _Tap(EngineTap):
    """Mutator-side ground truth: every send/recv/create/release as the
    engine performs it, before any recording machinery can lose it."""

    def __init__(self, san: "Sanitizer"):
        self.san = san

    def on_send(self, target: Any, remote: bool = False) -> None:
        san = self.san
        with san._lock:
            san.sends[target] = san.sends.get(target, 0) + 1
            if remote:
                san.tainted.add(target)

    def on_recv(self, cell: Any, crossed: bool = False) -> None:
        san = self.san
        with san._lock:
            recvs = san.recvs.get(cell, 0) + 1
            san.recvs[cell] = recvs
            if crossed:
                # Crossed a node boundary: the matching send was counted
                # by the peer's sanitizer; local send/recv comparison is
                # meaningless for this actor from here on.
                san.tainted.add(cell)
                return
            if cell in san.tainted:
                return
            sends = san.sends.get(cell, 0)
            if recvs > sends:
                san.record(
                    "balance.recv_without_send",
                    "actor received more local messages than were sent to it",
                    actor=_path(cell),
                    recvs=recvs,
                    sends=sends,
                )

    def on_create(self, owner: Any, target: Any) -> None:
        san = self.san
        with san._lock:
            san.creates[target] = san.creates.get(target, 0) + 1

    def on_release(self, ref: Any, already_released: bool = False) -> None:
        san = self.san
        if already_released:
            san.record(
                "release.double",
                "refob released twice without an intervening flush",
                refob=repr(ref),
                target=_path(getattr(ref, "target", None)),
            )
            return
        target = getattr(ref, "target", None)
        with san._lock:
            san.releases[target] = san.releases.get(target, 0) + 1

    def on_migrate_out(self, cell: Any, key: str) -> None:
        # A live migration moves the entity's remaining balance to
        # another node's books: local send/recv comparison for this
        # cell is meaningless from here on (same verdict as a message
        # that crossed a node boundary).
        san = self.san
        with san._lock:
            san.tainted.add(cell)

    def on_migrate_in(self, cell: Any, key: str) -> None:
        # The reconstructed incarnation's history (creates/sends under
        # the old uid) lives on the source node; never compare local
        # ground truth against it.
        san = self.san
        with san._lock:
            san.tainted.add(cell)

    def on_stop_decision(self, cell: Any, msg: Any) -> None:
        san = self.san
        if san.oracle is None:
            return
        with san._lock:
            shadow = san.oracle.shadow_map.get(cell)
            if shadow is None or not shadow.interned:
                # Unknown to the oracle, or known only through other
                # actors' unresolved claims — not provably live.
                return
            live = san._oracle_reachable()
        if shadow in live:
            san.record(
                "terminate.premature",
                "engine stopped an actor the oracle still proves reachable",
                actor=_path(cell),
                trigger=repr(msg),
                shadow=repr(shadow),
            )


class _MirrorGraph:
    """Wraps the collector's shadow graph: forwards every call to the
    real backend, folds the same facts into the sanitizer's oracle, and
    cross-checks each trace's verdict.  Unwrapped attributes (pipelined
    wake control, diagnostics, packed-plane wiring) pass straight
    through."""

    def __init__(self, real: Any, san: "Sanitizer"):
        # Instance dict bypass: __setattr__ below guards forwarding.
        object.__setattr__(self, "_real", real)
        object.__setattr__(self, "_san", san)

    def __getattr__(self, name: str) -> Any:
        return getattr(object.__getattribute__(self, "_real"), name)

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(object.__getattribute__(self, "_real"), name, value)

    # -- folds ------------------------------------------------------ #

    def merge_entry(self, entry: Any) -> None:
        self._san._fold_entry(entry)
        self._real.merge_entry(entry)

    def merge_entries(self, batch: Any) -> None:
        for entry in batch:
            self._san._fold_entry(entry)
        real_batch = getattr(self._real, "merge_entries", None)
        if real_batch is not None:
            real_batch(batch)
        else:
            for entry in batch:
                self._real.merge_entry(entry)

    def merge_packed(self, rows: Any) -> None:
        self._san._fold_packed(rows)
        self._real.merge_packed(rows)

    def merge_delta(self, delta: Any) -> None:
        self._san._fold_delta(delta)
        self._real.merge_delta(delta)

    def merge_undo_log(self, log: Any) -> None:
        self._san._fold_undo(log)
        self._real.merge_undo_log(log)

    # -- distributed-mode folds -------------------------------------- #

    def reset_partition(self, partitions: Any) -> int:
        # The absorb path (engines/crgc/distributed.py): the gained
        # slices are cleared and re-folded from retained journals.  The
        # oracle must reset the SAME slice, or the journal re-fold
        # (which arrives through merge_delta above) double-counts every
        # balance and edge for the gained partitions.
        real = object.__getattribute__(self, "_real")
        self._san._reset_partition(partitions, real.partition_map)
        return real.reset_partition(partitions)

    # -- verdicts ---------------------------------------------------- #

    def trace(self, should_kill: bool) -> int:
        n = self._real.trace(should_kill)
        self._san._check_trace(n, compare=True)
        return n

    def harvest_trace(self, should_kill: bool) -> int:
        # Pipelined verdicts were computed from an earlier snapshot; the
        # oracle holds newer facts, so count equality is not expected —
        # fold-side checks still ran, and the oracle is compacted here.
        n = self._real.harvest_trace(should_kill)
        self._san._check_trace(n, compare=False)
        return n


class Sanitizer:
    """uigcsan.  Create via :meth:`attach`, ideally before any managed
    actor is spawned (the config key ``uigc.analysis.sanitizer`` does
    this at system construction)."""

    def __init__(self, system: "ActorSystem"):
        self.system = system
        self.engine = system.engine
        self._lock = threading.RLock()
        self.violations: List[SanitizerViolation] = []
        self.raise_on_violation = system.config.get_bool(
            "uigc.analysis.sanitizer-raise"
        )
        # Mutator-side ground truth (keyed by cell identity; remote
        # targets key by their proxy).
        self.sends: Dict[Any, int] = {}
        self.recvs: Dict[Any, int] = {}
        self.creates: Dict[Any, int] = {}
        self.releases: Dict[Any, int] = {}
        self.tainted: Set[Any] = set()
        # CRGC mirror state.
        self.oracle: Optional[Any] = None
        self.bookkeeper: Optional[Any] = None
        self._folded_undo: Set[str] = set()
        self._delta_seq: Dict[str, int] = {}
        self._seen_packed_seqs: Set[int] = set()
        #: memoized pseudo-root closure; invalidated by every fold so a
        #: cascade of stop decisions costs one traversal, not one each.
        self._reach_cache: Optional[Set[Any]] = None
        self.checks = 0
        # Distributed-collector mode (engines/crgc/distributed.py): the
        # per-node oracle holds only the owned slice (facts are routed,
        # not broadcast), so single-node verdict checks cannot judge a
        # cross-node cycle — the sweep instead records its verdicts
        # here, and :func:`cross_check_distributed` merges every node's
        # oracle into one global graph to judge them.
        #: cumulative (address, uid) keys this node's distributed
        #: sweeps declared garbage
        self.dist_garbage_keys: Set[Any] = set()
        #: the last sweep's live (marked, owned) key set
        self.dist_live_keys: Set[Any] = set()
        #: wave id of the last recorded distributed sweep
        self.dist_last_wave = 0
        self.dist_sweeps = 0

    # -- attachment --------------------------------------------------- #

    @classmethod
    def attach(cls, system: "ActorSystem") -> "Sanitizer":
        san = cls(system)
        engine = system.engine
        engine.tap = _Tap(san)
        bookkeeper = getattr(engine, "bookkeeper", None)
        if bookkeeper is not None and hasattr(bookkeeper, "shadow_graph"):
            from ..engines.crgc.shadow import ShadowGraph

            san.bookkeeper = bookkeeper
            san.oracle = ShadowGraph(engine.crgc_context, system.address)
            # the partitioned collector's sticky undo fold, mirrored
            san.oracle.sticky_undo = getattr(
                bookkeeper.shadow_graph, "sticky_undo", False)
            bookkeeper.shadow_graph = _MirrorGraph(
                bookkeeper.shadow_graph, san
            )
            san._wrap_bookkeeper(bookkeeper)
        system.sanitizer = san
        return san

    def _wrap_bookkeeper(self, bookkeeper: Any) -> None:
        """Observe the collector's control-plane stream for the monotone
        sequence invariant on peer delta gossip."""
        from ..engines.crgc.collector import DeltaMsg
        from ..runtime.fabric import MemberRemoved, MemberUp

        orig = bookkeeper.on_message

        def on_message(msg: Any) -> Any:
            if isinstance(msg, MemberRemoved):
                # A rejoining FRESH incarnation of this address starts
                # its gossip sequence from zero — the monotonicity
                # window is per incarnation, not per address.
                with self._lock:
                    self._delta_seq.pop(msg.address, None)
            if isinstance(msg, MemberUp):
                # Re-admission of a previously-downed address (restart
                # rejoin, or a heal after a partition verdict): the
                # collector reset its undo state, so a LATER legitimate
                # fold for this address must not read as a double fold
                # — and the healed peer's delta stream continues its
                # own numbering, so the window re-learns from scratch.
                with self._lock:
                    if msg.address in self._folded_undo:
                        self.oracle.forget_dead(msg.address)
                    self._folded_undo.discard(msg.address)
                    self._delta_seq.pop(msg.address, None)
            if isinstance(msg, DeltaMsg) and msg.graph.address is not None:
                addr = msg.graph.address
                with self._lock:
                    last = self._delta_seq.get(addr)
                    # Keep the observed maximum so a replayed frame
                    # below it is still caught after a flagged dip.
                    self._delta_seq[addr] = max(
                        msg.seqnum, last if last is not None else msg.seqnum
                    )
                if last is not None and msg.seqnum <= last:
                    self.record(
                        "delta.seq_regression",
                        "peer delta gossip sequence number did not increase",
                        peer=addr,
                        last=last,
                        got=msg.seqnum,
                    )
            return orig(msg)

        bookkeeper.on_message = on_message

    # -- violation plumbing ------------------------------------------- #

    def record(self, rule: str, detail: str, **payload: Any) -> None:
        violation = SanitizerViolation(rule, detail, **payload)
        with self._lock:
            self.violations.append(violation)
        events.recorder.commit(
            events.ANALYSIS_VIOLATION,
            rule=rule,
            detail=detail,
            node=self.system.address,
        )
        if self.raise_on_violation:
            raise violation

    def by_rule(self, rule: str) -> List[SanitizerViolation]:
        with self._lock:
            return [v for v in self.violations if v.rule == rule]

    def report(self) -> Dict[str, Any]:
        """Structured summary for tests and post-mortems."""
        with self._lock:
            rules: Dict[str, int] = {}
            for v in self.violations:
                rules[v.rule] = rules.get(v.rule, 0) + 1
            return {
                "node": self.system.address,
                "checks": self.checks,
                "violations": [str(v) for v in self.violations],
                "by_rule": rules,
                "tap": {
                    "sends": sum(self.sends.values()),
                    "recvs": sum(self.recvs.values()),
                    "creates": sum(self.creates.values()),
                    "releases": sum(self.releases.values()),
                    "tainted": len(self.tainted),
                },
                "oracle_population": (
                    len(self.oracle.from_set) if self.oracle is not None else None
                ),
            }

    # -- oracle folds (collector thread) ------------------------------ #
    # These replicate ShadowGraph.merge_entry semantics but look shadows
    # up by cell, never through refob.target_shadow — the oracle must not
    # poison the shared refob shadow caches the real backend relies on.

    def _fold_entry(self, entry: Any) -> None:
        from ..engines.crgc import refob as refob_info
        from ..engines.crgc.shadow import _update_outgoing

        g = self.oracle
        with self._lock:
            self._reach_cache = None
            self_shadow = g.get_shadow(entry.self_ref.target)
            self_shadow.interned = True
            self_shadow.is_local = True
            self_shadow.recv_count += entry.recv_count
            self_shadow.is_busy = entry.is_busy
            self_shadow.is_root = entry.is_root

            field_size = self.engine.crgc_context.entry_field_size
            for i in range(field_size):
                owner = entry.created_owners[i]
                if owner is None:
                    break
                target_shadow = g.get_shadow(entry.created_targets[i].target)
                _update_outgoing(
                    g.get_shadow(owner.target).outgoing, target_shadow, 1
                )
            for i in range(field_size):
                child = entry.spawned_actors[i]
                if child is None:
                    break
                g.get_shadow(child.target).supervisor = self_shadow
            for i in range(field_size):
                target = entry.updated_refs[i]
                if target is None:
                    break
                target_shadow = g.get_shadow(target.target)
                info = entry.updated_infos[i]
                send_count = refob_info.count(info)
                if send_count > 0:
                    target_shadow.recv_count -= send_count
                if not refob_info.is_active(info):
                    _update_outgoing(self_shadow.outgoing, target_shadow, -1)

    def _fold_packed(self, rows: Any) -> None:
        """Decode a drained batch of packed rows (packed.py row layout)
        into the oracle, in flush order, resolving uids the same way the
        real fold does (plane pin first, weak registry second; facts
        naming proven-garbage uids drop)."""
        import numpy as np

        from ..engines.crgc.shadow import _update_outgoing

        seqs = rows[:, 0]
        uniq, counts = np.unique(seqs, return_counts=True)
        with self._lock:
            # Flush stamps are globally unique (plane.next_seq is
            # atomic): a repeat within or across drained batches means a
            # row was replayed.  The seen-set grows with total flushes —
            # acceptable for a debugging tool.
            replayed = [
                s for s in uniq.tolist() if s in self._seen_packed_seqs
            ]
            self._seen_packed_seqs.update(uniq.tolist())
        dup_stamps = uniq[counts > 1].tolist() + replayed
        if dup_stamps:
            self.record(
                "packed.seq_duplicate",
                "duplicate flush stamps in the packed entry stream",
                stamps=sorted(set(dup_stamps)),
            )
        plane = self.engine.packed_plane
        resolve = self.system.resolve_cell
        pins = plane.uid_strong

        def cell_of(uid: int) -> Any:
            cell = pins.get(uid)
            return cell if cell is not None else resolve(uid)

        g = self.oracle
        field_size = self.engine.crgc_context.entry_field_size
        order = np.argsort(seqs, kind="stable")
        with self._lock:
            self._reach_cache = None
            for row in rows[order]:
                row = row.tolist()
                base = 4
                # Created pairs survive an unresolvable flusher, exactly
                # like ArrayShadowGraph.merge_packed.
                for i in range(field_size):
                    owner_uid = row[base + 2 * i]
                    if owner_uid < 0:
                        continue
                    owner = cell_of(owner_uid)
                    target = cell_of(row[base + 2 * i + 1])
                    if owner is None or target is None:
                        continue
                    _update_outgoing(
                        g.get_shadow(owner).outgoing, g.get_shadow(target), 1
                    )
                self_cell = cell_of(row[1])
                if self_cell is None:
                    continue
                self_shadow = g.get_shadow(self_cell)
                self_shadow.interned = True
                self_shadow.is_local = True
                self_shadow.is_busy = bool(row[2] & 1)
                self_shadow.is_root = bool(row[2] & 2)
                self_shadow.recv_count += row[3]
                base = 4 + 2 * field_size
                for i in range(field_size):
                    child_uid = row[base + i]
                    if child_uid < 0:
                        continue
                    child = cell_of(child_uid)
                    if child is not None:
                        g.get_shadow(child).supervisor = self_shadow
                base = 4 + 3 * field_size
                for i in range(field_size):
                    target_uid = row[base + 2 * i]
                    if target_uid < 0:
                        continue
                    info = row[base + 2 * i + 1]
                    target = cell_of(target_uid)
                    if target is None:
                        continue
                    target_shadow = g.get_shadow(target)
                    send_count = info >> 1
                    if send_count > 0:
                        target_shadow.recv_count -= send_count
                    if info & 1:
                        _update_outgoing(
                            self_shadow.outgoing, target_shadow, -1
                        )

    def _fold_delta(self, delta: Any) -> None:
        with self._lock:
            self._reach_cache = None
            self.oracle.merge_delta(delta)

    def _fold_undo(self, log: Any) -> None:
        addr = log.node_address
        bookkeeper = self.bookkeeper
        if addr in self._folded_undo:
            self.record(
                "undo.double_fold",
                "undo log folded twice for the same dead node",
                address=addr,
            )
        else:
            my_addr = self.system.address
            expected = {my_addr}
            if bookkeeper is not None:
                expected.update(bookkeeper.remote_gcs)
            missing = sorted(expected - log.finalized_by)
            if missing:
                self.record(
                    "undo.premature_fold",
                    "undo log folded before its finalization quorum",
                    address=addr,
                    finalized_by=sorted(log.finalized_by),
                    missing=missing,
                )
        self._folded_undo.add(addr)
        with self._lock:
            self._reach_cache = None
            self.oracle.merge_undo_log(log)

    # -- verdict cross-check (collector thread) ------------------------ #

    def _check_trace(self, n_real: int, compare: bool) -> None:
        with self._lock:
            self._reach_cache = None  # the trace compacts the oracle
            # Muted: the oracle re-runs the instrumented trace pipeline;
            # letting it commit crgc.tracing/crgc.sweep would make every
            # metrics consumer double-count the wave with oracle timings.
            with events.recorder.suppressed():
                n_oracle = self.oracle.trace(should_kill=False)
            self.checks += 1
        events.recorder.commit(
            events.ANALYSIS_CHECK,
            node=self.system.address,
            n_garbage=n_real,
            oracle_garbage=n_oracle,
        )
        if compare and n_oracle != n_real:
            self.record(
                "verdict.mismatch",
                "engine and oracle disagree on a collection verdict",
                engine_garbage=n_real,
                oracle_garbage=n_oracle,
                oracle_addresses=self.oracle.addresses_in_graph(),
            )

    # -- distributed mode (collector thread) ---------------------------- #

    def _reset_partition(self, partitions: Any, pmap: Any) -> None:
        """Mirror of PartitionedShadowGraph.reset_partition over the
        oracle: clear the authoritative state of every oracle shadow in
        the gained partitions (objects kept — other shadows' edges
        reference them by identity) so the journal re-fold rebuilds the
        oracle and the real slice from the same blank."""
        if pmap is None:
            return
        from ..engines.crgc.shadow import clear_authoritative_state
        from ..parallel.partition import cell_key

        with self._lock:
            self._reach_cache = None
            for shadow in self.oracle.from_set:
                key = cell_key(shadow.self_cell)
                if pmap.partition_of(key) in partitions:
                    clear_authoritative_state(shadow)
            self.oracle.reset_undo_slice(
                lambda cell: pmap.partition_of(cell_key(cell)) in partitions)

    def note_dist_sweep(self, wave: int, garbage_keys: Any, live_keys: Any) -> None:
        """One distributed sweep's verdicts for this node's owned slice.
        Recorded, not judged: a cross-node cycle's liveness is not
        decidable from one node's oracle — :func:`cross_check_distributed`
        merges every node's oracle and judges the accumulated verdicts
        against the global graph."""
        with self._lock:
            self.dist_garbage_keys.update(garbage_keys)
            self.dist_live_keys = set(live_keys)
            self.dist_last_wave = wave
            self.dist_sweeps += 1
        events.recorder.commit(
            events.ANALYSIS_CHECK,
            node=self.system.address,
            n_garbage=len(garbage_keys),
            oracle_garbage=-1,  # judged globally, not per node
        )

    def oracle_slice(self, pmap: Any) -> Dict[Any, Dict[str, Any]]:
        """This node's owned slice of the oracle as plain data keyed by
        (address, uid) — the unit :func:`merged_oracle` aggregates.
        Only keys the given partition map assigns to this node are
        exported: mirror shadows (non-owned edge endpoints) carry no
        authoritative state here and undo folds may have adjusted their
        balances redundantly, so the owner's record is the one that
        counts."""
        from ..parallel.partition import cell_key

        out: Dict[Any, Dict[str, Any]] = {}
        with self._lock:
            for shadow in self.oracle.from_set:
                key = cell_key(shadow.self_cell)
                if pmap is not None and not pmap.owns(key):
                    continue
                out[key] = {
                    "interned": shadow.interned,
                    "is_root": shadow.is_root,
                    "is_busy": shadow.is_busy,
                    "is_halted": shadow.is_halted,
                    "recv": shadow.recv_count,
                    "supervisor": (
                        cell_key(shadow.supervisor.self_cell)
                        if shadow.supervisor is not None
                        else None
                    ),
                    "outgoing": {
                        cell_key(t.self_cell): c
                        for t, c in shadow.outgoing.items()
                        if c != 0
                    },
                }
        return out

    # -- reachability / quiescence ------------------------------------- #

    def _oracle_reachable(self) -> Set[Any]:
        """Non-mutating pseudo-root closure over the oracle (caller holds
        the lock), memoized until the next fold.  Mirrors
        ShadowGraph.trace without touching marks."""
        if self._reach_cache is not None:
            return self._reach_cache
        g = self.oracle
        frontier = [s for s in g.from_set if g.is_pseudo_root(s)]
        live = set(frontier)
        while frontier:
            shadow = frontier.pop()
            if shadow.is_halted:
                continue
            for target, count in shadow.outgoing.items():
                if count > 0 and target not in live:
                    live.add(target)
                    frontier.append(target)
            supervisor = shadow.supervisor
            if supervisor is not None and supervisor not in live:
                live.add(supervisor)
                frontier.append(supervisor)
        self._reach_cache = live
        return live

    def check_quiescent(self) -> List[SanitizerViolation]:
        """Balance checks that only hold once the system has settled (no
        in-flight messages, collector caught up): every receive balance
        back at zero and no persistently negative reference edge.  Call
        from tests after a settle loop; returns the new violations.  In
        raise mode the whole scan still runs (recording every
        violation) and the first one is raised at the end, so no
        evidence is lost."""
        found: List[SanitizerViolation] = []
        before = len(self.violations)
        raise_mode, self.raise_on_violation = self.raise_on_violation, False
        if self.oracle is not None:
            with self._lock:
                shadows = list(self.oracle.from_set)
                taps = {
                    "sends": dict(self.sends),
                    "recvs": dict(self.recvs),
                    "tainted": set(self.tainted),
                }
            for shadow in shadows:
                if shadow.is_halted:
                    continue
                cell = shadow.self_cell
                if shadow.recv_count != 0:
                    self.record(
                        "balance.nonzero_recv",
                        "receive balance did not return to zero at quiescence",
                        actor=_path(cell),
                        balance=shadow.recv_count,
                        tap_sends=taps["sends"].get(cell, 0),
                        tap_recvs=taps["recvs"].get(cell, 0),
                        crossed_link=cell in taps["tainted"],
                    )
                negative = {
                    _path(t.self_cell): c
                    for t, c in shadow.outgoing.items()
                    if c < 0
                }
                if negative:
                    self.record(
                        "edges.negative",
                        "reference edge persistently negative at quiescence",
                        owner=_path(cell),
                        edges=negative,
                    )
        else:
            with self._lock:
                for cell, recvs in self.recvs.items():
                    if cell in self.tainted:
                        continue
                    sends = self.sends.get(cell, 0)
                    if recvs > sends:
                        self.record(
                            "balance.recv_without_send",
                            "actor received more messages than were sent",
                            actor=_path(cell),
                            recvs=recvs,
                            sends=sends,
                        )
        self.raise_on_violation = raise_mode
        with self._lock:
            found = self.violations[before:]
        if raise_mode and found:
            raise found[0]
        return found


# ------------------------------------------------------------------- #
# Distributed mode: merge per-node oracles, judge every sweep verdict
# against the global graph (engines/crgc/distributed.py).
# ------------------------------------------------------------------- #


class MergedOracle:
    """The union of every node's owned oracle slice — the pointer-exact
    global shadow graph no single node of the partitioned collector is
    allowed to hold.  State is owner-authoritative: each actor's record
    comes from the oracle of the node whose partition map owns it, so a
    mirror's redundant undo-fold adjustments can never double-count.

    ``live`` / ``garbage`` partition the key space by the same
    pseudo-root closure the single-host trace runs (halted actors can be
    marked but never propagate), which is the fixpoint the distributed
    wave protocol must iterate to."""

    def __init__(self, state: Dict[Any, Dict[str, Any]], nodes: List[str]):
        self.state = state
        self.nodes = nodes
        self.live: Set[Any] = set()
        self._close()
        self.garbage: Set[Any] = set(state) - self.live

    def _close(self) -> None:
        state = self.state
        frontier = []
        for key, rec in state.items():
            pseudo_root = (
                rec["is_root"]
                or rec["is_busy"]
                or rec["recv"] != 0
                or not rec["interned"]
            ) and not rec["is_halted"]
            if pseudo_root:
                self.live.add(key)
                frontier.append(key)
        while frontier:
            key = frontier.pop()
            rec = state.get(key)
            if rec is None or rec["is_halted"]:
                continue
            for target, count in rec["outgoing"].items():
                if count > 0 and target not in self.live:
                    self.live.add(target)
                    frontier.append(target)
            sup = rec["supervisor"]
            if sup is not None and sup not in self.live:
                self.live.add(sup)
                frontier.append(sup)


def merged_oracle(systems: Any) -> MergedOracle:
    """Merge the live systems' sanitizer oracles into one global graph.
    Every system must be sanitizer-attached and running the distributed
    collector (so each oracle holds exactly its owned slice)."""
    state: Dict[Any, Dict[str, Any]] = {}
    nodes: List[str] = []
    for system in systems:
        san = getattr(system, "sanitizer", None)
        if san is None or san.oracle is None:
            continue
        pmap = getattr(system.engine.bookkeeper, "pmap", None)
        nodes.append(system.address)
        state.update(san.oracle_slice(pmap))
    return MergedOracle(state, nodes)


def cross_check_distributed(systems: Any) -> List[SanitizerViolation]:
    """The distributed verdict check: every key any node's sweeps
    declared garbage must be unreachable in the merged global oracle.
    Garbage is monotone in CRGC, so a correct past verdict stays
    unreachable; a premature collection stays visible because the live
    holder's positive edge to the victim is still in its owner's oracle.
    Each violation is recorded on the judged node's own sanitizer (so
    per-node "sanitizer clean" assertions catch it) and the new
    violations are returned."""
    merged = merged_oracle(systems)
    found: List[SanitizerViolation] = []
    for system in systems:
        san = getattr(system, "sanitizer", None)
        if san is None:
            continue
        with san._lock:
            swept = set(san.dist_garbage_keys)
        bad = swept & merged.live
        if bad:
            before = len(san.violations)
            raise_mode, san.raise_on_violation = san.raise_on_violation, False
            san.record(
                "verdict.mismatch",
                "distributed sweep collected actors the merged oracle "
                "proves reachable",
                node=system.address,
                keys=sorted(f"{a}#{u}" for a, u in bad),
                merged_nodes=merged.nodes,
            )
            san.raise_on_violation = raise_mode
            with san._lock:
                found.extend(san.violations[before:])
    return found
