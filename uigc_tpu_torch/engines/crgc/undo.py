"""Copy of ``uigc_tpu/engines/crgc/undo.py`` (pure Python).

Undo logs: reverting a dead node's unadmitted effects.

Mirrors the reference's UndoLog (reference: crgc/UndoLog.java:16-105):
per remote node, subtract everything that node *claimed* to have sent or
created toward actors it did not host (mergeDeltaGraph), and add back
what provably crossed each link (mergeIngressEntry).  Once every
surviving peer's final ingress entry has arrived (the finalization
quorum, reference: LocalGC.scala:253-257), the net log is folded into the
shadow graph: the dead node's actors halt and its unadmitted sends/refs
are reverted (reference: ShadowGraph.java:158-174).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Set

from ...utils import events
from .delta import DeltaGraph
from .gateways import IngressEntry

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell


class UndoLogField:
    """(reference: UndoLog.java:21-31)"""

    __slots__ = ("message_count", "created_refs")

    def __init__(self) -> None:
        self.message_count = 0
        self.created_refs: Dict["ActorCell", int] = {}


class UndoLog:
    """(reference: UndoLog.java:16-105)

    Fence discipline (ours): windows are keyed by (peer, fence era) at
    the ingress, and the log refuses pre-death stragglers of a rejoined
    incarnation — ``fence`` floors entries tallied by *this* node
    (whose eras we know exactly: it is set to our current era for the
    address when the log is created at rejoin), per-ingress floors
    seeded from the superseded log (:meth:`seed_floors`) fence out
    every era a peer already used for the dead incarnation, and
    per-ingress monotonicity covers the rest of each peer's rebroadcast
    stream without ever comparing fence counters across nodes (a late
    joiner legitimately counts fewer deaths than a veteran).  The one
    ordering none of those can judge — a peer whose FIRST entry after a
    rejoin is a dead-era straggler, with no floor on record — has two
    guards.  Primary: ``expected_nonce``, the process-incarnation
    identity (hello nonce) of the incarnation this log covers — every
    observer stamps the SAME value, so a straggler about a previous
    incarnation is refused outright before it can tally or join the
    fold quorum, with no counter comparison at all.  Fallback (nonce
    unknown: in-process fabrics, old peers): era supersession — tallies
    are bucketed per (ingress, fence), and a higher-era entry from the
    same ingress un-applies the lower era's tallies and withdraws its
    finalization before merging."""

    def __init__(
        self,
        node_address: str,
        fence: int = 0,
        own_address: "str | None" = None,
        expected_nonce: int = 0,
    ):
        self.node_address = node_address
        self.finalized_by: Set[str] = set()
        self.admitted: Dict["ActorCell", UndoLogField] = {}
        self.fence = fence
        self.own_address = own_address
        self.expected_nonce = expected_nonce
        #: highest fence seen per ingress address — a dip within one
        #: observer's stream is a pre-death straggler, dropped
        self._ingress_fences: Dict[str, int] = {}
        #: minimum acceptable era per ingress address, seeded at rejoin
        #: from the superseded incarnation's log
        self._ingress_floors: Dict[str, int] = {}
        #: era whose tallies are currently merged, per ingress, plus
        #: the NET of those tallies (kept so supersession can invert
        #: without retaining entry objects: the aggregate is bounded by
        #: the actors the stream touched, not by window count) and how
        #: many windows fed it (diagnostics only)
        self._applied_eras: Dict[str, int] = {}
        self._applied_net: Dict[str, Dict[Any, UndoLogField]] = {}
        self._applied_counts: Dict[str, int] = {}

    def _field(self, cell: "ActorCell") -> UndoLogField:
        field = self.admitted.get(cell)
        if field is None:
            field = UndoLogField()
            self.admitted[cell] = field
        return field

    def merge_delta_graph(self, delta: DeltaGraph) -> None:
        """Subtract the dead node's claims toward non-interned (remote)
        actors (reference: UndoLog.java:39-67)."""
        decoder = delta.decoder()
        for i, shadow in enumerate(delta.shadows):
            if shadow.interned:
                # Only sends/creates toward actors on OTHER nodes matter.
                continue
            field = self._field(decoder[i])
            field.message_count -= shadow.recv_count
            for target_id, count in shadow.outgoing.items():
                target = decoder[target_id]
                self._update(field.created_refs, target, -count)

    def stale_fence(self, entry: IngressEntry) -> bool:
        """True when the entry belongs to a window era this log must
        not merge (its stream pre-dates a rejoin this log post-dates).
        Checked — and the per-stream watermark advanced — before any
        tally lands."""
        src = entry.ingress_address
        if src is None:
            return False
        if (
            self.expected_nonce
            and entry.nonce
            and entry.nonce != self.expected_nonce
        ):
            # The entry tallies a DIFFERENT incarnation of the address
            # than the one this log covers — the exact, observer-
            # independent verdict (no era inference needed).
            return True
        if src == self.own_address and entry.fence < self.fence:
            return True
        if entry.fence < self._ingress_floors.get(src, 0):
            return True
        seen = self._ingress_fences.get(src)
        if seen is not None and entry.fence < seen:
            return True
        self._ingress_fences[src] = entry.fence
        return False

    def seed_floors(self, prior: "UndoLog") -> None:
        """Carry the superseded incarnation's per-ingress knowledge
        into the rejoined incarnation's log: any era a peer used toward
        the dead stream is below that peer's era for the live one, so
        the common straggler ordering — a dead-era rebroadcast arriving
        first after the rejoin — is refused outright instead of waiting
        for supersession."""
        for src, era in prior._ingress_fences.items():
            self._ingress_floors[src] = max(
                self._ingress_floors.get(src, 0), era + 1,
            )
        for src, floor in prior._ingress_floors.items():
            self._ingress_floors[src] = max(
                self._ingress_floors.get(src, 0), floor,
            )

    def _discard_superseded(self, src: str) -> None:
        """A higher-era entry from ``src`` proves the tallies currently
        merged for it belong to the dead incarnation's stream (the
        no-floor first-straggler ordering): un-apply their net and
        withdraw any finalization they granted — a stale final must
        never satisfy the fold quorum."""
        stale_net = self._applied_net.pop(src, {})
        for cell, net in stale_net.items():
            field = self._field(cell)
            # Application subtracted the raw admitted counts and added
            # the raw created refs; inversion does the opposite.
            field.message_count += net.message_count
            for target, count in net.created_refs.items():
                self._update(field.created_refs, target, -count)
            self._drop_if_zero(cell, field)
        self.finalized_by.discard(src)
        events.recorder.commit(
            events.STALE_WINDOW,
            peer=self.node_address,
            ingress=src,
            fence=self._applied_eras.get(src, 0),
            log_fence=self.fence,
            superseded=self._applied_counts.pop(src, 0),
        )

    def merge_ingress_entry(self, entry: IngressEntry) -> None:
        """Cancel the admitted portion of the dead node's claims
        (reference: UndoLog.java:69-93).

        Sign note — deliberate deviation: sends enter the shadow graph
        NEGATIVELY (recv_count -= send_count) while created refs enter
        POSITIVELY, so reverting unadmitted claims requires
        ``message_count = claimed - admitted`` (applied as +) but
        ``created_refs = admitted - claimed`` (applied as +).  The
        reference adds admitted message counts (UndoLog.java:81), which
        would leave every fully-admitted message double-counted in the
        receive balance after the undo, pinning the recipient as a
        pseudoroot forever; we subtract instead."""
        src = entry.ingress_address
        net = None
        if src is not None and src != self.own_address:
            era = self._applied_eras.get(src)
            if era is not None and entry.fence > era:
                self._discard_superseded(src)
            self._applied_eras[src] = entry.fence
            if entry.admitted:
                net = self._applied_net.setdefault(src, {})
                self._applied_counts[src] = self._applied_counts.get(src, 0) + 1
        for cell, entry_field in entry.admitted.items():
            field = self._field(cell)
            field.message_count -= entry_field.message_count
            for target, count in entry_field.created_refs.items():
                self._update(field.created_refs, target, count)
            self._drop_if_zero(cell, field)
            if net is not None:
                nf = net.get(cell)
                if nf is None:
                    nf = net[cell] = UndoLogField()
                nf.message_count += entry_field.message_count
                for target, count in entry_field.created_refs.items():
                    self._update(nf.created_refs, target, count)
        if entry.is_final:
            self.finalized_by.add(entry.ingress_address)

    def _drop_if_zero(self, cell: Any, field: UndoLogField) -> None:
        # A net-zero field is indistinguishable from an absent one to
        # every merge_undo_log consumer; dropping it keeps summary()
        # honest after a supersession.
        if not field.message_count and not field.created_refs:
            self.admitted.pop(cell, None)

    def summary(self) -> Dict[str, int]:
        """Structured size of the net log (event fields for the
        ``crgc.undo_fold`` commit and the chaos bench): how many actors
        carry a reverted message balance or reverted created refs, and
        how many surviving peers finalized."""
        return {
            "reverted_actors": len(self.admitted),
            "reverted_messages": sum(
                abs(f.message_count) for f in self.admitted.values()
            ),
            "reverted_refs": sum(
                len(f.created_refs) for f in self.admitted.values()
            ),
            "finalized_by": len(self.finalized_by),
        }

    @staticmethod
    def _update(outgoing: Dict[Any, int], target: Any, delta: int) -> None:
        count = outgoing.get(target, 0) + delta
        if count == 0:
            outgoing.pop(target, None)
        else:
            outgoing[target] = count
