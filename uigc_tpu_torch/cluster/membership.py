"""Copy of ``uigc_tpu/cluster/membership.py`` (pure Python, no imports
of the package).

Membership arbiter: split-brain resolution and epoch fencing.

The phi-accrual detector (runtime/heartbeat.py) turns a network
partition into *mutual* death verdicts: both halves see the other go
silent, both inherit the "dead" side's shards, and both keep appending
to the journal — dual activation, the failure mode the reference's
fail-stop crash machinery (undo-log quorums) was never built for.  This
module is the judgement layer on top of those verdicts:

- **Settle window** — an unreachability verdict is not acted on
  immediately; it opens a short window (``uigc.cluster.sbr-settle``)
  during which further verdicts accumulate.  A one-node crash and a
  half-cluster partition look identical for the first verdict; the
  settle window lets the full unreachable set form before a strategy
  judges it (the same reason Akka SBR waits for a stable membership
  view).  Shard inheritance is deferred until the verdict — the side
  that will lose never starts acquiring shards.

- **Strategies** (``uigc.cluster.sbr-strategy``), each a pure function
  of (seen members, live members) evaluated identically on every node,
  so the two halves reach *complementary* verdicts without exchanging
  a single frame (they can't — the link is down):

  ``keep-majority``  the half with more than half of the last-known
                     membership survives; an exact 50/50 tie keeps the
                     half containing the lowest address.
  ``static-quorum``  survive iff at least ``sbr-quorum-size`` members
                     remain live (0 = derive majority quorum).
  ``keep-oldest``    the half containing the most senior member
                     survives — seniority is a join stamp gossiped and
                     min-merged through the ``mship`` handshake, so
                     every node agrees who is oldest.
  ``down-all``       any partition downs every side; operators restart
                     (the strictest consistency posture).
  ``off``            legacy behavior: every verdict is acted on
                     immediately, no arbitration (1- and 2-node
                     topologies below ``sbr-min-members`` get this
                     automatically — majority is undefined there).

- **Fencing** — the arbiter mints a monotone **fence epoch**: bumped
  exactly when a side *survives* a verdict, frozen when it loses.  The
  survivor's fence therefore strictly exceeds the loser's, and every
  ownership-bearing artifact is stamped with it: journal records
  (cluster/journal.py quarantines lower-fence conflicts out of
  recovery merges), shard-table gossip (fence orders tables before the
  (version, origin) lamport pair), ``mig``/``sgrant`` frames (state
  shipped or granted under a superseded era is refused), and entity
  routing.  Fences are small logical counters, not wall clocks — two
  survivors of the same partition independently bump to the same
  value, so same-side traffic is never falsely fenced.

- **Heal handshake** — a ``mship`` frame (wire.py: JSON, never pickle)
  carries (fence, live view, join stamps, quarantined flag).  It is
  exchanged on every MemberUp, broadcast on fence adoptions, and
  gossiped periodically.  A quarantined loser that reconnects adopts
  the survivor's fence through it and rejoins as a fresh member; a
  survivor admits a previously-downed address back into placement only
  after the peer's handshake shows the adopted fence.  Two live peers
  whose views *disagree* (one lists as live a node the other downed,
  at equal fences) are the split-brain-suspected signal — surfaced as
  ``cluster.membership_disagreement`` events feeding the
  ``split_brain_suspected`` alert.

The arbiter is deliberately transport-free: it never sends a frame or
takes a region lock.  ``ClusterSharding`` (sharding.py) owns the wiring
— it feeds membership events in, polls for decisions on its tick, and
executes the verdicts (deferred inheritance, quarantine, rejoin).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

#: strategy names accepted by ``uigc.cluster.sbr-strategy``
STRATEGIES = ("keep-majority", "static-quorum", "keep-oldest", "down-all")

_FAR_FUTURE = 1 << 62


def _now_ms() -> int:
    return time.time_ns() // 1_000_000


class SbrDecision:
    """One settled split-brain verdict."""

    __slots__ = ("strategy", "survived", "downed", "live", "seen", "fence", "reason")

    def __init__(
        self,
        strategy: str,
        survived: bool,
        downed: List[str],
        live: List[str],
        seen: List[str],
        fence: int,
        reason: str,
    ):
        self.strategy = strategy
        self.survived = survived
        self.downed = downed
        self.live = live
        self.seen = seen
        self.fence = fence
        self.reason = reason

    def __repr__(self) -> str:  # pragma: no cover
        verdict = "survive" if self.survived else "down-self"
        return f"SbrDecision({self.strategy}: {verdict}, downed={self.downed})"


class MembershipArbiter:
    """Split-brain resolver for ONE node.  Pure bookkeeping + judgement;
    the owning ``ClusterSharding`` drives it and executes its verdicts.

    Thread-safety: one lock; every method is safe from any thread
    (membership events arrive on the coordinator cell, handshake frames
    on transport threads, polls on the tick)."""

    def __init__(
        self,
        address: str,
        strategy: str = "keep-majority",
        settle_s: float = 0.2,
        quorum_size: int = 0,
        min_members: int = 3,
    ):
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown sbr strategy {strategy!r} (one of {STRATEGIES})"
            )
        self.address = address
        self.strategy = strategy
        self.settle_s = settle_s
        self.quorum_size = quorum_size
        self.min_members = max(1, min_members)
        self._lock = threading.Lock()
        #: current partition era; bumped only by SURVIVING a verdict (or
        #: adopted, higher, from a survivor's handshake)
        self.fence = 0
        #: the membership this era has seen live (self always included)
        self._seen: Set[str] = {address}
        #: join seniority: address -> wall-ms stamp, min-merged across
        #: handshakes so every node converges on who is oldest
        self._stamps: Dict[str, int] = {address: _now_ms()}
        #: verdicts accumulating toward the settle deadline
        self._unreachable: Dict[str, float] = {}
        self._deadline: Optional[float] = None
        #: addresses removed by a verdict this era — they re-enter
        #: placement only through the handshake (requires_handshake)
        self._downed: Set[str] = set()
        #: this node lost a verdict and is quarantined until a
        #: survivor's fence arrives
        self.quarantined = False
        #: decisions reached (stats)
        self.decisions = 0

    # -- membership events (coordinator thread) --------------------- #

    def on_member_up(self, address: str) -> bool:
        """A peer connected (or reconnected).  Returns True when the
        address may join placement immediately; False when it must
        complete the ``mship`` handshake first (it was downed by a
        verdict this era, or WE are quarantined and everything readmits
        through the handshake)."""
        if address == self.address:
            return True
        with self._lock:
            if self.quarantined or address in self._downed:
                return False
            self._seen.add(address)
            self._stamps.setdefault(address, _now_ms())
            self._unreachable.pop(address, None)
            if not self._unreachable:
                self._deadline = None
            return True

    def on_leaving(self, address: str) -> None:
        """Voluntary departure (drain): not an unreachability — the
        leaver exits the era's membership without a verdict."""
        with self._lock:
            self._seen.discard(address)
            self._unreachable.pop(address, None)
            if not self._unreachable:
                self._deadline = None

    def admit(self, address: str) -> None:
        """Handshake completed: the previously-downed address re-enters
        this era's membership."""
        with self._lock:
            self._downed.discard(address)
            self._seen.add(address)
            self._stamps.setdefault(address, _now_ms())

    def requires_handshake(self, address: str) -> bool:
        with self._lock:
            return self.quarantined or address in self._downed

    def track_unreachable(self, address: str) -> bool:
        """An unreachability verdict arrived.  True = arbitration owns
        it now (the caller defers all removal handling until a settled
        decision); False = not arbitrated (unknown address, or the
        topology is below ``sbr-min-members``) — handle immediately,
        the legacy path."""
        with self._lock:
            if self.quarantined:
                return True  # already lost: nothing more to decide
            if address not in self._seen:
                return False
            if len(self._seen) < self.min_members:
                # Majority is undefined below the floor: legacy
                # availability semantics (act immediately), but keep
                # the era's view coherent.
                self._seen.discard(address)
                return False
            self._unreachable[address] = time.monotonic()
            self._deadline = time.monotonic() + self.settle_s
            return True

    # -- the verdict (tick thread) ----------------------------------- #

    def poll(self, now: Optional[float] = None) -> Optional[SbrDecision]:
        """Evaluate once the unreachable set has settled.  Returns the
        decision exactly once per episode, or None while waiting."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._deadline is None or now < self._deadline:
                return None
            unreachable = sorted(self._unreachable)
            self._deadline = None
            self._unreachable.clear()
            if not unreachable or self.quarantined:
                return None
            seen = sorted(self._seen)
            live = sorted(self._seen - set(unreachable))
            survived, reason = self._evaluate(set(seen), set(live))
            self.decisions += 1
            self._downed.update(unreachable)
            if survived:
                self.fence += 1
                for address in unreachable:
                    self._seen.discard(address)
            else:
                self.quarantined = True
                self._seen = {self.address}
            return SbrDecision(
                self.strategy,
                survived,
                unreachable,
                live,
                seen,
                self.fence,
                reason,
            )

    def _evaluate(self, seen: Set[str], live: Set[str]) -> Tuple[bool, str]:
        """The strategy proper — a pure function both halves compute
        identically (caller holds the lock)."""
        if self.strategy == "down-all":
            return False, "down-all: every side downs on any partition"
        if self.strategy == "static-quorum":
            quorum = self.quorum_size or (len(seen) // 2 + 1)
            ok = len(live) >= quorum
            return ok, f"live={len(live)} quorum={quorum}"
        if self.strategy == "keep-oldest":
            oldest = min(
                seen, key=lambda a: (self._stamps.get(a, _FAR_FUTURE), a)
            )
            return oldest in live, f"oldest={oldest}"
        # keep-majority (default)
        if 2 * len(live) > len(seen):
            return True, f"majority {len(live)}/{len(seen)}"
        if 2 * len(live) == len(seen):
            # exact tie: the half containing the lowest address wins —
            # deterministic and complementary on both sides
            anchor = min(seen)
            return anchor in live, f"tie: anchor={anchor}"
        return False, f"minority {len(live)}/{len(seen)}"

    # -- handshake plane (transport threads) ------------------------- #

    def view(self) -> Tuple[int, List[str], Dict[str, int], bool]:
        """(fence, live members, join stamps, quarantined) — the
        ``mship`` frame's content."""
        with self._lock:
            return (
                self.fence,
                sorted(self._seen),
                dict(self._stamps),
                self.quarantined,
            )

    def merge_stamps(self, stamps: Dict[str, int]) -> None:
        """Min-merge a peer's join stamps (seniority converges)."""
        with self._lock:
            for address, stamp in stamps.items():
                mine = self._stamps.get(address)
                if mine is None or stamp < mine:
                    self._stamps[address] = stamp

    def adopt_fence(self, fence: int) -> bool:
        """Adopt a survivor's (higher) fence; True when it moved."""
        with self._lock:
            if fence <= self.fence:
                return False
            self.fence = fence
            return True

    def rejoin(self, fence: int) -> None:
        """Heal-time re-entry of a quarantined loser: adopt the
        survivor's era and start over as a sole member (peers re-admit
        through their own handshakes)."""
        with self._lock:
            self.quarantined = False
            if fence > self.fence:
                self.fence = fence
            self._downed.clear()
            self._unreachable.clear()
            self._deadline = None
            self._seen = {self.address}

    def disagreement(self, peer_doc: dict) -> List[str]:
        """Membership conflicts between a live peer's equal-fence view
        and ours: addresses the peer lists live that WE downed this
        era (or vice versa for our own live view).  Nonempty = the
        split-brain-suspected signal."""
        peer_live = set(peer_doc.get("members", []))
        with self._lock:
            if self.quarantined or peer_doc.get("quarantined"):
                return []
            # Only the downed-by-verdict direction is checked: a peer
            # still serving alongside someone WE downed is the genuine
            # split-brain signature.  ("Peer hasn't seen X yet" view
            # lag during ordinary joins must NOT fire the alert — each
            # side checks its own verdicts, so the asymmetric case is
            # still caught by whichever side reached one.)
            return sorted(peer_live & self._downed)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "strategy": self.strategy,
                "fence": self.fence,
                "seen": sorted(self._seen),
                "downed": sorted(self._downed),
                "pending_unreachable": sorted(self._unreachable),
                "quarantined": self.quarantined,
                "decisions": self.decisions,
            }
