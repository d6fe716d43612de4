"""Copy of ``uigc_tpu/runtime/faults.py`` (pure Python).

Deterministic fault injection for the node transports.

Failure is a first-class, testable input to the runtime: a seeded
:class:`FaultPlan` is one policy object that both fabrics consult —
``NodeFabric`` (runtime/node.py) at its frame send/receive edges, and the
in-process ``Fabric`` (runtime/fabric.py) at its message admission edge —
generalizing the ad-hoc per-link drop filters into something a chaos test
or ``tools/chaos_bench.py`` can construct once and replay exactly.

Semantics at the sender edge (NodeFabric frames; since the writer-thread
transport, verdicts run on the destination peer's writer in STREAM order
— the order frames were queued, which is the order they would hit the
wire — so batching changes neither which frame a rule matches nor the
receiver-observable outcome):

- ``drop``      the frame is never transmitted but *consumes* a sequence
                number, so the receiver observes a gap (the wire analogue
                of a packet lost in flight after the egress stamp).
- ``duplicate`` the frame is transmitted twice with the SAME sequence
                number; the receiver's seq layer must discard the copy.
- ``reorder``   the frame is held and transmitted after the next frame on
                the link; the receiver sees an early frame (gap) and a
                late one (discarded as duplicate) — a reordering network
                under a FIFO transport contract.
- ``delay``     the link stalls: this frame and the next ``frames`` ones
                queue up, then release in order (FIFO preserved).
- ``truncate``  the frame body is cut in half; the receiver fails to
                decode it and drops it as corrupt.
- partitions    every frame between a partitioned pair drops (both
                directions) until ``heal`` — heartbeats included, which
                is how failure-detector tests starve a node.  With
                ``oneway=True`` only the a->b direction drops (a
                half-open link: a's sends vanish so b never hears a,
                while a still hears b — the asymmetric-failure case
                phi detectors disagree on), and
                ``heal_after(seconds)`` schedules the cut to mend by
                itself, so a chaos script can express flapping links as
                data instead of timer threads.
- ``crash_at``  after this node transmits its N-th protocol frame
                (heartbeats excluded — they are timer-driven and would
                make the crash point wall-clock-dependent), the fabric
                kills itself abruptly (``NodeFabric.die``): sockets close
                with whatever the kernel already accepted, nothing
                flushes — the in-process analogue of ``kill -9``.

Determinism: each (src, dst) link gets its own RNG stream derived from
the plan seed and the addresses (crc32, not the salted builtin hash), so
probability draws on one link are not perturbed by traffic interleaving
on another, and heartbeat frames (timer-driven, wall-clock-dependent)
never consume draws or crash budget unless a rule names ``"hb"``
explicitly.  Frame-level traces still depend on thread scheduling; the
guarantee chaos tests rely on is outcome determinism — the same seed
yields the same verdict distribution per link and the same crash point.
One caveat: a ``count=`` budget is ONE counter shared by every link the
rule matches, so thread interleaving decides which link spends it —
combine ``count`` with explicit src/dst (as the chaos tests do) when
per-link reproducibility matters.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from collections import Counter
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

from ..utils.validation import require

DELIVER = "deliver"
DROP = "drop"
DUPLICATE = "duplicate"
REORDER = "reorder"
DELAY = "delay"
TRUNCATE = "truncate"

_ACTIONS = (DROP, DUPLICATE, REORDER, DELAY, TRUNCATE)

#: Client-socket fault kinds (the gateway edge, uigc_tpu/gateway).
#: These model CLIENTS misbehaving, not links: the gateway's listener
#: and reader loops consult them via :meth:`FaultPlan.client_accept`
#: and :meth:`FaultPlan.client_inbound`.
SLOWLORIS = "slowloris"  # byte-trickle: the reader sees ~1 byte/round
HALF_OPEN = "half-open"  # bytes vanish, the socket never EOFs
FLOOD = "flood"  # connect flood: accept then slam the door

_CLIENT_KINDS = (SLOWLORIS, HALF_OPEN, TRUNCATE, FLOOD)


class _Rule:
    __slots__ = ("action", "src", "dst", "kind", "prob", "count", "match", "frames")

    def __init__(
        self,
        action: str,
        src: str,
        dst: str,
        kind: Any,
        prob: float,
        count: Optional[int],
        match: Optional[Callable[[Any], bool]],
        frames: int = 0,
    ):
        self.action = action
        self.src = src
        self.dst = dst
        self.kind = kind
        self.prob = prob
        self.count = count
        self.match = match
        self.frames = frames

    def applies(self, src: str, dst: str, kind: str) -> bool:
        if self.count is not None and self.count <= 0:
            return False
        if self.src != "*" and self.src != src:
            return False
        if self.dst != "*" and self.dst != dst:
            return False
        if self.kind != "*":
            kinds = (self.kind,) if isinstance(self.kind, str) else self.kind
            if kind not in kinds:
                return False
        return True


class FaultPlan:
    """A seeded, ordered set of fault rules plus live partitions and
    scheduled crashes.  Thread-safe; one instance may be shared by every
    node of an in-process cluster (links are keyed by address pair)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rules: List[_Rule] = []
        self._inbound: List[_Rule] = []
        self._partitions: set = set()  # frozenset({a, b})
        #: directed cuts: (src, dst) pairs ("*" wildcards allowed) that
        #: drop ONLY src->dst traffic — the half-open-link model
        self._oneway: set = set()
        #: scheduled heals: (monotonic deadline, a, b, oneway) —
        #: consulted lazily on every partition check, so no timer
        #: thread perturbs determinism
        self._heals: List[tuple] = []
        self._crash_at: Dict[str, int] = {}
        #: client-socket fault rules (gateway edge); src = the gateway
        #: address ("*" = any), kind = one of _CLIENT_KINDS
        self._client_rules: List[_Rule] = []
        #: sticky per-connection verdicts: a slowloris client stays a
        #: slowloris for the life of its connection
        self._client_verdicts: Dict[Tuple[str, int], str] = {}
        #: address -> [appends_remaining, keep_bytes, keep_fraction]
        #: for the torn-journal-append injection (crash-at-byte)
        self._journal_crash: Dict[str, list] = {}
        self._journal_appends: Counter = Counter()
        self._sent: Counter = Counter()
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        self._lock = threading.Lock()
        #: observed verdicts, keyed (action, src, dst) — for tests/benches
        self.stats: Counter = Counter()

    # ------------------------------------------------------------- #
    # Rule builders (chainable)
    # ------------------------------------------------------------- #

    def _add(self, rule: _Rule) -> "FaultPlan":
        with self._lock:
            self._rules.append(rule)
        return self

    def drop(self, src: str = "*", dst: str = "*", kind: Any = "*",
             prob: float = 1.0, count: Optional[int] = None) -> "FaultPlan":
        return self._add(_Rule(DROP, src, dst, kind, prob, count, None))

    def duplicate(self, src: str = "*", dst: str = "*", kind: Any = "*",
                  prob: float = 1.0, count: Optional[int] = None) -> "FaultPlan":
        return self._add(_Rule(DUPLICATE, src, dst, kind, prob, count, None))

    def reorder(self, src: str = "*", dst: str = "*", kind: Any = "*",
                prob: float = 1.0, count: Optional[int] = None) -> "FaultPlan":
        return self._add(_Rule(REORDER, src, dst, kind, prob, count, None))

    def delay(self, src: str = "*", dst: str = "*", kind: Any = "*",
              prob: float = 1.0, count: Optional[int] = None,
              frames: int = 4) -> "FaultPlan":
        """Stall the link: the matched frame and the next ``frames``
        frames queue and then release in order (FIFO preserved)."""
        return self._add(_Rule(DELAY, src, dst, kind, prob, count, None, frames))

    def truncate(self, src: str = "*", dst: str = "*", kind: Any = "*",
                 prob: float = 1.0, count: Optional[int] = None) -> "FaultPlan":
        return self._add(_Rule(TRUNCATE, src, dst, kind, prob, count, None))

    def drop_messages(self, src: str = "*", dst: str = "*",
                      match: Optional[Callable[[Any], bool]] = None,
                      prob: float = 1.0, count: Optional[int] = None) -> "FaultPlan":
        """Message-level inbound drop (after decode, before the ingress
        tally) — the generalization of the fabrics' drop filters."""
        with self._lock:
            self._inbound.append(_Rule(DROP, src, dst, "*", prob, count, match))
        return self

    def partition(self, a: str, b: str, oneway: bool = False) -> "FaultPlan":
        """Cut the link between ``a`` and ``b``.  Symmetric by default;
        ``oneway=True`` drops only a->b frames (b's detector starves,
        a's stays fed — the asymmetric verdict chaos tests script)."""
        with self._lock:
            if oneway:
                self._oneway.add((a, b))
            else:
                self._partitions.add(frozenset((a, b)))
        return self

    def heal(self, a: str, b: str) -> "FaultPlan":
        """Mend every cut between ``a`` and ``b`` (both directions,
        symmetric and one-way alike).  A ``"*"`` on EITHER side sweeps
        every cut naming the other endpoint — specific pairs and
        wildcard isolations alike — and ``heal("*", "*")`` mends
        everything; argument order never changes the outcome."""
        with self._lock:
            self._heal_locked(a, b)
        return self

    def _heal_locked(self, a: str, b: str) -> None:
        if a == "*" and b == "*":
            self._partitions.clear()
            self._oneway.clear()
            return
        if a == "*" or b == "*":
            named = b if a == "*" else a
            self._partitions = {
                p for p in self._partitions if named not in p
            }
            self._oneway = {
                p for p in self._oneway if named not in p
            }
            return
        # Specific pair: mend exactly these two endpoints' mutual cuts
        # (a wildcard isolation of either endpoint covers MORE than the
        # pair and deliberately stays).
        self._partitions.discard(frozenset((a, b)))
        self._oneway.discard((a, b))
        self._oneway.discard((b, a))

    def heal_after(
        self, seconds: float, a: str = "*", b: str = "*"
    ) -> "FaultPlan":
        """Schedule a heal: after ``seconds`` the cut(s) between ``a``
        and ``b`` (default: every partition) mend on their own — the
        primitive flapping-link scripts are built from
        (``partition(); heal_after(0.5); ...``), with no timer thread
        involved: due heals apply lazily on the next partition check."""
        with self._lock:
            self._heals.append((time.monotonic() + seconds, a, b))
        return self

    def isolate(self, address: str, oneway: bool = False) -> "FaultPlan":
        """Partition ``address`` from everyone (wildcard partition).
        ``oneway=True`` drops only the frames ``address`` SENDS — it
        goes silent to every peer (their detectors starve) while it
        still hears all of them."""
        with self._lock:
            if oneway:
                self._oneway.add((address, "*"))
            else:
                self._partitions.add(frozenset((address, "*")))
        return self

    def crash_at(self, address: str, after_frames: int) -> "FaultPlan":
        """Schedule an abrupt self-crash of ``address`` after it has
        transmitted (or dropped) ``after_frames`` frames."""
        with self._lock:
            self._crash_at[address] = after_frames
        return self

    def torn_journal_append(
        self,
        address: str,
        after_appends: int,
        keep_bytes: Optional[int] = None,
        keep_fraction: float = 0.5,
    ) -> "FaultPlan":
        """Crash-at-byte injection for the entity journal
        (uigc_tpu/cluster/journal.py): on ``address``'s N-th append
        (1-based, counted from now), only a PREFIX of the framed record
        reaches the file — ``keep_bytes`` bytes, or ``keep_fraction``
        of the frame when unset — and the journal goes dead, the way a
        process dies mid-``write``.  Recovery must stop replay cleanly
        at the last valid CRC frame and report ``journal.torn_record``."""
        with self._lock:
            self._journal_crash[address] = [
                int(after_appends),
                keep_bytes,
                keep_fraction,
            ]
        return self

    def client_fault(
        self,
        kind: str,
        gateway: str = "*",
        prob: float = 1.0,
        count: Optional[int] = None,
    ) -> "FaultPlan":
        """Arm one client-socket fault unit at the gateway edge:

        - ``SLOWLORIS``: the connection trickles — the reader loop
          processes at most one byte of it per select round, so frames
          take hundreds of rounds to complete (the classic
          hold-a-worker-hostage attack; a selector-based reader must
          not care).
        - ``HALF_OPEN``: the client vanished without FIN — its bytes
          stop being delivered but the socket never EOFs, so only
          idle/liveness accounting can reclaim it.
        - ``TRUNCATE``: the connection dies mid-frame — half the
          current read chunk arrives, then EOF.
        - ``FLOOD``: a connect flood — matched accepts are slammed shut
          before admission (the listener's cheap first line of
          defense); the gateway accounts them as ``shed{reason=flood}``.

        Verdicts are sticky per connection (drawn once, on the first
        inbound query) and deterministic in (seed, gateway, conn_id)."""
        require(
            kind in _CLIENT_KINDS,
            "fault.client_kind",
            f"unknown client fault kind {kind!r}",
        )
        with self._lock:
            self._client_rules.append(
                _Rule(kind, gateway, "*", kind, prob, count, None)
            )
        return self

    def client_accept(self, gateway: str, accept_seq: int) -> str:
        """Accept-time verdict for the ``accept_seq``-th connection the
        gateway's listener took: DELIVER, or DROP for a matched connect
        flood (close before admission)."""
        with self._lock:
            rng = self._rng(gateway, "client-accept")
            for rule in self._client_rules:
                if rule.kind != FLOOD or not rule.applies(gateway, "*", FLOOD):
                    continue
                if rule.prob < 1.0 and rng.random() >= rule.prob:
                    continue
                if rule.count is not None:
                    rule.count -= 1
                self.stats[("client-flood", gateway, "")] += 1
                return DROP
        return DELIVER

    def client_inbound(self, gateway: str, conn_id: int) -> str:
        """Sticky read-path verdict for one client connection:
        DELIVER, SLOWLORIS, HALF_OPEN or TRUNCATE.  Drawn once per
        connection from the (seed, gateway, conn_id) RNG stream."""
        key = (gateway, conn_id)
        with self._lock:
            verdict = self._client_verdicts.get(key)
            if verdict is not None:
                return verdict
            verdict = DELIVER
            rng = self._rng(gateway, f"client-{conn_id}")
            for rule in self._client_rules:
                if rule.kind == FLOOD or not rule.applies(
                    gateway, "*", rule.kind
                ):
                    continue
                if rule.prob < 1.0 and rng.random() >= rule.prob:
                    continue
                if rule.count is not None:
                    rule.count -= 1
                verdict = rule.action
                self.stats[("client-" + verdict, gateway, "")] += 1
                break
            self._client_verdicts[key] = verdict
            return verdict

    # ------------------------------------------------------------- #
    # Fabric-facing queries
    # ------------------------------------------------------------- #

    def _rng(self, src: str, dst: str) -> random.Random:
        key = (src, dst)
        rng = self._rngs.get(key)
        if rng is None:
            stream = zlib.crc32(f"{self.seed}|{src}|{dst}".encode())
            rng = self._rngs[key] = random.Random((self.seed << 32) ^ stream)
        return rng

    def _partitioned(self, src: str, dst: str) -> bool:
        # Caller holds self._lock.  Apply due scheduled heals first so
        # a healed link delivers from the very next frame.
        if self._heals:
            now = time.monotonic()
            due = [h for h in self._heals if h[0] <= now]
            if due:
                self._heals = [h for h in self._heals if h[0] > now]
                for _deadline, a, b in due:
                    self._heal_locked(a, b)
        if (
            frozenset((src, dst)) in self._partitions
            or frozenset((src, "*")) in self._partitions
            or frozenset((dst, "*")) in self._partitions
        ):
            return True
        if self._oneway:
            ow = self._oneway
            return (
                (src, dst) in ow
                or (src, "*") in ow
                or ("*", dst) in ow
            )
        return False

    def outbound(self, src: str, dst: str, kind: str) -> Tuple[str, int]:
        """Verdict for one outbound frame on link src->dst.  Returns
        (action, frames) where frames is only meaningful for DELAY.

        Heartbeat frames (kind ``"hb"``) are timer-driven, so their
        count before the N-th protocol frame is wall-clock-dependent;
        letting wildcard rules draw on them would perturb the per-link
        RNG streams across runs.  They therefore match only rules that
        name ``"hb"`` explicitly — partitions still drop them, which is
        how failure-detector tests starve a node."""
        with self._lock:
            if self._partitioned(src, dst):
                self.stats[(DROP, src, dst)] += 1
                return DROP, 0
            rng = self._rng(src, dst)
            for rule in self._rules:
                if kind == "hb" and rule.kind == "*":
                    continue
                if not rule.applies(src, dst, kind):
                    continue
                if rule.prob < 1.0 and rng.random() >= rule.prob:
                    continue
                if rule.count is not None:
                    rule.count -= 1
                self.stats[(rule.action, src, dst)] += 1
                return rule.action, rule.frames
        return DELIVER, 0

    def drop_inbound(self, src: str, dst: str, msg: Any) -> bool:
        """Message-level inbound verdict (post-decode, pre-ingress)."""
        with self._lock:
            if self._partitioned(src, dst):
                self.stats[(DROP, src, dst)] += 1
                return True
            rng = self._rng(src, dst)
            for rule in self._inbound:
                if not rule.applies(src, dst, "*"):
                    continue
                if rule.match is not None and not rule.match(msg):
                    continue
                if rule.prob < 1.0 and rng.random() >= rule.prob:
                    continue
                if rule.count is not None:
                    rule.count -= 1
                self.stats[(DROP, src, dst)] += 1
                return True
        return False

    def record_sent(self, address: str, kind: str = "") -> bool:
        """Count one transmitted-or-dropped frame for ``address``;
        True when its scheduled crash point is reached (exactly once).
        Heartbeat frames are not counted — they are timer-driven, so
        counting them would make the crash point wall-clock-dependent
        instead of a deterministic position in the protocol stream."""
        if kind == "hb":
            return False
        with self._lock:
            self._sent[address] += 1
            at = self._crash_at.get(address)
            if at is not None and self._sent[address] >= at:
                del self._crash_at[address]
                return True
        return False

    def journal_append(self, address: str, nbytes: int) -> Optional[int]:
        """Torn-append verdict for one journal record of ``nbytes``
        framed bytes about to be written by ``address``.  Returns None
        to write fully, or the number of bytes (< nbytes) to write
        before the simulated crash; the trigger fires exactly once."""
        with self._lock:
            spec = self._journal_crash.get(address)
            self._journal_appends[address] += 1
            if spec is None:
                return None
            spec[0] -= 1
            if spec[0] > 0:
                return None
            del self._journal_crash[address]
            keep = spec[1]
            if keep is None:
                keep = int(nbytes * spec[2])
            keep = max(1, min(int(keep), nbytes - 1))
            self.stats[("torn-journal", address, "")] += 1
            return keep

    def frames_sent(self, address: str) -> int:
        with self._lock:
            return self._sent[address]
