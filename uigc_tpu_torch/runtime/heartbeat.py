"""Copy of ``uigc_tpu/runtime/heartbeat.py`` (pure Python, no change but
this header).

Phi-accrual heartbeat failure detection for the node transport.

EOF is a *lucky* failure signal: a kernel that tears the socket down on
process death.  A wedged peer, a pulled cable, or a partitioned network
produces silence, not EOF — so ``NodeFabric`` layers a heartbeat monitor
on the frame stream.  Every received frame counts as a heartbeat; the
monitor additionally pings each live peer every interval (a few dozen
bytes, keeping the peer's estimator fed even on an otherwise
one-directional link), and a phi-accrual estimator
(Hayashibara et al. 2004 — the same estimator Akka's remoting failure
detector uses) turns "how long since the last arrival" into a continuous
suspicion level.  When phi crosses the configured threshold the fabric
declares the peer dead *without waiting for EOF*, which drives the same
``MemberRemoved`` -> ``finalize_dead_link`` -> undo-log-quorum recovery
path as a torn socket.

Phi is ``-log10(P(a heartbeat arrives later than now))`` under a normal
model of the observed inter-arrival times: phi 1 means ~10% of healthy
gaps are this long, phi 8 means ~1e-8.  The estimator self-tunes to the
observed cadence, so GC pauses on a loaded host widen the window instead
of tripping it.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils import events

#: floor for P(later) so phi stays finite (caps phi at 128).
_MIN_P = 1e-128


class PhiAccrualFailureDetector:
    """Suspicion estimator for ONE peer, fed by arrival timestamps."""

    def __init__(
        self,
        threshold: float = 8.0,
        max_sample_size: int = 200,
        min_std_dev_s: float = 0.05,
        acceptable_pause_s: float = 0.5,
        first_heartbeat_estimate_s: float = 0.5,
    ):
        self.threshold = threshold
        self.acceptable_pause_s = acceptable_pause_s
        self.min_std_dev_s = min_std_dev_s
        self._intervals: deque = deque(maxlen=max_sample_size)
        # Bootstrap the distribution like Akka does: one synthetic sample
        # at the estimate with a wide spread, so the first real gap is
        # judged leniently.
        self._intervals.append(first_heartbeat_estimate_s)
        self._intervals.append(first_heartbeat_estimate_s * 2)
        self._last: Optional[float] = None
        self._lock = threading.Lock()

    def heartbeat(self, now: Optional[float] = None) -> None:
        """Record one arrival (any frame from the peer counts)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._last is not None:
                self._intervals.append(now - self._last)
            self._last = now

    def phi(self, now: Optional[float] = None) -> float:
        """Current suspicion level; 0.0 until the first arrival."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._last is None:
                return 0.0
            elapsed = now - self._last
            n = len(self._intervals)
            mean = sum(self._intervals) / n
            var = sum((x - mean) ** 2 for x in self._intervals) / n
        mean += self.acceptable_pause_s
        std = max(math.sqrt(var), self.min_std_dev_s)
        # Tail probability of the normal distribution via the logistic
        # approximation Akka's PhiAccrualFailureDetector uses.
        y = (elapsed - mean) / std
        if y < -20.0:
            # Far before the expected arrival (a generous acceptable
            # pause against a tight cadence): suspicion is zero, and
            # the cubic exponent below would overflow exp() for large
            # negative y — which used to abort the whole monitor tick
            # mid-loop and silently blind the detector for every peer
            # AFTER the freshly-heard one.
            return 0.0
        e = math.exp(-y * (1.5976 + 0.070566 * y * y))
        if elapsed > mean:
            p = e / (1.0 + e)
        else:
            p = 1.0 - 1.0 / (1.0 + e)
        return -math.log10(max(p, _MIN_P))

    def is_available(self, now: Optional[float] = None) -> bool:
        return self.phi(now) < self.threshold


class HeartbeatMonitor:
    """Periodic driver: pings every live peer, evaluates phi, and fires
    the down callback on a verdict.  One per NodeFabric.

    ``peers``   -> current list of peer addresses to watch
    ``ping``    -> send one heartbeat frame to an address
    ``on_down`` -> declare an address dead (called at most once each)
    """

    def __init__(
        self,
        interval_s: float,
        peers: Callable[[], List[str]],
        ping: Callable[[str], None],
        on_down: Callable[[str, float], None],
        threshold: float = 8.0,
        acceptable_pause_s: float = 0.5,
        origin: Optional[str] = None,
    ):
        self.interval_s = interval_s
        #: event-origin tag for the monitor's threads (the owning
        #: node's address; see utils/events.py set_thread_origin)
        self.origin = origin
        self._peers = peers
        self._ping = ping
        self._on_down = on_down
        self._threshold = threshold
        self._acceptable_pause_s = acceptable_pause_s
        self._detectors: Dict[str, PhiAccrualFailureDetector] = {}
        self._suspected: set = set()
        self._downed: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ping_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- #

    def detector_for(self, address: str) -> PhiAccrualFailureDetector:
        with self._lock:
            det = self._detectors.get(address)
            if det is None:
                det = self._detectors[address] = PhiAccrualFailureDetector(
                    threshold=self._threshold,
                    acceptable_pause_s=self._acceptable_pause_s,
                    # the ping cadence is the expected arrival cadence
                    first_heartbeat_estimate_s=max(self.interval_s, 0.05),
                )
            return det

    def record(self, address: str) -> None:
        """An arrival from ``address`` (any frame, not just heartbeats)."""
        self.detector_for(address).heartbeat()
        with self._lock:
            self._suspected.discard(address)

    def forget(self, address: str) -> None:
        with self._lock:
            self._detectors.pop(address, None)
            self._suspected.discard(address)

    def revive(self, address: str) -> None:
        """A downed peer was re-admitted (a heal rejoin or a fresh
        incarnation on the same address): start watching it again with
        a FRESH detector.  Without this the one-shot ``_downed`` latch
        would leave the rejoined peer unmonitored forever — its second
        death could only ever be detected by EOF."""
        with self._lock:
            self._downed.discard(address)
            self._suspected.discard(address)
            self._detectors.pop(address, None)

    def phi(self, address: str) -> float:
        return self.detector_for(address).phi()

    def phis(self) -> Dict[str, float]:
        """Current suspicion level per watched peer — the telemetry
        gauge tap (``uigc_link_phi``); sampled lazily at scrape time."""
        with self._lock:
            detectors = dict(self._detectors)
        return {address: det.phi() for address, det in detectors.items()}

    # ------------------------------------------------------------- #

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="node-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        events.set_thread_origin(self.origin)
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:  # pragma: no cover - keep the monitor alive
                import traceback

                traceback.print_exc()

    def _tick(self) -> None:
        now = time.monotonic()
        to_ping: List[str] = []
        for address in self._peers():
            with self._lock:
                if address in self._downed:
                    continue
            det = self.detector_for(address)
            phi = det.phi(now)
            if phi > self._threshold:
                with self._lock:
                    if address in self._downed:
                        continue
                    self._downed.add(address)
                self._on_down(address, phi)
                continue
            if phi > self._threshold / 2.0:
                with self._lock:
                    fresh = address not in self._suspected
                    self._suspected.add(address)
                if fresh:
                    events.recorder.commit(
                        events.NODE_SUSPECT, address=address, phi=phi
                    )
            to_ping.append(address)
        # Pings go out on their own thread: a wedged peer whose TCP
        # window filled would otherwise block THIS thread in sendall and
        # freeze phi evaluation for every peer — deadlocking the
        # detector on exactly the silent-death scenario it exists for.
        # If the previous ping round is still stuck, skip this one (its
        # silence is what the peers' detectors should see anyway).
        if to_ping and (self._ping_thread is None or not self._ping_thread.is_alive()):
            self._ping_thread = threading.Thread(
                target=self._ping_round,
                args=(to_ping,),
                name="node-heartbeat-ping",
                daemon=True,
            )
            self._ping_thread.start()

    def _ping_round(self, addresses: List[str]) -> None:
        events.set_thread_origin(self.origin)
        for address in addresses:
            try:
                self._ping(address)
            except Exception:  # pragma: no cover - best-effort pings
                pass
