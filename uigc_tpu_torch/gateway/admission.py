"""Copy of ``uigc_tpu/gateway/admission.py`` (pure Python, no imports
of the package), except one repair (ROADMAP.md Queue 3 item 14):
:meth:`OverloadController.shedding` empties its latency window when it
begins to shed, so the latency band is judged only on samples observed
since.  While it sheds, the gateway admits nothing and no sample
arrives: the reference keeps judging the samples that made it shed and
never leaves.  Here the empty window reads as clear, the depth signal
decides the exit, and the commands admitted after it refill the window.

Admission control: who gets in, and when the door closes.

Three independent gates, consulted in order on the reader threads:

1. :class:`TokenAuth` — the CONNECT frame's token maps to a tenant
   (``uigc.gateway.auth-tokens``); an empty spec runs the gateway open,
   trusting the client-supplied tenant label.
2. :class:`TenantQuotas` — per-tenant connection caps and a msgs/s
   token bucket, so one hot tenant cannot starve the rest of the edge.
3. :class:`OverloadController` — the load shedder.  It watches the
   admitted-traffic p99 (time from decode to routed) and the fabric
   writer-queue depth; when either crosses its band the gateway sheds
   NEW work with clean ERROR(retry-after) frames while admitted traffic
   keeps its latency.  Hysteresis (exit at a fraction of the entry
   band) keeps it from flapping at the boundary.

Every gate is pure bookkeeping over caller-supplied clocks — no
threads, no sockets — so the units test in microseconds.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional


class TokenAuth:
    """``uigc.gateway.auth-tokens`` parser + authenticator.

    The spec is ``token=tenant[,token=tenant...]``; an empty spec means
    open admission (every token accepted, tenant taken from the CONNECT
    frame, ``"public"`` when absent)."""

    __slots__ = ("_tokens", "open")

    def __init__(self, spec: str) -> None:
        self._tokens: Dict[str, str] = {}
        for pair in (spec or "").split(","):
            token, sep, tenant = pair.strip().partition("=")
            if sep and token:
                self._tokens[token] = tenant or "public"
        self.open = not self._tokens

    def authenticate(self, token: object, tenant: object) -> Optional[str]:
        """-> tenant name when admitted, None when rejected."""
        if self.open:
            return tenant if isinstance(tenant, str) and tenant else "public"
        if isinstance(token, str):
            return self._tokens.get(token)
        return None


class TenantQuotas:
    """Per-tenant connection counts and msgs/s token buckets.

    The bucket holds one second of budget (burst == rate): an idle
    tenant cannot bank unlimited credit, a bursty one smooths to its
    configured rate.  ``msgs_per_sec == 0`` disables rate limiting.
    Callers pass a monotonic ``now`` so tests never sleep."""

    __slots__ = ("max_conns", "msgs_per_sec", "_conns", "_buckets")

    def __init__(self, max_conns: int, msgs_per_sec: float) -> None:
        self.max_conns = max_conns
        self.msgs_per_sec = float(msgs_per_sec)
        self._conns: Dict[str, int] = {}
        self._buckets: Dict[str, list] = {}  # tenant -> [tokens, stamp]

    def try_connect(self, tenant: str) -> bool:
        held = self._conns.get(tenant, 0)
        if self.max_conns and held >= self.max_conns:
            return False
        self._conns[tenant] = held + 1
        return True

    def disconnect(self, tenant: str) -> None:
        held = self._conns.get(tenant, 0)
        if held <= 1:
            self._conns.pop(tenant, None)
        else:
            self._conns[tenant] = held - 1

    def connections(self, tenant: str) -> int:
        return self._conns.get(tenant, 0)

    def admit_msgs(self, tenant: str, count: int, now: float) -> int:
        """How many of ``count`` messages the tenant's bucket admits at
        ``now`` (the rest are shed with ERR_MSG_RATE)."""
        if not self.msgs_per_sec or count <= 0:
            return count
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = [self.msgs_per_sec, now]
            self._buckets[tenant] = bucket
        tokens, stamp = bucket
        tokens = min(
            self.msgs_per_sec, tokens + (now - stamp) * self.msgs_per_sec
        )
        admitted = min(count, int(tokens))
        bucket[0] = tokens - admitted
        bucket[1] = now
        return admitted


class OverloadController:
    """The shed decision: a hysteresis band over admitted p99 and
    writer-queue depth.

    ``observe(ms)`` records one admitted command's decode-to-routed
    latency; ``note_depth(depth)`` records the worst fabric writer
    queue.  ``shedding(now)`` flips ON when either signal crosses its
    band and OFF only when BOTH have fallen to the exit fraction, with
    a minimum dwell so a single spike cannot strobe the door."""

    __slots__ = (
        "p99_band_ms",
        "depth_band",
        "_ring",
        "_depth",
        "_shedding",
        "_since",
        "shed_entered_total",
    )

    #: Exit hysteresis: leave shedding when p99 < 0.8 band AND
    #: depth < 0.5 band.
    _EXIT_P99 = 0.8
    _EXIT_DEPTH = 0.5
    #: Minimum seconds in either state before flipping.
    _DWELL_S = 0.25

    def __init__(self, p99_band_ms: float, depth_band: int) -> None:
        self.p99_band_ms = float(p99_band_ms)
        self.depth_band = int(depth_band)
        self._ring: deque = deque(maxlen=512)
        self._depth = 0
        self._shedding = False
        self._since = 0.0
        self.shed_entered_total = 0

    def observe(self, latency_ms: float) -> None:
        self._ring.append(latency_ms)

    def note_depth(self, depth: int) -> None:
        self._depth = depth

    def admitted_p99_ms(self) -> float:
        if not self._ring:
            return 0.0
        stats = sorted(self._ring)
        return stats[min(len(stats) - 1, (len(stats) * 99) // 100)]

    def shedding(self, now: float) -> bool:
        if now - self._since < self._DWELL_S:
            return self._shedding
        p99 = self.admitted_p99_ms()
        if self._shedding:
            if (
                p99 < self.p99_band_ms * self._EXIT_P99
                and self._depth < self.depth_band * self._EXIT_DEPTH
            ):
                self._shedding = False
                self._since = now
        else:
            over_p99 = self.p99_band_ms and p99 > self.p99_band_ms
            over_depth = self.depth_band and self._depth > self.depth_band
            if over_p99 or over_depth:
                self._shedding = True
                self._since = now
                self.shed_entered_total += 1
                # the samples that closed the door are spent: judge the
                # exit on what is admitted from here on
                self._ring.clear()
        return self._shedding
