"""Copy of ``uigc_tpu/engines/crgc/messages.py`` (pure Python).

CRGC wire messages (reference: crgc/GCMessage.scala:7-21)."""

from __future__ import annotations

from typing import Any, Iterable, Tuple

from ...interfaces import GCMessage, Refob


class AppMsg(GCMessage):
    """An application message wrapped with the refs it carries.  The
    ``window_id`` is stamped by the egress when the message crosses a node
    boundary (reference: GCMessage.scala:7-13, Gateways.scala:83)."""

    __slots__ = ("payload", "_refs", "window_id", "external", "trace_ctx")

    def __init__(self, payload: Any, refs: Iterable[Refob], external: bool = False):
        self.payload = payload
        self._refs: Tuple[Refob, ...] = tuple(refs)
        self.window_id = -1
        #: causal-tracing context, a ``(trace_id, span_id)`` pair or
        #: None (uigc_tpu/telemetry/tracing.py); stamped by the engine's
        #: send path when tracing is on, and carried across node
        #: boundaries in the transport frame header.
        self.trace_ctx = None
        #: True for messages wrapped by the root adapter (sent by
        #: unmanaged code).  External sends carry no sender-side
        #: send-count, so counting them as received would leave the
        #: recipient's receive balance permanently nonzero — the reference
        #: tolerates this because it never collects root shadows at all;
        #: we skip the count so dead roots' shadows can be reclaimed.
        self.external = external

    @property
    def refs(self) -> Tuple[Refob, ...]:
        return self._refs

    def __repr__(self) -> str:
        return f"AppMsg({self.payload!r})"


class _StopMsg(GCMessage):
    """Collector-to-actor kill order (reference: GCMessage.scala:15-17)."""

    __slots__ = ()

    @property
    def refs(self) -> Tuple[Refob, ...]:
        return ()

    def __repr__(self) -> str:
        return "StopMsg"


class _WaveMsg(GCMessage):
    """Wave-style flush trigger, forwarded down the spawn tree
    (reference: GCMessage.scala:19-21, CRGC.scala:137-144)."""

    __slots__ = ()

    @property
    def refs(self) -> Tuple[Refob, ...]:
        return ()

    def __repr__(self) -> str:
        return "WaveMsg"


StopMsg = _StopMsg()
WaveMsg = _WaveMsg()
