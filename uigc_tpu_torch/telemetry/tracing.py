"""Copy of ``uigc_tpu/telemetry/tracing.py`` (pure Python), held against
it by ``tests/test_torch_telemetry.py``.

Causal message tracing with Chrome-trace/Perfetto export.

The reference has no cross-node causality story at all — JFR events are
per-JVM and correlate only by wall clock.  This tracer stamps every
traced send with a ``(trace_id, span_id)`` context that rides the
message envelope locally and the ``NodeFabric`` frame header across
processes (``runtime/node.py``; version-tolerant — a peer with tracing
off, or an older frame layout, simply ignores it), so a multi-node
send -> remote invoke -> GC wave -> terminate renders as one
causally-linked timeline.

Span vocabulary (all recorded into a bounded ring, oldest dropped):

- ``send``      a traced message left an actor (instant; the context it
                returns is what propagates)
- ``invoke``    a traced message is being processed by its recipient
                (child of the send, possibly on another node)
- ``gc_wave``   one collector wake (its context becomes ``last_wave``)
- ``terminate`` an actor reached its terminal state (child of the
                current span if the stop was processed inside one,
                otherwise of the wave that sent the StopMsg)
- ``uigc.*``    the port's own host code under an open span: the mark
                fixpoint's seed, sweeps, waits and glue, and
                ``compute_marks``'s layout sync, upload and readback
                (``utils/events.py`` ``span``; children of the
                ``gc_wave`` they run in)

Export: :func:`chrome_trace` merges any number of tracers (one per
node) into the Chrome ``traceEvents`` JSON consumed by
``chrome://tracing`` and Perfetto, with flow arrows for parent->child
edges that cross nodes.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..utils import events

#: Wire shape of a trace context: ``(trace_id, span_id)`` — two ints,
#: pickle- and JSON-friendly.  This is what rides message envelopes
#: (``msg.trace_ctx``) and NodeFabric frame headers.
TraceHeader = Tuple[int, int]

_ID_TLS = threading.local()


def _new_id() -> int:
    """63-bit random id (positive, JSON-safe).  Per-thread PRNG seeded
    once from the OS — id generation sits on the traced send hot path,
    where a getrandom syscall per id would dominate the tracing cost."""
    rng = getattr(_ID_TLS, "rng", None)
    if rng is None:
        rng = _ID_TLS.rng = random.Random(os.urandom(16))
    return rng.getrandbits(63)


def decode_header(obj: Any) -> Optional[TraceHeader]:
    """Version-tolerant header validation: anything that is not a pair
    of non-negative ints is treated as absent, never an error — an
    unknown future header layout must not break delivery."""
    if (
        isinstance(obj, tuple)
        and len(obj) == 2
        and isinstance(obj[0], int)
        and isinstance(obj[1], int)
        and obj[0] >= 0
        and obj[1] >= 0
    ):
        return obj
    return None


class _ActiveSpan:
    """An open span.  While it is open its tracer is the thread's open
    tracer in ``utils/events.py``, so the port's ``events.span`` sites
    (the mark fixpoint's) record as its children."""

    __slots__ = ("tracer", "name", "ctx", "parent", "args", "start", "prev",
                 "prev_tracer")

    def __init__(self, tracer: "Tracer", name: str, ctx: TraceHeader,
                 parent: Optional[TraceHeader], args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.ctx = ctx
        self.parent = parent
        self.args = args
        self.start = 0.0
        self.prev: Optional[TraceHeader] = None
        self.prev_tracer: Optional["Tracer"] = None

    def __enter__(self) -> "_ActiveSpan":
        tls = self.tracer._tls
        self.prev = getattr(tls, "ctx", None)
        tls.ctx = self.ctx
        self.prev_tracer = events.swap_span_tracer(self.tracer)
        self.start = time.time()
        return self

    def __exit__(self, *exc: Any) -> None:
        end = time.time()
        self.tracer._tls.ctx = self.prev
        events.swap_span_tracer(self.prev_tracer)
        self.tracer._record(
            self.name, self.ctx, self.parent, self.start, end - self.start, self.args
        )


class Tracer:
    """Per-system span recorder with thread-local context propagation.

    ``enabled`` is checked by every instrumentation site before doing
    any work, so a disabled tracer costs one attribute read."""

    def __init__(self, node: str, enabled: bool = False, max_spans: int = 65536):
        self.node = node
        self.enabled = enabled
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)
        #: context of the most recent gc_wave span — the causal parent
        #: for terminations whose StopMsg carries no context (the
        #: collector's kill order is a singleton message).
        self.last_wave: Optional[TraceHeader] = None

    # -- context ---------------------------------------------------- #

    def current(self) -> Optional[TraceHeader]:
        return getattr(self._tls, "ctx", None)

    def adopt(self, header: Any) -> Optional[TraceHeader]:
        return decode_header(header)

    # -- recording -------------------------------------------------- #

    def _record(
        self,
        name: str,
        ctx: TraceHeader,
        parent: Optional[TraceHeader],
        ts: float,
        dur: float,
        args: Dict[str, Any],
    ) -> None:
        record = {
            "name": name,
            "node": self.node,
            "trace_id": ctx[0],
            "span_id": ctx[1],
            "parent_id": parent[1] if parent else None,
            "ts": ts,
            "dur": dur,
            "tid": threading.get_ident(),
            "args": args,
        }
        with self._lock:
            self._spans.append(record)

    def span(
        self,
        name: str,
        parent: Optional[TraceHeader] = None,
        **args: Any,
    ) -> _ActiveSpan:
        """Open a span as a context manager.  ``parent=None`` chains to
        the thread's current context; an explicit parent (e.g. a remote
        header) continues that trace instead."""
        if parent is None:
            parent = self.current()
        trace_id = parent[0] if parent else _new_id()
        ctx = (trace_id, _new_id())
        return _ActiveSpan(self, name, ctx, parent, args)

    def instant(
        self,
        name: str,
        parent: Optional[TraceHeader] = None,
        **args: Any,
    ) -> TraceHeader:
        """Record a zero-duration span; returns its context."""
        if parent is None:
            parent = self.current()
        trace_id = parent[0] if parent else _new_id()
        ctx = (trace_id, _new_id())
        self._record(name, ctx, parent, time.time(), 0.0, args)
        return ctx

    def on_send(self, **args: Any) -> TraceHeader:
        """One traced send: records the ``send`` instant under the
        current context and returns the header the message should
        carry — the remote ``invoke`` becomes its child."""
        return self.instant("send", **args)

    def note_wave(self, ctx: TraceHeader) -> None:
        self.last_wave = ctx

    # -- export ----------------------------------------------------- #

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


def chrome_trace(tracers: Iterable[Tracer]) -> Dict[str, Any]:
    """Merge spans from any number of tracers (one per node) into the
    Chrome ``traceEvents`` format.

    Every span becomes a complete event (``ph: "X"``) with its trace and
    span ids in ``args``; parent->child edges whose endpoints live on
    different nodes additionally get a flow arrow (``ph: "s"``/``"f"``)
    keyed by the child span id, which is what draws the cross-node
    causality line in the viewer."""
    tracers = list(tracers)
    spans: List[Dict[str, Any]] = []
    for tracer in tracers:
        spans.extend(tracer.spans())

    pids: Dict[str, int] = {}
    trace_events: List[Dict[str, Any]] = []
    for tracer in tracers:
        if tracer.node not in pids:
            pid = pids[tracer.node] = len(pids) + 1
            trace_events.append(
                {
                    "ph": "M",
                    "name": "process_name",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": tracer.node},
                }
            )

    by_span: Dict[int, Dict[str, Any]] = {s["span_id"]: s for s in spans}
    for s in spans:
        pid = pids.setdefault(s["node"], len(pids) + 1)
        ts_us = s["ts"] * 1e6
        dur_us = max(s["dur"] * 1e6, 1.0)
        trace_events.append(
            {
                "ph": "X",
                "name": s["name"],
                "pid": pid,
                "tid": s["tid"],
                "ts": ts_us,
                "dur": dur_us,
                "args": dict(
                    s["args"],
                    trace_id=f"{s['trace_id']:x}",
                    span_id=f"{s['span_id']:x}",
                    parent_id=(
                        f"{s['parent_id']:x}" if s["parent_id"] is not None else None
                    ),
                ),
            }
        )
        parent = by_span.get(s["parent_id"]) if s["parent_id"] is not None else None
        if parent is not None and parent["node"] != s["node"]:
            parent_pid = pids.setdefault(parent["node"], len(pids) + 1)
            flow = {"cat": "uigc", "name": "causal", "id": s["span_id"]}
            trace_events.append(
                dict(
                    flow,
                    ph="s",
                    pid=parent_pid,
                    tid=parent["tid"],
                    ts=parent["ts"] * 1e6,
                )
            )
            trace_events.append(
                dict(flow, ph="f", bp="e", pid=pid, tid=s["tid"], ts=ts_us)
            )
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracers: Iterable[Tracer]) -> Dict[str, Any]:
    doc = chrome_trace(tracers)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc
