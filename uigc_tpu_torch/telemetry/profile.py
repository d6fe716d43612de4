"""Copy of ``uigc_tpu/telemetry/profile.py`` (pure Python), held against
it by ``tests/test_torch_telemetry.py``.  Its device seconds are the
``tpu.device_trace`` timed events, and in the port each of them spans
this interval:

- ``engines/crgc/arrays.py`` ``compute_marks`` (the ``device`` and
  ``decremental`` backends) and ``_compute_marks_with_parents``: from
  the layout sync through the trace to the marks' host readback
  (``_readback``, a ``.cpu()`` copy that waits for the card).  So the
  block ends after the device work, and ``device_s`` is the host wall
  time of the whole device trace, host glue and syncs included: an
  upper bound of the card's busy time in it.
- ``engines/crgc/mesh.py`` ``compute_marks``: the same, ending at the
  gathered marks' readback.
- ``engines/crgc/mesh.py`` ``_start_wake`` (the pipelined
  ``mesh-decremental`` wake): the dispatch only.  The sharded wake reads
  its run flag on the host once per sweep, so the block ends once the
  last sweep is dispatched, before that sweep and the mark unpack finish on
  the card; the harvest that waits for them is timed as ``trace``.
- The pipelined ``decremental`` wake (``_WakeHandle``) commits no
  ``tpu.device_trace``, as in the reference: its dispatch and harvest
  count as ``trace`` host time, and ``device_s`` stays 0 for it.

Collector wake profiler: per-phase, device-vs-host wake attribution.

One Bookkeeper wake (``engines/crgc/collector.py collect()``) is the
unit of collection latency, but a single wall-clock number cannot say
*where* a slow wake went.  This profiler breaks every wake into the
pipeline's named phases:

- ``ingest``     draining the mutator entry queue + packed rows
- ``fold``       merging the drained batch into the shadow graph
- ``trace``      the liveness trace (mark computation; includes the
                 device kernel dispatch on device backends)
- ``sweep``      kill decisions + slot frees (attributed from the
                 ``crgc.sweep`` event every backend emits, and
                 subtracted from the enclosing trace bracket)
- ``broadcast``  delta-graph serialization + peer broadcast (multi-node)

Device time is attributed by hooking the ``tpu.device_trace`` event:
the profiler registers as a recorder listener and credits device
durations committed on the wake's thread to the active wake, so every
phase report carries both host wall time and the device share.

Dumps are BENCH-style JSON (one ``wake_profile`` document per node),
matching the ``tools/*_bench.py`` artifact convention.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils import events

PHASES = ("ingest", "fold", "trace", "sweep", "broadcast")

#: DEVICE_TRACE event fields copied into the per-wake record (the
#: fixpoint's per-sweep frontier decomposition; engines/crgc/arrays.py
#: _stamp_sweep_stats stamps them, tools/sweep_profile.py reads them)
_SWEEP_FIELDS = (
    "trace_mode", "n_sweeps", "sweep_dirty_chunks",
    "sweep_changed_supers", "sweep_tiles_skipped", "sweep_pull_on",
)


class _PhaseFrame:
    __slots__ = ("name", "acc", "last_start")

    def __init__(self, name: str, now: float):
        self.name = name
        self.acc = 0.0
        self.last_start = now


class _Phase:
    """Context manager charging exclusive time to one named phase; a
    nested phase pauses the enclosing one (so ``broadcast`` inside the
    ingest drain loop is never double-counted)."""

    __slots__ = ("wake", "name")

    def __init__(self, wake: "_Wake", name: str):
        self.wake = wake
        self.name = name

    def __enter__(self) -> "_Phase":
        now = time.perf_counter()
        stack = self.wake.stack
        if stack:
            top = stack[-1]
            top.acc += now - top.last_start
        stack.append(_PhaseFrame(self.name, now))
        return self

    def __exit__(self, *exc: Any) -> None:
        now = time.perf_counter()
        stack = self.wake.stack
        frame = stack.pop()
        frame.acc += now - frame.last_start
        self.wake.phases[frame.name] = (
            self.wake.phases.get(frame.name, 0.0) + frame.acc
        )
        if stack:
            stack[-1].last_start = now


class _Wake:
    """Accounting for one in-flight collector wake."""

    __slots__ = ("profiler", "thread", "t0", "start", "phases", "stack",
                 "device_s", "sweep_s", "trace_fields")

    def __init__(self, profiler: "WakeProfiler"):
        self.profiler = profiler
        self.thread = threading.get_ident()
        self.t0 = time.time()
        self.start = time.perf_counter()
        self.phases: Dict[str, float] = {}
        self.stack: List[_PhaseFrame] = []
        self.device_s = 0.0
        self.sweep_s = 0.0
        self.trace_fields: Dict[str, Any] = {}

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def end(self, **fields: Any) -> None:
        self.profiler._finish(self, time.perf_counter() - self.start, fields)


class WakeProfiler:
    """Per-system wake profiler.  Install as the engine's
    ``wake_profiler`` (the collector consults it each wake) and as a
    recorder listener (device/sweep attribution); both are done by
    :meth:`uigc_tpu.telemetry.Telemetry.attach`."""

    def __init__(self, node: str, max_recent: int = 256, registry=None):
        self.node = node
        self._lock = threading.Lock()
        self._active: Optional[_Wake] = None
        #: Prometheus face (optional): per-phase wake durations as one
        #: histogram labelled by phase, plus the device share — so the
        #: BENCH-JSON dump is no longer the only way to read the
        #: profiler (uigc.telemetry.metrics + wake-profile together).
        self._phase_hist = None
        self._device_hist = None
        if registry is not None:
            self._phase_hist = registry.histogram(
                "uigc_wake_phase_seconds",
                "Exclusive time of one collector-wake phase, by phase "
                "(ingest/fold/trace/sweep/broadcast).",
            )
            self._device_hist = registry.histogram(
                "uigc_wake_device_seconds",
                "Device-kernel share of one collector wake.",
            )
        self._wakes = 0
        self._wall_total = 0.0
        self._wall_max = 0.0
        self._totals: Dict[str, Dict[str, float]] = {
            name: {"total_s": 0.0, "max_s": 0.0, "device_total_s": 0.0}
            for name in PHASES
        }
        self._recent: deque = deque(maxlen=max_recent)
        self._entries_total = 0
        self._garbage_total = 0

    # -- wake lifecycle (called from the Bookkeeper thread) ---------- #

    def begin_wake(self) -> _Wake:
        wake = _Wake(self)
        self._active = wake
        return wake

    def _finish(self, wake: _Wake, wall_s: float, fields: Dict[str, Any]) -> None:
        self._active = None
        phases = {name: wake.phases.get(name, 0.0) for name in PHASES}
        # The sweep ran inside the trace bracket: report it as its own
        # phase and keep trace exclusive.
        phases["sweep"] += wake.sweep_s
        phases["trace"] = max(0.0, phases["trace"] - wake.sweep_s)
        record = {
            "t": wake.t0,
            "wall_s": wall_s,
            "device_s": wake.device_s,
            "phases": phases,
            **wake.trace_fields,
            **fields,
        }
        if record.get("n_sweeps") and wake.device_s > 0.0:
            # Per-sweep device attribution (uigc_tpu/telemetry/device.py):
            # the wake's measured device seconds distributed over its
            # sweeps by dirty-chunk weight.  Sums back to device_s by
            # construction, so downstream reports always reconcile with
            # this profiler's own device figure.
            from .device import sweep_attribution

            ms, bytes_est = sweep_attribution(
                wake.device_s,
                int(record["n_sweeps"]),
                record.get("sweep_dirty_chunks"),
            )
            record["sweep_device_ms"] = ms
            record["sweep_bytes_est"] = bytes_est
        if self._phase_hist is not None:
            for name in PHASES:
                self._phase_hist.observe(phases[name], phase=name)
            if self._device_hist is not None:
                self._device_hist.observe(wake.device_s)
        with self._lock:
            self._wakes += 1
            self._wall_total += wall_s
            if wall_s > self._wall_max:
                self._wall_max = wall_s
            self._entries_total += int(fields.get("entries", 0) or 0)
            self._garbage_total += int(fields.get("garbage", 0) or 0)
            for name in PHASES:
                totals = self._totals[name]
                totals["total_s"] += phases[name]
                if phases[name] > totals["max_s"]:
                    totals["max_s"] = phases[name]
            self._totals["trace"]["device_total_s"] += wake.device_s
            self._recent.append(record)

    # -- recorder listener (device / sweep attribution) -------------- #

    def __call__(self, name: str, fields: Dict[str, Any]) -> None:
        if name != events.DEVICE_TRACE and name != events.SWEEP:
            return
        wake = self._active
        if wake is None or wake.thread != threading.get_ident():
            return
        duration = fields.get("duration_s") or 0.0
        if name == events.DEVICE_TRACE:
            wake.device_s += duration
            # Per-sweep frontier decomposition stamped by the device
            # backends (arrays._stamp_sweep_stats / sweep_profile):
            # carried into the per-wake record — the data the
            # pull-density threshold is tuned from (PROFILING.md
            # "Reading sweep_profile").
            for key in _SWEEP_FIELDS:
                if key in fields:
                    wake.trace_fields[key] = fields[key]
        else:
            wake.sweep_s += duration

    # -- reading ----------------------------------------------------- #

    def wakes_since(self, t0: float) -> List[Dict[str, Any]]:
        """Recent wake records newer than ``t0`` (their ``t`` stamp),
        oldest first — the time-plane sampler's feed
        (uigc_tpu/telemetry/timeseries.py): each call hands over only
        the wakes completed since the last tick."""
        with self._lock:
            return [dict(r) for r in self._recent if r["t"] > t0]

    # -- export ------------------------------------------------------ #

    def to_json(self) -> Dict[str, Any]:
        """BENCH-style document: per-phase totals plus the recent wakes."""
        with self._lock:
            return {
                "bench": "wake_profile",
                "node": self.node,
                "wakes": self._wakes,
                "wall_total_s": self._wall_total,
                "wall_max_s": self._wall_max,
                "entries_total": self._entries_total,
                "garbage_total": self._garbage_total,
                "phases": {k: dict(v) for k, v in self._totals.items()},
                "recent": list(self._recent),
            }

    def dump(self, path: str) -> Dict[str, Any]:
        doc = self.to_json()
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
        return doc
