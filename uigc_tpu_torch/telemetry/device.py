"""Port of ``uigc_tpu/telemetry/device.py``, held against it by
``tests/test_torch_device_telemetry.py``.  What differs from the
reference:

- **Device bytes.**  Every ``torch.Tensor`` is device state, whatever
  its device, and numpy arrays are host state: the counterpart of the
  reference counting every ``jax.Array`` as device, on the CPU backend
  too.  So the ledger of a graph on the CPU equals the reference's byte
  for byte per family, and on the card it counts the CUDA tensors.
- **Families.**  ``_FAMILY_ATTRS`` is the reference's table.  The
  port's graphs have every attribute it names but ``_zero_words`` (the
  reference's cached zero word array, dropped on purpose by
  ``engines/crgc/mesh.py``), which reads 0 bytes.
- **Build seconds.**  The ``jax.monitoring`` hookup is gone.  What the
  port builds is the propagate kernel (``nvcc``,
  ``ops/propagate.py:build_library``) and the native data plane
  (``g++``, ``native/__init__.py:_build``); both record their seconds in
  ``utils/platform.py``'s process-wide build log, which the observatory
  reads into ``uigc_compile_seconds{tag}`` and the document's
  ``compile.kernel_build`` (the reference's ``compile.jax_backend``).
- **Compile events: one rule.**  A cache keyed by layout geometry
  commits ``tpu.compile`` with ``hit`` true or false on every lookup: a
  miss is a new geometry, and the ``recompile_storm`` alert reads that
  churn.  The port has two such caches, ``ops/cuda_trace.py:
  get_trace_fn_multi`` (tag ``trace_fn``) and ``ops/cuda_decremental.py:
  get_wake_fn`` (tag ``dec_wake``).  A path with no such cache commits
  nothing: the mesh backend (``engines/crgc/mesh.py``) builds its
  sharded trace per call and compiles nothing per shape.
- **Donation audit.**  The port updates device state in place where
  the reference donates buffers; ``engines/crgc/arrays.py:
  audit_donation`` commits ``tpu.donation_copy`` when an update left a
  tensor on new storage (a silent copy, the same bug class).

Device-plane observatory: HBM/array ledger, compile-cache telemetry,
per-sweep kernel attribution.

The wake profiler (:mod:`uigc_tpu.telemetry.profile`) says *which phase*
of a wake was slow; this module answers the device-plane questions the
phase brackets cannot: which array family holds how many bytes (and what
the high-water mark was), whether a jit/pjit cache is being missed every
wake (the recompile-storm class of bug — a multi-system pjit deadlock
of the JAX package was found by hand; the ``recompile_storm`` alert exists so the
next one fires a page instead of hanging tier-1), whether a
supposedly-donated buffer silently copied, and how many bytes crossed
device->host on a hot path.  It is the measurement substrate the
adaptive-strategy work (ROADMAP items 1 and 5) presupposes: per-sweep,
per-pass numbers, not per-wake wall clock.

Three planes, all fed through the existing recorder-listener
architecture (no engine imports — the observatory reads graphs
duck-typed, like the metrics gauges, and everything else arrives as
structured events):

- **memory ledger** — :func:`ledger_families` walks a shadow graph's
  known array families (host mirrors, device-resident operands, the
  bookkeeping maps) read-only and tallies bytes per family;
  :meth:`DeviceObservatory.on_wake` samples it on the collector thread
  (fold-consistent) and tracks per-family peak watermarks.  Exposed as
  ``uigc_device_ledger_bytes{family=...}`` callback gauges.
- **compile-cache telemetry** — the engine/ops compile caches commit
  ``tpu.compile`` events (tag + geometry key + hit/miss); the
  observatory folds them into ``uigc_compile_{hits,misses}_total{tag}``
  and a ``uigc_compile_seconds`` histogram (the nvcc and g++ build
  seconds additionally come from the build log).  The
  ``recompile_storm`` built-in alert is a rate rule over the miss
  counter.
- **host-transfer accounting + donation audit** — the annotated
  readback sites in ``engines/crgc`` commit ``tpu.host_transfer``
  (site, bytes); donating call sites audit their operands after the
  call and commit ``tpu.donation_copy`` when an update in place left
  its tensor on new storage.  Transfers are attributed to the
  active wake's open profiler phase — the listener runs synchronously
  on the committing thread, so reading the profiler's active-wake stack
  is race-free.

Per-sweep attribution: the fixpoint's sweeps are not timed one by one
(the wake is timed whole), so per-sweep device timings are not
separable without instrumenting the kernel.  :func:`sweep_attribution` distributes the
wake's measured device seconds across sweeps weighted by each sweep's
dirty-chunk count (the frontier stats the fixpoint streams back), plus
a coarse bytes-touched model — an explicitly labelled *estimate* whose
total always reconciles with the measured device time by construction.

``tools/device_report.py`` renders :meth:`DeviceObservatory.to_doc`
(also served as ``/device`` on the metrics HTTP server) into the
wake-budget attribution report; ``tools/uigc_top.py`` shows the same
doc as a device panel.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils import events, platform

#: Coarse bytes-touched model: one dirty walk chunk covers 32,768 node
#: bits (the pre-hierarchy granularity PERF_WAKE.md names); a sweep
#: touching it reads the mark words, writes them back, and reads the
#: packed layout rows gated to it — modelled as three 4KB streams.
#: An estimate for *relative* attribution, not a bandwidth claim.
CHUNK_BYTES_EST = 3 * (32768 // 8)

#: Per-entry byte estimates for the bookkeeping maps the ledger cannot
#: measure exactly (CPython dict/list overhead; coarse on purpose —
#: the ledger's job is catching growth that never comes back down, and
#: a constant factor cancels in that comparison).
_DICT_ENTRY_EST = 96
_LIST_ENTRY_EST = 72


def _array_bytes(x: Any) -> Tuple[int, bool]:
    """(nbytes, is_device) of one array-like; (0, False) for anything
    else.  Every ``torch.Tensor`` is device state, whatever its device;
    numpy arrays are host state."""
    if isinstance(x, torch.Tensor):
        return x.nelement() * x.element_size(), True
    nbytes = getattr(x, "nbytes", None)
    if nbytes is None or isinstance(x, (bytes, bytearray, memoryview)):
        return 0, False
    try:
        return int(nbytes), False
    except Exception:
        return 0, False


def _tally(out: Dict[str, int], x: Any, depth: int = 0) -> None:
    """Fold one object (array, or a dict/list/tuple of arrays) into a
    {host, device, items} tally."""
    nbytes, device = _array_bytes(x)
    if nbytes:
        out["device" if device else "host"] += nbytes
        out["items"] += 1
        return
    if depth >= 2:
        return
    if isinstance(x, dict):
        for v in list(x.values()):
            _tally(out, v, depth + 1)
    elif isinstance(x, (list, tuple)):
        for v in list(x):
            _tally(out, v, depth + 1)


#: (family, attribute names) groups duck-typed off the shadow graph.
#: Missing attributes contribute nothing — the same walk serves the
#: host array graph, the device/decremental graph and the mesh graph.
_FAMILY_ATTRS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("node_features", (
        "flags", "recv_count", "supervisor", "_br_seq", "_sup_seq",
        "_slot_uid", "_uid_to_slot", "_recv_synced",
    )),
    ("edges", ("edge_src", "edge_dst", "edge_weight")),
    ("parents", ("last_parents", "last_parents_mark")),
    ("jump", ("_jump_parent", "_jump_dev")),
    ("device_nodes", ("_dev_flags", "_dev_recv")),
    ("device_layout", ("_dev_stacked", "_stacked")),
    ("device_buckets", ("_dev_psrc", "_dev_pdst", "_pb_src", "_pb_dst")),
    ("wake_state", ("_wake_state", "_pending_wake", "_zero_words")),
)

#: sub-objects whose ``vars()`` are scanned generically for arrays —
#: the incremental layout and the decremental tracer own device mirrors
#: the graph only references indirectly.
_SCAN_ATTRS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("incremental_layout", ("_inc",)),
    ("decremental_tracer", ("_dec",)),
)


def _scan_object(out: Dict[str, int], obj: Any, depth: int = 0) -> None:
    """Tally every array reachable through one object's ``__dict__``
    (one level of nested layout objects)."""
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for value in list(d.values()):
        nbytes, _device = _array_bytes(value)
        if nbytes or isinstance(value, (dict, list, tuple)):
            _tally(out, value)
        elif depth < 1 and hasattr(value, "__dict__"):
            _scan_object(out, value, depth + 1)


def ledger_families(graph: Any) -> Dict[str, Dict[str, int]]:
    """Read-only walk of one shadow graph's array families ->
    ``{family: {host, device, items}}`` byte tallies.  Tolerates
    concurrent folds (torn reads of a growing container cost one family
    sample, never an exception) and unknown backends (missing
    attributes contribute nothing)."""
    out: Dict[str, Dict[str, int]] = {}

    def family(name: str) -> Dict[str, int]:
        return out.setdefault(name, {"host": 0, "device": 0, "items": 0})

    for name, attrs in _FAMILY_ATTRS:
        tally = family(name)
        for attr in attrs:
            try:
                _tally(tally, getattr(graph, attr, None))
            except Exception:
                continue
    for name, attrs in _SCAN_ATTRS:
        tally = family(name)
        for attr in attrs:
            try:
                _scan_object(tally, getattr(graph, attr, None))
            except Exception:
                continue
    # The bookkeeping maps: measured by entry-count estimate (documented
    # constants above) — what the "no ledger leak" check watches, since
    # these are exactly the structures that shrink when a sweep frees
    # slots (slot_of pops, edge_of pops, send-matrix purge).
    maps = family("maps")
    for attr, per_entry in (
        ("slot_of", _DICT_ENTRY_EST),
        ("send_matrix", _DICT_ENTRY_EST),
        ("_pair_log", _LIST_ENTRY_EST),
        ("_jump_writes", _DICT_ENTRY_EST),
    ):
        try:
            container = getattr(graph, attr, None)
            if container is not None and hasattr(container, "__len__"):
                maps["host"] += len(container) * per_entry
                maps["items"] += 1
        except Exception:
            continue
    try:
        edge_of = getattr(graph, "edge_of", None)
        if edge_of is not None:
            scanned = {"host": 0, "device": 0, "items": 0}
            _scan_object(scanned, edge_of)
            if scanned["host"]:
                maps["host"] += scanned["host"]
            elif hasattr(edge_of, "__len__"):
                maps["host"] += len(edge_of) * _DICT_ENTRY_EST
            maps["items"] += 1
    except Exception:
        pass
    return out


def sweep_attribution(
    device_s: float,
    n_sweeps: int,
    dirty_chunks: Optional[List[int]] = None,
) -> Tuple[List[float], List[int]]:
    """Distribute one wake's measured device seconds across its sweeps.

    Weights are each sweep's dirty-chunk count (the work measure the
    per-sweep frontier stats stream back); a missing/short stats vector degrades
    to equal weights.  Returns ``(per_sweep_ms, per_sweep_bytes_est)``;
    ``sum(per_sweep_ms) == device_s * 1000`` by construction, so the
    attribution always reconciles with the profiler's device time."""
    n = max(0, int(n_sweeps))
    if n == 0:
        return [], []
    weights = [1.0] * n
    if dirty_chunks:
        for i in range(min(n, len(dirty_chunks))):
            try:
                weights[i] = max(1.0, float(dirty_chunks[i]))
            except (TypeError, ValueError):
                pass
    total = sum(weights)
    ms = [float(device_s) * 1000.0 * w / total for w in weights]
    bytes_est = [int(w * CHUNK_BYTES_EST) for w in weights]
    return ms, bytes_est


#: compile-cache geometry labelling lives with the event vocabulary so
#: the emitting sites (engines/ops) never import this package.
geom_key = events.compile_geom


class DeviceObservatory:
    """Per-system device-plane observatory (see module docstring).

    Install as a recorder listener AND as the engine's
    ``device_observatory`` (the collector feeds :meth:`on_wake` once per
    wake on its own thread); both are done by
    :class:`uigc_tpu.telemetry.Telemetry`.  Works registry-less too
    (offline JSONL replay builds one and feeds it events)."""

    def __init__(
        self,
        node: str = "",
        registry: Any = None,
        profiler: Any = None,
        graph_fn: Any = None,
    ):
        self.node = node
        self.profiler = profiler
        self.graph_fn = graph_fn
        self._lock = threading.Lock()
        self.wakes = 0
        #: family -> latest {host, device, items} sample (collector thread)
        self.ledger: Dict[str, Dict[str, int]] = {}
        #: family -> peak host+device bytes ever sampled
        self.peaks: Dict[str, int] = {}
        #: (tag, geom) -> {hits, misses, compile_s}
        self.compiles: Dict[Tuple[str, str], Dict[str, float]] = {}
        #: (site, phase) -> {count, bytes}
        self.transfers: Dict[Tuple[str, str], Dict[str, float]] = {}
        #: site -> donation-copy count
        self.donations: Dict[str, int] = {}
        #: kernel and native builds of this process already observed
        self._builds_seen = 0
        self._kernel_build = {"n": 0, "total_s": 0.0, "max_s": 0.0}

        self._m_transfers = self._m_transfer_bytes = None
        self._m_donations = None
        self._m_hits = self._m_misses = self._m_compile_s = None
        if registry is not None:
            self._m_transfers = registry.counter(
                "uigc_host_transfers_total",
                "Device->host value crossings on collector paths, by "
                "readback site and the wake phase they landed in.",
            )
            self._m_transfer_bytes = registry.counter(
                "uigc_host_transfer_bytes_total",
                "Bytes moved device->host on collector paths.",
            )
            self._m_donations = registry.counter(
                "uigc_donation_copies_total",
                "Donated buffers that survived their donating call "
                "(XLA copied instead of aliasing), by site.",
            )
            self._m_misses = registry.counter(
                "uigc_compile_misses_total",
                "Compile-cache misses (a program was (re)built), by tag. "
                "A sustained per-wake rate is a recompile storm.",
            )
            self._m_hits = registry.counter(
                "uigc_compile_hits_total",
                "Compile-cache hits, by tag.",
            )
            self._m_compile_s = registry.histogram(
                "uigc_compile_seconds",
                "Seconds spent building/compiling one cached program "
                "(timed misses, and the nvcc/g++ builds of the kernel "
                "and native libraries, tagged by what was built).",
            )
            registry.gauge(
                "uigc_device_ledger_bytes",
                "Live bytes per shadow-graph array family (host mirrors "
                "+ device-resident operands), sampled per wake.",
                fn=self._gauge_ledger,
                label_name="family",
            )
            registry.gauge(
                "uigc_device_ledger_peak_bytes",
                "Peak watermark of uigc_device_ledger_bytes per family.",
                fn=self._gauge_peaks,
                label_name="family",
            )
        self._sync_builds()

    # -- recorder listener ------------------------------------------- #

    def __call__(self, name: str, fields: Dict[str, Any]) -> None:
        if self.node:
            # The recorder is process-global: in a multi-system process
            # accept only this node's threads (origin-less events — user
            # and test threads — are unscoped and accepted), the same
            # scoping discipline as the EventMetricsBridge.
            origin = fields.get("origin")
            if origin is not None and origin != self.node:
                return
        if name == events.HOST_TRANSFER:
            self._on_transfer(fields)
        elif name == events.COMPILE:
            self._on_compile(fields)
        elif name == events.DONATION_COPY:
            self._on_donation(fields)

    def _active_phase(self) -> str:
        """The open profiler phase of the active wake, when the event
        committed on the collector thread (listeners run synchronously
        on the committing thread, so this read cannot race the wake that
        owns the stack)."""
        profiler = self.profiler
        wake = getattr(profiler, "_active", None)
        if wake is None or wake.thread != threading.get_ident():
            return ""
        stack = wake.stack
        return stack[-1].name if stack else ""

    def _on_transfer(self, fields: Dict[str, Any]) -> None:
        site = str(fields.get("site", "?"))
        nbytes = int(fields.get("bytes", 0) or 0)
        phase = str(fields.get("phase", "") or self._active_phase())
        with self._lock:
            slot = self.transfers.setdefault(
                (site, phase), {"count": 0, "bytes": 0}
            )
            slot["count"] += 1
            slot["bytes"] += nbytes
        if self._m_transfers is not None:
            self._m_transfers.inc(site=site, phase=phase)
            self._m_transfer_bytes.inc(nbytes, phase=phase)

    #: per-tag geometry-stream bound: past it, further geometries fold
    #: into one ``geom="overflow"`` stream.  The recompile-storm
    #: pathology mints a FRESH geometry per wake, so without the bound
    #: the observatory's own state would grow without limit during
    #: exactly the incident it exists to diagnose (the same discipline
    #: as the registry's max-labelsets).  The storm stays visible: the
    #: overflow stream keeps counting misses per tag.
    MAX_GEOMS_PER_TAG = 256

    def _on_compile(self, fields: Dict[str, Any]) -> None:
        tag = str(fields.get("tag", "?"))
        geom = str(fields.get("geom", ""))
        hit = bool(fields.get("hit"))
        duration = fields.get("duration_s")
        with self._lock:
            slot = self.compiles.get((tag, geom))
            if slot is None:
                tag_geoms = sum(1 for t, _g in self.compiles if t == tag)
                if tag_geoms >= self.MAX_GEOMS_PER_TAG:
                    geom = "overflow"
                slot = self.compiles.setdefault(
                    (tag, geom), {"hits": 0, "misses": 0, "compile_s": 0.0}
                )
            slot["hits" if hit else "misses"] += 1
            if duration and not hit:
                slot["compile_s"] += float(duration)
        if hit:
            if self._m_hits is not None:
                self._m_hits.inc(tag=tag)
        else:
            if self._m_misses is not None:
                self._m_misses.inc(tag=tag)
            if duration and self._m_compile_s is not None:
                self._m_compile_s.observe(float(duration), tag=tag)

    def _on_donation(self, fields: Dict[str, Any]) -> None:
        site = str(fields.get("site", "?"))
        with self._lock:
            self.donations[site] = self.donations.get(site, 0) + 1
        if self._m_donations is not None:
            self._m_donations.inc(site=site)

    def _sync_builds(self) -> None:
        """Fold the process's kernel and native builds not yet seen
        (``utils/platform.py:build_log``) into ``kernel_build`` and the
        compile-seconds histogram.  Builds are process-wide, so an
        observatory attached after them still reports them."""
        log = platform.build_log()
        with self._lock:
            fresh = log[self._builds_seen:]
            self._builds_seen = len(log)
            b = self._kernel_build
            for _tag, seconds in fresh:
                b["n"] += 1
                b["total_s"] += seconds
                if seconds > b["max_s"]:
                    b["max_s"] = seconds
        if self._m_compile_s is not None:
            for tag, seconds in fresh:
                self._m_compile_s.observe(seconds, tag=tag)

    # -- per-wake sampling (collector thread) ------------------------- #

    def on_wake(self, graph: Any) -> None:
        """Sample the memory ledger against one fold-consistent graph
        view and roll the peak watermarks.  Called by the collector
        after each wake (exception-isolated there, like the liveness
        inspector's hook)."""
        sample = ledger_families(graph)
        self._sync_builds()
        with self._lock:
            self.wakes += 1
            self.ledger = sample
            for fam, tally in sample.items():
                total = tally["host"] + tally["device"]
                if total > self.peaks.get(fam, 0):
                    self.peaks[fam] = total

    # -- gauges -------------------------------------------------------- #

    def _gauge_ledger(self) -> Optional[Dict[str, int]]:
        graph = None
        if self.graph_fn is not None:
            try:
                graph = self.graph_fn()
            except Exception:
                graph = None
        if graph is not None:
            # Lazy scrape-time sample (concurrent-fold tolerant); also
            # refreshes the wake-sampled copy for headless readers and
            # rolls the peaks — live must never read above peak in one
            # exposition (the leak heuristic compares the two).
            sample = ledger_families(graph)
            with self._lock:
                self.ledger = sample
                for fam, tally in sample.items():
                    total = tally["host"] + tally["device"]
                    if total > self.peaks.get(fam, 0):
                        self.peaks[fam] = total
        else:
            with self._lock:
                sample = dict(self.ledger)
        return {
            fam: tally["host"] + tally["device"] for fam, tally in sample.items()
        } or None

    def _gauge_peaks(self) -> Optional[Dict[str, int]]:
        with self._lock:
            return dict(self.peaks) or None

    # -- reading / export --------------------------------------------- #

    def recent_wakes(self, limit: int = 32) -> List[Dict[str, Any]]:
        """The profiler's newest per-wake records (with the per-sweep
        device attribution profile.py stamps), newest last.  Prefers
        wakes that actually dispatched device work — a healthy idle
        system's newest wakes all skip the trace (the ``_graph_dirty``
        gate), and a report full of idle records would hide the sweeps
        the regression explainer exists to decompose."""
        profiler = self.profiler
        if profiler is None or not hasattr(profiler, "wakes_since"):
            return []
        records = profiler.wakes_since(0.0)
        active = [
            r for r in records if r.get("device_s") or r.get("n_sweeps")
        ]
        return (active or records)[-limit:]

    def to_doc(self) -> Dict[str, Any]:
        """The ``/device`` document: every plane, JSON-able.  The shape
        ``tools/device_report.py`` renders and validates, with
        ``compile.kernel_build`` (count, total and longest seconds of the
        process's nvcc and g++ builds) in place of the reference's
        ``compile.jax_backend``."""
        self._sync_builds()
        with self._lock:
            ledger = {
                fam: dict(tally) for fam, tally in sorted(self.ledger.items())
            }
            peaks = dict(self.peaks)
            compiles = [
                {"tag": tag, "geom": geom, **{k: v for k, v in slot.items()}}
                for (tag, geom), slot in sorted(self.compiles.items())
            ]
            transfers = [
                {"site": site, "phase": phase, **slot}
                for (site, phase), slot in sorted(self.transfers.items())
            ]
            donations = dict(self.donations)
            kernel_build = dict(self._kernel_build)
            wakes = self.wakes
        return {
            "version": 1,
            "bench": "device_observatory",
            "node": self.node,
            "t": time.time(),
            "wakes": wakes,
            "ledger": {
                "families": ledger,
                "peaks": peaks,
                "total_bytes": sum(
                    t["host"] + t["device"] for t in ledger.values()
                ),
                "device_bytes": sum(t["device"] for t in ledger.values()),
            },
            "compile": {
                "entries": compiles,
                "misses_total": sum(c["misses"] for c in compiles),
                "hits_total": sum(c["hits"] for c in compiles),
                "kernel_build": kernel_build,
            },
            "transfers": {
                "sites": transfers,
                "total_count": sum(t["count"] for t in transfers),
                "total_bytes": sum(t["bytes"] for t in transfers),
            },
            "donation": {
                "sites": donations,
                "copies_total": sum(donations.values()),
            },
            "recent_wakes": self.recent_wakes(),
        }

    def close(self) -> None:
        """Nothing to release: the build log is read, not subscribed."""


def validate_device_doc(doc: Any) -> List[str]:
    """Schema check of one observatory document; returns the problems
    (empty = valid).  Used by ``device_report --selfcheck`` and the
    tests, so the wire shape cannot drift silently."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    for key, kind in (
        ("version", int), ("node", str), ("wakes", int),
        ("ledger", dict), ("compile", dict), ("transfers", dict),
        ("donation", dict), ("recent_wakes", list),
    ):
        if not isinstance(doc.get(key), kind):
            problems.append(f"missing/typed-wrong key {key!r}")
    ledger = doc.get("ledger") or {}
    if not isinstance(ledger.get("families"), dict):
        problems.append("ledger.families is not an object")
    else:
        for fam, tally in ledger["families"].items():
            if not isinstance(tally, dict) or not {
                "host", "device", "items"
            } <= set(tally):
                problems.append(f"ledger family {fam!r} malformed")
    compile_doc = doc.get("compile") or {}
    if not isinstance(compile_doc.get("entries"), list):
        problems.append("compile.entries is not a list")
    else:
        for entry in compile_doc["entries"]:
            if not isinstance(entry, dict) or "tag" not in entry:
                problems.append("compile entry without a tag")
                break
    transfers = doc.get("transfers") or {}
    if not isinstance(transfers.get("sites"), list):
        problems.append("transfers.sites is not a list")
    for rec in doc.get("recent_wakes") or []:
        if not isinstance(rec, dict):
            problems.append("recent_wakes entry is not an object")
            break
        n = rec.get("n_sweeps")
        ms = rec.get("sweep_device_ms")
        if ms is not None:
            if not isinstance(ms, list) or (n and len(ms) != int(n)):
                problems.append("sweep_device_ms does not match n_sweeps")
                break
    return problems
