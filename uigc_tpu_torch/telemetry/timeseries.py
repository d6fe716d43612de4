"""Copy of ``uigc_tpu/telemetry/timeseries.py`` (pure Python), held
against it by ``tests/test_torch_telemetry.py`` and
``tests/test_torch_node_telemetry.py``.  The ``tsq``/``tsr`` cluster
pull registers on a fabric with ``register_frame_handler``, the node
transport (``runtime/node.py``).

Telemetry time plane: multi-resolution metric history.

Every other telemetry surface answers "what does the system look like
*now*" — the registry is point-in-time, the inspector snapshots one
wave.  This module records *history*: per-metric/per-labelset ring
buffers with multi-resolution downsampling tiers, the data substrate
the alert engine (:mod:`uigc_tpu.telemetry.alerts`), the live dashboard
(``tools/uigc_top.py``) and the future telemetry-driven placement loop
(ROADMAP item 5) all read.

Three parts:

- :class:`TimeSeriesStore` — fixed-size ring buffers per
  (metric, labelset), one ring per downsampling tier (default
  1s x 120 / 10s x 180 / 60s x 240).  Each bucket folds min/max/sum/
  count/last, so memory is O(tiers x ring) no matter how many samples
  arrive — the same bounded-memory discipline as
  :class:`uigc_tpu.utils.events.DurationStat`.  The query surface is
  :meth:`TimeSeriesStore.range` — a stable API; item 5's policy loop
  is expected to build on it.

- :class:`MetricsSampler` — a daemon thread feeding the store each
  tick from the :class:`~uigc_tpu.telemetry.metrics.MetricsRegistry`
  (counters/gauges as values, histograms as ``_count``/``_sum``
  series), the wake profiler's per-wake records, and the shadow
  graph's accumulated send matrix; it also drives the alert engine's
  evaluation.

- Coordinator-free cluster aggregation — any node can pull and merge
  the cluster's series over the fabric's ``tsq``/``tsr`` frame pair
  (runtime/wire.py; JSON payloads, never pickle).  Following Tascade's
  atomic-free asynchronous reduction shape (PAPERS.md), there is no
  coordinator: the puller fans a query out, folds responses as they
  land, and degrades to ``missing_nodes`` for peers that never answer
  — the same discipline as the cross-node ``snap`` merge.  The transport
  closures are injected by :class:`uigc_tpu.telemetry.Telemetry`, so
  this module stays transport-free.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import events
from .metrics import OVERFLOW_LABELS

#: Default downsampling tiers: (resolution_s, ring_size) pairs, finest
#: first.  120s of 1s buckets, 30min of 10s buckets, 4h of 1min buckets.
DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = (
    (1.0, 120),
    (10.0, 180),
    (60.0, 240),
)

LabelKey = Tuple[Tuple[str, str], ...]


def parse_tiers(spec: str) -> Tuple[Tuple[float, int], ...]:
    """``"1x120,10x180,60x240"`` -> ((1.0, 120), (10.0, 180), (60.0, 240)).
    Anything unparseable degrades to :data:`DEFAULT_TIERS` — a bad
    config value must not fail system construction."""
    try:
        tiers = []
        for part in spec.split(","):
            res, size = part.strip().split("x")
            res_f, size_i = float(res), int(size)
            if res_f <= 0 or size_i <= 0:
                return DEFAULT_TIERS
            tiers.append((res_f, size_i))
        return tuple(sorted(tiers)) or DEFAULT_TIERS
    except (ValueError, AttributeError):
        return DEFAULT_TIERS


class _Tier:
    """One fixed-size ring of downsampled buckets.

    ``idxs[slot]`` holds the absolute bucket index currently resident in
    ``slot = idx % size``; a sample landing in a *newer* bucket index
    overwrites the slot in place (the ring's eviction), so the tier
    never allocates past its fixed arrays."""

    __slots__ = ("res", "size", "idxs", "buckets")

    def __init__(self, res: float, size: int):
        self.res = float(res)
        self.size = int(size)
        self.idxs: List[Optional[int]] = [None] * self.size
        #: slot -> [count, total, vmin, vmax, last]
        self.buckets: List[Optional[List[float]]] = [None] * self.size

    def record(self, t: float, value: float) -> None:
        idx = int(t // self.res)
        slot = idx % self.size
        if self.idxs[slot] != idx:
            # Never resurrect an evicted bucket: a straggler sample
            # older than the resident bucket would otherwise clobber
            # newer data with an ancient window.
            resident = self.idxs[slot]
            if resident is not None and resident > idx:
                return
            self.idxs[slot] = idx
            self.buckets[slot] = [1.0, value, value, value, value]
            return
        b = self.buckets[slot]
        b[0] += 1.0
        b[1] += value
        if value < b[2]:
            b[2] = value
        if value > b[3]:
            b[3] = value
        b[4] = value

    def rows(self, idx_lo: int, idx_hi: int) -> List[List[float]]:
        """Resident ``[idx, count, total, min, max, last]`` rows with
        idx_lo <= idx <= idx_hi, in time order."""
        out = []
        for slot in range(self.size):
            idx = self.idxs[slot]
            if idx is not None and idx_lo <= idx <= idx_hi:
                out.append([idx] + list(self.buckets[slot]))
        out.sort(key=lambda row: row[0])
        return out

    def allocated(self) -> int:
        return sum(1 for idx in self.idxs if idx is not None)


class _Series:
    __slots__ = ("name", "labels", "tiers")

    def __init__(self, name: str, labels: LabelKey, tier_spec):
        self.name = name
        self.labels = labels
        self.tiers = [_Tier(res, size) for res, size in tier_spec]

    def record(self, t: float, value: float) -> None:
        for tier in self.tiers:
            tier.record(t, value)


def _row_dicts(rows: List[List[float]], res: float) -> List[Dict[str, Any]]:
    return [
        {
            "t": idx * res,
            "count": int(count),
            "sum": total,
            "min": vmin,
            "max": vmax,
            "last": last,
            "mean": total / count if count else 0.0,
        }
        for idx, count, total, vmin, vmax, last in rows
    ]


class TimeSeriesStore:
    """Per-node in-process time-series store (see module docstring).

    Thread-safe: the sampler writes, HTTP handlers / link receive
    threads / the alert engine read, all under one lock — every
    operation is O(ring), never O(samples)."""

    def __init__(
        self,
        node: str = "",
        tiers: Tuple[Tuple[float, int], ...] = DEFAULT_TIERS,
        max_labelsets: int = 512,
        clock: Callable[[], float] = time.time,
    ):
        self.node = node
        self.tier_spec = tuple(sorted(tiers)) or DEFAULT_TIERS
        self.max_labelsets = max(1, int(max_labelsets))
        self.clock = clock
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, LabelKey], _Series] = {}
        #: metric name -> labelset count (for the cardinality bound)
        self._cardinality: Dict[str, int] = {}
        self._overflowed: set = set()
        self.dropped_labelsets = 0
        # -- cluster pull plumbing (closures injected by Telemetry) --- #
        self._known_peers_fn: Optional[Callable[[], List[str]]] = None
        self._live_peers_fn: Optional[Callable[[], List[str]]] = None
        self._send_query: Optional[Callable[[str, int, Dict], Any]] = None
        self._send_response: Optional[Callable[[str, int, bytes], Any]] = None
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._req_counter = 0

    # -- writing ----------------------------------------------------- #

    def record(
        self, name: str, value: float, t: Optional[float] = None, **labels: Any
    ) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        self.record_key(name, key, value, t)

    def record_key(
        self, name: str, key: LabelKey, value: float, t: Optional[float] = None
    ) -> None:
        if t is None:
            t = self.clock()
        overflow_event = False
        with self._lock:
            series = self._series.get((name, key))
            if series is None:
                if (
                    self._cardinality.get(name, 0) >= self.max_labelsets
                    and key != OVERFLOW_LABELS
                ):
                    # Over the bound: fold into the overflow labelset so
                    # the aggregate is still observable, and note the
                    # overflow once per metric.
                    self.dropped_labelsets += 1
                    if name not in self._overflowed:
                        self._overflowed.add(name)
                        overflow_event = True
                    key = OVERFLOW_LABELS
                    series = self._series.get((name, key))
                if series is None:
                    series = self._series[(name, key)] = _Series(
                        name, key, self.tier_spec
                    )
                    self._cardinality[name] = self._cardinality.get(name, 0) + 1
            series.record(t, float(value))
        if overflow_event and events.recorder.enabled:
            events.recorder.commit(
                events.LABELSET_OVERFLOW,
                scope="timeseries",
                metric=name,
                node=self.node,
                limit=self.max_labelsets,
            )

    # -- querying (the stable surface) ------------------------------- #

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._cardinality)

    def label_sets(self, name: str) -> List[LabelKey]:
        with self._lock:
            return sorted(
                key for (n, key) in self._series if n == name
            )

    def _pick_tier(
        self, series: _Series, window_s: float, resolution: Optional[float]
    ) -> _Tier:
        if resolution is not None:
            for tier in series.tiers:
                if tier.res >= float(resolution) - 1e-9:
                    return tier
            return series.tiers[-1]
        # No resolution asked: the finest tier whose ring still covers
        # the window; fall through to the coarsest.
        for tier in series.tiers:
            if tier.res * tier.size >= window_s:
                return tier
        return series.tiers[-1]

    def range(
        self,
        name: str,
        labels: Optional[Dict[str, Any]] = None,
        window_s: float = 120.0,
        resolution: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Buckets of one series over ``[now - window_s, now]``.

        The **stable query API**: returns ``{name, labels, resolution,
        buckets: [{t, count, sum, min, max, last, mean}, ...]}`` in
        time order (empty buckets when the series is unknown).
        ``resolution`` selects the coarsest-enough tier; ``None`` picks
        the finest tier that still covers the window."""
        key = tuple(sorted((k, str(v)) for k, v in (labels or {}).items()))
        if now is None:
            now = self.clock()
        with self._lock:
            series = self._series.get((name, key))
            if series is None:
                return {
                    "name": name,
                    "labels": dict(key),
                    "resolution": float(resolution or 0.0),
                    "buckets": [],
                }
            tier = self._pick_tier(series, window_s, resolution)
            idx_hi = int(now // tier.res)
            idx_lo = int(max(0.0, now - window_s) // tier.res)
            rows = tier.rows(idx_lo, idx_hi)
        return {
            "name": name,
            "labels": dict(key),
            "resolution": tier.res,
            "buckets": _row_dicts(rows, tier.res),
        }

    def stats(self) -> Dict[str, Any]:
        """Bound proof: allocated buckets can never exceed
        ``series x sum(ring sizes)``."""
        with self._lock:
            series = list(self._series.values())
        return {
            "series": len(series),
            "buckets_allocated": sum(
                tier.allocated() for s in series for tier in s.tiers
            ),
            "buckets_capacity": len(series)
            * sum(size for _res, size in self.tier_spec),
            "dropped_labelsets": self.dropped_labelsets,
        }

    # -- wire documents ---------------------------------------------- #

    def to_doc(
        self, name: Optional[str] = None, window_s: Optional[float] = None
    ) -> Dict[str, Any]:
        """JSON-able dump of every series (optionally one metric name,
        optionally clipped to a trailing window) — the ``tsr`` payload
        and the ``/timeseries`` body."""
        now = self.clock()
        with self._lock:
            series = [
                s
                for (n, _k), s in sorted(self._series.items())
                if name is None or n == name
            ]
            out = []
            for s in series:
                tiers = []
                for tier in s.tiers:
                    idx_hi = int(now // tier.res) + 1
                    idx_lo = (
                        int(max(0.0, now - window_s) // tier.res)
                        if window_s
                        else 0
                    )
                    tiers.append(
                        {"res": tier.res, "buckets": tier.rows(idx_lo, idx_hi)}
                    )
                out.append(
                    {"name": s.name, "labels": dict(s.labels), "tiers": tiers}
                )
        return {"version": 1, "node": self.node, "t": now, "series": out}

    # -- cluster pull (tsq/tsr; closures injected by Telemetry) ------- #

    def bind_fabric(
        self,
        known_peers_fn: Callable[[], List[str]],
        live_peers_fn: Callable[[], List[str]],
        send_query: Callable[[str, int, Dict], Any],
        send_response: Callable[[str, int, bytes], Any],
    ) -> None:
        self._known_peers_fn = known_peers_fn
        self._live_peers_fn = live_peers_fn
        self._send_query = send_query
        self._send_response = send_response

    def on_query_frame(
        self, from_address: str, req_id: int, origin: str, query: Dict[str, Any]
    ) -> None:
        """Decoded ``tsq`` frame (runtime/wire.py): answer with this
        node's matching series.  Runs on the link's receive thread;
        unknown query keys are ignored (version tolerance)."""
        if self._send_response is None:
            return
        window = query.get("window")
        doc = self.to_doc(
            name=query.get("name") or None,
            window_s=float(window) if window else None,
        )
        self._send_response(
            origin, req_id, json.dumps(doc, default=repr).encode()
        )

    def on_response_frame(
        self, req_id: int, origin: str, payload: Optional[bytes]
    ) -> None:
        """Decoded ``tsr`` frame: fold one peer's series document into
        the pending pull.  The payload (every series x every tier) is
        parsed BEFORE taking the store lock — a large peer document
        must not stall the sampler's writes or an alert evaluation."""
        doc = None
        try:
            doc = json.loads(payload or b"{}")
        except ValueError:
            pass  # recorded under "bad" below
        with self._lock:
            pending = self._pending.get(req_id)
            if pending is None:
                return
            if doc is None:
                pending["bad"].append(origin)
            else:
                pending["docs"][origin] = doc
            if set(pending["docs"]) | set(pending["bad"]) >= pending["want"]:
                pending["done"].set()

    def merged(
        self, query: Optional[Dict[str, Any]] = None, timeout_s: float = 2.0
    ) -> Dict[str, Any]:
        """Pull and merge the cluster's series: local store plus a
        ``tsq`` round-trip to every *known* peer.  A peer that is
        already declared dead is named in ``missing_nodes`` without
        waiting; a live peer whose response never lands (dropped frame,
        mid-pull death) degrades there after the timeout — the merge
        never blocks past ``timeout_s`` and never needs a coordinator."""
        query = dict(query or {})
        local = self.to_doc(
            name=query.get("name") or None,
            window_s=query.get("window") or None,
        )
        if self._known_peers_fn is None or self._send_query is None:
            return merge_series_docs([local])
        known = [p for p in self._known_peers_fn() if p != self.node]
        live = set(self._live_peers_fn() if self._live_peers_fn else known)
        targets = [p for p in known if p in live]
        dead = sorted(set(known) - live)
        if not targets:
            return merge_series_docs([local], missing=dead)
        with self._lock:
            self._req_counter += 1
            req_id = self._req_counter
            pending = {
                "docs": {},
                "bad": [],
                "want": set(targets),
                "done": threading.Event(),
            }
            self._pending[req_id] = pending
        try:
            for peer in targets:
                # A send the fabric refuses (link closed between the
                # liveness check and here) or that raises can never be
                # answered: fold the peer into "bad" NOW so the early-
                # completion check can still fire once every reachable
                # peer responds — one dead link must not force every
                # merge to sit out the full timeout.
                accepted = True
                try:
                    accepted = self._send_query(peer, req_id, query)
                except Exception:
                    accepted = False
                if accepted is False:
                    with self._lock:
                        pending["bad"].append(peer)
                        if (
                            set(pending["docs"]) | set(pending["bad"])
                            >= pending["want"]
                        ):
                            pending["done"].set()
            pending["done"].wait(timeout_s)
        finally:
            with self._lock:
                self._pending.pop(req_id, None)
        docs = [local] + list(pending["docs"].values())
        missing = sorted(set(targets) - set(pending["docs"])) + dead
        return merge_series_docs(docs, missing=sorted(set(missing)))


def merge_series_docs(
    docs: List[Dict[str, Any]], missing: Optional[List[str]] = None
) -> Dict[str, Any]:
    """Merge per-node series documents into one cluster document.

    Per-node series are preserved under ``nodes`` (the survivors'
    series, verbatim); ``cluster`` carries the cross-node rollup — for
    each (name, labels, tier resolution), buckets aligned by absolute
    bucket index merge count/sum additively and fold min/max (each node
    samples only its own process, so a bucket key can never be the same
    fact twice).  The ``last`` sample merges by the UL009 unit-suffix
    convention: ``_total``/``_count``/``_sum`` series are additive
    tallies (cluster last = sum of per-node lasts), everything else is
    a level gauge (phi, queue depth) where summing would fabricate a
    value no node ever reported — those fold by max."""
    merged: Dict[str, Any] = {
        "version": 1,
        "merged": True,
        "t": time.time(),
        "nodes": {},
        "missing_nodes": list(missing or []),
    }
    rollup: Dict[Tuple[str, LabelKey, float], Dict[int, List[float]]] = {}
    for doc in docs:
        node = doc.get("node", "?")
        merged["nodes"][node] = doc.get("series", [])
        for series in doc.get("series", []):
            name = series.get("name", "?")
            additive_last = name.endswith(("_total", "_count", "_sum"))
            labels = tuple(sorted((series.get("labels") or {}).items()))
            for tier in series.get("tiers", []):
                res = float(tier.get("res", 0.0))
                buckets = rollup.setdefault((name, labels, res), {})
                for row in tier.get("buckets", []):
                    try:
                        idx, count, total, vmin, vmax, last = row
                    except (TypeError, ValueError):
                        continue  # tolerate rows from newer layouts
                    have = buckets.get(idx)
                    if have is None:
                        buckets[idx] = [count, total, vmin, vmax, last]
                    else:
                        have[0] += count
                        have[1] += total
                        if vmin < have[2]:
                            have[2] = vmin
                        if vmax > have[3]:
                            have[3] = vmax
                        if additive_last:
                            have[4] += last
                        elif last > have[4]:
                            have[4] = last
    cluster = []
    for (name, labels, res), buckets in sorted(rollup.items()):
        rows = [[idx] + vals for idx, vals in sorted(buckets.items())]
        cluster.append(
            {
                "name": name,
                "labels": dict(labels),
                "res": res,
                "buckets": rows,
            }
        )
    merged["cluster"] = cluster
    return merged


# ------------------------------------------------------------------- #
# The sampler thread
# ------------------------------------------------------------------- #


class MetricsSampler:
    """Feeds the store each tick and drives alert evaluation.

    Sources (all optional; a missing one simply contributes nothing):

    - ``registry``: every counter/gauge sample becomes a point on its
      series; histograms contribute ``<name>_count`` and ``<name>_sum``
      (rates and means derive from those at query time — the bucket
      vectors stay out of the store).
    - ``profiler``: each completed wake's wall/device time becomes a
      point at the wake's own timestamp (``uigc_wake_wall_seconds`` /
      ``uigc_wake_device_seconds``) — the wake-latency alert input.
    - ``graph_fn``: the shadow graph's accumulated send matrix folds to
      ``uigc_send_matrix_pairs`` (distinct communicating pairs) and
      ``uigc_send_matrix_volume_total`` (total sends) — the drift
      signal item 5's partitioner will consume.
    """

    def __init__(
        self,
        store: TimeSeriesStore,
        registry: Any = None,
        profiler: Any = None,
        graph_fn: Optional[Callable[[], Any]] = None,
        alerts: Any = None,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.time,
    ):
        self.store = store
        self.registry = registry
        self.profiler = profiler
        self.graph_fn = graph_fn
        self.alerts = alerts
        self.interval_s = max(0.01, float(interval_s))
        self.clock = clock
        self._last_wake_t = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsSampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="uigc-ts-sampler", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # a torn read must not kill the plane
                pass

    # -- one tick (public: offline replay and tests drive it) --------- #

    def sample_once(self, now: Optional[float] = None) -> None:
        if now is None:
            now = self.clock()
        store = self.store
        if self.registry is not None:
            for metric in self.registry.metrics():
                kind = getattr(metric, "kind", "")
                try:
                    samples = metric.samples()
                except Exception:
                    continue  # a dead callback gauge: skip this tick
                for suffix, key, value in samples:
                    if kind == "histogram":
                        if suffix not in ("_count", "_sum"):
                            continue
                        store.record_key(metric.name + suffix, key, value, now)
                    else:
                        store.record_key(metric.name, key, value, now)
        profiler = self.profiler
        if profiler is not None and hasattr(profiler, "wakes_since"):
            wakes = profiler.wakes_since(self._last_wake_t)
            for rec in wakes:
                t = float(rec.get("t", now))
                if t > self._last_wake_t:
                    self._last_wake_t = t
                store.record("uigc_wake_wall_seconds", rec.get("wall_s", 0.0), t=t)
                store.record(
                    "uigc_wake_device_seconds", rec.get("device_s", 0.0), t=t
                )
                # Device-plane decomposition (present when a device
                # backend ran the stats-variant fixpoint): sweep count
                # and the worst single sweep's attributed device time —
                # the regression explainer's time-plane inputs
                # (uigc_tpu/telemetry/device.py, device_wake_regression).
                if rec.get("n_sweeps"):
                    store.record(
                        "uigc_device_sweeps", int(rec["n_sweeps"]), t=t
                    )
                sweep_ms = rec.get("sweep_device_ms")
                if sweep_ms:
                    store.record(
                        "uigc_device_sweep_ms_max", max(sweep_ms), t=t
                    )
        if self.graph_fn is not None:
            self._sample_send_matrix(now)
        if self.alerts is not None:
            self.alerts.evaluate(now)

    def _sample_send_matrix(self, now: float) -> None:
        try:
            graph = self.graph_fn()
        except Exception:
            return
        sm = getattr(graph, "send_matrix", None)
        if not isinstance(sm, dict):
            return
        for _attempt in range(4):
            try:
                pairs = len(sm)
                volume = float(sum(sm.values()))
                break
            except RuntimeError:  # concurrent fold resized the dict
                continue
        else:  # pragma: no cover - pathological churn
            return
        self.store.record("uigc_send_matrix_pairs", pairs, t=now)
        self.store.record("uigc_send_matrix_volume_total", volume, t=now)
