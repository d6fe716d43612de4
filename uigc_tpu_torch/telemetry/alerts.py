"""Copy of ``uigc_tpu/telemetry/alerts.py`` (pure Python), held against
it by ``tests/test_torch_telemetry.py``.

Anomaly/SLO alerting over the telemetry time plane.

Declarative rules evaluated against the
:class:`~uigc_tpu.telemetry.timeseries.TimeSeriesStore` on the
sampler's cadence.  Three rule kinds:

- ``threshold`` — an aggregate (mean/max/last) of the latest bucket
  compared against a fixed bound;
- ``rate`` — per-second slope of a (counter-valued) series over the
  window, from the first and last bucket's ``last`` samples;
- ``ewma`` — exponentially-weighted mean/variance of the series'
  bucket means; a point beyond ``sigma`` standard deviations fires
  (the regression detector: no fixed bound to mis-tune).  An optional
  absolute floor (``value > 0``) fires regardless of the learned
  baseline — the knob tests and hard SLOs use.

A rule evaluates once per matching labelset, so one declarative rule
covers every peer/shard/source the series fans out over, and the fired
alert carries that labelset (``frame_gap_spike`` names the gapping
``src``, ``heartbeat_phi_climb`` the climbing ``peer``).

Transitions are edge-triggered: entering the firing state commits one
structured ``telemetry.alert`` event (counted into
``uigc_alerts_total{rule,severity}`` by the
:class:`~uigc_tpu.telemetry.metrics.EventMetricsBridge`, so offline
JSONL replay rebuilds the same counters) and registers the alert as
active; recovery commits a ``state="resolved"`` event and clears it.
``/alerts`` on the metrics HTTP server serves :meth:`AlertEngine.to_doc`.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import events
from .timeseries import TimeSeriesStore

LabelKey = Tuple[Tuple[str, str], ...]

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


class AlertRule:
    """One declarative rule; see the module docstring for the kinds."""

    __slots__ = (
        "name", "series", "kind", "severity", "labels", "op", "value",
        "window_s", "resolution", "agg", "sigma", "min_points",
        "description",
    )

    def __init__(
        self,
        name: str,
        series: str,
        kind: str,
        severity: str = "warning",
        labels: Optional[Dict[str, Any]] = None,
        op: str = ">",
        value: float = 0.0,
        window_s: float = 60.0,
        resolution: Optional[float] = None,
        agg: str = "mean",
        sigma: float = 3.0,
        min_points: int = 8,
        description: str = "",
    ):
        if kind not in ("threshold", "rate", "ewma"):
            raise ValueError(f"unknown alert rule kind {kind!r}")
        if op not in _OPS:
            raise ValueError(f"unknown alert rule op {op!r}")
        self.name = name
        self.series = series
        self.kind = kind
        self.severity = severity
        #: None = evaluate every labelset of the series; a dict pins one.
        self.labels = dict(labels) if labels is not None else None
        self.op = op
        self.value = float(value)
        self.window_s = float(window_s)
        self.resolution = resolution
        self.agg = agg
        self.sigma = float(sigma)
        self.min_points = max(1, int(min_points))
        self.description = description

    def to_doc(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "series": self.series,
            "kind": self.kind,
            "severity": self.severity,
            "op": self.op,
            "value": self.value,
            "window_s": self.window_s,
            "description": self.description,
        }


def _bucket_agg(bucket: Dict[str, Any], agg: str) -> float:
    if agg == "max":
        return float(bucket["max"])
    if agg == "last":
        return float(bucket["last"])
    return float(bucket["mean"])


class AlertEngine:
    """Evaluates rules against a store; tracks firing state.

    Driven by the sampler thread (one :meth:`evaluate` per tick);
    readable from HTTP handlers and tests, so state is lock-guarded."""

    def __init__(self, store: TimeSeriesStore, node: str = ""):
        self.store = store
        self.node = node
        self._lock = threading.Lock()
        self._rules: List[AlertRule] = []
        #: (rule, labelkey) -> {mean, var, n}   (ewma state)
        self._ewma: Dict[Tuple[str, LabelKey], List[float]] = {}
        #: (rule, labelkey) -> firing alert record
        self._active: Dict[Tuple[str, LabelKey], Dict[str, Any]] = {}
        self.fired_total = 0

    def add_rule(self, rule: AlertRule) -> AlertRule:
        with self._lock:
            self._rules.append(rule)
        return rule

    def add_rules(self, rules: List[AlertRule]) -> None:
        with self._lock:
            self._rules.extend(rules)

    def rules(self) -> List[AlertRule]:
        with self._lock:
            return list(self._rules)

    # -- evaluation (sampler thread) ---------------------------------- #

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Evaluate every rule; returns the alerts newly fired this
        pass.  Transitions commit ``telemetry.alert`` events."""
        if now is None:
            now = self.store.clock()
        fired: List[Dict[str, Any]] = []
        resolved: List[Dict[str, Any]] = []
        for rule in self.rules():
            if rule.labels is not None:
                keys = [
                    tuple(sorted((k, str(v)) for k, v in rule.labels.items()))
                ]
            else:
                keys = self.store.label_sets(rule.series) or [()]
            for key in keys:
                verdict = self._evaluate_one(rule, key, now)
                self._transition(rule, key, verdict, now, fired, resolved)
        for alert in fired:
            self._commit(alert, "firing")
        for alert in resolved:
            self._commit(alert, "resolved")
        return fired

    def _evaluate_one(
        self, rule: AlertRule, key: LabelKey, now: float
    ) -> Optional[Dict[str, Any]]:
        """-> {value, threshold} when the rule fires for this labelset,
        else None."""
        window = self.store.range(
            rule.series,
            labels=dict(key),
            window_s=rule.window_s,
            resolution=rule.resolution,
            now=now,
        )
        buckets = window["buckets"]
        if not buckets:
            return None
        if rule.kind == "threshold":
            value = _bucket_agg(buckets[-1], rule.agg)
            if _OPS[rule.op](value, rule.value):
                return {"value": value, "threshold": rule.value}
            return None
        if rule.kind == "rate":
            if len(buckets) < 2:
                return None
            first, last = buckets[0], buckets[-1]
            dt = last["t"] - first["t"]
            if dt <= 0:
                return None
            rate = (last["last"] - first["last"]) / dt
            if _OPS[rule.op](rate, rule.value):
                return {"value": rate, "threshold": rule.value}
            return None
        # ewma: learn mean/var of bucket means, fire on sigma deviation
        value = _bucket_agg(buckets[-1], rule.agg)
        state_key = (rule.name, key)
        with self._lock:
            state = self._ewma.get(state_key)
            if state is None:
                state = self._ewma[state_key] = [value, 0.0, 1.0]
                baseline_ready = False
            else:
                baseline_ready = state[2] >= rule.min_points
            mean, var, n = state
        deviated = False
        if baseline_ready:
            std = math.sqrt(max(var, 0.0))
            # The 10% relative margin keeps a zero-variance warm-up
            # (identical samples -> std == 0) from firing on float
            # jitter the moment any wobble appears.
            deviated = (
                value > mean + rule.sigma * std and value > mean * 1.1 + 1e-9
            )
        floored = rule.value > 0.0 and value >= rule.value
        if deviated or floored:
            threshold = (
                rule.value
                if floored and not deviated
                else mean + rule.sigma * math.sqrt(max(var, 0.0))
            )
            # Deliberately NOT folded into the baseline: a sustained
            # regression must keep firing, not teach the baseline that
            # slow is normal.
            return {"value": value, "threshold": threshold, "baseline": mean}
        alpha = 0.3
        with self._lock:
            state = self._ewma.get(state_key)
            if state is not None:
                delta = value - state[0]
                state[0] += alpha * delta
                state[1] = (1 - alpha) * (state[1] + alpha * delta * delta)
                state[2] += 1.0
        return None

    def _transition(
        self,
        rule: AlertRule,
        key: LabelKey,
        verdict: Optional[Dict[str, Any]],
        now: float,
        fired: List[Dict[str, Any]],
        resolved: List[Dict[str, Any]],
    ) -> None:
        active_key = (rule.name, key)
        with self._lock:
            active = self._active.get(active_key)
            if verdict is not None and active is None:
                alert = {
                    "rule": rule.name,
                    "severity": rule.severity,
                    "series": rule.series,
                    "labels": dict(key),
                    "node": self.node,
                    "since": now,
                    "description": rule.description,
                    **verdict,
                }
                self._active[active_key] = alert
                self.fired_total += 1
                fired.append(alert)
            elif verdict is not None and active is not None:
                active["value"] = verdict["value"]  # refresh, no re-fire
            elif verdict is None and active is not None:
                del self._active[active_key]
                resolved.append(dict(active, resolved_at=now))

    def _commit(self, alert: Dict[str, Any], state: str) -> None:
        if not events.recorder.enabled:
            return
        events.recorder.commit(
            events.ALERT,
            rule=alert["rule"],
            severity=alert["severity"],
            series=alert["series"],
            labels=dict(alert["labels"]),
            value=alert.get("value"),
            threshold=alert.get("threshold"),
            node=self.node,
            state=state,
        )

    # -- reading ------------------------------------------------------ #

    def active(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(a) for a in self._active.values()]

    def to_doc(self) -> Dict[str, Any]:
        return {
            "node": self.node,
            "t": time.time(),
            "firing": self.active(),
            "fired_total": self.fired_total,
            "rules": [r.to_doc() for r in self.rules()],
        }


# ------------------------------------------------------------------- #
# Built-in rules
# ------------------------------------------------------------------- #


def builtin_rules(config: Any) -> List[AlertRule]:
    """The rule set every instrumented node watches out of the box.
    Knobs ride ``uigc.telemetry.alert-*`` config keys; rules whose
    input series never materializes simply never evaluate."""
    sigma = config.get_float("uigc.telemetry.alert-ewma-sigma")
    wake_floor = config.get_float("uigc.telemetry.alert-wake-threshold")
    gap_rate = config.get_float("uigc.telemetry.alert-gap-rate")
    queue_limit = config.get_int("uigc.node.writer-queue-limit")
    phi_threshold = config.get_float("uigc.node.phi-threshold")
    recompile_rate = config.get_float("uigc.telemetry.alert-recompile-rate")
    device_floor = config.get_float(
        "uigc.telemetry.alert-device-wake-threshold"
    )
    return [
        # -- device-plane rules (uigc_tpu/telemetry/device.py feeds the
        # series; they never evaluate when the observatory is off) ----- #
        AlertRule(
            "recompile_storm",
            "uigc_compile_misses_total",
            "rate",
            severity="critical",
            op=">",
            value=recompile_rate,
            window_s=30.0,
            description="a compile cache is being missed repeatedly "
            "(shape-key churn): every wake pays a fresh XLA compile — "
            "a multi-system pjit hang of the JAX package was this class "
            "of bug",
        ),
        AlertRule(
            "device_wake_regression",
            "uigc_wake_device_seconds",
            "ewma",
            severity="warning",
            sigma=sigma,
            value=device_floor,
            window_s=60.0,
            agg="mean",
            description="the device-kernel share of a collector wake "
            "regressed beyond the learned baseline (or the configured "
            "floor); run device_report for the sweep-by-sweep picture",
        ),
        AlertRule(
            "donation_copy_detected",
            "uigc_donation_copies_total",
            "rate",
            severity="warning",
            op=">",
            value=0.0,
            window_s=120.0,
            description="a supposedly-donated device buffer survived "
            "its donating call (XLA silently copied): per-wake HBM "
            "traffic doubled at that site",
        ),
        AlertRule(
            "wake_latency_regression",
            "uigc_wake_wall_seconds",
            "ewma",
            severity="warning",
            sigma=sigma,
            value=wake_floor,
            window_s=60.0,
            agg="mean",
            description="collector wake wall time beyond the learned "
            "baseline (or the configured floor)",
        ),
        AlertRule(
            "frame_gap_spike",
            "uigc_frame_gaps_total",
            "rate",
            severity="warning",
            op=">",
            value=gap_rate,
            window_s=30.0,
            description="receiver sequence layer losing frames faster "
            "than the tolerated rate",
        ),
        AlertRule(
            "frame_dup_spike",
            "uigc_frame_duplicates_total",
            "rate",
            severity="warning",
            op=">",
            value=gap_rate,
            window_s=30.0,
            description="duplicate frames arriving faster than the "
            "tolerated rate (retransmit storm)",
        ),
        AlertRule(
            "writer_queue_saturation",
            "uigc_writer_queue_depth",
            "threshold",
            severity="critical",
            op=">=",
            value=0.8 * queue_limit,
            agg="max",
            window_s=30.0,
            description="a per-peer outbound writer queue within 20% of "
            "its backpressure high-water mark",
        ),
        AlertRule(
            "leak_suspect_growth",
            "uigc_leak_suspects_total",
            "rate",
            severity="warning",
            op=">",
            value=0.0,
            window_s=120.0,
            description="the liveness watchdog is flagging new leak "
            "suspects (run graph_inspect why-live)",
        ),
        AlertRule(
            "heartbeat_phi_climb",
            "uigc_link_phi",
            "threshold",
            severity="critical",
            op=">=",
            value=phi_threshold / 2.0,
            agg="max",
            window_s=30.0,
            description="a peer link's phi suspicion crossed half the "
            "death threshold",
        ),
        AlertRule(
            "split_brain_suspected",
            "uigc_membership_disagreements_total",
            "rate",
            severity="critical",
            op=">",
            value=0.0,
            window_s=30.0,
            description="two live peers disagree on membership: a peer "
            "is serving alongside a member this node downed — a "
            "partition the split-brain resolver has not (yet) "
            "arbitrated, or an asymmetric link feeding one-sided "
            "verdicts (cluster/membership.py)",
        ),
        AlertRule(
            "backpressure_spike",
            "uigc_backpressure_total",
            "rate",
            severity="warning",
            op=">",
            value=config.get_float("uigc.telemetry.alert-backpressure-rate"),
            window_s=30.0,
            description="bounded queues (mailboxes / writer queues / "
            "cluster buffers) are overflowing faster than the tolerated "
            "rate — a consumer is saturated or a node is wedged",
        ),
        AlertRule(
            "gateway_overload",
            "uigc_gateway_shed_total",
            "rate",
            severity="warning",
            op=">",
            value=config.get_float("uigc.telemetry.alert-shed-rate"),
            window_s=30.0,
            description="the ingress gateway is shedding client traffic "
            "faster than the tolerated rate — admitted-traffic p99 or "
            "writer-queue depth crossed the overload bands, or tenants "
            "are blowing their quotas (uigc_tpu/gateway)",
        ),
    ]
