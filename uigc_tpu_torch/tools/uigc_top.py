"""uigc-top: live ops dashboard for a uigc node (or a cluster).

The port's copy of ``tools/uigc_top.py``, run from the repository root
as ``python -m uigc_tpu_torch.tools.uigc_top``.

Renders the telemetry time plane (``uigc.telemetry.timeseries``) as a
terminal dashboard: sparklines per key series, actor/entity/shard
counts, firing anomaly/SLO alerts, per-peer link health (phi,
writer-queue depth), and — when the node serves ``/device``
(``uigc.telemetry.device``) — a device-observatory panel (ledger
bytes, per-wake device time, compile hit/miss, transfer and donation
tallies; dashes on nodes that predate the observatory).  Two sources:

- ``--url http://127.0.0.1:PORT``  poll a live node's metrics HTTP
  server (``/timeseries`` + ``/alerts`` + ``/metrics.json``); add
  ``--merged`` to pull the cluster-wide view over the ``tsq``/``tsr``
  fabric frames (surviving peers merge, dead ones show under
  ``missing``).
- ``--from-jsonl PATH``  replay a persisted (possibly rotated) JSONL
  event sink offline: the same event->metrics bridge a live node runs
  rebuilds the registry, a synthetic-clock sampler folds it into a
  store, and the built-in alert rules re-evaluate — one static frame
  of what the run looked like.

Display: full-screen curses when stdout is a TTY (q quits), else (or
with ``--plain``) one frame per poll to stdout; ``--once`` prints a
single frame and exits.  The renderers (:func:`sparkline`,
:func:`render_dashboard`, :func:`series_points`) are shared with
``telemetry_dump --series``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

SPARK_CHARS = "▁▂▃▄▅▆▇█"

#: (series, label, mode) rows of the dashboard body.  ``mode``:
#: value series render the bucket aggregate, ``rate`` differentiates a
#: sampled counter into per-second deltas.
KEY_SERIES: Tuple[Tuple[str, str, str], ...] = (
    ("uigc_wake_wall_seconds", "wake wall s", "mean"),
    ("uigc_wake_device_seconds", "wake device s", "mean"),
    ("uigc_live_actors", "live actors", "last"),
    # the bridge-fed twin (TRACING events): the row an offline JSONL
    # replay can still show, where callback gauges never existed
    ("uigc_gc_live_actors", "gc live actors", "last"),
    ("uigc_mailbox_depth", "mailbox depth", "last"),
    ("uigc_entries_flushed_total", "entries/s", "rate"),
    ("uigc_gc_garbage_total", "garbage/s", "rate"),
    ("uigc_frame_gaps_total", "frame gaps/s", "rate"),
    ("uigc_frame_duplicates_total", "frame dups/s", "rate"),
    ("uigc_writer_queue_depth", "writer queue", "max"),
    ("uigc_send_matrix_pairs", "send pairs", "last"),
    ("uigc_leak_suspects_total", "leak suspects", "last"),
    ("uigc_fence_rejected_total", "fence rejects/s", "rate"),
    ("uigc_dist_marks_exchanged_total", "dist marks/s", "rate"),
)

#: header gauges pulled from /metrics.json: (metric, short label)
HEADER_GAUGES: Tuple[Tuple[str, str], ...] = (
    ("uigc_live_actors", "actors"),
    ("uigc_shadow_graph_size", "shadows"),
    ("uigc_shard_table_size", "shards"),
    ("uigc_shard_entities_active", "entities"),
    ("uigc_shard_entities_passivated", "passivated"),
    ("uigc_dead_letters", "dead-letters"),
)


# ------------------------------------------------------------------- #
# Renderers (shared with telemetry_dump --series)
# ------------------------------------------------------------------- #


def fmt_si(value: Optional[float]) -> str:
    """Compact SI rendering: 1234567 -> '1.2M', 0.00042 -> '420µ'."""
    if value is None:
        return "-"
    v = float(value)
    if v == 0:
        return "0"
    sign = "-" if v < 0 else ""
    v = abs(v)
    for bound, suffix, div in (
        (1e9, "G", 1e9), (1e6, "M", 1e6), (1e3, "k", 1e3),
    ):
        if v >= bound:
            return f"{sign}{v / div:.1f}{suffix}"
    if v >= 1:
        return f"{sign}{v:.3g}"
    for bound, suffix, div in ((1e-3, "m", 1e-3), (1e-6, "µ", 1e-6)):
        if v >= bound:
            return f"{sign}{v / div:.3g}{suffix}"
    return f"{sign}{v:.2e}"


def sparkline(values: List[Optional[float]], width: int = 48) -> str:
    """One-line block-character sparkline; None gaps render as spaces.
    Scaled to the window's own min/max (the stats column carries the
    absolute numbers)."""
    values = list(values)[-width:]
    present = [v for v in values if v is not None]
    if not present:
        return "·" * 4
    lo, hi = min(present), max(present)
    span = hi - lo
    out = []
    for v in values:
        if v is None:
            out.append(" ")
        elif span <= 0:
            out.append(SPARK_CHARS[0] if hi <= 0 else SPARK_CHARS[3])
        else:
            idx = int((v - lo) / span * (len(SPARK_CHARS) - 1))
            out.append(SPARK_CHARS[idx])
    return "".join(out)


def series_points(
    series_doc: Dict[str, Any], mode: str = "mean"
) -> List[Tuple[float, float]]:
    """(t, value) points from one ``/timeseries`` series entry (its
    finest tier) or a ``range()`` result.  ``rate`` differentiates the
    per-bucket ``last`` samples into per-second slopes."""
    if "buckets" in series_doc and "tiers" not in series_doc:
        res = float(series_doc.get("resolution", 1.0)) or 1.0
        rows = [
            [b["t"] / res, b["count"], b["sum"], b["min"], b["max"], b["last"]]
            for b in series_doc["buckets"]
        ]
    else:
        tiers = series_doc.get("tiers") or []
        if not tiers:
            return []
        tier = tiers[0]
        res = float(tier.get("res", 1.0)) or 1.0
        rows = tier.get("buckets", [])
    points: List[Tuple[float, float]] = []
    prev: Optional[Tuple[float, float]] = None
    for row in rows:
        try:
            idx, count, total, vmin, vmax, last = row
        except (TypeError, ValueError):
            continue
        t = idx * res
        if mode == "rate":
            if prev is not None and t > prev[0]:
                points.append((t, max(0.0, (last - prev[1]) / (t - prev[0]))))
            prev = (t, last)
        elif mode == "max":
            points.append((t, vmax))
        elif mode == "last":
            points.append((t, last))
        else:
            points.append((t, total / count if count else 0.0))
    return points


def render_series(
    label: str, points: List[Tuple[float, float]], width: int = 48
) -> str:
    """One dashboard row: label, sparkline, min/mean/max/last stats."""
    values = [v for _t, v in points]
    spark = sparkline(values, width=width)
    if values:
        stats = (
            f"min {fmt_si(min(values)):>7}  mean "
            f"{fmt_si(sum(values) / len(values)):>7}  "
            f"max {fmt_si(max(values)):>7}  last {fmt_si(values[-1]):>7}"
        )
    else:
        stats = "(no data)"
    return f"{label:<16} {spark:<{width}} {stats}"


def _labels_str(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _find_series(
    doc: Dict[str, Any], name: str
) -> List[Dict[str, Any]]:
    return [s for s in doc.get("series", []) if s.get("name") == name]


def _merged_as_series(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Adapt a merged (cluster) document's rollup entries to the
    per-node series shape the renderers consume."""
    out = []
    for entry in doc.get("cluster", []):
        out.append(
            {
                "name": entry.get("name"),
                "labels": entry.get("labels", {}),
                "tiers": [
                    {"res": entry.get("res", 1.0), "buckets": entry.get("buckets", [])}
                ],
            }
        )
    return out


def _gauge_value(metrics: Dict[str, Any], name: str) -> Optional[float]:
    entry = metrics.get(name)
    if not entry:
        return None
    total = None
    for sample in entry.get("samples", []):
        if sample.get("suffix"):
            continue
        total = (total or 0.0) + float(sample.get("value", 0.0))
    return total


def render_device_panel(device: Optional[Dict[str, Any]]) -> List[str]:
    """The device-observatory rows.  A node that predates the /device
    route (or runs with the observatory off) renders dashes — the panel
    must degrade, never crash, on an old or un-instrumented peer."""
    if not isinstance(device, dict):
        return ["device: -  (observatory off, or node predates /device)"]
    try:
        ledger = device.get("ledger") or {}
        compile_doc = device.get("compile") or {}
        transfers = device.get("transfers") or {}
        donation = device.get("donation") or {}
        wakes = [
            r for r in device.get("recent_wakes") or [] if r.get("device_s")
        ]
        if wakes:
            mean_ms = sum(r["device_s"] for r in wakes) / len(wakes) * 1e3
            wake_cell = f"{mean_ms:.2f}ms/wake"
        else:
            wake_cell = "-"
        sweeps = [int(r["n_sweeps"]) for r in wakes if r.get("n_sweeps")]
        sweeps_cell = (
            f"{sum(sweeps) / len(sweeps):.1f} sweeps" if sweeps else "-"
        )
        lines = [
            "device: ledger "
            + fmt_si(ledger.get("total_bytes"))
            + "B ("
            + fmt_si(ledger.get("device_bytes"))
            + "B on-device) · "
            + wake_cell
            + " · "
            + sweeps_cell
            + f" · compile {fmt_si(compile_doc.get('hits_total'))}h/"
            + f"{fmt_si(compile_doc.get('misses_total'))}m"
            + f" · transfers {fmt_si(transfers.get('total_count'))}"
            + f" · donation copies {fmt_si(donation.get('copies_total'))}"
        ]
        families = sorted(
            (ledger.get("families") or {}).items(),
            key=lambda kv: -(kv[1].get("host", 0) + kv[1].get("device", 0)),
        )[:4]
        cells = [
            f"{fam} {fmt_si(t.get('host', 0) + t.get('device', 0))}B"
            for fam, t in families
            if t.get("host", 0) + t.get("device", 0)
        ]
        if cells:
            lines.append("  " + "  ".join(cells))
        return lines
    except Exception:
        return ["device: -  (unreadable /device document)"]


def render_dashboard(
    tsdoc: Dict[str, Any],
    alerts: Optional[Dict[str, Any]] = None,
    metrics: Optional[Dict[str, Any]] = None,
    width: int = 48,
    source: str = "",
    device: Optional[Dict[str, Any]] = None,
) -> str:
    """The full dashboard frame as plain text."""
    lines: List[str] = []
    merged = bool(tsdoc.get("merged"))
    series_list = (
        _merged_as_series(tsdoc) if merged else tsdoc.get("series", [])
    )
    node = tsdoc.get("node", "cluster" if merged else "?")
    stamp = time.strftime("%H:%M:%S", time.localtime(tsdoc.get("t", time.time())))
    title = f"uigc-top · {node} · {stamp}"
    if source:
        title += f" · {source}"
    lines.append(title)
    if merged:
        nodes = sorted(tsdoc.get("nodes", {}))
        missing = tsdoc.get("missing_nodes", [])
        lines.append(
            f"cluster: {len(nodes)} node(s) merged"
            + (f" · missing: {', '.join(missing)}" if missing else "")
        )
    if metrics:
        cells = []
        for name, label in HEADER_GAUGES:
            value = _gauge_value(metrics, name)
            if value is not None:
                cells.append(f"{label} {fmt_si(value)}")
        if cells:
            lines.append("  ".join(cells))
    lines.append("-" * (width + 60))
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for s in series_list:
        by_name.setdefault(s.get("name", "?"), []).append(s)
    for name, label, mode in KEY_SERIES:
        fans = by_name.get(name)
        if not fans:
            continue
        if len(fans) == 1:
            lines.append(
                render_series(label, series_points(fans[0], mode), width)
            )
        else:
            lines.append(f"{label}:")
            for fan in fans:
                sub = _labels_str(fan.get("labels", {})) or "(all)"
                lines.append(
                    "  "
                    + render_series(sub[:14], series_points(fan, mode), width)
                )
    # Per-peer link health: phi + writer queue keyed by peer label.
    peers: Dict[str, Dict[str, float]] = {}
    for s in _find_series({"series": series_list}, "uigc_link_phi"):
        peer = s.get("labels", {}).get("peer")
        pts = series_points(s, "last")
        if peer and pts:
            peers.setdefault(peer, {})["phi"] = pts[-1][1]
    for s in _find_series({"series": series_list}, "uigc_writer_queue_depth"):
        peer = s.get("labels", {}).get("peer")
        pts = series_points(s, "max")
        if peer and pts:
            peers.setdefault(peer, {})["queue"] = pts[-1][1]
    if peers:
        lines.append("")
        lines.append("links:")
        for peer, health in sorted(peers.items()):
            phi = health.get("phi")
            state = "ok" if phi is None or phi < 1.0 else (
                "suspect" if phi < 4.0 else "CRITICAL"
            )
            lines.append(
                f"  {peer:<28} phi {fmt_si(phi):>7}  "
                f"queue {fmt_si(health.get('queue')):>7}  [{state}]"
            )
    def metric_row(title, pairs, show_at_zero=()):
        """One 'plane' row: each metric's last sample summed over its
        labelsets.  Metrics in ``show_at_zero`` render even at 0 (an
        idle gauge is informative; an untouched counter is noise)."""
        cells = []
        for metric, label in pairs:
            total = 0.0
            seen_any = False
            for s in _find_series({"series": series_list}, metric):
                pts = series_points(s, "last")
                if pts:
                    seen_any = True
                    total += pts[-1][1]
            if seen_any and (total > 0 or metric in show_at_zero):
                cells.append(f"{label} {fmt_si(total)}")
        if cells:
            lines.append("")
            lines.append(title + ": " + "  ".join(cells))

    # Partition-tolerance counters (cluster/membership.py): nonzero
    # means the split-brain plane acted (or is refusing stale work).
    metric_row(
        "partition plane",
        (
            ("uigc_cluster_partitions_total", "partitions"),
            ("uigc_sbr_downed_total", "sbr-downed"),
            ("uigc_fence_rejected_total", "fence-rejected"),
            ("uigc_membership_disagreements_total", "view-conflicts"),
        ),
    )
    # Distributed-collector plane (engines/crgc/distributed.py): the
    # cross-node trace protocol's surface — boundary edges shown even
    # at zero so an idle partitioned node is visible.
    metric_row(
        "distributed collector",
        (
            ("uigc_dist_boundary_edges", "boundary-edges"),
            ("uigc_dist_marks_exchanged_total", "marks"),
            ("uigc_dist_mark_bytes_total", "mark-bytes"),
            ("uigc_dist_wave_rounds_total", "rounds"),
            ("uigc_dist_refolds_total", "refolds"),
            ("uigc_dist_mirror_evictions_total", "mirror-evicts"),
        ),
        show_at_zero=("uigc_dist_boundary_edges",),
    )
    # Ingress-gateway plane (uigc_tpu_torch/gateway): the front door — live
    # connections and egress depth shown even at zero so an attached
    # but idle gateway is visible.
    metric_row(
        "ingress gateway",
        (
            ("uigc_gateway_connections", "conns"),
            ("uigc_gateway_tenant_msgs_total", "msgs"),
            ("uigc_gateway_shed_total", "shed"),
            ("uigc_gateway_egress_queue_depth", "egress-depth"),
        ),
        show_at_zero=(
            "uigc_gateway_connections",
            "uigc_gateway_egress_queue_depth",
        ),
    )
    lines.append("")
    lines.extend(render_device_panel(device))
    firing = (alerts or {}).get("firing", [])
    lines.append("")
    if firing:
        lines.append(f"ALERTS ({len(firing)} firing):")
        for alert in firing:
            labels = _labels_str(alert.get("labels", {}))
            lines.append(
                f"  [{alert.get('severity', '?'):>8}] {alert.get('rule')}"
                f"{labels}  value={fmt_si(alert.get('value'))} "
                f"threshold={fmt_si(alert.get('threshold'))}"
            )
    else:
        lines.append("alerts: none firing")
    return "\n".join(lines)


# ------------------------------------------------------------------- #
# Sources
# ------------------------------------------------------------------- #


def fetch_live(
    base: str, merged: bool = False, window: float = 180.0
) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], Optional[Dict[str, Any]]]:
    """(timeseries doc, alerts doc, metrics.json) from a live node."""

    def get(path: str) -> Optional[Dict[str, Any]]:
        try:
            with urllib.request.urlopen(base + path, timeout=5) as rsp:
                return json.loads(rsp.read())
        except Exception:
            return None

    ts_path = f"/timeseries?window={window:g}"
    if merged:
        ts_path += "&merged=1"
    tsdoc = get(ts_path)
    if tsdoc is None:
        raise ConnectionError(f"no /timeseries at {base} (timeseries off?)")
    return tsdoc, get("/alerts"), get("/metrics.json")


def fetch_device(base: str) -> Optional[Dict[str, Any]]:
    """The /device observatory doc, or None on a node that predates it
    or runs with ``uigc.telemetry.device`` off — the device panel
    renders dashes for None, never raises."""
    try:
        with urllib.request.urlopen(base + "/device", timeout=5) as rsp:
            return json.loads(rsp.read())
    except Exception:
        return None


def replay_device(path: str) -> Optional[Dict[str, Any]]:
    """Rebuild the event-fed observatory planes (compile cache, host
    transfers, donation audit) from a persisted JSONL sink — the memory
    ledger needs a live graph and stays empty offline."""
    try:
        from uigc_tpu_torch.telemetry.device import DeviceObservatory
        from uigc_tpu_torch.telemetry.exporter import replay_jsonl

        # Unscoped (node="") so the origin filter accepts the sink's
        # events — every persisted line carries the live node's origin
        # tag, which a "replay:<file>" node name would reject wholesale.
        obs = DeviceObservatory(node="")
        try:
            for name, fields in replay_jsonl(path):
                obs(name, fields)
            obs.node = f"replay:{Path(path).name}"  # display only
            return obs.to_doc()
        finally:
            obs.close()
    except Exception:
        return None


def replay_model(
    path: str, stride: int = 200
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """Rebuild (timeseries doc, alerts doc, metrics.json) offline from
    a JSONL event sink: the live event->metrics bridge refills a
    registry, and a synthetic 1s-per-``stride``-events clock samples it
    into a store while the built-in rules re-evaluate."""
    from uigc_tpu_torch.config import Config
    from uigc_tpu_torch.telemetry.alerts import AlertEngine, builtin_rules
    from uigc_tpu_torch.telemetry.exporter import replay_jsonl
    from uigc_tpu_torch.telemetry.metrics import (EventMetricsBridge,
                                                  MetricsRegistry)
    from uigc_tpu_torch.telemetry.timeseries import (MetricsSampler,
                                                     TimeSeriesStore)

    node = f"replay:{Path(path).name}"
    registry = MetricsRegistry()
    bridge = EventMetricsBridge(registry)
    clock_t = [time.time() - 3600.0]
    store = TimeSeriesStore(node=node, clock=lambda: clock_t[0])
    engine = AlertEngine(store, node=node)
    engine.add_rules(builtin_rules(Config()))
    sampler = MetricsSampler(
        store, registry=registry, alerts=engine, clock=lambda: clock_t[0]
    )
    n = 0
    for name, fields in replay_jsonl(path):
        bridge(name, fields)
        n += 1
        if n % stride == 0:
            sampler.sample_once(clock_t[0])
            clock_t[0] += 1.0
    if n == 0:
        raise FileNotFoundError(f"no events in {path!r}")
    sampler.sample_once(clock_t[0])
    return (
        store.to_doc(),
        engine.to_doc(),
        registry.snapshot(),
    )


# ------------------------------------------------------------------- #
# Main loop
# ------------------------------------------------------------------- #


def _curses_loop(args) -> int:
    import curses

    def body(screen) -> None:
        curses.curs_set(0)
        screen.nodelay(True)
        while True:
            # A transient fetch failure (node saturated, mid-restart)
            # renders as a stale-data notice — a top-style tool keeps
            # polling through exactly the windows where the system is
            # most interesting.
            try:
                tsdoc, alerts, metrics = fetch_live(
                    args.url, merged=args.merged, window=args.window
                )
                frame = render_dashboard(
                    tsdoc, alerts, metrics, width=args.width, source=args.url,
                    device=fetch_device(args.url),
                )
            except Exception as exc:
                frame = f"uigc-top · {args.url}\n\nno data: {exc}\nretrying…"
            screen.erase()
            rows, cols = screen.getmaxyx()
            for i, line in enumerate(frame.splitlines()[: rows - 1]):
                try:
                    screen.addnstr(i, 0, line, cols - 1)
                except curses.error:
                    pass
            screen.refresh()
            deadline = time.monotonic() + args.interval
            while time.monotonic() < deadline:
                ch = screen.getch()
                if ch in (ord("q"), ord("Q")):
                    return
                time.sleep(0.05)

    curses.wrapper(body)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="uigc-top", description=__doc__.splitlines()[0]
    )
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument(
        "--url", metavar="URL", help="live node base URL (http://host:port)"
    )
    source.add_argument(
        "--from-jsonl", metavar="PATH", help="replay a JSONL event sink"
    )
    parser.add_argument(
        "--merged", action="store_true",
        help="pull the cluster-wide merged view (tsq/tsr) from the node",
    )
    parser.add_argument(
        "--interval", type=float, default=1.0, help="poll interval seconds"
    )
    parser.add_argument(
        "--window", type=float, default=180.0, help="history window seconds"
    )
    parser.add_argument("--width", type=int, default=48, help="sparkline width")
    parser.add_argument(
        "--once", action="store_true", help="print one frame and exit"
    )
    parser.add_argument(
        "--plain", action="store_true",
        help="never use curses; print frames to stdout",
    )
    args = parser.parse_args(argv)

    if args.from_jsonl:
        try:
            tsdoc, alerts, metrics = replay_model(args.from_jsonl)
        except (FileNotFoundError, OSError) as exc:
            print(f"uigc-top: {exc}", file=sys.stderr)
            return 1
        print(
            render_dashboard(
                tsdoc, alerts, metrics, width=args.width,
                source=f"jsonl:{args.from_jsonl}",
                device=replay_device(args.from_jsonl),
            )
        )
        return 0

    base = args.url.rstrip("/")
    args.url = base
    if args.once or args.plain or not sys.stdout.isatty():
        while True:
            try:
                tsdoc, alerts, metrics = fetch_live(
                    base, merged=args.merged, window=args.window
                )
            except Exception as exc:
                print(f"uigc-top: {exc}", file=sys.stderr)
                if args.once:
                    return 1
                # transient: keep polling (see the curses loop's note)
                time.sleep(args.interval)
                continue
            print(
                render_dashboard(
                    tsdoc, alerts, metrics, width=args.width, source=base,
                    device=fetch_device(base),
                )
            )
            if args.once:
                return 0
            sys.stdout.flush()
            time.sleep(args.interval)
    try:
        return _curses_loop(args)
    except Exception as exc:
        print(f"uigc-top: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
