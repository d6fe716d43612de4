"""telemetry-dump: render uigc telemetry as Prometheus text or JSON.

The port's copy of ``tools/telemetry_dump.py``, run from the repository
root as ``python -m uigc_tpu_torch.tools.telemetry_dump``.  Its demo
collector traces on the CUDA card (``device`` shadow graph) unless
``--device cpu`` is passed.

Three sources, one output pipeline (build a metrics registry, render):

- ``--from-jsonl PATH``  replay a persisted JSONL event log
  (``uigc.telemetry.jsonl-path``) through the same event->metrics
  bridge a live system uses, so an offline dump and a live scrape of
  the same run agree;
- ``--demo``             run a tiny in-process workload with telemetry
  attached (spawn/churn/release under a fast collector tracing on
  ``--device``: ``cuda`` by default, ``cpu`` for the plain versions) and
  dump what it produced — the zero-to-metrics smoke;
- ``--snapshot PATH``    pretty-print a recorder snapshot JSON file
  (``events.recorder.snapshot()`` saved by your program) as-is.

Output: ``--format prom`` (default; Prometheus text exposition) or
``--format json`` (the registry snapshot).  One document to stdout.

``--series NAME`` switches to the telemetry time plane: render one
stored series (every labelset fan-out) as an ASCII sparkline + stats,
from a live ``/timeseries`` endpoint (``--url``) or a JSONL replay
(``--from-jsonl``) — the renderers are shared with ``uigc_top``.

``--device`` with no value renders the device-plane observatory
(``uigc.telemetry.device``): from a live ``/device`` endpoint
(``--url``) or by replaying the event-fed planes (compile cache, host
transfers, donation audit) out of a JSONL sink — the renderers are
``device_report``'s.  ``--device cuda`` / ``--device cpu`` instead
names where the demo systems of ``--demo`` and ``--inspect`` trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

#: ``--device`` with no value: render the observatory
_OBSERVATORY = "observatory"


def _registry(node: str):
    from uigc_tpu_torch.telemetry.metrics import (EventMetricsBridge,
                                                  MetricsRegistry)

    registry = MetricsRegistry(const_labels={"node": node})
    return registry, EventMetricsBridge(registry)


def dump_from_jsonl(path: str, fmt: str) -> int:
    from uigc_tpu_torch.telemetry.exporter import prometheus_text, replay_jsonl

    registry, bridge = _registry(node=f"replay:{Path(path).name}")
    n = 0
    for name, fields in replay_jsonl(path):
        bridge(name, fields)
        n += 1
    if n == 0:
        print(f"telemetry-dump: no events in {path!r}", file=sys.stderr)
        return 1
    if fmt == "json":
        print(json.dumps(registry.snapshot(), indent=2, sort_keys=True, default=repr))
    else:
        sys.stdout.write(prometheus_text(registry))
    return 0


def dump_demo(fmt: str, device: str = "cuda") -> int:
    from uigc_tpu_torch import AbstractBehavior, ActorTestKit, Behaviors, NoRefs
    from uigc_tpu_torch.telemetry.exporter import prometheus_text

    class Ping(NoRefs):
        pass

    class Worker(AbstractBehavior):
        def on_message(self, msg):
            return self

    class Root(AbstractBehavior):
        def __init__(self, context):
            super().__init__(context)
            self.workers = [
                context.spawn(Behaviors.setup(Worker), f"w{i}") for i in range(8)
            ]

        def on_message(self, msg):
            ctx = self.context
            if isinstance(msg, Ping) and self.workers:
                for worker in self.workers:
                    worker.tell(Ping(), ctx)
            elif self.workers:
                ctx.release(*self.workers)
                self.workers = []
            return self

    kit = ActorTestKit(
        config={
            "uigc.crgc.wakeup-interval": 10,
            "uigc.crgc.shadow-graph": "device",
            "uigc.crgc.device": device,
            "uigc.telemetry.metrics": True,
            "uigc.telemetry.wake-profile": True,
        },
        name="telemetry-demo",
    )
    try:
        root = kit.spawn(Behaviors.setup_root(Root), "root")
        for _ in range(50):
            root.tell(Ping())
        time.sleep(0.3)
        root.tell(object())  # release branch
        time.sleep(0.5)
        telemetry = kit.system.telemetry
        if fmt == "json":
            doc = {
                "metrics": telemetry.registry.snapshot(),
                "wake_profile": telemetry.profiler.to_json(),
            }
            print(json.dumps(doc, indent=2, sort_keys=True, default=repr))
        else:
            sys.stdout.write(prometheus_text(telemetry.registry))
    finally:
        kit.shutdown()
    return 0


def dump_snapshot(path: str, fmt: str) -> int:
    with open(path) as fh:
        snap = json.load(fh)
    if fmt == "json":
        print(json.dumps(snap, indent=2, sort_keys=True))
        return 0
    # Render a recorder snapshot as gauges/counters: counts are
    # monotone (counter-like), sums and duration stats become gauges.
    lines = []
    for name, count in sorted(snap.get("counts", {}).items()):
        metric = "uigc_event_total{event=\"%s\"}" % name
        lines.append(f"{metric} {count}")
    for name, value in sorted(snap.get("sums", {}).items()):
        lines.append('uigc_event_sum{field="%s"} %s' % (name, value))
    for name, stat in sorted(snap.get("durations", {}).items()):
        for key in ("n", "total_s", "max_s"):
            lines.append(
                'uigc_event_duration_%s{event="%s"} %s' % (key, name, stat[key])
            )
    sys.stdout.write("\n".join(lines) + "\n")
    return 0


def dump_inspect(path, actor, fmt, device: str = "cuda") -> int:
    """Pretty-print a liveness-inspector snapshot (and optionally one
    why-live retaining path): from a dumped JSON file when ``path`` is
    given, else from a live in-process demo system on ``device`` — the
    rendering is shared with graph_inspect."""
    from uigc_tpu_torch.telemetry.inspect import why_live

    from . import graph_inspect

    if path:
        snap = graph_inspect.load_snapshot(path)
        result = why_live(snap, actor) if actor else None
    else:
        demo = graph_inspect.DemoSystem(device=device)
        try:
            snap = demo.inspector.snapshot()
            result = demo.inspector.why_live(actor) if actor else None
        finally:
            demo.shutdown()
    if fmt == "json":
        doc = {"snapshot": snap}
        if result is not None:
            doc["why_live"] = result
        print(json.dumps(doc, indent=2, sort_keys=True, default=repr))
    else:
        print(graph_inspect.render_snapshot(snap))
        if result is not None:
            print(graph_inspect.render_why_live(result))
    return 0


def dump_series(name, url, jsonl, fmt) -> int:
    """Render one stored time-plane series (every labelset fan-out) as
    an ASCII sparkline + stats, from a live ``/timeseries`` endpoint or
    a JSONL replay — the renderers are uigc_top's."""
    from . import uigc_top

    if url:
        try:
            tsdoc, _alerts, _metrics = uigc_top.fetch_live(
                url.rstrip("/"), window=1e9
            )
        except Exception as exc:
            print(f"telemetry-dump: {exc}", file=sys.stderr)
            return 1
    else:
        try:
            tsdoc, _alerts, _metrics = uigc_top.replay_model(jsonl)
        except (FileNotFoundError, OSError) as exc:
            print(f"telemetry-dump: {exc}", file=sys.stderr)
            return 1
    matching = [s for s in tsdoc.get("series", []) if s.get("name") == name]
    if not matching:
        known = sorted({s.get("name") for s in tsdoc.get("series", [])})
        print(
            f"telemetry-dump: no series {name!r}; known: {', '.join(known)}",
            file=sys.stderr,
        )
        return 1
    if fmt == "json":
        print(json.dumps(
            {"name": name, "series": matching},
            indent=2, sort_keys=True, default=repr,
        ))
        return 0
    mode = "rate" if name.endswith("_total") else "mean"
    print(f"{name}  ({len(matching)} labelset(s), mode={mode})")
    for series in matching:
        labels = series.get("labels") or {}
        label = (
            ",".join(f"{k}={v}" for k, v in sorted(labels.items())) or "(all)"
        )
        points = uigc_top.series_points(series, mode)
        print("  " + uigc_top.render_series(label[:16], points, width=48))
    return 0


def dump_device(url, jsonl, fmt) -> int:
    """Render the device observatory: live ``/device`` or the event-fed
    planes replayed from a JSONL sink (device_report's renderers)."""
    from . import device_report, uigc_top

    if url:
        try:
            doc = device_report.fetch_doc(url.rstrip("/"))
        except Exception as exc:
            print(
                f"telemetry-dump: no /device at {url} "
                f"(uigc.telemetry.device off?): {exc}",
                file=sys.stderr,
            )
            return 1
    else:
        doc = uigc_top.replay_device(jsonl)
        if doc is None:
            print(
                f"telemetry-dump: no replayable events in {jsonl!r}",
                file=sys.stderr,
            )
            return 1
    if fmt == "json":
        print(json.dumps(doc, indent=2, sort_keys=True, default=repr))
        return 0
    print(
        device_report.render_device_doc(
            doc, device_report.committed_device_figures()
        )
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="telemetry-dump", description=__doc__.splitlines()[0]
    )
    parser.add_argument(
        "--series",
        metavar="NAME",
        help="render one time-plane series (sparkline + stats) from "
        "--url or --from-jsonl (uigc_top's renderers)",
    )
    parser.add_argument(
        "--device",
        nargs="?",
        const=_OBSERVATORY,
        choices=(_OBSERVATORY, "cuda", "cpu"),
        default=None,
        help="with no value: render the device-plane observatory from "
        "--url (/device) or --from-jsonl (device_report's renderers); "
        "cuda (the default) or cpu: where the --demo / --inspect demo "
        "system's collector traces",
    )
    parser.add_argument(
        "--url",
        metavar="URL",
        help="live metrics-HTTP base URL for --series",
    )
    source = parser.add_mutually_exclusive_group()
    source.add_argument("--from-jsonl", metavar="PATH", help="replay a JSONL event log")
    source.add_argument(
        "--demo", action="store_true", help="run a tiny workload and dump its metrics"
    )
    source.add_argument(
        "--snapshot", metavar="PATH", help="render a saved recorder snapshot JSON"
    )
    source.add_argument(
        "--inspect",
        nargs="?",
        const="",
        metavar="SNAPJSON",
        default=None,
        help="pretty-print a liveness snapshot (from SNAPJSON when "
        "given, else from a live demo system); combine with --actor "
        "for a why-live path (graph_inspect)",
    )
    parser.add_argument(
        "--actor", metavar="NAME", help="actor to explain with --inspect"
    )
    parser.add_argument(
        "--format",
        choices=("prom", "json"),
        default="prom",
        help="output format (default: prom)",
    )
    args = parser.parse_args(argv)
    demo_device = args.device if args.device in ("cuda", "cpu") else "cuda"
    if args.device == _OBSERVATORY:
        if not args.url and not args.from_jsonl:
            parser.error("--device needs --url or --from-jsonl")
        return dump_device(args.url, args.from_jsonl, args.format)
    if args.series:
        if not args.url and not args.from_jsonl:
            parser.error("--series needs --url or --from-jsonl")
        return dump_series(args.series, args.url, args.from_jsonl, args.format)
    if args.inspect is not None:
        return dump_inspect(args.inspect, args.actor, args.format,
                            demo_device)
    if args.from_jsonl:
        return dump_from_jsonl(args.from_jsonl, args.format)
    if args.snapshot:
        return dump_snapshot(args.snapshot, args.format)
    if args.demo:
        return dump_demo(args.format, demo_device)
    parser.error(
        "one of --from-jsonl / --demo / --snapshot / --inspect is required"
    )
    return 2


if __name__ == "__main__":
    sys.exit(main())
