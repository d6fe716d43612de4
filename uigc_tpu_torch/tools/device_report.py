"""device-report: wake-budget attribution from the device observatory.

The port's copy of ``tools/device_report.py``, run from the repository
root as ``python -m uigc_tpu_torch.tools.device_report``.  Two changes:
the demo and the self-check run on ``--device`` (the CUDA card by
default, ``cpu`` for the kernels' plain versions), and the committed
trajectory it compares against is the port's own — the reference's
``BENCH_WAKE_r*`` / ``BENCH_TPU_SESSION_r*`` rounds hold TPU figures,
which are not the port's, so :func:`committed_device_figures` returns
None until the port commits H100 rounds and the report says so.

Renders the ``uigc.telemetry.device`` observatory document (the
``/device`` HTTP route) as the device-plane regression explainer:
per-wake device time decomposed sweep-by-sweep, the HBM/array memory
ledger with peak watermarks, compile-cache hit/miss streams (the
recompile-storm detector), host-transfer accounting per readback site
and wake phase, and the donation audit — then compares the measured
``device_per_wake_ms`` against the committed trajectory (none yet on the
port) and prints the top regressing plane (kernel tag or array family)
first.

Sources:

- ``--url http://127.0.0.1:PORT``  a live node's metrics HTTP server
  (``uigc.telemetry.device`` + ``uigc.telemetry.http-port``);
- ``--from FILE``  a dumped observatory document (``--json`` output of
  a previous run, or a saved ``/device`` body);
- ``--demo``  a small in-process churn workload on the decremental
  device backend — the zero-to-report smoke;
- ``--selfcheck``  the verify gate: drives the demo and exits nonzero
  unless all three planes (ledger / compile / sweep attribution)
  produced nonzero, schema-valid output AND the per-sweep attribution
  totals reconcile with the wake profiler's device phase time within
  10%.

The renderers are shared with ``telemetry_dump --device`` and the
``uigc_top`` device panel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional

#: the repository root: uigc_tpu_torch/tools/device_report.py
REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    v = float(n)
    for bound, suffix in ((1 << 30, "GiB"), (1 << 20, "MiB"), (1 << 10, "KiB")):
        if v >= bound:
            return f"{v / bound:.1f}{suffix}"
    return f"{int(v)}B"


# ------------------------------------------------------------------- #
# Committed trajectory (the comparison baseline)
# ------------------------------------------------------------------- #


def committed_device_figures(repo: str = REPO) -> Optional[Dict[str, Any]]:
    """The newest committed device-plane figures of the port
    (``device_per_wake_ms`` / ``sweeps_mean`` / ``device_per_sweep_ms``
    measured on its card), or None.

    The reference reads them from its ``BENCH_WAKE_r*.json`` and
    ``BENCH_TPU_SESSION_r*.json`` rounds, which hold TPU figures: a
    comparison of the port's H100 wakes against them would explain a
    hardware difference as a regression.  The port reads no TPU
    artifact, and has committed no H100 round yet, so this returns None
    for every ``repo`` and the comparison skips, saying why (ROADMAP.md
    Queue 3)."""
    del repo  # no H100 trajectory exists yet to look for
    return None


# ------------------------------------------------------------------- #
# Analysis: the regression explainer
# ------------------------------------------------------------------- #


def measured_wake_figures(doc: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Aggregate device figures over the doc's device-active wakes."""
    wakes = [r for r in doc.get("recent_wakes", []) if r.get("device_s")]
    if not wakes:
        return None
    device_ms = sorted(r["device_s"] * 1000.0 for r in wakes)
    sweeps = [int(r["n_sweeps"]) for r in wakes if r.get("n_sweeps")]
    attributed = [
        (i, ms)
        for r in wakes
        for i, ms in enumerate(r.get("sweep_device_ms") or [])
    ]
    top_sweep = max(attributed, key=lambda t: t[1]) if attributed else None
    return {
        "wakes": len(wakes),
        "device_per_wake_ms": sum(device_ms) / len(device_ms),
        "device_per_wake_ms_p50": device_ms[len(device_ms) // 2],
        "sweeps_mean": (sum(sweeps) / len(sweeps)) if sweeps else None,
        "top_sweep": top_sweep,  # (sweep index, attributed ms)
    }


def findings(
    doc: Dict[str, Any], committed: Optional[Dict[str, Any]] = None
) -> List[Dict[str, str]]:
    """The explainer: ordered (severity, plane, label, detail) findings,
    worst first.  Deterministic rules, no magic — each names the plane
    and the kernel tag / array family / readback site to look at."""
    out: List[Dict[str, str]] = []

    # Compile plane: a tag missing repeatedly is a recompile storm —
    # one miss per geometry is the healthy shape.  Aggregated per TAG,
    # not per (tag, geom): the classic shape-key bug compiles a FRESH
    # geometry every wake, so each entry shows one innocent miss and
    # only the tag-level stream reveals the storm.
    per_tag: Dict[str, List[int]] = {}
    for entry in doc.get("compile", {}).get("entries", []):
        tag = str(entry.get("tag"))
        slot = per_tag.setdefault(tag, [0, 0, 0])
        slot[0] += int(entry.get("misses", 0))
        slot[1] += int(entry.get("hits", 0))
        slot[2] += 1
    for tag, (misses, hits, geoms) in sorted(per_tag.items()):
        if misses >= 3 and misses > hits:
            out.append({
                "severity": "critical",
                "plane": "compile",
                "label": tag,
                "detail": (
                    f"{misses} rebuilds vs {hits} hits across {geoms} "
                    "geometrie(s) — per-wake recompile (shape-key "
                    "churn); every wake pays a fresh compile"
                ),
            })

    # Donation audit: any copy is a real finding — the donating site is
    # paying double HBM traffic per wake.
    for site, count in sorted(
        (doc.get("donation", {}).get("sites") or {}).items()
    ):
        out.append({
            "severity": "warning",
            "plane": "donation",
            "label": site,
            "detail": (
                f"{count} donated buffer(s) survived their donating call "
                "(XLA copied instead of aliasing)"
            ),
        })

    # Transfer plane: readbacks landing OUTSIDE the trace bracket are
    # stray — ingest/fold/broadcast should never touch the device.
    for rec in doc.get("transfers", {}).get("sites", []):
        phase = rec.get("phase", "")
        if phase and phase not in ("trace", "sweep"):
            out.append({
                "severity": "warning",
                "plane": "transfer",
                "label": f"{rec.get('site')}@{phase}",
                "detail": (
                    f"{rec.get('count')} host transfer(s), "
                    f"{fmt_bytes(rec.get('bytes'))} inside the "
                    f"{phase!r} phase — a hot-path readback"
                ),
            })

    # Trajectory: measured per-wake device time vs the committed figure.
    measured = measured_wake_figures(doc)
    if measured and committed:
        prior = committed["device_per_wake_ms"]
        now = measured["device_per_wake_ms"]
        if prior > 0 and now > prior * 1.4:
            top = measured.get("top_sweep")
            sweep_note = (
                f"; heaviest sweep #{top[0]} at {top[1]:.2f}ms attributed"
                if top
                else ""
            )
            out.append({
                "severity": "critical",
                "plane": "wake_budget",
                "label": "device_per_wake_ms",
                "detail": (
                    f"{now:.2f}ms vs committed {prior:.2f}ms "
                    f"({committed['source']}){sweep_note}"
                ),
            })

    # Ledger: the family at its peak holding the most bytes (context
    # line, not an alarm: the ~700MB device-resident layout question).
    families = doc.get("ledger", {}).get("families", {})
    peaks = doc.get("ledger", {}).get("peaks", {})
    if families:
        fam, tally = max(
            families.items(), key=lambda kv: kv[1]["host"] + kv[1]["device"]
        )
        total = tally["host"] + tally["device"]
        out.append({
            "severity": "info",
            "plane": "ledger",
            "label": fam,
            "detail": (
                f"largest family: {fmt_bytes(total)} live "
                f"({fmt_bytes(tally['device'])} device-resident, "
                f"peak {fmt_bytes(peaks.get(fam, total))})"
            ),
        })
    severity_rank = {"critical": 0, "warning": 1, "info": 2}
    out.sort(key=lambda f: severity_rank.get(f["severity"], 3))
    return out


# ------------------------------------------------------------------- #
# Rendering (shared with telemetry_dump --device / uigc_top)
# ------------------------------------------------------------------- #


def render_device_doc(
    doc: Dict[str, Any], committed: Optional[Dict[str, Any]] = None
) -> str:
    lines: List[str] = []
    ledger = doc.get("ledger", {})
    stamp = time.strftime(
        "%H:%M:%S", time.localtime(doc.get("t", time.time()))
    )
    lines.append(
        f"device-report · {doc.get('node', '?')} · {stamp} · "
        f"{doc.get('wakes', 0)} wakes sampled"
    )
    lines.append("")

    flist = findings(doc, committed)
    alarms = [f for f in flist if f["severity"] != "info"]
    lines.append(
        f"findings ({len(alarms)} actionable):" if flist else "findings: none"
    )
    for f in flist:
        lines.append(
            f"  [{f['severity']:>8}] {f['plane']}/{f['label']}: {f['detail']}"
        )
    lines.append("")

    measured = measured_wake_figures(doc)
    lines.append("wake budget (device plane):")
    if measured:
        lines.append(
            f"  device_per_wake_ms  mean {measured['device_per_wake_ms']:.3f}"
            f"  p50 {measured['device_per_wake_ms_p50']:.3f}"
            f"  over {measured['wakes']} device-active wake(s)"
        )
        if measured["sweeps_mean"] is not None:
            lines.append(f"  sweeps_mean         {measured['sweeps_mean']:.2f}")
    else:
        lines.append("  (no device-active wakes recorded)")
    if committed:
        lines.append(
            f"  committed           {committed['device_per_wake_ms']:.3f}ms"
            f"/wake ({committed['source']})"
            + (
                f", sweeps_mean {committed['sweeps_mean']:.2f}"
                if committed.get("sweeps_mean") is not None
                else ""
            )
        )
    else:
        lines.append(
            "  committed           (no H100 round of the port carries "
            "device_per_wake_ms — nothing to compare; TPU rounds are not "
            "the port's)"
        )
    # Sweep-by-sweep decomposition of the newest stats-bearing wake.
    stats_wakes = [
        r for r in doc.get("recent_wakes", []) if r.get("sweep_device_ms")
    ]
    if stats_wakes:
        r = stats_wakes[-1]
        lines.append(
            f"  newest decomposed wake: {int(r.get('n_sweeps', 0))} sweep(s),"
            f" device {r.get('device_s', 0.0) * 1000:.3f}ms"
        )
        dirty = r.get("sweep_dirty_chunks") or []
        for i, ms in enumerate(r["sweep_device_ms"]):
            extra = f"  dirty_chunks {dirty[i]}" if i < len(dirty) else ""
            best = r.get("sweep_bytes_est") or []
            est = f"  ~{fmt_bytes(best[i])}" if i < len(best) else ""
            lines.append(f"    sweep {i}: {ms:9.3f}ms{est}{extra}")
    lines.append("")

    lines.append("memory ledger:")
    families = ledger.get("families", {})
    peaks = ledger.get("peaks", {})
    if families:
        width = max(len(f) for f in families) + 2
        lines.append(
            f"  {'family'.ljust(width)}{'live':>10}{'device':>10}{'peak':>10}"
        )
        for fam in sorted(
            families, key=lambda f: -(families[f]["host"] + families[f]["device"])
        ):
            tally = families[fam]
            total = tally["host"] + tally["device"]
            lines.append(
                f"  {fam.ljust(width)}{fmt_bytes(total):>10}"
                f"{fmt_bytes(tally['device']):>10}"
                f"{fmt_bytes(peaks.get(fam, total)):>10}"
            )
        lines.append(
            f"  total {fmt_bytes(ledger.get('total_bytes'))} live, "
            f"{fmt_bytes(ledger.get('device_bytes'))} device-resident"
        )
    else:
        lines.append("  (no ledger samples yet)")
    lines.append("")

    lines.append("compile cache:")
    entries = doc.get("compile", {}).get("entries", [])
    if entries:
        for entry in entries:
            compile_s = entry.get("compile_s") or 0.0
            lines.append(
                f"  {entry.get('tag', '?'):<24} geom {entry.get('geom', '?'):<10}"
                f" hits {int(entry.get('hits', 0)):>6}"
                f" misses {int(entry.get('misses', 0)):>4}"
                + (f"  build {compile_s:.2f}s" if compile_s else "")
            )
        jx = doc.get("compile", {}).get("jax_backend", {})
        if jx.get("n"):
            lines.append(
                f"  xla backend_compile: {jx['n']} compile(s), "
                f"{jx['total_s']:.2f}s total, {jx['max_s']:.2f}s max"
            )
    else:
        lines.append("  (no compile-cache traffic observed)")
    lines.append("")

    lines.append("host transfers:")
    sites = doc.get("transfers", {}).get("sites", [])
    if sites:
        for rec in sites:
            phase = rec.get("phase") or "(no wake)"
            lines.append(
                f"  {rec.get('site', '?'):<24} {phase:<12}"
                f" n {int(rec.get('count', 0)):>6}"
                f"  {fmt_bytes(rec.get('bytes')):>10}"
            )
    else:
        lines.append("  none observed (transfer-free on the sampled window)")
    donation = doc.get("donation", {})
    if donation.get("copies_total"):
        lines.append("")
        lines.append(
            f"donation audit: {donation['copies_total']} silent cop(ies): "
            + ", ".join(
                f"{site}×{count}"
                for site, count in sorted(donation.get("sites", {}).items())
            )
        )
    return "\n".join(lines)


# ------------------------------------------------------------------- #
# Sources
# ------------------------------------------------------------------- #


def fetch_doc(base: str) -> Dict[str, Any]:
    with urllib.request.urlopen(base.rstrip("/") + "/device", timeout=10) as rsp:
        return json.loads(rsp.read())


class DemoSystem:
    """Decremental device backend under spawn/release churn with the
    observatory attached — enough cycles that the repair fixpoint runs
    real sweeps (the sweep-attribution plane needs n_sweeps >= 1)."""

    def __init__(self, extra_config: Optional[dict] = None,
                 device: str = "cuda"):
        from uigc_tpu_torch import (
            AbstractBehavior,
            ActorTestKit,
            Behaviors,
            NoRefs,
        )

        class Spawn(NoRefs):
            pass

        class Drop(NoRefs):
            pass

        class Worker(AbstractBehavior):
            def on_message(self, msg):
                return self

        outer = self

        class Root(AbstractBehavior):
            def __init__(self, context):
                super().__init__(context)
                self.held = []

            def on_message(self, msg):
                ctx = self.context
                if isinstance(msg, Spawn):
                    base = outer.spawned
                    outer.spawned += len_chain
                    self.held.extend(
                        ctx.spawn(Behaviors.setup(Worker), f"w{base + i}")
                        for i in range(len_chain)
                    )
                elif isinstance(msg, Drop) and self.held:
                    ctx.release(*self.held)
                    self.held = []
                return self

        len_chain = 24
        self.spawned = 0
        config = {
            "uigc.crgc.wakeup-interval": 10,
            "uigc.crgc.shadow-graph": "decremental",
            "uigc.crgc.device": device,
            "uigc.telemetry.device": True,
            "uigc.telemetry.timeseries": True,
            "uigc.telemetry.ts-sample-interval": 100,
        }
        config.update(extra_config or {})
        self.kit = ActorTestKit(config=config, name="device-report-demo")
        self.root = self.kit.spawn(Behaviors.setup_root(Root), "root")
        self._spawn_msg, self._drop_msg = Spawn, Drop

    def churn(self, cycles: int = 5, settle_s: float = 0.2) -> None:
        for _ in range(cycles):
            self.root.tell(self._spawn_msg())
            time.sleep(settle_s)
            self.root.tell(self._drop_msg())
            time.sleep(settle_s)

    @property
    def telemetry(self):
        return self.kit.system.telemetry

    def shutdown(self) -> None:
        self.kit.shutdown()


def run_selfcheck(device: str = "cuda") -> int:
    """The verify gate: all three planes nonzero, schema valid,
    attribution reconciles with the profiler's device phase within
    10%."""
    from uigc_tpu_torch.telemetry.device import validate_device_doc

    failures: List[str] = []
    demo = DemoSystem(device=device)
    try:
        # First collect pays the kernel build + the wake-fn build.
        time.sleep(2.0)
        demo.churn(cycles=6)
        deadline = time.time() + 30.0
        doc = demo.telemetry.observatory.to_doc()
        while time.time() < deadline:
            doc = demo.telemetry.observatory.to_doc()
            if any(r.get("n_sweeps") for r in doc["recent_wakes"]):
                break
            demo.churn(cycles=2)
        problems = validate_device_doc(doc)
        if problems:
            failures.append(f"schema: {problems}")
        if doc["wakes"] <= 0:
            failures.append("ledger plane: no wake samples")
        families = doc["ledger"]["families"]
        if not any(t["host"] + t["device"] for t in families.values()):
            failures.append("ledger plane: all families zero")
        if doc["compile"]["misses_total"] + doc["compile"]["hits_total"] <= 0:
            failures.append("compile plane: no cache traffic")
        stats_wakes = [r for r in doc["recent_wakes"] if r.get("n_sweeps")]
        if not stats_wakes:
            failures.append("sweep plane: no wake carried n_sweeps >= 1")
        for rec in stats_wakes:
            ms = rec.get("sweep_device_ms") or []
            device_ms = rec.get("device_s", 0.0) * 1000.0
            if ms and device_ms > 0:
                drift = abs(sum(ms) - device_ms) / device_ms
                if drift > 0.10:
                    failures.append(
                        f"attribution drift {drift:.1%} vs the profiler's "
                        f"device time on wake at t={rec.get('t')}"
                    )
        # The profiler's own view must agree in aggregate too.
        profiler = demo.telemetry.profiler
        prof_device_s = profiler.to_json()["phases"]["trace"]["device_total_s"]
        doc_device_s = sum(
            r.get("device_s", 0.0) for r in profiler.wakes_since(0.0)
        )
        if prof_device_s > 0:
            drift = abs(doc_device_s - prof_device_s) / prof_device_s
            # wakes_since is ring-bounded; only flag when it holds MORE
            # time than the running total (impossible) or the ring
            # covers everything yet disagrees.
            if doc_device_s > prof_device_s * 1.10:
                failures.append(
                    f"per-wake records exceed the profiler total by {drift:.1%}"
                )
        print(render_device_doc(doc, committed_device_figures()))
    finally:
        demo.shutdown()
    if failures:
        print("\ndevice-report selfcheck FAILED:", file=sys.stderr)
        for failure in failures:
            print(f"  - {failure}", file=sys.stderr)
        return 1
    print("\ndevice-report selfcheck OK", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="device-report", description=__doc__.splitlines()[0]
    )
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument(
        "--url", metavar="URL", help="live node base URL (http://host:port)"
    )
    source.add_argument(
        "--from", dest="from_file", metavar="FILE",
        help="a saved observatory document (/device body or --json output)",
    )
    source.add_argument(
        "--demo", action="store_true",
        help="drive a small churn workload and report on it",
    )
    source.add_argument(
        "--selfcheck", action="store_true",
        help="verify gate: demo + assert every plane produced "
        "schema-valid nonzero output (exit 1 otherwise)",
    )
    parser.add_argument(
        "--repo", default=REPO,
        help="repo root holding the committed trajectory",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the raw observatory document instead of the report",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the --demo / --selfcheck collector traces (default: "
        "the CUDA card; cpu runs the kernels' plain versions)",
    )
    args = parser.parse_args(argv)

    if args.selfcheck:
        return run_selfcheck(args.device)
    if args.demo:
        demo = DemoSystem(device=args.device)
        try:
            time.sleep(2.0)
            demo.churn(cycles=6)
            doc = demo.telemetry.observatory.to_doc()
        finally:
            demo.shutdown()
    elif args.from_file:
        with open(args.from_file) as fh:
            doc = json.load(fh)
    else:
        try:
            doc = fetch_doc(args.url)
        except Exception as exc:
            print(
                f"device-report: no /device at {args.url} "
                f"(uigc.telemetry.device off, or a node that predates the "
                f"observatory): {exc}",
                file=sys.stderr,
            )
            return 1
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True, default=repr))
        return 0
    print(render_device_doc(doc, committed_device_figures(args.repo)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
