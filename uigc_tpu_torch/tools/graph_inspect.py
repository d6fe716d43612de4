"""graph-inspect: query the liveness inspector — why-live retaining
paths, shadow-graph snapshots, retained-set diffs, and a self-check.

The port's copy of ``tools/graph_inspect.py``, run from the repository
root as ``python -m uigc_tpu_torch.tools.graph_inspect``.  The demo
system's collector traces on the CUDA card (``device`` shadow graph)
unless ``--device cpu`` is passed.

The heap-dump/retained-path tool of the collector (GUIDE.md "Debugging
liveness").  Sources:

- ``--url http://127.0.0.1:PORT``  a live system's telemetry HTTP
  server (``uigc.telemetry.http-port`` + ``uigc.telemetry.inspect``);
  hits ``/snapshot`` (``--merged`` = the cluster-wide graph via the
  "snap" NodeFabric exchange) and ``/inspect?actor=...``;
- ``--from FILE``  a dumped snapshot JSON (flight-recorder dump or a
  previous ``graph_inspect snapshot -o``);
- ``--demo``  a small in-process system (chain of retained actors plus
  one deliberately leaked pin) — the zero-to-inspection smoke; its
  collector runs on ``--device`` (``cuda`` by default, or ``cpu``).

Subcommands:

  snapshot   dump one (optionally merged) snapshot as JSON
  why-live   print a pseudoroot→actor retaining path with per-hop
             provenance (created edge / supervisor pointer)
  diff       retained-set diff of two snapshot files
  selfcheck  drive the demo system, validate a why-live path for every
             live actor against the snapshot invariants, and require
             the watchdog to flag the planted leak — exit nonzero on
             any failure (the zero-to-inspection smoke)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request


# ------------------------------------------------------------------- #
# Sources
# ------------------------------------------------------------------- #


def _fetch(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=10) as rsp:
        return json.loads(rsp.read().decode())


def snapshot_from_url(base: str, merged: bool) -> dict:
    base = base.rstrip("/")
    suffix = "/snapshot?merged=1" if merged else "/snapshot"
    return _fetch(base + suffix)


def why_live_from_url(base: str, actor: str) -> dict:
    import urllib.parse

    base = base.rstrip("/")
    return _fetch(base + "/inspect?actor=" + urllib.parse.quote(actor))


def load_snapshot(path: str) -> dict:
    with open(path) as fh:
        doc = json.load(fh)
    # Accept a flight-recorder dump too: take its newest snapshot.
    if "snapshots" in doc and "actors" not in doc:
        if not doc["snapshots"]:
            raise SystemExit(f"{path}: flight-recorder dump holds no snapshots")
        return doc["snapshots"][-1]
    return doc


# ------------------------------------------------------------------- #
# Demo system (also the selfcheck substrate)
# ------------------------------------------------------------------- #


class DemoSystem:
    """Chain root -> keeper -> kept (the kept actor is retained only
    through the keeper: a 2-hop why-live path), a few busy workers, and
    one planted leak: a worker pinned by a root ref that never receives
    traffic."""

    def __init__(self, leak_waves: int = 3, extra_config: dict = None,
                 device: str = "cuda"):
        from uigc_tpu_torch import (
            AbstractBehavior,
            ActorTestKit,
            Behaviors,
            Message,
            NoRefs,
        )

        class Ping(NoRefs):
            pass

        class Give(Message):
            def __init__(self, ref):
                self.ref = ref

            @property
            def refs(self):
                return (self.ref,)

        class Worker(AbstractBehavior):
            def on_message(self, msg):
                return self

        class Keeper(AbstractBehavior):
            def __init__(self, context):
                super().__init__(context)
                self.held = None

            def on_message(self, msg):
                if isinstance(msg, Give):
                    self.held = msg.ref
                return self

        outer = self

        class Root(AbstractBehavior):
            def __init__(self, context):
                super().__init__(context)
                self.keeper = context.spawn(Behaviors.setup(Keeper), "keeper")
                self.kept = context.spawn(Behaviors.setup(Worker), "kept")
                self.leaked = context.spawn(Behaviors.setup(Worker), "leaked")
                self.workers = [
                    context.spawn(Behaviors.setup(Worker), f"w{i}")
                    for i in range(3)
                ]
                outer.names["keeper"] = self.keeper
                outer.names["kept"] = self.kept
                outer.names["leaked"] = self.leaked

            def on_message(self, msg):
                ctx = self.context
                if isinstance(msg, Give):  # hand kept to keeper, drop ours
                    self.keeper.tell(
                        Give(ctx.create_ref(self.kept, self.keeper)), ctx
                    )
                    ctx.release(self.kept)
                    self.kept = None
                elif isinstance(msg, Ping):
                    for worker in self.workers:
                        worker.tell(Ping(), ctx)
                return self

        config = {
            "uigc.crgc.wakeup-interval": 10,
            "uigc.crgc.shadow-graph": "device",
            "uigc.crgc.device": device,
            "uigc.telemetry.inspect": True,
            "uigc.telemetry.leak-waves": leak_waves,
            "uigc.telemetry.snapshot-every": 1,
            "uigc.telemetry.metrics": True,
        }
        if extra_config:
            config.update(extra_config)
        self.names = {}
        self.kit = ActorTestKit(config=config, name="inspect-demo")
        self.root = self.kit.spawn(Behaviors.setup_root(Root), "root")
        self._ping = Ping
        self._give = Give
        self.root.tell(Give(None))  # transfer kept to keeper
        self.churn(rounds=3)

    def churn(self, rounds: int = 1, settle_s: float = 0.08) -> None:
        for _ in range(rounds):
            self.root.tell(self._ping())
            time.sleep(settle_s)

    @property
    def inspector(self):
        return self.kit.system.telemetry.inspector

    def shutdown(self) -> None:
        self.kit.shutdown()


# ------------------------------------------------------------------- #
# Rendering
# ------------------------------------------------------------------- #


def render_why_live(result: dict) -> str:
    name = result.get("name") or result.get("actor")
    verdict = result.get("verdict", "?")
    lines = [f"why-live {name}: {verdict.upper()}"]
    if verdict == "live":
        reasons = ", ".join(result.get("root_reasons", [])) or "?"
        head = result.get("pseudoroot_name") or result.get("pseudoroot")
        src = result.get("parents")
        suffix = f"  [parents: {src}]" if src else ""
        lines.append(f"  pseudoroot {head} ({reasons}){suffix}")
        indent = "  "
        for hop in result.get("path", []):
            indent += "  "
            kind = hop.get("kind")
            weight = hop.get("weight")
            label = f"{kind}" + (f" w={weight}" if weight is not None else "")
            target = hop.get("to_name") or hop.get("to")
            lines.append(f"{indent}-[{label}]-> {target}")
    elif verdict == "collectable":
        lines.append("  " + result.get("note", "unreachable from any pseudoroot"))
    return "\n".join(lines)


def render_snapshot(snap: dict) -> str:
    summary = snap.get("summary", {})
    lines = [
        "snapshot node=%s wave=%s actors=%s edges=%s pseudoroots=%s"
        % (
            snap.get("node") or ",".join(snap.get("nodes", [])),
            snap.get("wave", "?"),
            summary.get("actors"),
            summary.get("edges"),
            summary.get("pseudoroots"),
        )
    ]
    if snap.get("missing_nodes"):
        lines.append("  MISSING nodes: " + ", ".join(snap["missing_nodes"]))
    for key, rec in sorted(snap.get("actors", {}).items()):
        flags = "".join(
            ch
            for ch, on in (
                ("R", rec.get("root")),
                ("B", rec.get("busy")),
                ("L", rec.get("local")),
                ("H", rec.get("halted")),
                ("P", rec.get("pseudoroot")),
            )
            if on
        )
        lines.append(
            f"  {rec.get('name', key):40s} [{flags:5s}] "
            f"recv={rec.get('recv_count', 0)} mailbox={rec.get('mailbox', '?')}"
        )
    return "\n".join(lines)


# ------------------------------------------------------------------- #
# Subcommands
# ------------------------------------------------------------------- #


def cmd_snapshot(args) -> int:
    if args.url:
        snap = snapshot_from_url(args.url, args.merged)
    elif args.from_file:
        snap = load_snapshot(args.from_file)
    else:
        demo = DemoSystem(device=args.device)
        try:
            snap = (
                demo.inspector.merged_snapshot()
                if args.merged
                else demo.inspector.snapshot()
            )
        finally:
            demo.shutdown()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(snap, fh, indent=2, sort_keys=True, default=repr)
        print(f"wrote {args.out}")
    else:
        print(
            json.dumps(snap, indent=2, sort_keys=True, default=repr)
            if args.json
            else render_snapshot(snap)
        )
    return 0


def cmd_why_live(args) -> int:
    from uigc_tpu_torch.telemetry.inspect import why_live

    if args.url:
        result = why_live_from_url(args.url, args.actor)
    elif args.from_file:
        result = why_live(load_snapshot(args.from_file), args.actor)
    else:
        demo = DemoSystem(device=args.device)
        try:
            result = demo.inspector.why_live(args.actor)
        finally:
            demo.shutdown()
    print(json.dumps(result, indent=2, default=repr) if args.json
          else render_why_live(result))
    return 0 if result.get("verdict") != "unknown" else 1


def cmd_diff(args) -> int:
    from uigc_tpu_torch.telemetry.inspect import diff_snapshots

    result = diff_snapshots(load_snapshot(args.old), load_snapshot(args.new))
    print(json.dumps(result, indent=2, sort_keys=True))
    return 0


def cmd_selfcheck(args) -> int:
    from uigc_tpu_torch.telemetry.inspect import validate_why_live, why_live

    demo = DemoSystem(leak_waves=2, device=args.device)
    problems = []
    try:
        # Let several wakes run so the watchdog sees quiet waves.
        deadline = time.monotonic() + args.timeout
        suspects = []
        while time.monotonic() < deadline and not suspects:
            demo.churn(rounds=1, settle_s=0.05)
            suspects = demo.inspector.watchdog.suspects()
        snap = demo.inspector.snapshot()
        checked = 0
        live_paths = 0
        for key in sorted(snap.get("actors", {})):
            result = why_live(snap, key)
            checked += 1
            if result["verdict"] == "live":
                live_paths += 1
            problems.extend(
                f"{key}: {p}" for p in validate_why_live(snap, result)
            )
        # The inspector's own (parents-based) derivation must agree on
        # the demo's 2-hop retained chain.
        kept_key = None
        for key, rec in snap["actors"].items():
            if rec.get("name", "").endswith("kept"):
                kept_key = key
        if kept_key is None:
            problems.append("demo 'kept' actor missing from snapshot")
        else:
            live = demo.inspector.why_live(kept_key)
            problems.extend(
                f"live-why-live({kept_key}): {p}"
                for p in validate_why_live(snap, live)
            )
            if live.get("verdict") == "live" and len(live.get("path", [])) < 2:
                problems.append(
                    "kept actor should be retained through the keeper "
                    f"(2 hops), got {live.get('path')}"
                )
        suspect_names = [
            snap.get("actors", {}).get(key, {}).get("name", key)
            for key in suspects
        ]
        if not any(name.endswith("leaked") for name in suspect_names):
            problems.append(
                "watchdog never flagged the planted leak "
                f"(suspects={suspect_names})"
            )
        doc = {
            "bench": "graph_inspect_selfcheck",
            "actors_checked": checked,
            "live_paths": live_paths,
            "leak_suspects": suspects,
            "problems": problems,
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
    finally:
        demo.shutdown()
    return 1 if problems else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="graph-inspect", description=__doc__.splitlines()[0]
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_source(p):
        p.add_argument("--url", help="live system telemetry HTTP base URL")
        p.add_argument(
            "--from", dest="from_file", metavar="FILE",
            help="snapshot (or flight-recorder dump) JSON file",
        )
        p.add_argument(
            "--demo", action="store_true",
            help="spawn the in-process demo system (the default when "
            "neither --url nor --from is given)",
        )
        p.add_argument("--json", action="store_true", help="raw JSON output")
        add_device(p)

    def add_device(p):
        p.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="where the demo system's collector traces (default: the "
            "CUDA card; cpu runs the kernels' plain versions)",
        )

    p = sub.add_parser("snapshot", help="dump a shadow-graph snapshot")
    add_source(p)
    p.add_argument("--merged", action="store_true",
                   help="merge across cluster nodes (snap frames)")
    p.add_argument("-o", "--out", help="write JSON to this file")
    p.set_defaults(fn=cmd_snapshot)

    p = sub.add_parser("why-live", help="print a retaining path")
    p.add_argument("actor", help="actor path, name suffix, or address#uid key")
    add_source(p)
    p.set_defaults(fn=cmd_why_live)

    p = sub.add_parser("diff", help="retained-set diff of two snapshots")
    p.add_argument("old")
    p.add_argument("new")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser(
        "selfcheck", help="drive a demo system and validate the inspector"
    )
    p.add_argument("--timeout", type=float, default=15.0)
    add_device(p)
    p.set_defaults(fn=cmd_selfcheck)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
