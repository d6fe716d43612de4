"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` its per-layer metrics, the device's busy and
traced-window seconds, and a breakdown.  Every run checks the verdicts of
its timed path against the plain reference and prints each compared
number beside its limit.  With no CUDA card, or fewer cards than the cell
asks for, the run exits with code 3 and prints no result.

``--control 1`` runs the cell's control in the program's place (see
PERF.md): its checks must fail.  The benchmark's own runs never set it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux /proc;
    elsewhere the import of this module)."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = process_start()


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, why: str) -> int:
    print(f"portbench: {why}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import guard, harness

    found = guard.source_findings()
    if found:
        return fail(4, "forbidden imports: " + "; ".join(found))
    manifest = harness.load_manifest()
    plan = harness.cell_plan(manifest, args.workload)
    chips = plan["cell"]["chips"]

    import torch

    if not torch.cuda.is_available():
        return fail(3, "no CUDA card: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        return fail(3, f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are visible")
    runner = harness.driver(plan["traffic"]["driver"])
    readings = runner({
        "cell": plan["cell"], "config": plan["config"],
        "traffic": plan["traffic"], "seed": args.seed,
        "seconds": args.seconds, "trace": bool(args.trace),
        "control": bool(args.control), "device": "cuda", "t_start": T_START,
    })

    loaded = guard.loaded_forbidden()
    if loaded:
        return fail(5, "the run loaded forbidden modules: " + ", ".join(loaded))
    specs = plan["per_layer"] if args.trace else plan["end_to_end"]
    result = {
        "correct": all(c["ok"] for c in readings["checks"]),
        "attempted": readings["attempted"],
        "failed": readings["failed"],
        "metrics": harness.read_metrics(specs, readings),
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": readings["memory_peak_bytes"],
        },
    }
    if args.trace:
        from portbench import devtrace

        trace = readings["trace"]
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = devtrace.breakdown(trace)
    harness.emit(result, readings["checks"])
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
