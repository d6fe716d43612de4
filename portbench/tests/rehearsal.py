"""The entry the tests use: a cell's driver at a tiny size, by default on
the CPU through the program's ``device="cpu"`` path (every kernel as its
plain PyTorch version).  It returns the readings and the metrics its
readers find, and prints nothing: a CPU run times nothing of the card."""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

from portbench import harness


def rehearse(cell: str, seed: int = 1, seconds: float = 1.0, trace: bool = False,
             sizes: Optional[Dict[str, Any]] = None,
             traffic: Optional[Dict[str, Any]] = None,
             control: bool = False, root=harness.ROOT,
             device: str = "cpu") -> Dict[str, Any]:
    plan = harness.cell_plan(harness.load_manifest(root), cell, root)
    config = copy.deepcopy(plan["config"])
    config["sizes"].update(sizes or {})
    tr = dict(plan["traffic"], **(traffic or {}))
    readings = harness.driver(tr["driver"], root)({
        "cell": plan["cell"], "config": config, "traffic": tr, "seed": seed,
        "seconds": seconds, "trace": trace, "control": control,
        "device": device, "t_start": time.perf_counter(),
    })
    specs = plan["per_layer"] if trace else plan["end_to_end"]
    readings["metrics"] = harness.read_metrics(specs, readings, root)
    readings["correct"] = all(c["ok"] for c in readings["checks"])
    return readings
