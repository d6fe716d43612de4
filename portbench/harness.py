"""The benchmark's core: the manifest, discovery by name, the statistics
every reader shares, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``  the sizes, the cuts and the program's keys
- ``traffic/<mix>.json``     the parameters of a mix, and the driver
                             (``drivers/<driver>.py``) that runs them
- ``metrics/<metric>.py``    a reader: ``read(readings) -> float | None``
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

#: the benchmark's own folder and the checkout it sits in
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def find(entries: List[Dict[str, Any]], name: str, what: str) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(root: Path, rel: str) -> Dict[str, Any]:
    with open(root / rel) as fh:
        return json.load(fh)


def cell_plan(manifest: Dict[str, Any], cell_name: str,
              root: Path = ROOT) -> Dict[str, Any]:
    """The cell, its configuration's file, its traffic's file, and the
    metrics it reports with and without tracing."""
    cell = find(manifest["workloads"], cell_name, "workload")
    config_entry = find(manifest["configs"], cell["config"], "config")
    config = load_json(root, config_entry["file"])
    traffic = load_json(root, f"{HERE.name}/traffic/{cell['traffic']}.json")
    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "end_to_end": cell_metrics(manifest["end_to_end"], cell_name),
        "per_layer": layer_metrics(manifest, cell_name),
    }


def cell_metrics(metrics: List[Dict[str, Any]], cell_name: str) -> List[Dict[str, Any]]:
    """The end-to-end metrics a cell reports: those that list it, and
    those that list no cells."""
    return [m for m in metrics
            if "workloads" not in m or cell_name in m["workloads"]]


def layer_metrics(manifest: Dict[str, Any], cell_name: str) -> List[Dict[str, Any]]:
    """The per-layer metrics a cell reports: those that list it, and those
    that list no cells but move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in cell_metrics(manifest["end_to_end"], cell_name)}
    out = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def load_module(path: Path, name: str):
    """Import a file under the benchmark by path (metric names hold dots,
    so a reader is not importable by module name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    return load_module(path, f"portbench_metric_{name.replace('.', '_')}").read


def driver(name: str, root: Path = ROOT):
    """The ``run`` function of ``drivers/<name>.py``."""
    path = root / HERE.name / "drivers" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no driver named {name!r}: {path}")
    return load_module(path, f"portbench_driver_{name}").run


def read_metrics(specs: List[Dict[str, Any]], readings: Dict[str, Any],
                 root: Path = ROOT) -> Dict[str, Dict[str, Any]]:
    """Each metric its reader finds something for, with its unit."""
    out = {}
    for spec in specs:
        value = reader(spec["name"], root)(readings)
        if value is None:
            continue
        out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


# ------------------------------------------------------------------ #
# Statistics shared by the readers
# ------------------------------------------------------------------ #


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) by linear interpolation between
    the closest ranks (numpy's default rule); None for no values."""
    v = sorted(float(x) for x in values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> Optional[float]:
    v = list(values)
    return float(statistics.median(v)) if v else None


# ------------------------------------------------------------------ #
# The result
# ------------------------------------------------------------------ #


def emit(result: Dict[str, Any], checks: List[Dict[str, Any]]) -> None:
    """Each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard output,
    with the same numbers under ``checks``, its last key."""
    for c in checks:
        print(f"check {c['name']}: {c['value']} limit {c['limit']} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    print(json.dumps(line), flush=True)


def check(name: str, value, limit) -> Dict[str, Any]:
    """A compared number: ``value`` passes while it is at most ``limit``."""
    return {"name": name, "value": value, "limit": limit,
            "ok": value is not None and value <= limit}
