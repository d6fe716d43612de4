"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and manifest entries, in a copy of the benchmark, are found by
name and run, with no file that was there edited."""

import hashlib
import json
import shutil

from portbench import harness
from portbench.tests.rehearsal import rehearse


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_pieces_are_files_of_their_own(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    bench = tmp_path / "portbench"

    config = json.loads((bench / "configs" / "powerlaw10m.json").read_text())
    config.update(name="powerlaw20k", reduced={"actors": {"published": 10000000}})
    config["sizes"]["actors"] = 20000
    (bench / "configs" / "powerlaw20k.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "full.json").read_text())
    traffic.update(busy_flips=10, halt_flips=2)
    (bench / "traffic" / "light.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "passes.count.py").write_text(
        '"""passes.count: passes completed in the window."""\n\n\n'
        "def read(r):\n    return r['counters'].get('passes')\n")

    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "powerlaw20k", "source": config["source"],
        "file": "portbench/configs/powerlaw20k.json", "reduced": ["actors"],
        "why": "a small graph"})
    manifest["workloads"].append({
        "name": "powerlaw20k.light", "config": "powerlaw20k", "traffic": "light",
        "chips": 1, "why": "few flips"})
    for m in manifest["end_to_end"]:
        if m["name"] in ("detect_p95_ms", "garbage_per_s"):
            m["workloads"].append("powerlaw20k.light")
    manifest["per_layer"].append({
        "name": "passes.count", "unit": "passes", "better": "higher",
        "source": "host_clock", "layer": "fixpoint loop", "moves": "detect_p95_ms",
        "workloads": ["powerlaw20k.light"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    after = digests(tmp_path)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "portbench/configs/powerlaw20k.json", "portbench/traffic/light.json",
        "portbench/metrics/passes.count.py"}

    r = rehearse("powerlaw20k.light", seconds=0.5, root=tmp_path)
    assert r["correct"] and r["counters"]["n_actors"] == 20000
    assert set(r["metrics"]) == {"detect_p95_ms", "garbage_per_s", "setup_s"}
    t = rehearse("powerlaw20k.light", seconds=0.5, trace=True, root=tmp_path)
    assert t["metrics"]["passes.count"]["value"] == t["counters"]["passes"]
