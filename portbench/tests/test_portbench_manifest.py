"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files each entry names, and which cell reports which metric."""

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def short_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size(manifest):
    assert set(manifest) == TOP
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)


def test_command_and_paths(manifest):
    cmd, paths = manifest["command"], manifest["paths"]
    assert 1 <= len(cmd) <= 32 and all(short_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (harness.ROOT / p).is_dir()
    for w in cmd:
        assert not w.startswith("/") and ".." not in w


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(manifest, section):
    names = [e["name"] for e in manifest[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_names_unique_across_metrics(manifest):
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))


def test_configs(manifest):
    assert 1 <= len(manifest["configs"]) <= 24
    files = set()
    used = {w["config"] for w in manifest["workloads"]}
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert short_line(c["source"]) and short_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert sorted(body.get("reduced", {})) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size"))
        assert c["name"] in used


def test_workloads(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and short_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_end_to_end_metrics(manifest):
    e2e = manifest["end_to_end"]
    assert 1 <= len(e2e) <= 16 and "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_per_layer_metrics(manifest):
    pl = manifest["per_layer"]
    assert 1 <= len(pl) <= 128
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in pl:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and short_line(m["layer"])
        assert m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        # every cell that reads it reports the metric it moves
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", []):
            assert cell in cells
            assert cell in moved.get("workloads", cells)


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(manifest["end_to_end"], w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.layer_metrics(manifest, w["name"])


def test_roofline_names(manifest):
    for m in manifest["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_run_seconds_fit_a_full_check(manifest):
    # 2 + 14 runs a cell, each allowed run_seconds + 60, each cell 2 x 90
    # to compile, 1200 spare, within 43,200 s, for the full 24 cells
    cells = 24
    total = (2 + 14 * cells) * (manifest["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for path in harness.HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert PATH.match(rel), rel
