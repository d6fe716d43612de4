"""The import guard: no JAX and nothing of the JAX package in the
benchmark's sources or in a run's process, and nothing of the program in
the plain reference.  Names compare by their whole top level."""

import subprocess
import sys

from portbench import guard
from portbench.harness import ROOT


def test_the_benchmark_sources_are_clean():
    assert guard.source_findings() == []


def test_top_level_names_compare_whole():
    mods = {"uigc_tpu_torch": 1, "uigc_tpu_torch.ops": 1, "jaxtyping": 1,
            "numpy": 1}
    assert guard.loaded_forbidden(mods) == []
    mods.update({"uigc_tpu.ops": 1, "jax": 1, "jaxlib.xla_client": 1, "flax": 1})
    assert guard.loaded_forbidden(mods) == ["flax", "jax", "jaxlib.xla_client",
                                            "uigc_tpu.ops"]


def test_planted_imports_are_found(tmp_path):
    bench = tmp_path / "portbench"
    (bench / "reference").mkdir(parents=True)
    (bench / "a.py").write_text("import jax.numpy as jnp\nimport uigc_tpu_torch\n")
    (bench / "b.py").write_text("from uigc_tpu.ops import trace\n")
    (bench / "reference" / "c.py").write_text(
        "import importlib\nimportlib.import_module('uigc_tpu_torch.ops')\n")
    (bench / "reference" / "d.py").write_text("from . import c\nimport numpy\n")
    found = guard.source_findings(bench)
    assert found == [
        "portbench/a.py imports jax.numpy",
        "portbench/b.py imports uigc_tpu.ops",
        "portbench/reference/c.py imports uigc_tpu_torch.ops",
    ]


def test_a_rehearsed_run_loads_no_forbidden_module():
    code = (
        "from portbench.tests.rehearsal import rehearse\n"
        "from portbench import guard\n"
        "r = rehearse('powerlaw10m.full', seconds=0.3, sizes={'actors': 5000})\n"
        "assert r['correct']\n"
        "print(guard.loaded_forbidden())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_the_program_fails_and_prints_nothing(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "powerlaw10m.full",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
