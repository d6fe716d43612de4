"""Import hygiene and device discipline of the port (uigc_tpu_torch).

The port imports torch and never jax or uigc_tpu, so it runs on a
machine with no JAX; its entry points run on the CUDA card unless the
caller asks for the CPU, and never fall back to the CPU on their own.
"""

import ast
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from uigc_tpu_torch import native, parallel
from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_decremental, cuda_incremental, cuda_trace
from uigc_tpu_torch.ops import propagate as prop
from uigc_tpu_torch.ops import scc as scc_ops
from uigc_tpu_torch.ops import trace as trace_ops

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "uigc_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]
MODULES = ("utils/validation.py", "utils/events.py", "utils/platform.py",
           "ops/trace.py", "models/graphgen.py", "ops/cuda_trace.py",
           "ops/propagate.py", "ops/slotmap.py", "ops/cuda_incremental.py",
           "ops/cuda_decremental.py", "config.py", "interfaces.py",
           "runtime/__init__.py", "runtime/signals.py", "runtime/behaviors.py",
           "runtime/context.py", "runtime/dispatcher.py", "runtime/cell.py",
           "runtime/system.py", "runtime/testkit.py", "runtime/fabric.py",
           "engines/__init__.py", "engines/engine.py", "engines/manual.py",
           "engines/crgc/__init__.py", "engines/crgc/state.py",
           "engines/crgc/refob.py", "engines/crgc/messages.py",
           "engines/crgc/packed.py", "engines/crgc/delta.py",
           "engines/crgc/undo.py", "engines/crgc/gateways.py",
           "engines/crgc/shadow.py", "engines/crgc/collector.py",
           "engines/crgc/engine.py", "engines/crgc/arrays.py",
           "ops/i64map.py", "native/__init__.py", "native/graph.py",
           "native/crgc_shadow.cpp", "models/workloads.py", "ops/scc.py",
           "engines/mac/__init__.py", "engines/mac/engine.py",
           "engines/mac/detector.py", "engines/drl/__init__.py",
           "engines/drl/engine.py", "parallel/__init__.py",
           "parallel/sharded_trace.py", "engines/crgc/mesh.py",
           "analysis/__init__.py", "analysis/race.py", "analysis/sanitizer.py",
           "telemetry/__init__.py", "telemetry/metrics.py",
           "telemetry/profile.py", "telemetry/tracing.py",
           "telemetry/exporter.py", "telemetry/timeseries.py",
           "telemetry/alerts.py", "telemetry/device.py",
           "telemetry/inspect.py", "runtime/faults.py", "runtime/schema.py",
           "runtime/wire.py", "runtime/remote.py", "parallel/partition.py",
           "engines/crgc/distributed.py", "runtime/heartbeat.py",
           "runtime/shm_ring.py", "runtime/node.py", "models/nodeproc.py",
           "cluster/__init__.py", "cluster/sharding.py",
           "cluster/migration.py", "cluster/passivation.py",
           "cluster/journal.py", "cluster/membership.py",
           "gateway/__init__.py", "gateway/protocol.py",
           "gateway/admission.py", "gateway/session.py",
           "gateway/gateway.py", "analysis/check/__init__.py",
           "analysis/check/core.py", "analysis/check/lint_rules.py",
           "analysis/check/locks.py", "analysis/check/purity.py",
           "analysis/check/surface.py", "analysis/check/configdoc.py",
           "analysis/check/cli.py", "tools/__init__.py",
           "tools/uigc_check.py", "tools/uigc_lint.py",
           "tools/uigc_lint_allow.txt", "tools/telemetry_dump.py",
           "tools/graph_inspect.py", "tools/uigc_top.py",
           "tools/device_report.py", "tools/sweep_profile.py", "CONFIG.md")


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_the_reference(path):
    bad = imported_roots(path) & {"jax", "jaxlib", "uigc_tpu"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_slice_modules_and_kernel_source_exist():
    pkg = REPO / "uigc_tpu_torch"
    for rel in MODULES:
        assert (pkg / rel).is_file(), rel
    assert (pkg / "csrc" / "propagate.cu").is_file()


def test_port_imports_with_jax_blocked():
    """In a fresh interpreter where importing jax or uigc_tpu fails, the
    whole slice imports."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['uigc_tpu'] = None\n"
        "import uigc_tpu_torch.ops.cuda_trace\n"
        "import uigc_tpu_torch.ops.cuda_decremental\n"
        "import uigc_tpu_torch.models\n"
        "import uigc_tpu_torch.engines.crgc.engine\n"
        "import uigc_tpu_torch.engines.crgc.arrays\n"
        "import uigc_tpu_torch.engines.manual\n"
        "import uigc_tpu_torch.engines.mac\n"
        "import uigc_tpu_torch.engines.drl\n"
        "import uigc_tpu_torch.ops.scc\n"
        "import uigc_tpu_torch.native\n"
        "import uigc_tpu_torch.parallel\n"
        "import uigc_tpu_torch.engines.crgc.mesh\n"
        "import uigc_tpu_torch.analysis\n"
        "import uigc_tpu_torch.telemetry\n"
        "import uigc_tpu_torch.runtime.wire\n"
        "import uigc_tpu_torch.runtime.remote\n"
        "import uigc_tpu_torch.runtime.faults\n"
        "import uigc_tpu_torch.engines.crgc.distributed\n"
        "import uigc_tpu_torch.runtime.node\n"
        "import uigc_tpu_torch.runtime.heartbeat\n"
        "import uigc_tpu_torch.runtime.shm_ring\n"
        "import uigc_tpu_torch.models.nodeproc\n"
        "import uigc_tpu_torch.cluster\n"
        "from uigc_tpu_torch import ClusterSharding, Entity, EntityRef\n"
        "import uigc_tpu_torch.gateway\n"
        "from uigc_tpu_torch.gateway import ClientRef, IngressGateway\n"
        "from uigc_tpu_torch.models import run_cluster_recovery\n"
        "from uigc_tpu_torch import ActorSystem, ActorTestKit\n"
        "import uigc_tpu_torch.analysis.check\n"
        "from uigc_tpu_torch.analysis.check import run_check\n"
        "import uigc_tpu_torch.tools\n"
        "from uigc_tpu_torch.tools import (device_report, graph_inspect,\n"
        "    sweep_profile, telemetry_dump, uigc_check, uigc_lint,\n"
        "    uigc_top)\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
        "print('IMPORT OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "IMPORT OK" in out.stdout, out.stderr[-2000:]


def unported_raises():
    """(file, message) of every ``raise NotImplementedError("...")`` in
    the port whose message names a ROADMAP item: the paths that wait for
    a module."""
    out = []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if not isinstance(node, ast.Raise) or not isinstance(
                    node.exc, ast.Call):
                continue
            if getattr(node.exc.func, "id", None) != "NotImplementedError":
                continue
            parts = [n.value for n in ast.walk(node.exc)
                     if isinstance(n, ast.Constant) and isinstance(n.value,
                                                                   str)]
            message = "".join(parts)
            if "ROADMAP" in message:
                out.append((str(path.relative_to(REPO)), message))
    return out


def test_only_later_items_still_raise():
    """Every path that waited for a module is ported: no port file
    raises a NotImplementedError naming a ROADMAP item, the wire codec's
    ProxyCell, EntityRef and ClientRef resolvers are the port's classes,
    and no file names Queue 1 item 7b, 8 or 9."""
    raises = unported_raises()
    assert raises == [], raises
    from uigc_tpu_torch.cluster import sharding
    from uigc_tpu_torch.gateway import session
    from uigc_tpu_torch.runtime import node, wire

    assert wire._proxy_cell_class() is node.ProxyCell
    assert wire._entity_ref_class() is sharding.EntityRef
    assert wire._client_ref_class() is session.ClientRef
    assert not any("7b" in path.read_text() for path in PORT_FILES)
    assert not any(re.search(r"Queue 1 item [89]\b", path.read_text())
                   for path in PORT_FILES)


def test_package_import_leaves_the_cluster_and_the_wire_unloaded():
    """``import uigc_tpu_torch`` binds ClusterSharding, Entity and
    EntityRef at first use: the package import loads neither the
    cluster nor the wire codec nor the gateway, and the names are the
    cluster's."""
    code = (
        "import sys\n"
        "import uigc_tpu_torch as u\n"
        "assert 'uigc_tpu_torch.cluster' not in sys.modules\n"
        "assert 'uigc_tpu_torch.runtime.wire' not in sys.modules\n"
        "assert 'uigc_tpu_torch.gateway' not in sys.modules\n"
        "from uigc_tpu_torch.cluster import sharding\n"
        "assert 'uigc_tpu_torch.gateway' not in sys.modules\n"
        "assert u.ClusterSharding is sharding.ClusterSharding\n"
        "assert u.Entity is sharding.Entity\n"
        "assert u.EntityRef is sharding.EntityRef\n"
        "print('LAZY OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "LAZY OK" in out.stdout, out.stderr[-2000:]


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no CUDA device and no device="cpu", every entry point raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = powerlaw_actor_graph(256, seed=0)
    args = (g["flags"], g["recv_count"], g["supervisor"], g["edge_src"],
            g["edge_dst"], g["edge_weight"])
    prep = cuda_trace.prepare_chunks(g["edge_src"], g["edge_dst"],
                                     g["edge_weight"], g["supervisor"], 256)
    calls = [
        lambda: cuda_trace.trace_marks_cuda(*args),
        lambda: trace_ops.trace_marks_torch(*args),
        lambda: cuda_trace.trace_marks_layouts(g["flags"], g["recv_count"],
                                               [prep]),
        lambda: cuda_trace.layout_to_device(prep),
        lambda: cuda_trace.graph_to_device(g),
        lambda: cuda_incremental.IncrementalCudaLayout(256),
        lambda: cuda_decremental.DecrementalTracer(256),
        lambda: scc_ops.scc_labels_torch(256, g["edge_src"], g["edge_dst"]),
        lambda: parallel.build_mesh(1),
        lambda: parallel.Mesh(["cuda:0"] * 4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # and with device="cpu" the same entry point runs
    assert np.array_equal(cuda_trace.trace_marks_cuda(*args, device="cpu"),
                          trace_ops.trace_marks_np(*args))


def test_propagate_on_cpu_never_touches_the_kernel_loader(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel loader touched for a CPU tensor")

    monkeypatch.setattr(prop, "load_library", boom)
    monkeypatch.setattr(prop, "build_library", boom)
    g = powerlaw_actor_graph(1 << 11, seed=1)
    before = dict(prop.launches)
    for mode in ("push", "auto"):  # the plain and the gated form
        marks = cuda_trace.trace_marks_cuda(
            g["flags"], g["recv_count"], g["supervisor"], g["edge_src"],
            g["edge_dst"], g["edge_weight"], mode=mode, device="cpu",
        )
        garbage, _ = trace_ops.garbage_and_kills_np(g["flags"],
                                                    g["supervisor"], marks)
        assert np.array_equal(garbage, g["expected_garbage"])
    assert prop.launches == before  # the plain version counts no launch


def _race(n, target):
    """``target`` from ``n`` threads at once, with a short switch interval
    so the threads interleave finely; returns their results."""
    results = []
    go = threading.Event()

    def run():
        go.wait()
        results.append(target())

    threads = [threading.Thread(target=run) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return results


def test_kernel_build_runs_once_across_threads(monkeypatch, tmp_path):
    """A live collector's first wake builds the kernel on a dispatcher
    thread: threads that load the library together build it once, into
    one file, and share one binding."""
    compiles = []

    def fake_compile(out):
        compiles.append(out.name)
        time.sleep(0.2)
        out.write_bytes(b"library")
        return "ptxas report"

    monkeypatch.setattr(prop, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(prop, "_compile", fake_compile)
    monkeypatch.setattr(prop, "_bind", lambda path: ("bound", path.name))
    monkeypatch.setattr(prop, "_lib", None)
    results = _race(16, prop.load_library)
    assert len(results) == 16 and len(set(results)) == 1
    assert len(compiles) == 1
    assert str(threading.get_ident()) not in compiles[0]  # a worker's name
    assert [p.name for p in tmp_path.iterdir()] == [results[0][1]]


def test_native_build_runs_once_across_threads(monkeypatch, tmp_path):
    builds = []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        Path(native._LIB).write_bytes(b"library")

    monkeypatch.setattr(native, "_LIB", str(tmp_path / "libuigc_crgc.so"))
    monkeypatch.setattr(native, "_build", fake_build)
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: ("bound", path))
    monkeypatch.setattr(native, "_declare", lambda lib: None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    results = _race(16, native.load)
    assert len(builds) == 1 and len(set(results)) == 1


def test_launch_counts_survive_concurrent_collectors():
    """The collectors of a multi-node run launch from their own threads:
    no count is lost."""
    saved = dict(prop.launches)
    prop.reset_launches()
    try:
        _race(16, lambda: [prop._count_launch("propagate_gated")
                           for _ in range(2000)])
        assert prop.launches == {"propagate": 0, "propagate_gated": 32000,
                                 "jump": 0, "pairs": 0}
    finally:
        prop.launches.update(saved)


def test_propagate_cuda_refuses_cpu_tensors():
    z = torch.zeros(9, dtype=torch.int32)
    words = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        prop.propagate_words_cuda(z, z, z, words, z, z, words.clone(),
                                  n_super=1, s_rows=1, sub=1, group=1)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without CUDA, from the repo root or alone in a directory,
    chip_smoke.py exits non-zero and prints no result line."""
    if alone:
        script = tmp_path / "chip_smoke.py"
        script.write_text((REPO / "chip_smoke.py").read_text())
        cwd = tmp_path
    else:
        cwd = REPO
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
