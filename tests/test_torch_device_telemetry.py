"""The port's device observatory (``telemetry/device.py``) against the JAX
package's: the memory ledger of every device backend after the same
seeded fold, the compile-event rule, the donation audit of the mesh's
updates in place, the build log, and the observatory document.

The ledger counts every ``torch.Tensor`` as device state (the reference
counts every ``jax.Array``), so on the CPU both ledgers walk the same
families.  Where the port holds a different array than the reference,
the test names it and demands the difference be exactly its bytes:

- the reference's decremental tracer caches a zero word array
  (``_zeros``) and its mesh a zero word array (``_zero_words``); the
  port caches neither;
- the reference's mesh keeps device receive counts as ``int32`` (JAX
  without 64-bit mode); the port keeps them ``int64``, as its host graph
  does.

Before the comparison the reference's ``device`` backend is put in the
state its TPU path leaves (the incremental layout's device mirror and
jump mirror uploaded): on the CPU it traces through ``trace_marks_jax``
and keeps no mirror, while the port always traces through its mirror.
"""

import numpy as np
import pytest
import torch

from test_torch_arrays import Script, make_pair, wake_and_compare
import test_torch_mesh
from uigc_tpu.telemetry import device as ref_device
from uigc_tpu_torch.engines.crgc import arrays as port_arrays
from uigc_tpu_torch.ops import cuda_decremental, cuda_trace
from uigc_tpu_torch.telemetry import MetricsRegistry
from uigc_tpu_torch.telemetry import device as port_device
from uigc_tpu_torch.utils import events, platform

torch.set_num_threads(1)


def nbytes(x):
    return int(x.nbytes) if x is not None else 0


def bookkeeping_bytes(layout, scanned_objects=True):
    """Host bytes of the port's layout bookkeeping that the reference
    keeps in Python containers, which its ledger reads as 0: the live
    tier's key array, the queued mirror writes and, where the ledger's
    scan reaches that deep, the frozen tiers' slot arrays."""
    arrays = [layout.pending, *layout._jump_writes,
              *(a for w in layout._dev_writes.values() for a in w)]
    if scanned_objects:
        fs = layout.frozen_slots
        arrays += [*fs.keys, *fs.slots, *fs.live]
    return sum(nbytes(a) for a in arrays)


def ledger_pair(backend, monkeypatch):
    if backend.startswith("mesh"):
        ref, port = test_torch_mesh.make_pair(backend)
    else:
        ref, port = make_pair(backend)
    if backend == "device":
        ref._is_tpu = True  # the reference's layout path, interpreted
    script = Script(3, [ref, port])
    script.intern(700)
    script.churn(1500)
    wake_and_compare(ref, port, monkeypatch, "wake 0")
    script.intern(400)
    script.churn(600)
    wake_and_compare(ref, port, monkeypatch, "wake 1")
    if backend == "device":
        inc = ref._inc  # upload the mirrors the TPU path keeps
        for prep in [inc.base] + inc.frozen:
            inc._device_args(prep)
        if inc.use_jump:
            inc.jump_device()
    return ref, port


@pytest.mark.parametrize("backend", ["array", "device", "decremental",
                                     "mesh", "mesh-decremental"])
def test_ledger_families_equal_the_reference(backend, monkeypatch):
    ref, port = ledger_pair(backend, monkeypatch)
    want = ref_device.ledger_families(ref)
    got = port_device.ledger_families(port)
    adjust = {}
    host_adjust = {}
    if backend == "device":
        host_adjust["incremental_layout"] = bookkeeping_bytes(port._inc)
    if backend == "decremental":
        adjust["decremental_tracer"] = -nbytes(ref._dec._zeros)
        dec = port._dec
        host_adjust["decremental_tracer"] = bookkeeping_bytes(
            dec.layout, scanned_objects=False) + sum(
            nbytes(a) for a in dec._pending_del_dst + dec._pending_fresh_dst)
    if backend.startswith("mesh"):
        adjust["device_nodes"] = nbytes(ref._dev_recv)  # int64, not int32
    if backend == "mesh-decremental":
        adjust["wake_state"] = -nbytes(ref._zero_words)
    assert set(got) == set(want)
    for fam in want:
        assert got[fam]["host"] == want[fam]["host"] + host_adjust.get(
            fam, 0), fam
        assert got[fam]["device"] == want[fam]["device"] + adjust.get(
            fam, 0), fam
    assert sum(t["device"] for t in got.values()) > 0 or backend == "array"
    # each named difference is real
    assert all(v for v in adjust.values())
    assert all(v for v in host_adjust.values())


def test_every_tensor_counts_as_device_and_numpy_as_host():
    class G:
        flags = np.zeros(1024, np.uint8)
        _dev_flags = torch.zeros(256, dtype=torch.uint8)
        _dev_recv = [torch.zeros(64, dtype=torch.int64)] * 2
        _dev_stacked = {"row_pos": torch.zeros((4, 8), dtype=torch.int32)}
        _zero_words = None  # dropped by the port: reads 0

    fams = port_device.ledger_families(G())
    assert fams["node_features"] == {"host": 1024, "device": 0, "items": 1}
    assert fams["device_nodes"]["device"] == 256 + 2 * 64 * 8
    assert fams["device_layout"]["device"] == 4 * 8 * 4
    assert fams["wake_state"]["device"] == 0
    assert port_device._FAMILY_ATTRS == ref_device._FAMILY_ATTRS


@pytest.mark.cuda
def test_ledger_counts_a_cuda_tensor_as_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    class G:
        _dev_flags = torch.zeros(4096, dtype=torch.uint8, device="cuda")

    fams = port_device.ledger_families(G())
    assert fams["device_nodes"] == {"host": 0, "device": 4096, "items": 1}


# --------------------------------------------------------------------- #
# The compile-event rule
# --------------------------------------------------------------------- #


@pytest.fixture
def observatory():
    events.recorder.enable()
    obs = port_device.DeviceObservatory(node="")
    events.recorder.add_listener(obs)
    try:
        yield obs
    finally:
        events.recorder.remove_listener(obs)
        obs.close()
        events.recorder.disable()


def compile_entries(obs, tag=None):
    """{(tag, geom): (misses, hits)} of the observatory's compile plane."""
    return {(e["tag"], e["geom"]): (e["misses"], e["hits"])
            for e in obs.to_doc()["compile"]["entries"]
            if tag is None or e["tag"] == tag}


@pytest.mark.parametrize("backend,tag", [("device", "trace_fn"),
                                         ("decremental", "dec_wake")])
def test_geometry_keyed_caches_commit_a_miss_then_hits(backend, tag,
                                                       observatory,
                                                       monkeypatch):
    """One miss per new layout geometry, a hit for every wake after it."""
    monkeypatch.setattr(cuda_trace, "_fn_cache", {})
    monkeypatch.setattr(cuda_decremental, "_fn_cache", {})
    _ref, port = make_pair(backend)
    script = Script(5, [port])
    script.intern(500)
    script.churn(800)
    for _ in range(3):
        port.compute_marks()
    assert sorted(compile_entries(observatory, tag).values()) == [(1, 2)]
    script.intern(700)  # past 1,024 slots: the layout's geometry changes
    port.compute_marks()
    assert sorted(compile_entries(observatory, tag).values()) == [(1, 0),
                                                                  (1, 2)]


def test_the_mesh_commits_no_compile_event(observatory, monkeypatch):
    ledger_pair("mesh-decremental", monkeypatch)
    tags = {tag for tag, _geom in compile_entries(observatory)}
    assert tags == set()  # no geometry-keyed cache on the mesh path


# --------------------------------------------------------------------- #
# Donation audit (updates in place)
# --------------------------------------------------------------------- #


def test_audit_flags_a_tensor_moved_to_new_storage(observatory):
    kept = torch.zeros(1024, dtype=torch.int32)
    moved = torch.zeros(512, dtype=torch.int64)
    before = port_arrays.storage_ptrs([kept, moved])
    kept[3] = 7  # in place: same storage
    moved = moved.clone()  # a silent copy
    port_arrays.audit_donation("planted.copy", before, kept, moved)
    assert observatory.donations == {"planted.copy": 1}
    assert observatory.to_doc()["donation"]["copies_total"] == 1


def mesh_graph_with_audit(monkeypatch):
    ref, port = ledger_pair("mesh", monkeypatch)
    port.donation_audit = True
    script = Script(9, [port])
    script.intern(50)
    script.churn(400)
    return port, script


def test_mesh_updates_in_place_report_no_copy(observatory, monkeypatch):
    port, _ = mesh_graph_with_audit(monkeypatch)
    before = port_arrays.storage_ptrs(port._dev_flags + port._dev_recv)
    port.compute_marks()
    assert port_arrays.storage_ptrs(port._dev_flags + port._dev_recv) == before
    assert observatory.donations == {}


def test_mesh_fold_that_reallocates_is_reported(observatory, monkeypatch):
    port, _ = mesh_graph_with_audit(monkeypatch)
    fold = port._fold_fn

    def copying_fold(flags, recv, *batch):
        flags, recv = fold(flags, recv, *batch)
        return [f.clone() for f in flags], recv  # a fold that copies

    monkeypatch.setattr(port, "_fold_fn", copying_fold)
    port.compute_marks()
    assert observatory.donations == {"mesh.fold": port.n_devices}


# --------------------------------------------------------------------- #
# Build log and the document
# --------------------------------------------------------------------- #


def test_build_log_feeds_the_compile_seconds(monkeypatch):
    monkeypatch.setattr(platform, "_builds", [("nvcc:propagate", 2.5)])
    registry = MetricsRegistry()
    obs = port_device.DeviceObservatory(node="x", registry=registry)
    platform.record_build("g++:crgc_shadow", 1.25)
    doc = obs.to_doc()
    assert doc["compile"]["kernel_build"] == {"n": 2, "total_s": 3.75,
                                              "max_s": 2.5}
    samples = registry.snapshot()["uigc_compile_seconds"]["samples"]
    assert {s["labels"]["tag"] for s in samples} >= {"nvcc:propagate",
                                                     "g++:crgc_shadow"}
    assert port_device.validate_device_doc(doc) == []
    obs.close()


def test_port_doc_validates_and_rejects_what_the_reference_rejects():
    obs = port_device.DeviceObservatory(node="x")
    doc = obs.to_doc()
    assert port_device.validate_device_doc(doc) == []
    assert ref_device.validate_device_doc(doc) == []
    doc["recent_wakes"] = [{"n_sweeps": 2, "sweep_device_ms": [1.0]}]
    assert port_device.validate_device_doc(doc) == \
        ref_device.validate_device_doc(doc) != []
    assert port_device.validate_device_doc([]) == ["document is not an object"]


def test_sweep_attribution_equals_the_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        n = int(rng.integers(0, 9))
        chunks = rng.integers(0, 50, int(rng.integers(0, n + 2))).tolist()
        device_s = float(rng.exponential(0.01))
        assert port_device.sweep_attribution(device_s, n, chunks) == \
            ref_device.sweep_attribution(device_s, n, chunks)
