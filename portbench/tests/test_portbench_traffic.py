"""Each traffic driver rehearsed at a tiny size through the program's
``device="cpu"`` path (no device metric is read there), its control, and
the faults a cell can have planted in the program underneath: every one
must turn ``correct`` false."""

import pytest

from portbench.tests.rehearsal import rehearse

PASSES = dict(cell="powerlaw10m.full", sizes={"actors": 6000})


def test_passes_sound():
    r = rehearse(seed=2**31 + 3, seconds=1.0, **PASSES)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"detect_p95_ms", "garbage_per_s", "setup_s"}
    # the flips change the verdict from pass to pass
    assert len(set(r["samples"]["garbage"])) > 1


def test_passes_traced():
    r = rehearse(seed=4, seconds=0.6, trace=True, **PASSES)
    assert r["correct"], r["checks"]
    # the device's metrics have nothing to read on the CPU, but the
    # profile holds the passes of the trace fn the untraced run times,
    # with the loop's changed-flag reads (two or more a pass)
    assert r["metrics"] == {}
    passes = r["counters"]["profiled_passes"]
    assert passes > 0
    assert r["trace"]["host_counts"]["aten::_local_scalar_dense"] >= 2 * passes


def test_host_syncs_are_counted_per_profiled_pass():
    from portbench import harness

    read = harness.reader("fixpoint.host_syncs")
    trace = {"host_counts": {"cudaStreamSynchronize": 42, "cudaLaunchKernel": 9}}
    assert read({"trace": trace, "counters": {"profiled_passes": 2}}) == 21
    assert read({"trace": {"host_counts": {}},
                 "counters": {"profiled_passes": 2}}) is None


def test_control_is_not_correct():
    r = rehearse(seed=7, seconds=1.0, control=True, **PASSES)
    assert not r["correct"], r["checks"]


# ------------------------------------------------------------------ #
# Faults planted in the program
# ------------------------------------------------------------------ #


def plant_pass_fault(monkeypatch, fault):
    from uigc_tpu_torch.ops import cuda_trace as ct
    from uigc_tpu_torch.ops import propagate as prop

    if fault == "half_left_out":
        real = ct.layout_to_device

        def half(prep, device=None):
            lay = real(prep, device)
            slots = prop.ROWS * lay["sub"] * prop.LANE
            rp = lay["row_pos"].view(lay["n_blocks"], slots)
            rp[::2] = prop.PAD_ROW
            return lay

        monkeypatch.setattr(ct, "layout_to_device", half)
        return
    real_get = ct.get_trace_fn

    def get(prep, *a, **kw):
        fn = real_get(prep, *a, **kw)
        first = []

        def wrapped(*args):
            marks = fn(*args)
            if fault == "state_unchanged":
                first.append(marks)
                return first[0]
            marks = marks.clone()  # "answer_altered": a root called garbage
            marks[0] = False
            return marks
        return wrapped

    monkeypatch.setattr(ct, "get_trace_fn", get)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_passes_fault_is_not_correct(monkeypatch, fault):
    plant_pass_fault(monkeypatch, fault)
    r = rehearse(seed=8, seconds=1.0, **PASSES)
    assert not r["correct"], (fault, r["checks"])
