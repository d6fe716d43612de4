"""The two readers of the program's spans, ``fixpoint.sweeps`` and
``device_idle.program``: their values on synthetic readings, nothing
without device time or without the spans, and the spans in the traced
CPU rehearsal's profile."""

import pytest

from portbench import devtrace, harness
from portbench.tests.rehearsal import rehearse

READERS = ("fixpoint.sweeps", "device_idle.program")


def readings(busy_s=0.6, host_counts=None, passes=10):
    counts = {"uigc.fixpoint.sweep": 80, "uigc.fixpoint.wait": 90,
              "cudaStreamSynchronize": 200}
    return {
        "counters": {"profiled_passes": passes},
        "trace": {
            "busy_s": busy_s, "window_s": 1.0,
            "host_counts": counts if host_counts is None else host_counts,
            "idle_gaps": [(devtrace.NO_HOST_OP, 0.1),
                          ("uigc.fixpoint.wait", 0.05),
                          ("cudaStreamSynchronize", 0.04),
                          ("uigc.fixpoint.seed", 0.02),
                          ("aten::copy_", 0.01)],
        },
    }


def test_synthetic_values():
    assert harness.reader("fixpoint.sweeps")(readings()) == 8.0
    assert harness.reader("device_idle.program")(readings()) == pytest.approx(7.0)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no_device_time", "no_spans", "no_trace"])
def test_nothing_to_read(name, case):
    r = {"no_device_time": readings(busy_s=0.0),
         "no_spans": readings(host_counts={"cudaStreamSynchronize": 200}),
         "no_trace": {"counters": {"profiled_passes": 0}, "trace": None}}[case]
    assert harness.reader(name)(r) is None


def test_traced_rehearsal_holds_the_spans():
    r = rehearse("powerlaw10m.full", seed=5, seconds=0.6, trace=True,
                 sizes={"actors": 6000})
    assert r["correct"], r["checks"]
    passes = r["counters"]["profiled_passes"]
    assert passes > 0
    counts = r["trace"]["host_counts"]
    assert counts["uigc.fixpoint.sweep"] >= passes
    assert counts["uigc.fixpoint.wait"] == counts["uigc.fixpoint.sweep"] + passes
    assert r["metrics"] == {}
    for name in READERS:
        assert harness.reader(name)(r) is None
