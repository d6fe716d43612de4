"""wake.sweeps (layer: decremental wake): sweeps a wake, closure and
repair together, counted from the program's own
``uigc.wake.closure.sweep`` and ``uigc.wake.repair.sweep`` spans among
torch.profiler's host events over the traced part of the window: the
wake's work as a count, read in the wakes the untraced run times.
Nothing where no operation ran on a device (a CPU rehearsal) or where the
program opens no such span."""

SWEEPS = ("uigc.wake.closure.sweep", "uigc.wake.repair.sweep")


def read(r):
    trace = r.get("trace")
    wakes = r["counters"].get("profiled_passes")
    if not trace or not wakes or trace["busy_s"] <= 0:
        return None
    sweeps = sum(trace["host_counts"].get(name, 0) for name in SWEEPS)
    if not sweeps:
        return None
    return sweeps / wakes
