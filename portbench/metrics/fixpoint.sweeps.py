"""fixpoint.sweeps (layer: fixpoint loop): sweeps of the mark fixpoint a
pass, counted from the program's own ``uigc.fixpoint.sweep`` spans among
torch.profiler's host events over the traced part of the window: the
fixpoint's unit of work, read in the trace fn the untraced run times.
Nothing where no operation ran on a device (a CPU rehearsal) or where the
program opens no such span."""

SWEEP = "uigc.fixpoint.sweep"


def read(r):
    trace = r.get("trace")
    passes = r["counters"].get("profiled_passes")
    if not trace or not passes or trace["busy_s"] <= 0:
        return None
    sweeps = trace["host_counts"].get(SWEEP)
    if not sweeps:
        return None
    return sweeps / passes
