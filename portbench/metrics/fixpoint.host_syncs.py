"""fixpoint.host_syncs (layer: fixpoint loop): the times a pass makes the
host wait for the card (``cudaStreamSynchronize`` calls in torch.profiler's
host events over the traced part of the window, per pass): the trace fn's
changed-flag reads, once before the loop and once a sweep, whatever else
in the loop waits (a ``nonzero``, a size read back), and the verdict's
own readback, one a pass.  Nothing where no call reached a card (a CPU
rehearsal)."""

STREAM_SYNC = "cudaStreamSynchronize"


def read(r):
    trace = r.get("trace")
    passes = r["counters"].get("profiled_passes")
    if not trace or not passes or not trace["host_counts"].get(STREAM_SYNC):
        return None
    return trace["host_counts"][STREAM_SYNC] / passes
