"""wake.host_syncs (layer: decremental wake): the times a wake makes the
host wait for the card (``cudaStreamSynchronize`` calls in torch.profiler's
host events over the traced part of the window, per wake): the closure's
and the repair's changed-flag reads, the copies of the id sets, the
log's flag changes and the layout's masked slots to the card, and the
verdict's readback.  Nothing where no call reached a card (a CPU
rehearsal)."""

STREAM_SYNC = "cudaStreamSynchronize"


def read(r):
    trace = r.get("trace")
    wakes = r["counters"].get("profiled_passes")
    if not trace or not wakes or not trace["host_counts"].get(STREAM_SYNC):
        return None
    return trace["host_counts"][STREAM_SYNC] / wakes
