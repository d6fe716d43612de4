"""device_idle.detect (layer: device): the share of the traced part of
the window in which no operation ran on the card, in percent, from
torch.profiler (1 - union of device intervals / window).  Nothing where
no operation ran on a device (a CPU rehearsal)."""


def read(r):
    trace = r.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
