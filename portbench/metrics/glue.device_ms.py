"""glue.device_ms (layer: sweep glue): device time per pass of every
kernel other than the propagate kernel, from torch.profiler over the
traced part of the window (copies and sets left out).  Nothing where no
operation ran on a device (a CPU rehearsal)."""

KERNEL = "propagate_words_kernel"


def read(r):
    trace = r.get("trace")
    passes = r["counters"].get("profiled_passes")
    if not trace or not passes or trace["busy_s"] <= 0:
        return None
    glue_s = sum(s for name, s in trace["device_ops"]
                 if KERNEL not in name and not name.startswith(("Memcpy", "Memset")))
    return glue_s * 1e3 / passes
