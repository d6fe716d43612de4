"""wake.fold_idle (layer: layout fold): the share of the traced part of
the window, in percent, in which the card sat idle while the host folded
the log into the layout or built the wake's inputs: idle gaps named by a
``uigc.layout.*`` span (the fold, the freeze, the consolidation, the
tiers) or by ``uigc.wake.ids`` (the id sets scattered into words), as
``device_idle.program`` reads the gaps.  Nothing where no operation ran
on a device (a CPU rehearsal) or where the program opens no such span."""

LAYOUT = "uigc.layout."
IDS = "uigc.wake.ids"


def named(label: str) -> bool:
    return label.startswith(LAYOUT) or label == IDS


def read(r):
    trace = r.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    if not any(named(name) for name in trace["host_counts"]):
        return None
    idle_s = sum(s for label, s in trace["idle_gaps"] if named(label))
    return 100.0 * idle_s / trace["window_s"]
