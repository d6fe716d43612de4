"""device_idle.program (layer: fixpoint loop): the share of the traced
part of the window, in percent, in which the card sat idle while the host
was in the program's own code between torch calls.  The device trace
names each idle gap by the innermost host event open at its middle; this
sums the gaps named by one of the program's ``uigc.*`` spans.  Nothing
where no operation ran on a device (a CPU rehearsal) or where the program
opens no such span."""

PREFIX = "uigc."


def read(r):
    trace = r.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    if not any(name.startswith(PREFIX) for name in trace["host_counts"]):
        return None
    idle_s = sum(s for label, s in trace["idle_gaps"] if label.startswith(PREFIX))
    return 100.0 * idle_s / trace["window_s"]
