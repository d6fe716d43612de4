"""detect_p95_ms: the 95th percentile, over every pass completed in the
window, of one pass's host-clock time from being handed its inputs to its
verdicts on the host."""

from portbench.harness import percentile


def read(r):
    return percentile(r["samples"].get("pass_ms", []), 95)
