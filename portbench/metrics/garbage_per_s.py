"""garbage_per_s: the garbage actors named by the verdicts of every pass
in the window, summed, over the window's seconds."""


def read(r):
    garbage = r["samples"].get("garbage")
    if not garbage:
        return None
    return sum(garbage) / r["window_s"]
