"""The device trace of a ``--trace 1`` run: torch.profiler over a steady
part of the window, reduced to busy time, device time by operation, the
idle gaps named by what the host was doing, and how often each host
event ran.

Only device activity inside the ``portbench.window`` annotation counts;
the window's length is that annotation's.  Times are the profiler's
(microseconds on one clock for host and device events).
"""

from __future__ import annotations

import heapq
from collections import Counter, defaultdict
from contextlib import contextmanager
from typing import Any, Dict, List, Tuple

import torch

WINDOW = "portbench.window"
#: label of an idle gap in which no host-side torch event was open
NO_HOST_OP = "host: no torch op open"


@contextmanager
def profiled(out: Dict[str, Any], cuda: bool = True):
    """Profile the block on the CPU and, with ``cuda``, the card.  The
    profile is kept in ``out`` and reduced by :func:`finish` once the
    window has closed, so that reading it costs the window nothing."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize()
    out["profile"] = prof


def finish(out: Dict[str, Any]) -> Dict[str, Any]:
    """Reduce a profile kept by :func:`profiled` (in place)."""
    out.update(reduce_events(out.pop("profile").events()))
    return out


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(events) -> Dict[str, Any]:
    """Busy and window seconds, device seconds by operation name, idle
    seconds by the host event open at each gap's middle (the most
    recently begun, where several are), and the count of each host event
    begun in the window."""
    events = list(events)
    windows = [e for e in events if e.name == WINDOW]
    if not windows:
        raise RuntimeError("the profile holds no portbench.window annotation")
    w0 = windows[0].time_range.start
    w1 = windows[0].time_range.end
    device, host = [], []
    for e in events:
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a or e.name == WINDOW:
            continue
        (device if _is_device(e) else host).append((a, b, e.name))
    host_counts = Counter(name for a, _, name in host if a > w0)
    by_op: Dict[str, float] = defaultdict(float)
    for a, b, name in device:
        by_op[name] += (b - a) * 1e-6
    busy = _merge([(a, b) for a, b, _ in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    idle: Dict[str, float] = defaultdict(float)
    host.sort()
    # A sweep over the gaps in time order: the heap holds the host events
    # begun so far, latest start on top; an event that ended before this
    # gap's middle has ended before every later one too, and is dropped.
    opened: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            a, b, name = host[i]
            heapq.heappush(opened, (-a, b, name))
            i += 1
        while opened and opened[0][1] < mid:
            heapq.heappop(opened)
        label = opened[0][2] if opened else NO_HOST_OP
        idle[label] += (g1 - g0) * 1e-6
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1]),
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
        "host_counts": dict(host_counts),
    }


def breakdown(trace: Dict[str, Any]) -> Dict[str, List[List[Any]]]:
    """The result line's ``breakdown``: the ten largest of each list."""
    return {
        "device_ops": [[n, s] for n, s in trace["device_ops"][:10]],
        "idle_gaps": [[n, s] for n, s in trace["idle_gaps"][:10]],
    }
