"""Strongly-connected components as tensor ops (device SCC).

Port of ``uigc_tpu/ops/scc.py``: the Tarjan oracle ``scc_labels_np`` is
copied as it is; the reference's XLA program (``_build_scc_fn``, three
nested ``lax.while_loop`` s around scatter-max) becomes
:func:`scc_labels_torch`, the same FB-MAX coloring as torch ops on an
explicit device, held label-for-label against ``scc_labels_jax`` and
``scc_labels_np`` by ``tests/test_torch_scc.py``.

The MAC engine's cycle detector needs the SCCs of the blocked-actor
reference graph.  The reference ships only a stub detector
(reference: src/main/resources/reference.conf:48, mac/CycleDetector.scala:42-97);
ours completes it with host-side Tarjan (engines/mac/detector.py), and
this module provides the device alternative for large blocked sets: SCC
by iterative forward-backward label propagation ("coloring" SCC), which
is the trace's propagation pattern run in both directions.

Algorithm (FB-MAX coloring):

1. color[v] := max over nodes u that can reach v (forward max-propagation
   to fixpoint, restricted to unassigned nodes).
2. pivots are nodes with color[v] == v; each color class has exactly one.
3. backward-propagate reachability from each pivot within its own color
   class; every node reached belongs to the pivot's SCC.
4. assign those nodes, repeat on the rest.  Each round assigns at least
   one whole SCC, so the outer loop terminates in <= #SCC rounds.

Labels are the pivot node ids.  ``scc_labels_np`` is the Tarjan oracle
with identically-normalized labels for differential testing.

The reference's loops run on the device with no host read.  Here each
forward and each backward sweep ends in one ``bool(changed)`` read on
the host, and each round in one ``any(~assigned)`` read; ``with_stats``
returns their counts.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.platform import resolve_device


def scc_labels_np(
    n: int,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    active: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Tarjan oracle.  Returns int32[n] labels; nodes in the same SCC get
    the same label (the max member id, matching the device kernel);
    inactive nodes get their own id."""
    labels = np.arange(n, dtype=np.int32)
    if active is None:
        active = np.ones(n, dtype=bool)
    adj: Dict[int, list] = {}
    for s, d in zip(edge_src.tolist(), edge_dst.tolist()):
        if 0 <= s < n and 0 <= d < n and active[s] and active[d]:
            adj.setdefault(s, []).append(d)

    index_of: Dict[int, int] = {}
    lowlink: Dict[int, int] = {}
    on_stack = set()
    stack: list = []
    counter = [0]

    for root in range(n):
        if not active[root] or root in index_of:
            continue
        work = [(root, iter(adj.get(root, ())))]
        index_of[root] = lowlink[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for succ in it:
                if succ not in index_of:
                    index_of[succ] = lowlink[succ] = counter[0]
                    counter[0] += 1
                    stack.append(succ)
                    on_stack.add(succ)
                    work.append((succ, iter(adj.get(succ, ()))))
                    advanced = True
                    break
                elif succ in on_stack:
                    lowlink[node] = min(lowlink[node], index_of[succ])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[node])
            if lowlink[node] == index_of[node]:
                members = []
                while True:
                    member = stack.pop()
                    on_stack.discard(member)
                    members.append(member)
                    if member is node or member == node:
                        break
                rep = max(members)
                for member in members:
                    labels[member] = rep
    return labels


def scc_labels_torch(
    n: int,
    edge_src,
    edge_dst,
    active=None,
    device=None,
    with_stats: bool = False,
):
    """Device SCC labels; same contract as :func:`scc_labels_np`: int32[n]
    labels as a numpy array, each the max member id of its SCC; inactive
    nodes keep their own id and invalid endpoints (e.g. -1 padding) are
    ignored.  Runs on ``device`` (default: the CUDA card).

    With ``with_stats`` it returns ``(labels, stats)``: ``rounds``,
    ``sweeps`` (forward plus backward) and ``host_reads`` (one per sweep
    and one per round test).  Raises rather than spin if the rounds
    exceed ``n``, which the algorithm cannot need."""
    dev = resolve_device(device)
    if active is None:
        active = np.ones(n, dtype=bool)

    def put(a, dtype):
        host = np.asarray(a)  # readback: host inputs, numpy or a list
        return torch.as_tensor(host, device=dev).to(dtype)

    edge_src = put(edge_src, torch.int32)
    edge_dst = put(edge_dst, torch.int32)
    active = put(active, torch.bool)
    sink = n  # scatter target for masked-out edges
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    # Edge endpoint validity is fixed for the whole run.  The clip guards
    # the gathers before the range mask applies.
    evalid = (
        (edge_src >= 0)
        & (edge_src < n)
        & (edge_dst >= 0)
        & (edge_dst < n)
        & active[edge_src.clamp(0, n - 1).long()]
        & active[edge_dst.clamp(0, n - 1).long()]
    )
    # scatter_reduce_ takes int64 indices: widened once per call.
    esrc = torch.where(evalid, edge_src, 0).long()
    edst = torch.where(evalid, edge_dst, 0).long()
    neg1 = torch.full((1,), -1, dtype=torch.int32, device=dev)
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)

    labels = iota.clone()  # inactive nodes keep their own id
    assigned = ~active
    rounds = sweeps = host_reads = 0
    while True:
        host_reads += 1
        if not bool((~assigned).any()):
            break
        rounds += 1
        if rounds > n:
            raise RuntimeError(
                f"device SCC did not converge in {n} rounds; every round "
                "assigns at least one whole SCC"
            )
        live_edge = evalid & ~assigned[esrc] & ~assigned[edst]
        dst_or_sink = torch.where(live_edge, edst, sink)
        src_or_sink = torch.where(live_edge, esrc, sink)

        # 1. forward max-propagation of node ids.
        color = torch.where(assigned, -1, iota)
        while True:
            color_pad = torch.cat([color, neg1])
            prop = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
            prop.scatter_reduce_(0, dst_or_sink, color_pad[src_or_sink],
                                 "amax", include_self=True)
            new = torch.where(assigned, color, torch.maximum(color, prop[:n]))
            sweeps += 1
            host_reads += 1
            changed = bool((new != color).any())
            color = new
            if not changed:
                break

        # 2-3. backward reach from pivots within each color class.
        reach = (color == iota) & ~assigned
        same_color = color[esrc] == color[edst]
        while True:
            reach_pad = torch.cat([reach, false1])
            hit = reach_pad[dst_or_sink] & same_color
            prop = torch.zeros(n + 1, dtype=torch.int32, device=dev)
            prop.scatter_reduce_(0, src_or_sink, hit.to(torch.int32), "amax",
                                 include_self=True)
            new = reach | ((prop[:n] > 0) & ~assigned)
            sweeps += 1
            host_reads += 1
            changed = bool((new != reach).any())
            reach = new
            if not changed:
                break

        labels = torch.where(reach, color, labels)
        assigned = assigned | reach

    out = labels.cpu().numpy()  # readback: host boundary: np result contract
    if with_stats:
        return out, {"rounds": rounds, "sweeps": sweeps,
                     "host_reads": host_reads}
    return out


__all__ = ["scc_labels_np", "scc_labels_torch"]
