"""The liveness trace as array kernels: masked label propagation to fixpoint.

This is the array re-design of the reference's pointer-chasing BFS
(reference: ShadowGraph.java:205-289).  The shadow graph lives as dense
node-feature arrays plus a COO edge list; one trace is an iterative
frontier expansion:

    mark    <- pseudoroot(flags, recv_count)
    repeat: mark |= scatter_or(mark[src] & ~halted[src] & (w > 0) -> dst)
            mark |= scatter_or(mark & ~halted -> supervisor)
    until fixpoint

Semantics must match the oracle exactly:
- pseudoroot = (root | busy | recv_count != 0 | ~interned) & ~halted
  (reference: ShadowGraph.java:201-203)
- only edges with positive net count propagate
  (reference: ShadowGraph.java:231-241)
- halted actors neither seed nor propagate, but may be marked
  (reference: ShadowGraph.java:226-229)
- supervisors of marked, non-halted actors are marked
  (reference: ShadowGraph.java:242-267)

Port of ``uigc_tpu/ops/trace.py``: the numpy oracle is copied as it is;
the reference's JAX fixpoint (``trace_marks_jax``) becomes
:func:`trace_marks_torch`, a ``scatter_reduce_("amax")`` fixpoint with the
same contract, held mark-for-mark against it by
``tests/test_torch_trace.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.platform import resolve_device

# Node flag bits (shared by host and device code).
FLAG_ROOT = np.uint8(1)
FLAG_BUSY = np.uint8(2)
FLAG_INTERNED = np.uint8(4)
FLAG_LOCAL = np.uint8(8)
FLAG_HALTED = np.uint8(16)
FLAG_IN_USE = np.uint8(32)


def pseudoroots_np(flags: np.ndarray, recv_count: np.ndarray) -> np.ndarray:
    """(reference: ShadowGraph.java:201-203)"""
    in_use = (flags & FLAG_IN_USE) != 0
    not_halted = (flags & FLAG_HALTED) == 0
    seed = (
        ((flags & FLAG_ROOT) != 0)
        | ((flags & FLAG_BUSY) != 0)
        | (recv_count != 0)
        | ((flags & FLAG_INTERNED) == 0)
    )
    return in_use & not_halted & seed


def trace_marks_np(
    flags: np.ndarray,
    recv_count: np.ndarray,
    supervisor: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_weight: np.ndarray,
) -> np.ndarray:
    """Host (numpy) mark fixpoint.  Returns a bool[N] mark vector."""
    n = flags.shape[0]
    in_use = (flags & FLAG_IN_USE) != 0
    halted = (flags & FLAG_HALTED) != 0
    mark = pseudoroots_np(flags, recv_count)

    live_edge = edge_weight > 0
    esrc = edge_src[live_edge]
    edst = edge_dst[live_edge]

    has_sup = supervisor >= 0
    sup_src = np.nonzero(has_sup)[0]
    sup_dst = supervisor[sup_src]

    while True:
        active = mark & ~halted
        new_mark = mark.copy()
        # Edge propagation: dst gets marked if any active src points at it.
        if esrc.size:
            hits = edst[active[esrc]]
            new_mark[hits] = True
        # Supervisor marking.
        if sup_src.size:
            sup_hits = sup_dst[active[sup_src]]
            new_mark[sup_hits] = True
        new_mark &= in_use  # never mark free slots
        if np.array_equal(new_mark, mark):
            return mark
        mark = new_mark


def trace_marks_np_parents(
    flags: np.ndarray,
    recv_count: np.ndarray,
    supervisor: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_weight: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host mark fixpoint that additionally records the marking-parent
    array: ``parent[i]`` is the slot whose propagation first marked
    ``i`` (the minimum such source within the marking sweep, matching
    the device variant's scatter-min), or ``-1`` for pseudoroot seeds
    and unmarked slots.  Marks are bit-identical to
    :func:`trace_marks_np`; parents form an acyclic forest rooted at
    the seeds — the raw material of a why-live retaining path
    (telemetry/inspect.py).  A separate entry point, not a flag on the
    plain trace, so the no-capture wake path pays nothing."""
    n = flags.shape[0]
    in_use = (flags & FLAG_IN_USE) != 0
    halted = (flags & FLAG_HALTED) != 0
    mark = pseudoroots_np(flags, recv_count)
    parent = np.full(n, -1, dtype=np.int64)

    live_edge = edge_weight > 0
    esrc = edge_src[live_edge].astype(np.int64)
    edst = edge_dst[live_edge].astype(np.int64)

    has_sup = supervisor >= 0
    sup_src = np.nonzero(has_sup)[0]
    sup_dst = supervisor[sup_src].astype(np.int64)

    while True:
        active = mark & ~halted
        cand = np.full(n, n, dtype=np.int64)
        if esrc.size:
            hit = active[esrc]
            np.minimum.at(cand, edst[hit], esrc[hit])
        if sup_src.size:
            hit = active[sup_src]
            np.minimum.at(cand, sup_dst[hit], sup_src[hit])
        newly = (cand < n) & ~mark & in_use
        if not newly.any():
            return mark, parent
        parent[newly] = cand[newly]
        mark = mark | newly


# --------------------------------------------------------------------- #
# PyTorch implementation
# --------------------------------------------------------------------- #


def flag_set(flags: torch.Tensor, bit) -> torch.Tensor:
    """Bool tensor: ``flags & bit != 0`` for a uint8 flag tensor."""
    return (flags & int(bit)) != 0


def seeds_torch(flags: torch.Tensor, recv_count: torch.Tensor) -> torch.Tensor:
    """The pseudoroot seed predicate before the in-use/halted gates
    (reference: ShadowGraph.java:201-203)."""
    return (
        flag_set(flags, FLAG_ROOT)
        | flag_set(flags, FLAG_BUSY)
        | (recv_count != 0)
        | ~flag_set(flags, FLAG_INTERNED)
    )


def trace_marks_torch(
    flags, recv_count, supervisor, edge_src, edge_dst, edge_weight,
    device=None,
) -> np.ndarray:
    """Device (PyTorch) mark fixpoint.  Same contract as
    :func:`trace_marks_np`; runs on ``device`` (default: the CUDA card).

    Dead edges and absent supervisors scatter into a sink slot ``n``, as
    in the reference's XLA fixpoint; the loop reads its ``changed`` flag
    on the host once per sweep."""
    dev = resolve_device(device)

    def put(a, dtype):
        host = np.asarray(a)  # readback: host inputs, numpy or a list
        return torch.as_tensor(host, device=dev).to(dtype)

    flags = put(flags, torch.uint8)
    recv_count = put(recv_count, torch.int64)
    supervisor = put(supervisor, torch.int64)
    edge_src = put(edge_src, torch.int64)
    edge_dst = put(edge_dst, torch.int64)
    edge_weight = put(edge_weight, torch.int64)
    n = flags.shape[0]
    in_use = flag_set(flags, FLAG_IN_USE)
    halted = flag_set(flags, FLAG_HALTED)
    mark = in_use & ~halted & seeds_torch(flags, recv_count)

    live_edge = edge_weight > 0
    sink = torch.full_like(edge_dst, n)
    edst = torch.where(live_edge, edge_dst, sink)
    esrc = torch.where(live_edge, edge_src, sink)
    sup_dst = torch.where(supervisor >= 0, supervisor,
                          torch.full_like(supervisor, n))
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    while True:
        active = mark & ~halted
        active_pad = torch.cat([active, false1])
        prop = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        prop.scatter_reduce_(0, edst, active_pad[esrc].to(torch.int32),
                             "amax", include_self=True)
        prop.scatter_reduce_(0, sup_dst, active.to(torch.int32), "amax",
                             include_self=True)
        new_mark = (mark | (prop[:n] > 0)) & in_use
        if not bool((new_mark != mark).any()):
            return mark.cpu().numpy()  # readback: np result contract
        mark = new_mark


def garbage_and_kills_np(
    flags: np.ndarray, supervisor: np.ndarray, mark: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Post-trace sweep decisions (reference: ShadowGraph.java:273-284).

    Returns (garbage, kill): ``garbage`` = in-use and unmarked;
    ``kill`` = garbage that is local, not halted, and whose supervisor is
    marked — the oldest unmarked ancestors; the runtime's stop cascade
    takes down their subtrees."""
    in_use = (flags & FLAG_IN_USE) != 0
    garbage = in_use & ~mark
    local = (flags & FLAG_LOCAL) != 0
    not_halted = (flags & FLAG_HALTED) == 0
    sup_ok = supervisor >= 0
    sup_idx = np.where(sup_ok, supervisor, 0)
    sup_marked = mark[sup_idx] & sup_ok
    kill = garbage & local & not_halted & sup_marked
    return garbage, kill
