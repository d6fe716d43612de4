"""The plain reference of the collector's verdict: the CRGC mark fixpoint
in plain PyTorch, written from the collector's semantics (the reference
implementation's ShadowGraph.java:201-289) and not from the program.

    mark <- in_use & ~halted & (root | busy | recv_count != 0 | ~interned)
    repeat: every pair (s, d) with mark[s] & ~halted[s] marks d
    until nothing changes; marks stay inside in_use

The pairs are the graph's edges of positive weight and one pair from each
actor to its supervisor.  Garbage is in_use & ~mark.

``short_by`` returns the marks that many changing sweeps before the
fixpoint: the benchmark's control, a trace that stops early.
"""

from __future__ import annotations

import numpy as np
import torch

from .graphgen import (
    FLAG_BUSY,
    FLAG_HALTED,
    FLAG_IN_USE,
    FLAG_INTERNED,
    FLAG_ROOT,
)


def propagation_pairs(edge_src, edge_dst, edge_weight, supervisor):
    """(src, dst) int64 arrays of every pair that propagates a mark."""
    live = np.asarray(edge_weight) > 0
    sup = np.asarray(supervisor)
    child = np.nonzero(sup >= 0)[0]
    src = np.concatenate([np.asarray(edge_src)[live].astype(np.int64), child])
    dst = np.concatenate([np.asarray(edge_dst)[live].astype(np.int64),
                          sup[child].astype(np.int64)])
    return src, dst


def _bit(flags: torch.Tensor, bit) -> torch.Tensor:
    return (flags & int(bit)) != 0


def reference_marks(flags, recv_count, psrc, pdst, short_by: int = 0):
    """bool marks of the fixpoint over tensors on one device (numpy
    inputs are taken to the CPU).  ``psrc``/``pdst`` come from
    :func:`propagation_pairs`."""
    flags = torch.as_tensor(flags)
    dev = flags.device
    recv_count = torch.as_tensor(recv_count, device=dev)
    psrc = torch.as_tensor(psrc, device=dev).long()
    pdst = torch.as_tensor(pdst, device=dev).long()
    in_use = _bit(flags, FLAG_IN_USE)
    halted = _bit(flags, FLAG_HALTED)
    seed = (_bit(flags, FLAG_ROOT) | _bit(flags, FLAG_BUSY)
            | (recv_count != 0) | ~_bit(flags, FLAG_INTERNED))
    mark = in_use & ~halted & seed
    kept = [mark]
    while True:
        active = mark & ~halted
        new = mark.clone()
        new[pdst[active[psrc]]] = True
        new &= in_use
        if torch.equal(new, mark):
            break
        mark = new
        kept = (kept + [mark])[-(short_by + 1):]
    return kept[0]


def garbage_of(flags, marks) -> torch.Tensor:
    """The verdict: in-use actors left unmarked."""
    return _bit(torch.as_tensor(flags, device=marks.device), FLAG_IN_USE) & ~marks
