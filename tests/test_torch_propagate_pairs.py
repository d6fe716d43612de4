"""The raw pair tier's propagation (``ops/propagate.py``
``propagate_pairs``) on the CPU: its plain twin held against a numpy
``bitwise_or.at`` oracle over the tier's edge cases, the dispatch by
device, the operand checks, and the decremental wake's sweeps, which
call it once a sweep whenever the layout holds an xla tier.

The cases and the churn here are shared with the card's test,
``tests/test_torch_cuda_pairs.py``.  This file imports neither jax nor
uigc_tpu.
"""

import numpy as np
import pytest
import torch

from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import propagate as prop
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.ops.cuda_decremental import DecrementalTracer
from uigc_tpu_torch.ops.cuda_incremental import EDGE

F = trace_ops
NODES_PER_ROW = ct.LANE * ct.WORD_BITS  # 4,096 nodes a word row

#: the edge cases of a raw pair tier
CASES = ("random", "bit31", "sink_past_table", "all_sink", "kept_bits",
         "capacity_16k")


def pairs_case(name):
    """(table, src, dst, out, n) as numpy arrays: a table of random words
    (bits past n set too), a tier padded with sink pairs (src = dst = n),
    and a zero ``out`` plane unless the case keeps bits."""
    rng = np.random.default_rng(CASES.index(name))
    n, cap, m = 5000, 1 << 12, 3000
    if name == "sink_past_table":
        n, m = 8 * NODES_PER_ROW, 600  # a pad's word is one row past the table
    elif name == "all_sink":
        m = 0
    elif name == "capacity_16k":
        n, cap, m = (1 << 20) + 5, 1 << 14, 16_000
    r_rows = -(-n // NODES_PER_ROW)
    src = np.full(cap, n, np.int32)
    dst = np.full(cap, n, np.int32)
    src[:m] = rng.integers(0, n, m)
    # repeated destinations: a few hundred targets share the pairs
    dst[:m] = rng.choice(rng.integers(0, n, 300), m)
    if name == "bit31":
        dst[:m] = (rng.integers(0, n // 32, m) * 32 + 31).astype(np.int32)
    table = rng.integers(-(1 << 31), 1 << 31, (r_rows, ct.LANE),
                         dtype=np.int64).astype(np.int32)
    out = np.zeros_like(table)
    if name == "kept_bits":
        out = rng.integers(-(1 << 31), 1 << 31, table.shape,
                           dtype=np.int64).astype(np.int32)
    return table, src, dst, out, n


def oracle(table, src, dst, out, n):
    """The contract in numpy: for every slot whose src < n, dst < n and
    table bit src is set, OR bit dst into ``out``."""
    words = table.reshape(-1).view(np.uint32)
    s, d = src.astype(np.int64), dst.astype(np.int64)
    ok = (s < n) & (d < n)
    s, d = s[ok], d[ok]
    on = ((words[s >> 5] >> (s & 31).astype(np.uint32)) & 1) == 1
    got = out.copy().reshape(-1).view(np.uint32)
    np.bitwise_or.at(got, d[on] >> 5, np.uint32(1) << (d[on] & 31).astype(
        np.uint32))
    return got.view(np.int32).reshape(out.shape)


def tensors(case, dev="cpu"):
    """The case's arrays as fresh tensors on ``dev`` (copies: ``out`` is
    written in place), and n."""
    return tuple(torch.from_numpy(a.copy()).to(dev)
                 for a in case[:4]) + (case[4],)


@pytest.mark.parametrize("name", CASES)
def test_twin_matches_the_numpy_oracle(name):
    """The twin ORs exactly the oracle's bits into ``out``, keeps what
    ``out`` held, leaves its operands unchanged and counts no launch."""
    case = pairs_case(name)
    table, src, dst, out, n = tensors(case)
    kept = [x.clone() for x in (table, src, dst)]
    before = dict(prop.launches)
    got = prop.propagate_pairs(table, src, dst, out, n)
    assert got is out and got.dtype == torch.int32
    want = oracle(*case)
    assert np.array_equal(got.numpy(), want)
    assert all(torch.equal(a, b) for a, b in zip((table, src, dst), kept))
    assert prop.launches == before
    if name == "all_sink":
        assert not want.any()
    else:
        assert np.count_nonzero(want != case[3]) > 0
    if name == "bit31":
        assert (want.view(np.uint32) >> 31).any()
    if name == "sink_past_table":
        assert (case[1][-1] >> 5) == table.numel()


def test_unsupported_devices_raise():
    table, src, dst, out, n = tensors(pairs_case("random"))
    meta = [x.to("meta") for x in (table, src, dst, out)]
    with pytest.raises(ValueError, match="no pairs kernel"):
        prop.propagate_pairs(*meta, n)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        prop.propagate_pairs_cuda(table, src, dst, out, n)


@pytest.mark.parametrize("bad", ["dtype", "lengths", "out_shape", "n",
                                 "table_shape", "strided"])
def test_operand_checks_refuse(bad):
    table, src, dst, out, n = tensors(pairs_case("random"))
    if bad == "dtype":
        src = src.long()
    elif bad == "lengths":
        dst = dst[:-1]
    elif bad == "out_shape":
        out = out[:-1]
    elif bad == "n":
        n = table.numel() * ct.WORD_BITS + 1
    elif bad == "table_shape":
        table = table.reshape(-1)
    else:
        src = torch.stack([src, src], 1)[:, 0]
    with pytest.raises(ValueError):
        prop.propagate_pairs(table, src, dst, out, n)


class PairChurn:
    """A merged power-law graph of ``n`` actors and its seeded churn: each
    wake releases ``k`` live refs, creates up to ``k`` (into the live tier
    until it overflows ``freeze_threshold``), halts a few actors and
    flips a few busy.  The host arrays are the oracle's truth."""

    def __init__(self, n, seed, k=150):
        g = powerlaw_actor_graph(n, seed=seed, garbage_fraction=0.5)
        keys = np.unique((g["edge_src"].astype(np.int64) << 32)
                         | g["edge_dst"].astype(np.int64))
        self.n, self.k = n, k
        self.src = (keys >> 32).astype(np.int32)
        self.dst = (keys & 0xFFFFFFFF).astype(np.int32)
        self.w = np.ones(keys.size, np.int64)
        self.live = set(keys.tolist())
        self.flags = g["flags"].copy()
        self.recv = g["recv_count"].copy()
        self.sup = g["supervisor"]
        self.n_live = g["n_live"]
        self.rng = np.random.default_rng(seed)

    def tracer(self, dev, **kw):
        tr = DecrementalTracer(self.n, device=dev, **kw)
        tr.rebuild(self.src, self.dst, self.w, self.sup)
        tr.collect_stats = True
        return tr

    def next_log(self):
        rng, k, n = self.rng, self.k, self.n
        log = []
        for i in rng.choice(np.nonzero(self.w > 0)[0], k, replace=False):
            self.w[i] = 0
            s, d = int(self.src[i]), int(self.dst[i])
            self.live.discard((s << 32) | d)
            log.append((False, s, d, EDGE))
        new_s = rng.integers(0, n, k)
        new_d = np.where(new_s < self.n_live, rng.integers(0, self.n_live, k),
                         rng.integers(self.n_live, n, k))
        for s, d in zip(new_s.tolist(), new_d.tolist()):
            if (s << 32) | d not in self.live:
                self.live.add((s << 32) | d)
                self.src = np.append(self.src, np.int32(s))
                self.dst = np.append(self.dst, np.int32(d))
                self.w = np.append(self.w, 1)
                log.append((True, s, d, EDGE))
        self.flags[rng.integers(0, n, k // 10)] |= F.FLAG_HALTED
        self.flags[rng.choice(self.n_live, k // 10, replace=False)] ^= \
            F.FLAG_BUSY
        return log

    def oracle(self):
        return trace_ops.trace_marks_np(self.flags, self.recv, self.sup,
                                        self.src, self.dst, self.w)


def churned_wakes(churn, tracers, wakes):
    """Fold each wake's log into every tracer and wake them: yields
    (marks per tracer, stats per tracer, whether the wake's tiers held
    the live tier).  A wake that froze the tier, or had nothing new,
    traced without it."""
    for wake in range(wakes):
        if wake:
            log = churn.next_log()
            for tr in tracers:
                tr.apply_log(log)
        marks = [tr.marks(churn.flags, churn.recv) for tr in tracers]
        live_tier = [tr.layout.pending.size > 0 for tr in tracers]
        assert live_tier.count(live_tier[0]) == len(live_tier)
        yield marks, [tr.last_stats for tr in tracers], live_tier[0]


def test_decremental_wake_calls_the_twin_once_a_sweep(monkeypatch):
    """Over churned wakes on the CPU, the wake's marks are the oracle's
    and the twin runs once a closure or repair sweep of every wake whose
    tiers include the live tier, and never otherwise."""
    calls = [0]
    twin = prop.propagate_pairs_torch

    def counted(*args):
        calls[0] += 1
        return twin(*args)

    monkeypatch.setattr(prop, "propagate_pairs_torch", counted)
    churn = PairChurn(1 << 14, seed=3)
    tr = churn.tracer("cpu", freeze_threshold=512, mode="auto")
    seen = {True: 0, False: 0}
    for (marks,), (st,), live_tier in churned_wakes(churn, [tr], 10):
        got, calls[0] = calls[0], 0
        assert np.array_equal(marks, churn.oracle())
        sweeps = int(st["closure_sweeps"]) + int(st["n_sweeps"])
        assert got == (sweeps if live_tier else 0)
        seen[live_tier] += 1
    assert seen[True] >= 3 and seen[False] >= 2
