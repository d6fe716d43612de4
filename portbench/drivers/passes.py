"""Driver ``passes``: collection passes run back to back over one graph
that stays on the device, each pass handed its own inputs.

Set-up generates the configuration's graph from the seed (the frozen
generator in ``reference/graphgen.py``), packs it with the program's
packer (``ops/cuda_trace.py`` ``prepare_chunks``), moves the layout to the
card (``layout_to_device``) and takes the program's trace fn
(``get_trace_fn``) in the configuration's trace mode.

One pass, timed on the host clock from the moment it is handed its inputs
to the moment its garbage verdicts are on the host:

1. the traffic's flips, scattered into the device flags: ``busy_flips``
   live actors toggle FLAG_BUSY, ``halt_flips`` live actors toggle
   FLAG_HALTED, one of the roots toggles FLAG_ROOT (all drawn from the
   seed, so no two passes have the same inputs);
2. the program's trace fn over the packed layout;
3. the verdict, in-use and unmarked, read back with ``.cpu()``.

A sample of the passes, drawn from the seed, keeps its verdict; once the
window has closed and the program's state is freed, the plain reference
(``reference/trace.py``) recomputes each from the generated graph and the
replayed flips, and every verdict must agree.  The reference's own
inputs (its propagation pairs) are made after the window too, so that
set-up holds only what the program needs.

With ``--trace 1`` the same trace fn runs; torch.profiler watches part of
the window (``devtrace``).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import devtrace, harness
from portbench.reference import graphgen as gg
from portbench.reference import trace as ref

#: passes per block of the flip plan (each block has its own stream)
BLOCK = 256


class FlipPlan:
    """The flips of every pass, drawn block by block from the seed: the
    same seed gives the same flips whether the program or the reference
    asks, and in whatever order."""

    def __init__(self, seed: int, n_live: int, num_roots: int,
                 busy: int, halts: int, device=None):
        self.seed, self.n_live, self.num_roots = seed, n_live, num_roots
        self.busy, self.halts = busy, halts
        self.device = device
        self._blocks: Dict[int, tuple] = {}

    def block(self, b: int):
        rng = gg.rng_for(self.seed, 1, b)
        busy = np.stack([rng.choice(self.n_live, self.busy, replace=False)
                         for _ in range(BLOCK)]).astype(np.int64)
        halts = np.stack([rng.choice(self.n_live, self.halts, replace=False)
                          for _ in range(BLOCK)]).astype(np.int64)
        roots = rng.integers(0, self.num_roots, (BLOCK, 1)).astype(np.int64)
        return busy, halts, roots

    def row(self, k: int):
        """Pass ``k``'s flips as device tensors (blocks made on demand)."""
        b = k // BLOCK
        if b not in self._blocks:
            self._blocks = {b: tuple(torch.from_numpy(a).to(self.device)
                                     for a in self.block(b))}
        busy, halts, roots = self._blocks[b]
        i = k % BLOCK
        return busy[i], halts[i], roots[i]

    def replay(self, flags: np.ndarray, upto: int, start: int = 0) -> None:
        """Apply the flips of passes ``[start, upto)`` to host ``flags``."""
        for b in range(start // BLOCK, (upto + BLOCK - 1) // BLOCK):
            busy, halts, roots = self.block(b)
            for k in range(max(start, b * BLOCK), min(upto, (b + 1) * BLOCK)):
                i = k - b * BLOCK
                apply_flips(flags, busy[i], halts[i], roots[i])


def apply_flips(flags, busy, halts, roots) -> None:
    """One pass's flips; ``flags`` is a host array or a device tensor."""
    flags[busy] ^= int(gg.FLAG_BUSY)
    flags[halts] ^= int(gg.FLAG_HALTED)
    flags[roots] ^= int(gg.FLAG_ROOT)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    sizes = ctx["config"]["sizes"]
    keys = ctx["config"]["program"]
    tr = ctx["traffic"]
    dev = torch.device(ctx["device"])
    on_card = dev.type == "cuda"
    seed, tracing = ctx["seed"], ctx["trace"]

    t = time.perf_counter()
    g = gg.powerlaw_actor_graph(
        sizes["actors"], gg.rng_for(seed, 0),
        garbage_fraction=sizes["garbage_fraction"],
        avg_degree=sizes["avg_degree"], alpha=sizes["alpha"],
        num_roots=sizes["num_roots"],
    )
    n = sizes["actors"]
    gen_s = time.perf_counter() - t
    plan = FlipPlan(seed, g["n_live"], g["num_roots"], tr["busy_flips"],
                    tr["halt_flips"], dev)

    flags = torch.from_numpy(g["flags"].copy()).to(dev)
    recv = torch.from_numpy(g["recv_count"]).to(dev)
    in_use = (flags & int(gg.FLAG_IN_USE)) != 0

    t = time.perf_counter()
    if ctx.get("control"):
        # The control: the plain reference, stopped one sweep short, in
        # the program's place.
        psrc_d, pdst_d = (torch.from_numpy(a).to(dev) for a in pairs_of(g))

        def trace_pass():
            return ref.reference_marks(flags, recv, psrc_d, pdst_d, short_by=1)
        lay = None
    else:
        from uigc_tpu_torch.ops import cuda_trace as ct

        mode = keys["uigc.crgc.trace-mode"]
        prep = ct.prepare_chunks(g["edge_src"], g["edge_dst"], g["edge_weight"],
                                 g["supervisor"], n)
        jump = []
        if mode in (ct.MODE_JUMP, ct.MODE_AUTO):
            jp = ct.jump_parents_from_graph(g["edge_src"], g["edge_dst"],
                                            g["edge_weight"], g["supervisor"], n)
            jump = [torch.from_numpy(jp).to(dev)]
        lay = ct.layout_to_device(prep, dev)
        del prep
        fn = ct.get_trace_fn(lay, mode=mode)
        operands = (*jump, *ct.device_args(lay))

        def trace_pass():
            return fn(flags, recv, *operands)
    pack_s = time.perf_counter() - t

    def one_pass(k: int):
        apply_flips(flags, *plan.row(k))
        marks = trace_pass()
        verdict = (in_use & ~marks).cpu()
        return verdict, marks

    # Warm-up: the same passes as the window's, the first of them building
    # the kernel library where a checkout has none yet.
    t = time.perf_counter()
    k = 0
    for _ in range(tr["warmup_passes"]):
        one_pass(k)
        k += 1
    if on_card:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    say(f"[setup] actors={n} gen_s={gen_s:.3f} "
        f"pack_s={pack_s:.3f} warm_s={warm_s:.3f}")

    pass_ms: List[float] = []
    garbage: List[int] = []
    keep = tr["checked_passes"]
    sample_rng = gg.rng_for(seed, 2)
    kept: Dict[int, np.ndarray] = {}
    last = {}

    def drive(until: float, counter: List[int]) -> None:
        """Passes until ``until``, one at least."""
        nonlocal k
        while True:
            t0 = time.perf_counter()
            verdict, marks = one_pass(k)
            t1 = time.perf_counter()
            pass_ms.append((t1 - t0) * 1e3)
            v = verdict.numpy()
            garbage.append(int(np.count_nonzero(v)))
            # a reservoir sample of the window's passes, drawn from the seed
            i = len(pass_ms)
            if len(kept) < keep:
                kept[k] = v
            elif sample_rng.random() < keep / i:
                kept.pop(list(kept)[int(sample_rng.integers(0, keep))])
                kept[k] = v
            last.update(k=k, verdict=v, marks=marks)
            counter[0] += 1
            k += 1
            if t1 >= until:
                return

    seconds = ctx["seconds"]
    trace = None
    in_profile = [0]
    t_w0 = time.perf_counter()
    setup_s = t_w0 - ctx["t_start"]
    if tracing:
        # The profile takes the window's last ``profile_s``, so that
        # stopping the profiler, which collects its trace, falls after the
        # close.
        drive(t_w0 + seconds - tr["profile_s"], [0])
        trace = {}
        with devtrace.profiled(trace, cuda=on_card):
            drive(time.perf_counter() + tr["profile_s"], in_profile)
            window_s = time.perf_counter() - t_w0
    else:
        drive(t_w0 + seconds, [0])
        window_s = time.perf_counter() - t_w0
    kept[last["k"]] = last["verdict"]
    if trace is not None:
        devtrace.finish(trace)
        hc = trace["host_counts"]
        say(f"[trace] profiled_passes={in_profile[0]} "
            f"scalar_reads={hc.get('aten::_local_scalar_dense', 0)} "
            f"stream_syncs={hc.get('cudaStreamSynchronize', 0)} "
            f"launches={hc.get('cudaLaunchKernel', 0)}")

    readings: Dict[str, Any] = {
        "setup_s": setup_s,
        "window_s": window_s,
        "samples": {"pass_ms": pass_ms, "garbage": garbage},
        "counters": {"passes": len(pass_ms), "profiled_passes": in_profile[0],
                     "n_actors": n},
        "trace": trace,
    }
    if on_card:
        readings["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if tracing and lay is not None:
            readings["kernel"] = full_walk(lay, last["marks"], flags)
    say(f"[window] passes={len(pass_ms)} window_s={window_s:.3f} "
        f"p50_ms={harness.median(pass_ms):.3f} "
        f"garbage_last={garbage[-1]}")

    # The program's state goes before the reference runs.
    del trace_pass, one_pass, lay, last, flags, recv, in_use
    plan._blocks.clear()
    if on_card:
        torch.cuda.empty_cache()
    psrc, pdst = pairs_of(g)
    readings["counters"]["n_pairs"] = int(psrc.size)
    mismatches = check_verdicts(g, plan, kept, psrc, pdst, dev)
    readings["attempted"] = len(pass_ms)
    readings["failed"] = 0
    readings["checks"] = [harness.check("verdict_mismatches", mismatches, 0)]
    return readings


def pairs_of(g):
    """The reference's propagation pairs of the generated graph."""
    return ref.propagation_pairs(g["edge_src"], g["edge_dst"],
                                 g["edge_weight"], g["supervisor"])


def check_verdicts(g, plan: FlipPlan, kept: Dict[int, np.ndarray],
                   psrc, pdst, dev) -> int:
    """Verdicts of the kept passes that differ from the reference's."""
    flags = g["flags"].copy()
    psrc_d = torch.from_numpy(psrc).to(dev)
    pdst_d = torch.from_numpy(pdst).to(dev)
    recv = torch.from_numpy(g["recv_count"]).to(dev)
    done = 0
    bad = 0
    for k in sorted(kept):
        plan.replay(flags, k + 1, start=done)
        done = k + 1
        f = torch.from_numpy(flags).to(dev)
        want = ref.garbage_of(f, ref.reference_marks(f, recv, psrc_d, pdst_d))
        bad += int(np.count_nonzero(want.cpu().numpy() != kept[k]))
    return bad


def full_walk(lay, marks, flags) -> Dict[str, Any]:
    """The kernel on one full walk of the cell's layout (every walk group
    dirty, the converged marks as the table): the median of 20 launches
    timed with CUDA events."""
    from uigc_tpu_torch.ops import cuda_trace as ct
    from uigc_tpu_torch.ops import propagate as prop

    n, r_rows = lay["n"], lay["r_rows"]
    n_chunks = r_rows // (prop.ROWS * lay["group"])
    halted = (flags & int(gg.FLAG_HALTED)) != 0
    table = ct.pack_bools(marks & ~halted, n, r_rows)
    d = torch.arange(n_chunks + 1, dtype=torch.int32, device=table.device)
    words = lay["n_super"] * lay["s_rows"] * (prop.LANE // prop.WORD_BITS)
    out = torch.zeros(words, dtype=torch.int32, device=table.device)
    bmeta1, bmeta2, row_pos, emeta = ct.device_args(lay)

    def launch():
        prop.propagate_words(d, bmeta1, bmeta2, table, row_pos, emeta, out,
                             n_super=lay["n_super"], s_rows=lay["s_rows"],
                             sub=lay["sub"], group=lay["group"])

    launch()
    times = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return {"full_walk_ms": harness.median(times), "launches": 21}
