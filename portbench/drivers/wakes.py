"""Driver ``wakes``: the steady-state collector's wakes back to back over
one graph, each wake handed the log of what the mutators did since the
last one.

Set-up generates the configuration's graph from the seed (the frozen
generator in ``reference/graphgen.py``), merges its duplicate refs as a
shadow graph does (``reference/churn.py``), builds the program's
decremental tracer (``ops/cuda_decremental.py`` ``DecrementalTracer``)
with the configuration's trace mode and pull density and the layout's
defaults, and calls ``rebuild``.  The warm-up's first wake is the cold
one, the full derivation.

The loop is closed: a wake starts once the previous wake's verdicts are
on the host.  Each wake's log is drawn from the seed (``churn.WakePlan``)
outside the timed span, and the draw's host time is a counter.  One wake,
timed on the host clock from the log being handed over to the verdicts on
the host, does what the collector's decremental path does
(``engines/crgc/arrays.py`` ``_sync_layout`` then
``_compute_marks_decremental``), in its order:

1. ``apply_log(log)``;
2. the flag and receive-count changes scattered on the card;
3. ``needs_repack``, and then ``rebuild`` from the graph as it stands;
4. ``wake_device``;
5. the marks unpacked (``unpack_table``);
6. the verdict, in-use and unmarked, read back with ``.cpu()``.

Readings: the samples ``pass_ms`` (one wake) and ``garbage`` (its
verdict's count), which ``detect_p95_ms`` and ``garbage_per_s`` read as
they read passes; the counters ``passes``, ``profiled_passes``,
``n_actors``, ``n_pairs`` (the layout's pairs at set-up), ``freezes``,
``consolidations`` and ``repacks`` (the layout's tier packs and full
repacks in the run) and ``draw_s`` (the host seconds the window spent
drawing logs).

A sample of the window's wakes, drawn from the seed, keeps its verdict;
once the window has closed and the program's state is freed, the plain
reference (``reference/churn.py`` ``check_verdicts``) replays the logs
from the seed into a fresh plan, a pair-weight array in which a release
zeroes a ref's weight and a created ref is appended or revived, applies
the same flag changes, and recomputes each kept verdict with the full
fixpoint over the refs alive then and the supervisor pairs: every one
must agree.  ``--control 1`` runs that fixpoint, one changing sweep
short, in the program's place.

With ``--trace 1`` the same wakes run; torch.profiler watches the
window's last ``profile_s``.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import devtrace, harness
from portbench.reference import churn
from portbench.reference import graphgen as gg
from portbench.reference import trace as ref


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Program:
    """The program's side: the decremental tracer and the collector's
    steps of one wake."""

    def __init__(self, n, keys, merged, supervisor, dev):
        from uigc_tpu_torch.ops import cuda_decremental as cdec
        from uigc_tpu_torch.ops import cuda_trace as ct
        from uigc_tpu_torch.ops.cuda_incremental import EDGE

        self.n, self.supervisor, self.ct, self.edge = n, supervisor, ct, EDGE
        self.dec = cdec.DecrementalTracer(
            n, mode=keys["uigc.crgc.trace-mode"],
            pull_density=keys["uigc.crgc.pull-density"], device=dev)
        self.dec.rebuild(merged["src"], merged["dst"],
                         np.ones(merged["src"].size, np.int64), supervisor)
        self.repacks = 0

    def log_of(self, pairs) -> List[tuple]:
        return [(ins, s, d, self.edge) for ins, s, d in pairs]

    def fold(self, log, plan) -> None:
        self.dec.apply_log(log)

    def repack_if_needed(self, plan) -> None:
        if self.dec.layout.needs_repack:
            self.dec.rebuild(plan.src, plan.dst, plan.weight, self.supervisor)
            self.repacks += 1

    def marks(self, flags, recv):
        return self.ct.unpack_table(self.dec.wake_device(flags, recv), self.n)

    def counters(self) -> Dict[str, int]:
        st = self.dec.layout.stats
        return {"n_pairs": int(self.dec.layout.base["n_pairs"]),
                "freezes": st["freezes"],
                "consolidations": st["consolidations"],
                "repacks": self.repacks}


class Control:
    """The control in the program's place: the plain reference, stopped
    one changing sweep short, over the refs the logs leave alive (a copy
    of the plan's pair arrays on the card, kept in step with each log)."""

    def __init__(self, n, merged, supervisor, dev):
        self.dev = dev
        child = np.nonzero(supervisor >= 0)[0]
        self.sup = (torch.from_numpy(child.astype(np.int64)).to(dev),
                    torch.from_numpy(supervisor[child].astype(np.int64)).to(dev))
        self.src = torch.from_numpy(merged["src"].astype(np.int64)).to(dev)
        self.dst = torch.from_numpy(merged["dst"].astype(np.int64)).to(dev)

    def log_of(self, pairs):
        return pairs

    def fold(self, log, plan) -> None:
        known = self.src.shape[0]
        if plan.n_pairs > known:
            def tail(a):
                return torch.from_numpy(a[known:].astype(np.int64)).to(self.dev)
            self.src = torch.cat([self.src, tail(plan.src)])
            self.dst = torch.cat([self.dst, tail(plan.dst)])
        self.alive = torch.from_numpy(plan.weight > 0).to(self.dev)

    def repack_if_needed(self, plan) -> None:
        pass

    def marks(self, flags, recv):
        psrc = torch.cat([self.src[self.alive], self.sup[0]])
        pdst = torch.cat([self.dst[self.alive], self.sup[1]])
        return ref.reference_marks(flags, recv, psrc, pdst, short_by=1)

    def counters(self) -> Dict[str, int]:
        return {"n_pairs": int(self.src.shape[0] + self.sup[0].shape[0])}


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    sizes = ctx["config"]["sizes"]
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
    t = time.perf_counter()
    merged = churn.merged_graph(g)
    plan = churn.WakePlan(merged, g, seed, tr)
    merge_s = time.perf_counter() - t

    flags = torch.from_numpy(g["flags"].copy()).to(dev)
    recv = torch.from_numpy(g["recv_count"].copy()).to(dev)
    in_use = (flags & int(gg.FLAG_IN_USE)) != 0

    t = time.perf_counter()
    if ctx.get("control"):
        prog = Control(n, merged, g["supervisor"], dev)
    else:
        prog = Program(n, ctx["config"]["program"], merged, g["supervisor"],
                       dev)
    rebuild_s = time.perf_counter() - t
    draw_s = [0.0]

    def draw():
        """The next wake's inputs, made on the host: the log, and the flag
        changes' ids in one array (one copy to the card)."""
        t0 = time.perf_counter()
        w = plan.next()
        log = prog.log_of(churn.log_pairs(plan, w))
        groups = w.flag_groups()
        ids = np.concatenate(groups)
        cuts = np.cumsum([x.size for x in groups])[:-1].tolist()
        draw_s[0] += time.perf_counter() - t0
        return w.k, log, ids, cuts

    def one_wake(log, ids, cuts):
        prog.fold(log, plan)
        ids_d = torch.from_numpy(ids).to(dev)
        churn.apply_flags(flags, recv, *torch.tensor_split(ids_d, cuts))
        prog.repack_if_needed(plan)
        marks = prog.marks(flags, recv)
        return (in_use & ~marks).cpu()

    # Warm-up: the cold wake (the full derivation, and the kernel library
    # built where a checkout has none yet), then wakes as the window's.
    t = time.perf_counter()
    for _ in range(tr["warmup_wakes"]):
        one_wake(*draw()[1:])
    if on_card:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    say(f"[setup] actors={n} pairs={plan.n_pairs} gen_s={gen_s:.3f} "
        f"merge_s={merge_s:.3f} rebuild_s={rebuild_s:.3f} "
        f"warm_s={warm_s:.3f}")

    pass_ms: List[float] = []
    garbage: List[int] = []
    keep = tr["checked_wakes"]
    sample_rng = gg.rng_for(seed, 2)
    kept: Dict[int, np.ndarray] = {}
    last = {}
    draw_s[0] = 0.0

    def drive(until: float, counter: List[int]) -> None:
        """Wakes until ``until``, one at least."""
        while True:
            k, log, ids, cuts = draw()
            t0 = time.perf_counter()
            verdict = one_wake(log, ids, cuts)
            t1 = time.perf_counter()
            pass_ms.append((t1 - t0) * 1e3)
            v = verdict.numpy()
            garbage.append(int(np.count_nonzero(v)))
            # a reservoir sample of the window's wakes, drawn from the seed
            i = len(pass_ms)
            if len(kept) < keep:
                kept[k] = np.packbits(v)
            elif sample_rng.random() < keep / i:
                kept.pop(list(kept)[int(sample_rng.integers(0, keep))])
                kept[k] = np.packbits(v)
            last.update(k=k, verdict=v)
            counter[0] += 1
            if t1 >= until:
                return

    seconds = ctx["seconds"]
    trace = None
    in_profile = [0]
    t_w0 = time.perf_counter()
    setup_s = t_w0 - ctx["t_start"]
    if tracing:
        drive(t_w0 + seconds - tr["profile_s"], [0])
        trace = {}
        with devtrace.profiled(trace, cuda=on_card):
            drive(time.perf_counter() + tr["profile_s"], in_profile)
            window_s = time.perf_counter() - t_w0
    else:
        drive(t_w0 + seconds, [0])
        window_s = time.perf_counter() - t_w0
    kept[last["k"]] = np.packbits(last["verdict"])
    if trace is not None:
        devtrace.finish(trace)
        hc = trace["host_counts"]
        say(f"[trace] profiled_wakes={in_profile[0]} "
            f"stream_syncs={hc.get('cudaStreamSynchronize', 0)} "
            f"launches={hc.get('cudaLaunchKernel', 0)} "
            f"sweeps={hc.get('uigc.wake.closure.sweep', 0)}"
            f"+{hc.get('uigc.wake.repair.sweep', 0)}")

    readings: Dict[str, Any] = {
        "setup_s": setup_s,
        "window_s": window_s,
        "samples": {"pass_ms": pass_ms, "garbage": garbage},
        "counters": dict(prog.counters(), passes=len(pass_ms),
                         profiled_passes=in_profile[0], n_actors=n,
                         draw_s=draw_s[0]),
        "trace": trace,
    }
    if on_card:
        readings["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    c = readings["counters"]
    say(f"[window] wakes={len(pass_ms)} window_s={window_s:.3f} "
        f"p50_ms={harness.median(pass_ms):.3f} "
        f"p95_ms={harness.percentile(pass_ms, 95):.3f} "
        f"garbage_last={garbage[-1]} draw_s={draw_s[0]:.3f} "
        f"freezes={c.get('freezes')} consolidations={c.get('consolidations')} "
        f"repacks={c.get('repacks')}")

    # The program's state goes before the reference runs.
    del prog, one_wake, flags, recv, in_use, last
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    mismatches = churn.check_verdicts(g, merged, seed, tr, kept, dev,
                                      (plan.src, plan.dst))
    say(f"[check] wakes={len(kept)} check_s={time.perf_counter() - t:.3f}")
    readings["attempted"] = len(pass_ms)
    readings["failed"] = 0
    readings["checks"] = [harness.check("verdict_mismatches", mismatches, 0)]
    return readings
