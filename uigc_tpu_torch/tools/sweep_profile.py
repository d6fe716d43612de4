"""Decompose the propagate trace's per-sweep cost at graph scale.

The port of ``tools/sweep_profile.py``, run from the repository root as
``python -m uigc_tpu_torch.tools.sweep_profile``.  It drives the port's
hand-written kernel (``ops/propagate.py`` ``propagate_words``, both
forms: plain, and gated by the per-supertile pull gate) and the trace
fixpoint around it (``ops/cuda_trace.py``), on ``--device`` (the CUDA
card by default; ``cpu`` runs the kernel's plain version).  The
reference's one-hot contraction and int8 path were not ported (ROADMAP
Queue 2), so their probes are gone.  What it times:

- a **full-dirty** sweep per form (every walk group dirty: the whole
  walk) and a **half-dirty** one (even groups: the mid-fixpoint
  regime);
- a **no-dirty** sweep per form (an empty dirty prefix: the kernel's
  empty walk — every block still reads its metadata and skips);
- the **word packs**: ``pack_bools`` of an n-node bool vector (the seed
  and gate tables of every trace, and the jump hits of every jump
  sweep) and ``pack_hits_words`` of a full hits plane (what the plain
  version and the xla tier pay per sweep; the kernel writes words);
- per trace mode (``uigc.crgc.trace-mode``: push/pull/jump/auto), the
  **fixpoint** itself: its sweep count, its wall time, the kernel's
  share of it (each launch timed with CUDA events) and the **glue**
  around the sweeps (dirty prefixes, gates, jump sweeps, mark updates,
  the per-sweep host read: the wall time less the kernel's), plus the
  per-sweep frontier decomposition (dirty walk groups, supertiles
  changed, tiles pull-skipped, the auto mode's pull decision) emitted
  through the telemetry wake profiler (telemetry/profile.py), as a live
  wake stamps it.

:func:`profile` takes a graph and its device layout, so a caller that
already holds them (``chip_smoke.py`` phase 14 hands it phase 4's 10M
graph) profiles without a repack; it returns the launches it made per
kernel form beside the sweeps it counted.

``--simulate`` instead runs the numpy sweep-count simulation at the
same graph geometry: sweep counts are hardware-independent.

Prints one JSON line.  Usage: python -m uigc_tpu_torch.tools.sweep_profile
[--n 10000000] [--device cuda|cpu] [--simulate] [--modes auto,push,pull,jump]
[--skip-probes] [--reps 5]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import propagate as prop
from uigc_tpu_torch.ops import trace as trace_ops

#: the kernel form each trace mode launches (pull gates need the gated one)
MODE_FORM = {
    ct.MODE_PUSH: "propagate",
    ct.MODE_JUMP: "propagate",
    ct.MODE_PULL: "propagate_gated",
    ct.MODE_AUTO: "propagate_gated",
}
FORMS = ("propagate", "propagate_gated")


def simulate_sweeps(graph, n, modes, jump_steps=None):
    """Hardware-independent fixpoint sweep counts per trace mode, by
    direct numpy simulation of the fixpoint's per-sweep semantics
    (table = mark & ~halted, hits gated by in_use, jump parents squared
    ``JUMP_STEPS`` times per sweep through transparent intermediates).
    Pull gating changes per-sweep WORK, never the sweep count, so pull
    reports push's count and auto jump's.  A copy of the reference's."""
    F = trace_ops
    if jump_steps is None:
        jump_steps = ct.JUMP_STEPS
    flags = graph["flags"]
    recv = graph["recv_count"]
    live = graph["edge_weight"] > 0
    psrc = graph["edge_src"][live].astype(np.int64)
    pdst = graph["edge_dst"][live].astype(np.int64)
    sup = graph["supervisor"]
    sup_src = np.nonzero(sup >= 0)[0].astype(np.int64)
    psrc = np.concatenate([psrc, sup_src])
    pdst = np.concatenate([pdst, sup[sup_src].astype(np.int64)])

    in_use = (flags & F.FLAG_IN_USE) != 0
    halted = (flags & F.FLAG_HALTED) != 0
    seed = (
        ((flags & F.FLAG_ROOT) != 0)
        | ((flags & F.FLAG_BUSY) != 0)
        | (recv != 0)
        | ((flags & F.FLAG_INTERNED) == 0)
    )
    mark0 = in_use & (~halted) & seed
    trans = in_use & (~halted)
    trans_pad = np.concatenate([trans, [False]])

    counts = {}
    aliases = {ct.MODE_PULL: ct.MODE_PUSH, ct.MODE_AUTO: ct.MODE_JUMP}
    for mode in modes:
        src = aliases.get(mode, mode)
        if src in counts:
            continue
        use_jump = src == ct.MODE_JUMP
        j = ct.jump_parents(psrc, pdst, n) if use_jump else None
        mark = mark0.copy()
        sweeps = 0
        while True:
            sweeps += 1
            active = mark & ~halted
            new = mark.copy()
            hit_dst = pdst[active[psrc]]
            new[hit_dst] |= in_use[hit_dst]
            if use_jump:
                active_pad = np.concatenate([active, [False]])
                jh = active_pad[j[:n]] & in_use
                new |= jh
                for _ in range(jump_steps):
                    j2 = j[j]
                    can = trans_pad[j] & (j2 < n)
                    j = np.where(can, j2, j)
            if np.array_equal(new, mark):
                break
            mark = new
        # the device fixpoint's sweep count includes the final
        # no-change sweep that proves convergence — same convention
        counts[src] = sweeps
    return {m: counts[aliases.get(m, m)] for m in modes}


# --------------------------------------------------------------------- #
# Clocks
# --------------------------------------------------------------------- #


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable[[], Any], dev: torch.device, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up: CUDA events around each run on the card, the host clock on
    the CPU.  ``fn`` runs ``reps + 1`` times."""
    fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class KernelClock:
    """Times every launch of the propagate kernel (or every call of its
    plain version on the CPU) while it is entered: the wrapper the trace
    calls is swapped for one that records a CUDA event pair around the
    call.  The launches themselves are unchanged, and counted as always
    by the wrapper.  ``ms()`` syncs and sums."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self._name = ("propagate_words_cuda" if dev.type == "cuda"
                      else "propagate_words_torch")
        self._plain = getattr(prop, self._name)
        self._pairs: List[Any] = []
        self._host_ms = 0.0
        self.calls = 0

    def __enter__(self):
        plain, dev = self._plain, self.dev

        def clocked(*args, **kw):
            self.calls += 1
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = plain(*args, **kw)
                b.record()
                self._pairs.append((a, b))
                return out
            t0 = time.perf_counter()
            out = plain(*args, **kw)
            self._host_ms += (time.perf_counter() - t0) * 1e3
            return out

        setattr(prop, self._name, clocked)
        return self

    def __exit__(self, *exc):
        setattr(prop, self._name, self._plain)

    def ms(self) -> float:
        _sync(self.dev)
        return self._host_ms + sum(a.elapsed_time(b) for a, b in self._pairs)


# --------------------------------------------------------------------- #
# The profile
# --------------------------------------------------------------------- #


def _probes(lay: Dict, dev: torch.device, reps: int,
            launches: Dict[str, int]) -> Dict[str, Any]:
    """The isolated sweeps and packs.  Adds the kernel calls it makes
    to ``launches`` per form."""
    n, r_rows = lay["n"], lay["r_rows"]
    n_chunks = r_rows // (ct.ROWS * lay["group"])
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    table = torch.randint(-(1 << 31), 1 << 31, (r_rows, ct.LANE),
                          dtype=torch.int64, generator=gen).to(
                              torch.int32).to(dev)
    full = torch.arange(n_chunks + 1, dtype=torch.int32, device=dev)
    none = torch.zeros(n_chunks + 1, dtype=torch.int32, device=dev)
    half_diff = torch.arange(n_chunks, device=dev) % 2 == 0
    half = torch.zeros(n_chunks + 1, dtype=torch.int32, device=dev)
    half[1:] = torch.cumsum(half_diff.to(torch.int32), 0)
    args = ct.device_args(lay)
    out = torch.zeros_like(table)
    kw = dict(n_super=lay["n_super"], s_rows=lay["s_rows"], sub=lay["sub"],
              group=lay["group"],
              super_ids=args[4] if len(args) > 4 else None)
    res: Dict[str, Any] = {}
    for form in FORMS:
        gate = (torch.zeros(lay["n_super"], dtype=torch.int32, device=dev)
                if form == "propagate_gated" else None)
        for label, d in (("full_dirty", full), ("half_dirty", half),
                         ("no_dirty", none)):

            def sweep(d=d, gate=gate):
                out.zero_()
                prop.propagate_words(d, args[0], args[1], table, args[2],
                                     args[3], out, gate=gate, **kw)

            res[f"sweep_{label}_ms"] = res.get(f"sweep_{label}_ms", {})
            res[f"sweep_{label}_ms"][form] = timed(sweep, dev, reps)
            launches[form] += reps + 1
    active = torch.ones(n, dtype=torch.bool, device=dev)
    res["pack_bools_ms"] = timed(lambda: ct.pack_bools(active, n, r_rows),
                                 dev, reps)
    hits2d = torch.ones((lay["n_super"] * lay["s_rows"], ct.LANE),
                        dtype=torch.bool, device=dev)
    res["pack_hits_words_ms"] = timed(lambda: prop.pack_hits_words(hits2d),
                                      dev, reps)
    return res


def profile(graph: Dict[str, np.ndarray], lay: Dict, jump_parent,
            device="cuda", modes=ct.TRACE_MODES, reps: int = 5,
            probes: bool = True) -> Dict[str, Any]:
    """Profile the trace of ``graph`` (its ``flags`` and ``recv_count``)
    over ``lay``, a layout of its pairs on ``device``
    (``ct.layout_to_device``), with ``jump_parent`` the pairs' jump
    parents (needed for jump/auto).  Returns the JSON document, plus
    ``marks`` (mode -> numpy marks; not JSON) and ``launches`` (the
    kernel calls made, per form: on the card, what the launch counters
    must have moved by)."""
    from uigc_tpu_torch.telemetry.profile import WakeProfiler
    from uigc_tpu_torch.utils import events

    dev = torch.device(device)
    launches = {form: 0 for form in FORMS}
    out: Dict[str, Any] = {
        "n_actors": lay["n"], "n_blocks": lay["n_blocks"],
        "n_chunks": lay["r_rows"] // (ct.ROWS * lay["group"]),
        "device": str(dev),
    }
    if probes:
        out.update(_probes(lay, dev, reps, launches))

    flags = torch.as_tensor(graph["flags"][: lay["n"]]).to(dev, torch.uint8)
    recv = torch.as_tensor(graph["recv_count"][: lay["n"]]).to(
        dev, torch.int64)
    jp = (torch.as_tensor(jump_parent).to(dev, torch.int32)
          if jump_parent is not None else None)
    layout_args = list(ct.device_args(lay))
    profiler = WakeProfiler(node="sweep_profile")
    was_enabled = events.recorder.enabled
    events.recorder.enable()
    events.recorder.add_listener(profiler)
    mode_out: Dict[str, Any] = {}
    marks_out: Dict[str, np.ndarray] = {}
    try:
        for mode in modes:
            use_jump = mode in (ct.MODE_JUMP, ct.MODE_AUTO)
            fn = ct.get_trace_fn(lay, mode=mode, with_stats=True)
            args = [flags, recv] + ([jp] if use_jump else []) + layout_args
            fn(*args)  # warm-up: builds and loads the kernel once
            _sync(dev)
            wk = profiler.begin_wake()
            with wk.phase("trace"):
                with events.recorder.timed(events.DEVICE_TRACE) as ev:
                    with KernelClock(dev) as clock:
                        t0 = time.perf_counter()
                        marks, stats = fn(*args)
                        _sync(dev)
                        fix_ms = (time.perf_counter() - t0) * 1e3
                    k = int(stats["n_sweeps"])
                    kk = min(k, ct.MAX_SWEEP_STATS)
                    frontier = {
                        key: stats[key][:kk].tolist()
                        for key in ("dirty_chunks", "changed_supers",
                                    "tiles_skipped", "pull_on")
                    }
                    ev.fields["trace_mode"] = mode
                    ev.fields["n_sweeps"] = k
                    for key, vals in frontier.items():
                        ev.fields[f"sweep_{key}"] = vals
            wk.end(mode=mode)
            kernel_ms = clock.ms()
            launches[MODE_FORM[mode]] += 2 * k
            glue_ms = fix_ms - kernel_ms
            mode_out[mode] = {
                "n_sweeps": k,
                "host_syncs": int(stats["host_syncs"]),
                "fixpoint_ms": fix_ms,
                "kernel_ms": kernel_ms,
                "kernel_calls": clock.calls,
                "glue_ms": glue_ms,
                "glue_per_sweep_ms": glue_ms / k if k else 0.0,
                **frontier,
            }
            marks_out[mode] = marks.cpu().numpy()
    finally:
        events.recorder.remove_listener(profiler)
        if not was_enabled:
            events.recorder.disable()
    out["modes"] = mode_out
    out["wake_profile_recent"] = profiler.to_json()["recent"]
    out["launches"] = launches
    out["marks"] = marks_out
    return out


# --------------------------------------------------------------------- #
# The command line: graph, pack cache, print
# --------------------------------------------------------------------- #


def _cache_dir() -> Path:
    """A per-user directory under the temporary root (a fixed name could
    collide with another user's files on a shared host), with a prefix
    of the port's own: the reference's packs are not this packer's."""
    path = Path(tempfile.gettempdir()) / f"uigc_torch_prep_{os.getuid()}"
    path.mkdir(exist_ok=True)
    return path


def _packed(n: int, seed: int, frac: float):
    """(graph or None, prep, aux, host_pack_s) through the pack cache.
    The key carries the graph model's version and a digest of the
    packer's source, so a generator or packer change misses."""
    from uigc_tpu_torch.models import graphgen

    sub, group = ct.default_geometry()
    digest = hashlib.sha256(Path(ct.__file__).read_bytes()).hexdigest()[:12]
    cache = _cache_dir() / (
        f"p{digest}_g{graphgen.GRAPH_MODEL_VERSION}_s{seed}_f{frac}_{n}"
        f"_{ct.S_ROWS}_{sub}_{group}.npz"
    )
    aux_cache = cache.with_suffix(".aux.npz")
    graph, prep, aux, pack_s = None, None, None, None
    if cache.exists() and aux_cache.exists():
        try:
            z = np.load(cache)
            prep = {k: (z[k] if z[k].ndim else z[k].item()) for k in z.files}
            z = np.load(aux_cache)
            aux = {k: z[k] for k in z.files}
        except Exception:  # a poisoned cache: repack
            cache.unlink(missing_ok=True)
            aux_cache.unlink(missing_ok=True)
            prep = aux = None
    if prep is None:
        graph = graphgen.powerlaw_actor_graph(n, seed=seed,
                                              garbage_fraction=frac)
        t0 = time.perf_counter()
        prep = ct.prepare_chunks(graph["edge_src"], graph["edge_dst"],
                                 graph["edge_weight"], graph["supervisor"], n)
        pack_s = time.perf_counter() - t0
        aux = {
            "flags": graph["flags"], "recv_count": graph["recv_count"],
            "jump_parent": ct.jump_parents_from_graph(
                graph["edge_src"], graph["edge_dst"], graph["edge_weight"],
                graph["supervisor"], n),
        }
        # Atomic publish: an interrupted savez must not leave a
        # truncated npz at the final path.
        for path, doc in ((cache, prep), (aux_cache, aux)):
            tmp = path.with_suffix(".tmp.npz")
            np.savez(tmp, **{k: v for k, v in doc.items()
                             if not k.startswith("_")})
            os.replace(tmp, path)
    return graph, prep, aux, pack_s


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="sweep-profile",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernel runs (default: the CUDA card; "
                    "cpu runs its plain version)")
    ap.add_argument(
        "--simulate", action="store_true",
        help="numpy sweep-count simulation per mode (no device work)",
    )
    ap.add_argument(
        "--modes", default="push,pull,jump,auto",
        help="comma-separated trace modes for the fixpoint decomposition",
    )
    ap.add_argument(
        "--skip-probes", action="store_true",
        help="skip the isolated-sweep probes (fixpoint decomposition only)",
    )
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    from uigc_tpu_torch.models import graphgen

    on_card = args.device == "cuda"
    n = args.n or (10_000_000 if on_card and not args.small else 1 << 16)
    seed, frac = 0, 0.5
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]

    if args.simulate:
        graph = graphgen.powerlaw_actor_graph(n, seed=seed,
                                              garbage_fraction=frac)
        counts = simulate_sweeps(graph, n, modes)
        print(json.dumps({
            "bench": "sweep_profile_simulate",
            "n_actors": n,
            "n_pairs": int((graph["edge_weight"] > 0).sum()
                           + (graph["supervisor"] >= 0).sum()),
            "jump_steps": ct.JUMP_STEPS,
            "sweeps": counts,
        }))
        return 0

    from uigc_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    _graph, prep, aux, pack_s = _packed(n, seed, frac)
    lay = ct.layout_to_device(prep, dev)
    doc = profile(aux, lay, aux["jump_parent"], device=dev, modes=modes,
                  reps=args.reps, probes=not args.skip_probes)
    doc.pop("marks")
    print(json.dumps({"bench": "sweep_profile", "n_pairs": prep["n_pairs"],
                      "host_pack_s": pack_s, **doc}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
