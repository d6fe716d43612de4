#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (uigc_tpu_torch) on one Hopper card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. Device: the card's name and power limit (nvidia-smi), its compute
   capability; fails unless CUDA is present and the card is sm_90.
2. Build: compiles csrc/propagate.cu with nvcc (into
   uigc_tpu_torch/csrc/build/) and loads it.
3. Kernel vs plain: the propagate kernel, both forms, against its plain
   PyTorch version (propagate_words_torch) on the card: seeded random
   layouts (dense, and compact with pad tiles; global gates mixing
   PUSH/FULL/SKIP; full and partial dirty lists), a block-shuffled copy
   of each (its words must not change), and the 10M-actor layout of
   phase 4, all-dirty and with mixed gates.  Equality is exact on the
   int32 hit words.  Times each form on a full-walk sweep at the 10M
   layout with CUDA events, beside the byte bound of the work the new
   design does and the bound by the formula of the earlier f32 kernel
   (one thread per slot).
4. Main path: a 10M-actor power-law graph (seed 0, half garbage) packed,
   moved to the card and traced through get_trace_fn in push, pull, jump
   and auto; the garbage set must equal the generator's expected set.
   Then the sparse sweep: both forms timed on the inputs of push sweep
   SPARSE_SWEEP (a late sweep with few dirty walk groups), and a
   torch.profiler breakdown of one auto trace.
5. Incremental and decremental: a 1M-actor graph under a seeded churn
   schedule (inserts, removes, halts, root releases) over 11 wakes, on
   IncrementalCudaLayout.trace_device and DecrementalTracer; marks must
   equal trace_marks_np at every wake, and the repair sweep must have
   run FULL-gated tiles.
6. Live collector: the port's actor runtime with the CRGC engine, its
   collector tracing on the card (uigc.crgc.device "cuda").  run_tree
   (BASELINE config 1: 100,000 actors, fanout 8) on "device" (trace-mode
   auto, and push for the plain kernel form), "decremental" and
   pipelined "decremental"; run_rings (config 3: 1,000 rings of 100) on
   "decremental".  Each run holds the built topology for 10 collector
   wakes (no actor may stop: an unsound verdict kills live actors), then
   releases it; every actor must be collected and the kernel must have
   launched inside the collector.  In the push tree and the rings, every
   collector trace must equal trace_marks_np on the same graph arrays.
   Launch counts are reset just before each run and read just after.
   One launch of each kernel form at the live shapes is captured,
   replayed and held against its plain version.
7. MAC on the card: the port's MAC engine.  run_tree (BASELINE config 2:
   100,000 actors, flat, default MAC settings) is host work: held for 10
   wakeup intervals, released, every actor collected.  run_rings (10,000
   rings of 10) with uigc.mac.cycle-detection on and uigc.mac.device
   "cuda": 100,000 blocked candidates, above the 4,096 threshold, so the
   detector finds SCCs with the device SCC (ops/scc.py
   scc_labels_torch).  The rings are held for 10 detector scans (the root
   still owns them, so nothing may stop), released, and every actor must
   be collected in 10,000 cycles; every device SCC call the detector makes
   must equal scc_labels_np on the same padded arrays.  Then the device
   SCC alone, on the largest input of the rings run and on a seeded
   random graph of 131,072 nodes (m = 3n, 80% active, -1 padding): equal
   to scc_labels_np, with rounds, sweeps, host reads and the median ms of
   5 calls.  The propagate launch counts are reset before the phase and
   printed after it: MAC never launches the propagate kernel.

8. The mesh (``[mesh]`` lines): the sharded trace of
   parallel/sharded_trace.py with 4 shards on the one card (an explicit
   device tuple with repeats).  (a) The dryrun_multichip step of
   __graft_entry__.py: a sharded fold, then the bool fixpoint
   make_sharded_trace, equal to trace_marks_np.  (b) Phase 4's 10M graph
   (kept, not regenerated) packed into 4 shard layouts, 1% of its pairs
   held back into the insert buckets, traced by make_sharded_cuda_trace
   in push and auto: the marks must equal phase 4's single-device marks
   and the garbage set expected_garbage, and the gated launches must be
   shards x sweeps; p50 of 5 beside the single-device p50 of phase 4.
   One shard's full-walk sweep is held against the plain version and
   timed beside its byte bound.  (c) The sharded decremental wake at 1M
   actors, 4 shards: 11 wakes of flag churn, bucket inserts and base-slot
   masks, each equal to trace_marks_np.  (d) Live: run_tree at 100,000
   actors on "mesh" (auto, every collector trace held against
   trace_marks_np) and pipelined "mesh-decremental", uigc.crgc.mesh-devices
   0 (every card: one shard here), held for 10 wakes, released, every
   actor collected, the gated kernel launched inside the collector, and
   one launch replayed against its plain version.

Then one JSON line with the kernel table (the full-walk times; launches
counted on phase 6, the live collector, with every phase's counts beside
them) and, last, {"ok": true, "device": {...}}.  Any failed check exits
non-zero before that line; there is no CPU path.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from uigc_tpu_torch.engines.crgc import arrays
from uigc_tpu_torch.engines.crgc import mesh as mesh_backend
from uigc_tpu_torch.models import run_rings, run_tree
from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import propagate as prop
from uigc_tpu_torch.ops import scc as scc_ops
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.ops.cuda_decremental import DecrementalTracer
from uigc_tpu_torch.ops.cuda_incremental import EDGE, IncrementalCudaLayout
from uigc_tpu_torch.parallel import sharded_trace as st
from uigc_tpu_torch.utils.platform import require_hopper

F = trace_ops
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the
#: tensor cores (the kernel's one operation per hit is an OR)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
N_MAIN = 10_000_000
#: the push sweep (1-based) whose inputs the sparse-sweep timing reads
SPARSE_SWEEP = 8
N_CHURN = 1_000_000
MODES = ("push", "pull", "jump", "auto")
#: phase 6: (label, workload, its arguments, backend, trace-mode,
#: pipelined, every trace checked against the oracle), run in this order.
#: The oracle's host time slows a run's collector, so the runs whose
#: times are compared (auto tree, decremental against pipelined) go
#: unchecked.
LIVE_RUNS = (
    ("tree100k/device/auto", run_tree, dict(n_actors=100_000, fanout=8),
     "device", "auto", False, False),
    ("tree100k/device/push", run_tree, dict(n_actors=100_000, fanout=8),
     "device", "push", False, True),
    ("tree100k/decremental", run_tree, dict(n_actors=100_000, fanout=8),
     "decremental", "auto", False, False),
    ("tree100k/decremental/pipelined", run_tree,
     dict(n_actors=100_000, fanout=8), "decremental", "auto", True, False),
    ("rings1000x100/decremental", run_rings,
     dict(n_rings=1000, ring_size=100), "decremental", "auto", False, True),
)
HOLD_WAKES = 10
LIVE_TIMEOUT_S = 240.0
#: phase 7: BASELINE config 2 (flat tree) and the rings of the cycle run
MAC_FLAT_ACTORS = 100_000
MAC_RINGS = dict(n_rings=10_000, ring_size=10)
#: the standalone device SCC's random graph: nodes (m = 3n), seed
SCC_RANDOM_N = 1 << 17
SCC_REPS = 5
#: phase 8: shards on the one card, the share of the 10M pairs held back
#: into the insert buckets, and the churn of each 1M sharded wake
MESH_SHARDS = 4
MESH_BUCKET_SHARE = 0.01
MESH_CHURN = dict(flags=1000, inserts=500, deletes=500)
MESH_LIVE_RUNS = (
    ("tree100k/mesh/auto", "mesh", False, True),
    ("tree100k/mesh-decremental/pipelined", "mesh-decremental", True, False),
)
KERNEL_SOURCE = "uigc_tpu_torch/csrc/propagate.cu"
REPLACES = "uigc_tpu/ops/pallas_trace.py:983"


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def say(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events
    around each, after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# --------------------------------------------------------------------- #
# 1-2. device and build
# --------------------------------------------------------------------- #


def phase_device():
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    cap = require_hopper()
    say(f"[device] {torch.cuda.get_device_name(0)} capability={cap} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    return card


def phase_build():
    t0 = time.perf_counter()
    prop.load_library()
    info = prop.build_info
    say(f"[build] {info['path']} nvcc_s={info['seconds']:.2f} "
        f"cached={info['cached']} load_s={time.perf_counter() - t0:.2f}")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling" in line:
            say(f"[build] {line.strip()}")


# --------------------------------------------------------------------- #
# 3. kernel vs plain
# --------------------------------------------------------------------- #


def form_of(gate):
    return "propagate_gated" if gate is not None else "propagate"


def operands(lay, table, dirty, gate):
    """propagate_words' operands for a device layout, a word table, a
    dirty mask over its walk groups and a global gate (or None); the word
    plane is made zeroed per call by ``words_call``."""
    d = torch.zeros(dirty.numel() + 1, dtype=torch.int32, device=table.device)
    d[1:] = torch.cumsum(dirty.to(torch.int32), 0)
    args = ct.device_args(lay)
    kw = dict(n_super=lay["n_super"], s_rows=lay["s_rows"], sub=lay["sub"],
              group=lay["group"], gate=gate,
              super_ids=args[4] if len(args) > 4 else None)
    return (d, args[0], args[1], table, args[2], args[3]), kw


def words_call(fn, args, kw):
    return fn(*args, torch.zeros_like(args[3]), **kw)


def compare(args, kw, errs, label):
    """Kernel against plain version, exact on int32 words.  The error
    recorded is the largest |kernel bit - plain bit| over all nodes:
    0 when the words are equal, 1 otherwise."""
    got = words_call(prop.propagate_words_cuda, args, kw)
    torch.cuda.synchronize()
    want = words_call(prop.propagate_words_torch, args, kw)
    err = float(bool((got != want).any()))
    form = form_of(kw["gate"])
    errs[form] = max(errs[form], err)
    check(torch.equal(got, want), f"{form} differs from its plain version "
          f"on {label}: {int((got != want).sum())} words differ")
    return got


def shuffle_blocks(lay, seed):
    """The same layout blocks in another order: rows and metadata move
    together, so every slot keeps its row class and its output tile."""
    gen = torch.Generator(device=lay["bmeta1"].device)
    gen.manual_seed(seed)
    perm = torch.randperm(lay["n_blocks"], device=lay["bmeta1"].device,
                          generator=gen)
    out = dict(lay)
    for k in ("bmeta1", "bmeta2"):
        out[k] = lay[k][perm].contiguous()
    for k in ("row_pos", "emeta"):
        out[k] = lay[k].reshape(lay["n_blocks"], -1)[perm].reshape(
            lay[k].shape).contiguous()
    return out


def random_layout_checks(dev, errs):
    rng = np.random.default_rng(0)
    n, n_src = 50_000, 1 << 21
    cases = 0
    for kind in ("dense", "compact"):
        psrc = rng.integers(0, n_src, 400_000)
        pdst = np.where(rng.random(psrc.size) < 0.05, 7,
                        rng.integers(0, n, psrc.size))
        if kind == "compact":
            keep = (pdst % 20_000) < 3_000
            psrc, pdst = psrc[keep], pdst[keep]
        prep = ct.prepare_pairs(psrc, pdst, n, n_src=n_src, sub=1, group=1,
                                compact_supers=kind == "compact",
                                pad_blocks_pow2=kind == "compact")
        if kind == "compact":
            check(prep["out_supers"] > np.unique(prep["super_ids"]).size,
                  "the compact layout has no pad tile")
        lay = ct.layout_to_device(prep, dev)
        shuffled = shuffle_blocks(lay, 3)
        n_chunks = prep["r_rows"] // ct.ROWS
        table = torch.randint(-(1 << 31), 1 << 31, (prep["r_rows"], ct.LANE),
                              dtype=torch.int64, device=dev).to(torch.int32)
        for dirty_kind in ("all", "partial"):
            dirty = (torch.ones(n_chunks, dtype=torch.bool, device=dev)
                     if dirty_kind == "all" else
                     torch.arange(n_chunks, device=dev) % 3 == 1)
            mixed = torch.randint(0, 3, (prep["n_super"],), device=dev,
                                  dtype=torch.int32)
            mixed[0] = ct.GATE_PUSH  # supertile 0 holds the hub
            for gate in (None, mixed):
                label = f"{kind}/{dirty_kind}/gate={gate is not None}"
                out = compare(*operands(lay, table, dirty, gate), errs, label)
                check(bool(out.any()), f"no hit at all on {label}")
                moved = compare(*operands(shuffled, table, dirty, gate), errs,
                                f"{label}/shuffled blocks")
                check(torch.equal(moved, out),
                      f"block order changed the words on {label}")
                cases += 2
    say(f"[kernel] random layouts: {cases} cases equal to the plain version "
        f"(half of them block-shuffled, equal to the unshuffled words)")


def sweep_work(lay, table, args, kw):
    """What one sweep must move, counted from this sweep's inputs: the
    new design's bytes (row_pos of the walked blocks only, emeta of the
    live walked slots, the table rows of the walked groups, both block
    metadata words of every block, the dirty prefix, the gate and the
    word plane), the earlier f32 kernel's formula (row_pos of every
    slot, the whole table and a 40 MB f32 plane in place of the words)
    and the slot hits."""
    d, bmeta1, bmeta2, _, row_pos, emeta = args
    gate = kw["gate"]
    sub, group = lay["sub"], lay["group"]
    n_blocks, r_rows = lay["n_blocks"], lay["r_rows"]
    block_slots = ct.ROWS * sub * ct.LANE
    group_rows = ct.ROWS * group
    m2 = bmeta2.long()
    span = m2 & ((1 << ct.SPAN_BITS) - 1)
    c_lo = m2 >> ct.SPAN_BITS
    dl = d.long()
    tile = bmeta1.long() >> 1
    if gate is None:
        g = torch.zeros_like(tile)
    else:
        g = gate.long()[tile]  # dense layouts: tile is the global supertile
    full = g == ct.GATE_FULL
    walk_blk = (span > 0) & (g != ct.GATE_SKIP) & (
        full | (dl[c_lo + span] != dl[c_lo]))
    rp = row_pos.reshape(n_blocks, block_slots).long()
    row_cls = (torch.arange(block_slots, device=rp.device) // ct.LANE) & 7
    live = (rp >= 0) & (rp < r_rows) & ((rp & 7) == row_cls)
    c = torch.where(live, rp // group_rows, 0)
    walked = (live & walk_blk[:, None] & (c >= c_lo[:, None])
              & (c < (c_lo + span)[:, None])
              & (full[:, None] | (dl[c + 1] != dl[c])))
    n_walked = int(walked.sum())
    groups = int((torch.bincount(c[walked], minlength=1) > 0).sum())
    n_walk_blocks = int(walk_blk.sum())
    del rp, live, c, walked
    meta = 4 * (bmeta1.numel() + bmeta2.numel()) + 4 * d.numel() + (
        4 * gate.numel() if gate is not None else 0)
    words_bytes = kw["n_super"] * kw["s_rows"] * (ct.LANE // ct.WORD_BITS) * 4
    new_bytes = (4 * n_walk_blocks * block_slots + 4 * n_walked
                 + 4 * ct.LANE * group_rows * groups + meta + words_bytes)
    f32_bytes = (4 * row_pos.numel() + 4 * n_walked + 4 * table.numel()
                 + meta + kw["n_super"] * kw["s_rows"] * ct.LANE * 4)
    # slot hits: one OR each (the f32 count contract sums them)
    hits = int(prop.propagate_torch(
        d, bmeta1, bmeta2, table, row_pos, emeta, out_tiles=kw["n_super"],
        s_rows=kw["s_rows"], sub=sub, group=group, gate=gate).sum())
    return dict(walk_blocks=n_walk_blocks, blocks=n_blocks,
                walked_slots=n_walked, groups=groups, hits=hits,
                bytes=new_bytes, f32_bytes=f32_bytes)


def time_sweep(lay, table, dirty, gate, label, plain_reps):
    """Kernel and plain times of one sweep (zeroed word plane included)
    with the bounds of its work."""
    args, kw = operands(lay, table, dirty, gate)
    ms = cuda_ms(lambda: words_call(prop.propagate_words_cuda, args, kw), 20)
    plain_ms = cuda_ms(lambda: words_call(prop.propagate_words_torch, args,
                                          kw), plain_reps)
    work = sweep_work(lay, table, args, kw)
    bytes_ms = work["bytes"] / HBM_BYTES_S * 1e3
    # one OR per hit, at the card's non-tensor f32/int32 issue rate
    ops_ms = work["hits"] / F32_OPS_S * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               f32_bound_ms=work["f32_bytes"] / HBM_BYTES_S * 1e3)
    say(f"[kernel] {form_of(gate)} {label}: walked_blocks="
        f"{work['walk_blocks']}/{work['blocks']} walked_slots="
        f"{work['walked_slots']} groups={work['groups']} hits={work['hits']} "
        f"bytes={work['bytes']} f32_formula_bytes={work['f32_bytes']} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={row['bound_ms']:.4f} "
        f"f32_formula_bound_ms={row['f32_bound_ms']:.4f} "
        f"share_of_bound={row['bound_ms'] / ms:.3f}")
    return row


def main_layout_timing(lay, table, dev, errs):
    """Both forms on the 10M layout: equality (all-dirty and mixed
    gates), then times and byte bounds for one full-walk sweep."""
    n_chunks = lay["r_rows"] // (ct.ROWS * lay["group"])
    all_dirty = torch.ones(n_chunks, dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    gmix = torch.randint(0, 3, (lay["n_super"],), dtype=torch.int32,
                         device=dev, generator=gen)
    part = torch.arange(n_chunks, device=dev) % 2 == 0
    for dirty, gate, label in ((all_dirty, None, "10M all dirty"),
                               (all_dirty, gmix, "10M all dirty, mixed gates"),
                               (part, gmix, "10M half dirty, mixed gates")):
        compare(*operands(lay, table, dirty, gate), errs, label)
    rows = {}
    for gate in (None, torch.zeros(lay["n_super"], dtype=torch.int32,
                                   device=dev)):
        row = time_sweep(lay, table, all_dirty, gate, "@10M full walk", 5)
        rows[form_of(gate)] = dict(name=form_of(gate), route="cuda",
                                   source=KERNEL_SOURCE, replaces=REPLACES,
                                   library_ms=None, **row)
    return rows


def push_sweep_inputs(graph, lay, dev, k):
    """The table and dirty mask that sweep ``k`` (1-based) of a push
    trace reads: the fixpoint of ops/cuda_trace.py's push mode, run
    through the same sweep for its first k - 1 sweeps."""
    n, r_rows = lay["n"], lay["r_rows"]
    group_rows = ct.ROWS * lay["group"]
    n_chunks = r_rows // group_rows
    flags = torch.from_numpy(graph["flags"]).to(dev)
    recv = torch.from_numpy(graph["recv_count"]).to(dev)
    in_use = F.flag_set(flags, F.FLAG_IN_USE)
    halted = F.flag_set(flags, F.FLAG_HALTED)
    iu_w = ct.pack_bools(in_use, n, r_rows)
    nh_w = ct.pack_bools(~halted, n, r_rows)
    mark_w = ct.pack_bools(in_use & ~halted & F.seeds_torch(flags, recv), n,
                           r_rows)
    table = mark_w & nh_w
    sweep = ct.build_sweep_contribs((ct.layout_spec(lay),), n, lay["n_super"],
                                    lay["s_rows"])
    d, _ = ct.dirty_group_lists(table, torch.zeros_like(table), n_chunks,
                                group_rows)
    for _ in range(k - 1):
        mark_w = mark_w | (sweep(table, d, ct.device_args(lay)) & iu_w)
        prev, table = table, mark_w & nh_w
        d, _ = ct.dirty_group_lists(table, prev, n_chunks, group_rows)
    return table, (d[1:] != d[:-1])


def sparse_sweep_timing(graph, lay, dev, push_dirty, errs):
    """Both forms on the inputs of a late push sweep at 10M: the case the
    block skip exists for.  The dirty count must equal what the push
    trace's stats recorded for that sweep."""
    k = min(SPARSE_SWEEP, len(push_dirty))
    table, dirty = push_sweep_inputs(graph, lay, dev, k)
    check(int(dirty.sum()) == push_dirty[k - 1],
          f"sweep {k} inputs: {int(dirty.sum())} dirty groups, the push "
          f"trace recorded {push_dirty[k - 1]}")
    say(f"[kernel] sparse sweep = push sweep {k} of {len(push_dirty)}: "
        f"{int(dirty.sum())} of {dirty.numel()} walk groups dirty")
    for gate in (None, torch.zeros(lay["n_super"], dtype=torch.int32,
                                   device=dev)):
        compare(*operands(lay, table, dirty, gate), errs,
                f"10M push sweep {k}")
        time_sweep(lay, table, dirty, gate, f"@10M push sweep {k}", 5)


# --------------------------------------------------------------------- #
# 4. main path at full size
# --------------------------------------------------------------------- #


def phase_main(graph, lay, jp_dev, dev, n_garbage):
    """The four trace modes at 10M; returns the push trace's dirty walk
    groups per sweep and the p50 ms of each mode."""
    flags = torch.from_numpy(graph["flags"]).to(dev)
    recv = torch.from_numpy(graph["recv_count"]).to(dev)
    expected = torch.from_numpy(graph["expected_garbage"]).to(dev)
    in_use = F.flag_set(flags, F.FLAG_IN_USE)
    p50s = {}
    for mode in MODES:
        fn = ct.get_trace_fn(lay, mode=mode, with_stats=True)
        args = [flags, recv] + ([jp_dev] if mode in ("jump", "auto") else [])
        args += ct.device_args(lay)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks, stats = fn(*args)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(in_use & ~marks, expected),
              f"{mode}: garbage set differs from expected_garbage")
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            marks, _ = fn(*args)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        p50 = p50s[mode] = float(np.median(reps))
        sweeps = int(stats["n_sweeps"])
        dirty = [int(x) for x in
                 stats["dirty_chunks"][:min(sweeps, ct.MAX_SWEEP_STATS)]]
        if mode == "push":
            push_dirty = dirty
        say(f"[main] mode={mode} n_sweeps={sweeps} "
            f"host_syncs={stats['host_syncs']} one_shot_ms={one_ms:.2f} "
            f"p50_ms={p50:.2f} reps_ms={[round(r, 2) for r in reps]} "
            f"garbage_actors_per_s={n_garbage / (p50 / 1e3):.4g} "
            f"dirty_groups_per_sweep={dirty}")
    return push_dirty, p50s


def phase_profile(graph, lay, jp_dev, dev):
    """One auto-mode trace under torch.profiler: device time by kernel
    and the device's busy share of the traced wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn = ct.get_trace_fn(lay, mode="auto")
    args = [torch.from_numpy(graph["flags"]).to(dev),
            torch.from_numpy(graph["recv_count"]).to(dev), jp_dev]
    args += ct.device_args(lay)
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    say(f"[profile] auto trace: wall_ms={wall_us / 1e3:.2f} "
        f"device_ms={busy_us / 1e3:.2f} "
        f"busy_share={busy_us / wall_us:.3f} kernels={len(kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


# --------------------------------------------------------------------- #
# 5. incremental + decremental under churn
# --------------------------------------------------------------------- #


def churn_graph(n, seed):
    """A power-law graph with its duplicate (src, dst) edges merged: the
    layouts key pairs by (src, dst, kind), as a shadow graph does."""
    g = powerlaw_actor_graph(n, seed=seed, garbage_fraction=0.5)
    keys = np.unique((g["edge_src"].astype(np.int64) << 32)
                     | g["edge_dst"].astype(np.int64))
    return (g["flags"].copy(), g["recv_count"].copy(), g["supervisor"],
            (keys >> 32).astype(np.int32),
            (keys & 0xFFFFFFFF).astype(np.int32), g["n_live"])


def phase_churn(dev):
    rng = np.random.default_rng(5)
    n = N_CHURN
    flags, recv, sup, esrc, edst, n_live = churn_graph(n, 1)
    ew = np.ones(esrc.size, np.int64)
    base_keys = (esrc.astype(np.int64) << 32) | edst.astype(np.int64)
    t0 = time.perf_counter()
    inc = IncrementalCudaLayout(n, device=dev)
    inc.rebuild(esrc, edst, ew, sup)
    dec = DecrementalTracer(n, device=dev)
    dec.rebuild(esrc, edst, ew, sup)
    dec.collect_stats = True
    say(f"[churn] n={n} pairs={inc.base['n_pairs']} "
        f"rebuild_s={time.perf_counter() - t0:.2f}")
    roots = np.nonzero(flags & F.FLAG_ROOT)[0]
    full_tiles = 0
    added = set()
    for wake in range(11):
        if wake:
            log = []
            alive = np.nonzero(ew > 0)[0]
            for i in rng.choice(alive, 2000, replace=False):
                ew[i] = 0
                log.append((False, int(esrc[i]), int(edst[i]), EDGE))
            # new refs stay inside a partition: a live actor cannot
            # obtain a ref to garbage, which nothing can reach
            new_s = rng.integers(0, n, 2000)
            new_d = np.where(new_s < n_live, rng.integers(0, n_live, 2000),
                             rng.integers(n_live, n, 2000))
            keys = (new_s << 32) | new_d
            fresh = ~np.isin(keys, base_keys)
            ins = []
            for k, s, d in zip(keys[fresh], new_s[fresh], new_d[fresh]):
                if int(k) not in added:
                    added.add(int(k))
                    ins.append((int(s), int(d)))
                    log.append((True, int(s), int(d), EDGE))
            esrc = np.concatenate([esrc, np.array([p[0] for p in ins], np.int32)])
            edst = np.concatenate([edst, np.array([p[1] for p in ins], np.int32)])
            ew = np.concatenate([ew, np.ones(len(ins), np.int64)])
            inc.apply_log(log)
            dec.apply_log(log)
            # crashes halt any actor; messages and busy flips reach only
            # live actors (nothing sends to garbage)
            flags[rng.integers(0, n, 200)] |= F.FLAG_HALTED
            if wake in (3, 7):  # release a root: its subtree may die
                flags[roots[wake]] &= ~F.FLAG_ROOT
            flags[rng.integers(0, n_live, 200)] ^= F.FLAG_BUSY
            recv[rng.integers(0, n_live, 200)] = 0
        flags_dev = torch.from_numpy(flags).to(dev)
        recv_dev = torch.from_numpy(recv).to(dev)
        expected = trace_ops.trace_marks_np(flags, recv, sup, esrc, edst, ew)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_inc = inc.trace_device(flags_dev, recv_dev)
        torch.cuda.synchronize()
        inc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mark_w = dec.wake_device(flags_dev, recv_dev)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3
        check(np.array_equal(m_inc.cpu().numpy(), expected),
              f"incremental marks differ from the oracle at wake {wake}")
        check(np.array_equal(dec.unpack_marks(mark_w), expected),
              f"decremental marks differ from the oracle at wake {wake}")
        st = dec.last_stats
        full_tiles += int(st["full_tiles"])
        say(f"[churn] wake={wake} log={len(log) if wake else 0} "
            f"live={int(expected.sum())} inc_ms={inc_ms:.2f} "
            f"dec_ms={dec_ms:.2f} dec_sweeps={st['n_sweeps']} "
            f"dec_syncs={st['host_syncs']} full_tiles={int(st['full_tiles'])}")
    check(full_tiles > 0, "the decremental repair never ran a FULL gate")
    check(inc.stats["anomalies"] == 0 and dec.layout.stats["anomalies"] == 0,
          "layout anomalies under churn")


# --------------------------------------------------------------------- #
# 6. the live collector
# --------------------------------------------------------------------- #


class LaunchCapture:
    """Wraps the kernel wrapper for a live run: every call goes through
    unchanged (so it counts its launch), and the operands of the first
    call at each new, larger word table are kept per form (clones), so
    the last kept is a launch at the run's final geometry."""

    def __init__(self):
        self.kept = {}
        self._wrapped = prop.propagate_words_cuda

    def __enter__(self):
        def capture(d, bmeta1, bmeta2, table, row_pos, emeta, out, **kw):
            form = form_of(kw["gate"])
            rows = table.shape[0]
            if rows > self.kept.get(form, (0,))[0]:
                clone = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                         for k, v in kw.items()}
                self.kept[form] = (rows, (d.clone(), bmeta1.clone(),
                                          bmeta2.clone(), table.clone(),
                                          row_pos.clone(), emeta.clone()),
                                   clone)
            return self._wrapped(d, bmeta1, bmeta2, table, row_pos, emeta,
                                 out, **kw)

        prop.propagate_words_cuda = capture
        return self

    def __exit__(self, *exc):
        prop.propagate_words_cuda = self._wrapped


class OracleCheck:
    """Holds every collector trace of a live run against the numpy
    oracle: wraps ``cls.compute_marks`` (ArrayShadowGraph's, which the
    ``device`` and synchronous ``decremental`` backends call once per
    traced wake on the collector's thread, or MeshShadowGraph's), and
    compares its marks with trace_marks_np on the same graph arrays.  A
    mismatch tells a wrong trace on the card from a wrong folded graph,
    which the keep-alive window cannot."""

    def __init__(self, cls=arrays.ArrayShadowGraph):
        self.traces = 0
        self.mismatches = 0
        self.first = None
        self._cls = cls
        self._plain = cls.compute_marks

    def __enter__(self):
        def checked(graph):
            mark = self._plain(graph)
            want = trace_ops.trace_marks_np(
                graph.flags, graph.recv_count, graph.supervisor,
                graph.edge_src, graph.edge_dst, graph.edge_weight)
            self.traces += 1
            if not np.array_equal(mark, want):
                self.mismatches += 1
                if self.first is None:
                    self.first = (f"trace {self.traces}: "
                                  f"{int((want & ~mark).sum())} slots missed, "
                                  f"{int((mark & ~want).sum())} extra")
            return mark

        self._cls.compute_marks = checked
        return self

    def __exit__(self, *exc):
        self._cls.compute_marks = self._plain


def live_kernel_checks(kept, errs, label):
    """Replay each kept launch: kernel against plain version, exact, and
    its time beside the byte bound of its work."""
    for form, (rows, args, kw) in sorted(kept.items()):
        compare(args, kw, errs, f"{label} live launch")
        lay = dict(sub=kw["sub"], group=kw["group"], n_blocks=args[1].numel(),
                   r_rows=rows, n_super=kw["n_super"], s_rows=kw["s_rows"])
        ms = cuda_ms(lambda: words_call(prop.propagate_words_cuda, args, kw),
                     20)
        plain_ms = cuda_ms(lambda: words_call(prop.propagate_words_torch,
                                              args, kw), 5)
        work = sweep_work(lay, args[3], args, kw)
        bound_ms = max(work["bytes"] / HBM_BYTES_S,
                       work["hits"] / F32_OPS_S) * 1e3
        say(f"[live] {label} {form} replayed launch: r_rows={rows} "
            f"blocks={work['blocks']} walked_blocks={work['walk_blocks']} "
            f"hits={work['hits']} equal=True ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f}")


def live_run(label, workload, args, config, errs, oracle=None):
    """One live run with the collector on the card: launch counts reset
    just before and read just after, every collector trace held against
    trace_marks_np when ``oracle`` (the shadow-graph class whose
    compute_marks to wrap) is given, the hold window and the collection
    checked, and each kept launch replayed.  Returns its launches."""
    prop.reset_launches()
    with LaunchCapture() as cap, (
            OracleCheck(oracle) if oracle else contextlib.nullcontext()) as oc:
        try:
            r = workload(config=config, timeout_s=LIVE_TIMEOUT_S,
                         hold_wakes=HOLD_WAKES, **args)
        except (AssertionError, RuntimeError) as exc:
            seen = (f" (oracle: {oc.mismatches} of {oc.traces} traces "
                    f"differ; first {oc.first})" if oracle else "")
            raise SmokeFailure(f"live {label}: {exc}{seen}") from exc
    launches = dict(prop.launches)
    n = r["n_collected"]
    if oracle:
        check(oc.traces > 0, f"live {label}: no trace was checked")
        check(oc.mismatches == 0,
              f"live {label}: {oc.mismatches} of {oc.traces} traces "
              f"differ from trace_marks_np; first {oc.first}")
        say(f"[live] {label} oracle: {oc.traces} traces equal to "
            f"trace_marks_np")
    check(r["held_wakes"] >= HOLD_WAKES,
          f"live {label}: held {r['held_wakes']} wakes")
    check(sum(launches.values()) > 0,
          f"live {label}: the kernel never launched in the collector")
    say(f"[live] {label} actors={n} build_s={r['build_s']:.3f} "
        f"collect_s={r['collect_s']:.3f} "
        f"collected_per_s={n / r['collect_s']:.1f} "
        f"held_wakes={r['held_wakes']} wakes={r['wakes']} "
        f"rebuilds={r['rebuilds']} capacity={r['capacity']} "
        f"launches={launches}")
    live_kernel_checks(cap.kept, errs, label)
    return launches


def phase_live(errs):
    """Phase 6: each of LIVE_RUNS through the port's actor runtime with
    the collector tracing on the card.  Returns the launches per form
    summed over the runs."""
    total = {"propagate": 0, "propagate_gated": 0}
    for label, workload, args, backend, mode, pipelined, oracle in LIVE_RUNS:
        config = {
            "uigc.crgc.shadow-graph": backend,
            "uigc.crgc.device": "cuda",
            "uigc.crgc.trace-mode": mode,
            "uigc.crgc.pipelined": pipelined,
            "uigc.crgc.wakeup-interval": 10,
        }
        launches = live_run(label, workload, args, config, errs,
                            arrays.ArrayShadowGraph if oracle else None)
        for form, count in launches.items():
            total[form] += count
    return total


# --------------------------------------------------------------------- #
# 7. MAC on the card
# --------------------------------------------------------------------- #


class SccCheck:
    """Holds every device SCC call of a live run against the Tarjan
    oracle: wraps scc_labels_torch, which the MAC detector calls on its
    own thread once per scan with at least the threshold's candidates,
    and compares its labels with scc_labels_np on the same padded arrays.
    Keeps each call's stats and the largest input (by active nodes)."""

    def __init__(self):
        self.calls = []
        self.mismatches = 0
        self.first = None
        self.largest = None
        self._plain = scc_ops.scc_labels_torch

    def __enter__(self):
        def checked(n, edge_src, edge_dst, active=None, device=None):
            labels, stats = self._plain(n, edge_src, edge_dst, active,
                                        device=device, with_stats=True)
            want = scc_ops.scc_labels_np(n, edge_src, edge_dst, active)
            live = int(np.count_nonzero(active))
            self.calls.append(dict(stats, n=n, m=int(edge_src.size),
                                   active=live))
            if not np.array_equal(labels, want):
                self.mismatches += 1
                if self.first is None:
                    self.first = (f"call {len(self.calls)} (n={n}): "
                                  f"{int((labels != want).sum())} labels "
                                  f"differ")
            if self.largest is None or live > self.largest[0]:
                self.largest = (live, (n, edge_src.copy(), edge_dst.copy(),
                                       active.copy()))
            return labels

        scc_ops.scc_labels_torch = checked
        return self

    def __exit__(self, *exc):
        scc_ops.scc_labels_torch = self._plain


def random_scc_input(n, seed):
    """tests/test_scc.py's generator at n nodes: m = 3n random edges over
    n nodes, 80% of them active, and a few -1 pad edges."""
    rng = np.random.default_rng(seed)
    m = 3 * n
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    active = rng.random(n) < 0.8
    pad = np.full(int(rng.integers(1, 5)), -1, np.int32)
    return n, np.concatenate([src, pad]), np.concatenate([dst, pad]), active


def scc_timing(label, inputs, dev):
    """The device SCC alone on ``inputs``: equal to scc_labels_np, then
    the median of SCC_REPS calls on the host clock (each call ends in its
    labels' copy to the host, after a synchronize)."""
    n, src, dst, active = inputs
    want = scc_ops.scc_labels_np(n, src, dst, active)
    got, stats = scc_ops.scc_labels_torch(n, src, dst, active, device=dev,
                                          with_stats=True)
    check(np.array_equal(got, want),
          f"device SCC on {label}: {int((got != want).sum())} labels differ "
          f"from scc_labels_np")
    reps = []
    for _ in range(SCC_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scc_ops.scc_labels_torch(n, src, dst, active, device=dev)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3)
    say(f"[mac] device SCC {label}: n={n} m={src.size} "
        f"active={int(np.count_nonzero(active))} sccs={np.unique(want[active]).size} "
        f"equal=True rounds={stats['rounds']} sweeps={stats['sweeps']} "
        f"host_reads={stats['host_reads']} "
        f"p50_ms={float(np.median(reps)):.3f} "
        f"reps_ms={[round(r, 3) for r in reps]}")


def mac_line(label, r, extra=""):
    n = r["n_collected"]
    say(f"[mac] {label} actors={n} build_s={r['build_s']:.3f} "
        f"collect_s={r['collect_s']:.3f} "
        f"collected_per_s={n / r['collect_s']:.1f} "
        f"held_wakes={r['held_wakes']}{extra}")


def phase_mac(dev):
    """Phase 7: BASELINE config 2 on the port's MAC engine, then MAC's
    cycle detector on rings with its device SCC, then the device SCC
    alone.  Returns the propagate launches counted over the phase."""
    prop.reset_launches()
    try:
        r = run_tree(n_actors=MAC_FLAT_ACTORS, fanout=1 << 30, engine="mac",
                     timeout_s=LIVE_TIMEOUT_S, hold_wakes=HOLD_WAKES)
    except (AssertionError, RuntimeError) as exc:
        raise SmokeFailure(f"mac flat tree: {exc}") from exc
    check(r["held_wakes"] >= HOLD_WAKES,
          f"mac flat tree: held {r['held_wakes']} wake intervals")
    mac_line(f"flat{MAC_FLAT_ACTORS // 1000}k", r,
             " scans=0 (no cycle detection) device_scc_calls=0")

    rings = MAC_RINGS["n_rings"]
    label = f"rings{rings}x{MAC_RINGS['ring_size']}/cycles"
    config = {"uigc.engine": "mac", "uigc.mac.cycle-detection": True,
              "uigc.mac.wakeup-interval": 10, "uigc.mac.device": "cuda"}
    with SccCheck() as sc:
        try:
            r = run_rings(config=config, timeout_s=LIVE_TIMEOUT_S,
                          hold_wakes=HOLD_WAKES, **MAC_RINGS)
        except (AssertionError, RuntimeError) as exc:
            raise SmokeFailure(
                f"mac {label}: {exc} (device SCC: {sc.mismatches} of "
                f"{len(sc.calls)} calls differ; first {sc.first})") from exc
    check(r["held_wakes"] >= HOLD_WAKES,
          f"mac {label}: held {r['held_wakes']} scans")
    check(r["total_cycles_collected"] == rings,
          f"mac {label}: {r['total_cycles_collected']} cycles collected, "
          f"not {rings}")
    check(sc.calls, f"mac {label}: the detector never ran the device SCC")
    check(sc.mismatches == 0,
          f"mac {label}: {sc.mismatches} of {len(sc.calls)} device SCC calls "
          f"differ from scc_labels_np; first {sc.first}")
    mac_line(label, r, f" scans={r['scans']} device_scc_calls={len(sc.calls)}"
             f" cycles_collected={r['total_cycles_collected']}")
    sweeps = [c["sweeps"] for c in sc.calls]
    say(f"[mac] {label} oracle: {len(sc.calls)} device SCC calls equal to "
        f"scc_labels_np; active per call {min(c['active'] for c in sc.calls)}"
        f"..{max(c['active'] for c in sc.calls)}, n_pad "
        f"{sorted({c['n'] for c in sc.calls})}, m_pad "
        f"{sorted({c['m'] for c in sc.calls})}, rounds "
        f"{sorted({c['rounds'] for c in sc.calls})}, sweeps "
        f"{min(sweeps)}..{max(sweeps)}, host reads "
        f"{sum(c['host_reads'] for c in sc.calls)}")

    scc_timing("largest rings input", sc.largest[1], dev)
    scc_timing(f"random n={SCC_RANDOM_N}", random_scc_input(SCC_RANDOM_N, 0),
               dev)
    launches = dict(prop.launches)
    say(f"[mac] propagate launches={launches}: MAC never launches the "
        f"propagate kernel")
    return launches


# --------------------------------------------------------------------- #
# 8. the mesh
# --------------------------------------------------------------------- #


def mesh_dryrun(dev):
    """8a: __graft_entry__.py's dryrun_multichip step on MESH_SHARDS
    shards of the card: a sharded fold, then the bool fixpoint."""
    d = MESH_SHARDS
    graph = powerlaw_actor_graph(16 * d, seed=1, garbage_fraction=0.5)
    packed = st.shard_graph(graph, d)
    mesh = st.Mesh([dev] * d)
    n_pad, ss = packed["n_pad"], packed["shard_size"]
    # one busy-flag set and one receive-count bump per shard, and a pad
    slots = np.zeros((d, 2), np.int32)
    slots[:, 0] = 1
    slots[:, 1] = ss
    recv_delta = np.zeros((d, 2), np.int64)
    recv_delta[:, 0] = 1
    flag_set = np.zeros((d, 2), np.uint8)
    flag_set[:, 0] = F.FLAG_BUSY
    flags, recv = st.make_sharded_fold(mesh)(
        packed["flags"], packed["recv_count"], slots, recv_delta, flag_set,
        np.zeros((d, 2), np.uint8))
    mark = st.to_host(st.make_sharded_trace(mesh)(
        flags, recv, packed["pair_src"], packed["pair_dst"]))
    check(mark.shape == (n_pad,) and mark.any(),
          "mesh dryrun: the sharded trace marked nothing")
    sup = np.full(n_pad, -1, np.int32)
    sup[: graph["supervisor"].size] = graph["supervisor"]
    want = F.trace_marks_np(st.to_host(flags), st.to_host(recv), sup,
                            graph["edge_src"], graph["edge_dst"],
                            graph["edge_weight"])
    check(np.array_equal(mark, want),
          "mesh dryrun: the sharded trace differs from trace_marks_np")
    say(f"[mesh] dryrun_multichip: {d} shards on {dev} n_pad={n_pad} "
        f"marked={int(mark.sum())} equal to trace_marks_np")


def padded_nodes(graph, n_pad):
    n = graph["flags"].size
    flags = np.zeros(n_pad, np.uint8)
    flags[:n] = graph["flags"]
    recv = np.zeros(n_pad, np.int64)
    recv[:n] = graph["recv_count"]
    return flags, recv


def mesh_geometry(n, d):
    """n_pad for n nodes on d shards of whole supertiles."""
    chunk = d * ct.S_ROWS * ct.LANE
    return -(-n // chunk) * chunk


def mesh_main(graph, single_marks, single_p50, dev, errs):
    """8b: phase 4's 10M graph on MESH_SHARDS shards of the card, with
    MESH_BUCKET_SHARE of its pairs in the insert buckets, in push and
    auto; then one shard's full walk against the plain version, timed
    beside its byte bound.  Returns the traces' launches."""
    d, n = MESH_SHARDS, N_MAIN
    n_pad = mesh_geometry(n, d)
    psrc, pdst, _ = IncrementalCudaLayout.pairs_from_graph(
        graph["edge_src"], graph["edge_dst"], graph["edge_weight"],
        graph["supervisor"])
    held = np.random.default_rng(0).random(psrc.size) < MESH_BUCKET_SHARE
    t0 = time.perf_counter()
    stacked, meta, _ = st.pack_shard_layouts(psrc[~held], pdst[~held], n_pad,
                                             d)
    pack_s = time.perf_counter() - t0
    ss = meta["shard_size"]
    b1, b2 = stacked["bmeta1"], stacked["bmeta2"]
    padding = ((b2 == 0) & ((b1 & 1) == 0)).sum(axis=1)  # inert pad blocks
    hs, hd = psrc[held], pdst[held]
    counts = np.bincount(hd // ss, minlength=d)
    m = int(counts.max())
    bsrc = np.full((d, m), n_pad, np.int32)
    bdst = np.zeros((d, m), np.int32)
    for i in range(d):
        sel = hd // ss == i
        bsrc[i, : counts[i]] = hs[sel]
        bdst[i, : counts[i]] = hd[sel] - i * ss
    say(f"[mesh] 10M on {d} shards: n_pad={n_pad} shard={ss} "
        f"pairs={psrc.size} in_buckets={int(held.sum())} bucket_m={m} "
        f"blocks_per_shard={meta['n_blocks']} padding_blocks="
        f"{padding.tolist()} padding_share="
        f"{padding.sum() / (d * meta['n_blocks']):.4f} "
        f"host_pack_s={pack_s:.2f}")

    mesh = st.Mesh([dev] * d)
    flags, recv = padded_nodes(graph, n_pad)
    operands_ = ([st.put_nodes(mesh, flags), st.put_nodes(mesh, recv)]
                 + [st.put_stacked(mesh, stacked[k])
                    for k in ("bmeta1", "bmeta2", "row_pos", "emeta")]
                 + [st.put_stacked(mesh, bsrc), st.put_stacked(mesh, bdst)])
    jp = st.put_replicated(mesh, ct.jump_parents(psrc, pdst, n_pad))
    in_use = (graph["flags"] & F.FLAG_IN_USE) != 0
    launches = {"propagate": 0, "propagate_gated": 0}
    for mode in ("push", "auto"):
        fn = st.make_sharded_cuda_trace(
            mesh, n_pad, ss, meta["n_blocks"], meta["r_rows"], ct.S_ROWS, m,
            mode=mode, with_stats=True)
        args = operands_ + ([jp] if mode == "auto" else [])
        prop.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks, stats = fn(*args)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        got = dict(prop.launches)
        for form in launches:
            launches[form] += got[form]
        check(got["propagate_gated"] == d * stats["n_sweeps"]
              and got["propagate"] == 0,
              f"mesh {mode}: launches {got}, not {d} shards x "
              f"{stats['n_sweeps']} sweeps of the gated form")
        mark = st.to_host(marks)[:n]
        check(np.array_equal(mark, single_marks),
              f"mesh {mode}: {int((mark != single_marks).sum())} marks "
              f"differ from the single-device trace")
        check(np.array_equal(in_use & ~mark, graph["expected_garbage"]),
              f"mesh {mode}: garbage set differs from expected_garbage")
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.median(reps))
        say(f"[mesh] mode={mode} shards={d} n_sweeps={stats['n_sweeps']} "
            f"host_syncs={stats['host_syncs']} "
            f"launches_per_shard={stats['launches_per_shard']} "
            f"one_shot_ms={one_ms:.2f} p50_ms={p50:.2f} "
            f"single_device_p50_ms={single_p50[mode]:.2f} "
            f"reps_ms={[round(r, 2) for r in reps]} "
            f"dirty_groups_per_sweep={stats['dirty_chunks']} equal to the "
            f"single-device marks and expected_garbage")

    # one shard's full walk on its real operands: the global table of the
    # fixpoint's active words, every walk group dirty, a zero gate
    halted = np.zeros(n_pad, bool)
    halted[:n] = (graph["flags"] & F.FLAG_HALTED) != 0
    active = np.zeros(n_pad, bool)
    active[:n] = single_marks
    table = ct.pack_bools(torch.from_numpy(active & ~halted).to(dev), n_pad,
                          meta["r_rows"])
    lay = dict(zip(("bmeta1", "bmeta2", "row_pos", "emeta"),
                   (t[0] for t in operands_[2:6])),
               n_super=ss // (ct.S_ROWS * ct.LANE), s_rows=ct.S_ROWS,
               sub=meta["sub"], group=meta["group"],
               n_blocks=meta["n_blocks"], r_rows=meta["r_rows"])
    all_dirty = torch.ones(meta["r_rows"] // (ct.ROWS * meta["group"]),
                           dtype=torch.bool, device=dev)
    gate = torch.zeros(lay["n_super"], dtype=torch.int32, device=dev)
    compare(*operands(lay, table, all_dirty, gate), errs,
            "mesh shard 0 full walk")
    time_sweep(lay, table, all_dirty, gate,
               f"mesh shard 0 of {d} @10M full walk", 5)
    return launches


def mesh_churn(dev):
    """8c: the sharded decremental wake at 1M actors on MESH_SHARDS
    shards, auto mode: 11 wakes of flag churn, bucket inserts and
    base-slot masks (tests/test_sharded_trace.py's schedule, scaled; as
    in phase 5, new refs stay inside a partition and busy flips and
    messages reach only live actors, so the garbage stays garbage), each
    equal to trace_marks_np.  Returns the wakes' launches."""
    rng = np.random.default_rng(8)
    d, n = MESH_SHARDS, N_CHURN
    g = powerlaw_actor_graph(n, seed=1, garbage_fraction=0.5)
    n_live = g["n_live"]
    n_pad = mesh_geometry(n, d)
    flags, recv = padded_nodes(g, n_pad)
    psrc, pdst, _ = IncrementalCudaLayout.pairs_from_graph(
        g["edge_src"], g["edge_dst"], g["edge_weight"], g["supervisor"])
    stacked, meta, slot_vals = st.pack_shard_layouts(psrc, pdst, n_pad, d)
    ss = meta["shard_size"]
    m = 4096  # bucket columns per shard: room for every wake's inserts
    bsrc = np.full((d, m), n_pad, np.int32)
    bdst = np.zeros((d, m), np.int32)
    bcount = np.zeros(d, np.int64)
    base_live = np.ones(psrc.size, bool)
    inserted = set()
    jp = ct.jump_parents(psrc, pdst, n_pad)
    mesh = st.Mesh([dev] * d)
    row_pos = st.put_stacked(mesh, stacked["row_pos"])
    emeta = st.put_stacked(mesh, stacked["emeta"])
    mask = st.make_sharded_mask(mesh)
    wake = st.make_sharded_decremental_wake(
        mesh, n_pad, ss, meta["n_blocks"], meta["r_rows"], ct.S_ROWS, m,
        mode="auto")
    n_words = n_pad // 32
    state = [np.zeros(n_words, np.int32)] * 5

    def words_of(ids):
        w = np.zeros(n_words, np.uint32)
        ids = np.unique(np.asarray(ids, np.int64))
        np.bitwise_or.at(w, ids >> 5,
                         np.uint32(1) << (ids & 31).astype(np.uint32))
        return w.view(np.int32)

    launches = {"propagate": 0, "propagate_gated": 0}
    for wk in range(11):
        del_ids, fresh_ids = [], []
        if wk:
            k = MESH_CHURN["flags"]
            idx = rng.choice(n, k, replace=False)
            live_idx = rng.choice(n_live, k, replace=False)
            r = rng.random(k)
            flags[idx[r < 0.3]] |= F.FLAG_HALTED
            flags[live_idx[(r >= 0.3) & (r < 0.5)]] ^= F.FLAG_BUSY
            sel = live_idx[(r >= 0.5) & (r < 0.7)]
            recv[sel] = np.where(recv[sel] != 0, 0, 2)
            flags[idx[(r >= 0.7) & (r < 0.85)]] = 0  # freed
            flags[idx[r >= 0.85]] = F.FLAG_IN_USE | F.FLAG_INTERNED
            new_s = rng.integers(0, n, MESH_CHURN["inserts"])
            new_d = np.where(new_s < n_live,
                             rng.integers(0, n_live, new_s.size),
                             rng.integers(n_live, n, new_s.size))
            for s_, d_ in zip(new_s.tolist(), new_d.tolist()):
                sh = int(d_) // ss
                if bcount[sh] >= m or (s_, d_) in inserted:
                    continue
                bsrc[sh, bcount[sh]] = s_
                bdst[sh, bcount[sh]] = d_ - sh * ss
                bcount[sh] += 1
                inserted.add((s_, d_))
                fresh_ids.append(d_)
                jp[d_] = min(jp[d_], s_)  # min-fold, as the mesh backend
            j = rng.choice(np.nonzero(base_live)[0], MESH_CHURN["deletes"],
                           replace=False)
            base_live[j] = False
            hit = jp[pdst[j]] == psrc[j]  # invalidate, as the mesh backend
            jp[pdst[j][hit]] = n_pad
            sv = slot_vals[j]
            per = [sv[(sv >> 40) == i] for i in range(d)]
            mask(row_pos, emeta, [(p >> 8) & 0xFFFFFFFF for p in per],
                 [p & 0xFF for p in per])
            del_ids = pdst[j]
        ins = np.array(sorted(inserted), np.int64).reshape(-1, 2)
        want = F.trace_marks_np(
            flags[:n], recv[:n], np.full(n, -1, np.int32),
            np.concatenate([psrc[base_live], ins[:, 0]]),
            np.concatenate([pdst[base_live], ins[:, 1]]),
            np.ones(int(base_live.sum()) + ins.shape[0], np.int64))
        prop.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wake(flags, recv, words_of(del_ids), words_of(fresh_ids),
                   *state, stacked["bmeta1"], stacked["bmeta2"], row_pos,
                   emeta, bsrc, bdst, jp)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for form in launches:
            launches[form] += prop.launches[form]
        state = out[1:]
        got = st.to_host(out[0])[:n]
        check(np.array_equal(got, want),
              f"mesh wake {wk}: {int((got != want).sum())} marks differ "
              f"from trace_marks_np")
        say(f"[mesh] churn wake={wk} n={n} shards={d} live={int(want.sum())} "
            f"wake_ms={ms:.2f} gated_launches={prop.launches['propagate_gated']} "
            f"equal to trace_marks_np")
    return launches


def mesh_live(errs):
    """8d: run_tree at 100k actors on the mesh backends, every card of
    the machine (uigc.crgc.mesh-devices 0).  Returns the launches."""
    total = {"propagate": 0, "propagate_gated": 0}
    for label, backend, pipelined, oracle in MESH_LIVE_RUNS:
        config = {
            "uigc.crgc.shadow-graph": backend,
            "uigc.crgc.device": "cuda",
            "uigc.crgc.mesh-devices": 0,
            "uigc.crgc.trace-mode": "auto",
            "uigc.crgc.pipelined": pipelined,
            "uigc.crgc.wakeup-interval": 10,
        }
        launches = live_run(label, run_tree, dict(n_actors=100_000, fanout=8),
                            config, errs,
                            mesh_backend.MeshShadowGraph if oracle else None)
        check(launches["propagate_gated"] > 0,
              f"live {label}: the gated kernel never launched in the "
              f"collector")
        for form, count in launches.items():
            total[form] += count
    return total


def phase_mesh(graph, single_marks, single_p50, dev, errs):
    """Phase 8.  Returns the launches per form over its main-path runs
    (8b-8d, each counted from 0)."""
    mesh_dryrun(dev)
    launches = mesh_main(graph, single_marks, single_p50, dev, errs)
    for part in (mesh_churn(dev), mesh_live(errs)):
        for form, count in part.items():
            launches[form] += count
    say(f"[mesh] launches={launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def elapsed(phase):
        say(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")

    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    errs = {"propagate": 0.0, "propagate_gated": 0.0}
    random_layout_checks(dev, errs)

    t0 = time.perf_counter()
    graph = powerlaw_actor_graph(N_MAIN, seed=0, garbage_fraction=0.5)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = ct.prepare_chunks(graph["edge_src"], graph["edge_dst"],
                             graph["edge_weight"], graph["supervisor"], N_MAIN)
    pack_s = time.perf_counter() - t0
    jp = ct.jump_parents_from_graph(graph["edge_src"], graph["edge_dst"],
                                    graph["edge_weight"], graph["supervisor"],
                                    N_MAIN)
    lay = ct.layout_to_device(prep, dev)
    jp_dev = torch.from_numpy(jp).to(dev)
    n_garbage = int(graph["expected_garbage"].sum())
    say(f"[main] n={N_MAIN} pairs={prep['n_pairs']} blocks={prep['n_blocks']} "
        f"rows={prep['row_pos'].shape[0]} r_rows={prep['r_rows']} "
        f"n_super={prep['n_super']} gen_s={gen_s:.2f} host_pack_s={pack_s:.2f}")

    # a real table: the fixpoint's active words (marks & ~halted)
    marks = ct.trace_marks_layouts(graph["flags"], graph["recv_count"], [lay],
                                   device=dev)
    active = torch.from_numpy(marks).to(dev) & ~F.flag_set(
        torch.from_numpy(graph["flags"]).to(dev), F.FLAG_HALTED)
    table = ct.pack_bools(active, N_MAIN, lay["r_rows"])
    kernels = main_layout_timing(lay, table, dev, errs)

    prop.reset_launches()
    push_dirty, p50s = phase_main(graph, lay, jp_dev, dev, n_garbage)
    main_launches = dict(prop.launches)
    say(f"[main] launches={main_launches}")
    check(all(v > 0 for v in main_launches.values()),
          f"a kernel form was never launched on the main path: {main_launches}")
    sparse_sweep_timing(graph, lay, dev, push_dirty, errs)
    phase_profile(graph, lay, jp_dev, dev)
    elapsed("phases 1-4")
    del lay, prep, table, jp_dev  # the graph and marks stay for phase 8
    torch.cuda.empty_cache()

    prop.reset_launches()
    phase_churn(dev)
    churn_launches = dict(prop.launches)
    say(f"[churn] launches={churn_launches}")
    check(churn_launches["propagate_gated"] > 0,
          "the gated kernel never launched under churn")
    elapsed("phase 5")
    torch.cuda.empty_cache()

    live_launches = phase_live(errs)
    say(f"[live] launches={live_launches}")
    check(all(v > 0 for v in live_launches.values()),
          f"a kernel form never launched in the live collector: "
          f"{live_launches}")
    elapsed("phase 6")

    torch.cuda.empty_cache()
    mac_launches = phase_mac(dev)
    elapsed("phase 7")

    torch.cuda.empty_cache()
    mesh_launches = phase_mesh(graph, marks, p50s, dev, errs)
    check(mesh_launches["propagate_gated"] > 0,
          f"the gated kernel never launched on the mesh: {mesh_launches}")
    elapsed("phase 8")

    for form, row in kernels.items():
        row["launches"] = live_launches[form]
        row["launches_by_phase"] = {"trace_10M": main_launches[form],
                                    "churn_1M": churn_launches[form],
                                    "live": live_launches[form],
                                    "mac": mac_launches[form],
                                    "mesh": mesh_launches[form]}
        row["max_abs_err"] = errs[form]
    order = ("name", "route", "source", "replaces", "launches",
             "launches_by_phase", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")
    say(card)  # the numbers above ran on this card, at this power limit
    say(json.dumps({"kernels": [{k: kernels[f][k] for k in order}
                                for f in ("propagate", "propagate_gated")]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
