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
   (one thread per slot).  The jump step's kernel and the raw pair
   tier's kernel (propagate_pairs_kernel: PAIRS_CAPACITY pairs of phase
   4's graph on its 10M table) likewise, against their plain twins.
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

9. Telemetry and the sanitizer (``[telemetry]`` lines).  (a) Phase 6's
   100,000-actor tree on "device" (auto) with uigc.telemetry.wake-profile,
   metrics, device and inspect on (leak watchdog off, no parent capture,
   so the inspector adds nothing per wake): per-phase wake totals
   (ingest, fold, trace, sweep, broadcast), the device share and the
   memory ledger per family.  The hold window and the collection as in
   phase 6; the kernel launched in the collector; the profiler's device
   seconds above 0 and within the trace phase's wall time; the ledger's
   device families above 0 bytes and within
   torch.cuda.max_memory_allocated(); the Prometheus exposition parses.
   (b) In the same run, while it is held: why_live for a leaf actor must
   come out "derived" through marking_parents_torch on the card, its
   chain equal to the one trace_marks_np_parents gives on the same host
   arrays.  (c) With uigc.analysis.sanitizer on: a 10,000-actor tree on
   pipelined "decremental" and 1,000 MAC rings of 10 with cycle
   detection on the card: no violation, verdicts checked (CRGC) or tap
   facts checked (MAC, which has no oracle), every actor collected.

10. Multi-node (``[cluster]`` lines): three actor systems on one
   in-process Fabric in wire mode (serialized messages, async links),
   every collector on cuda:0.  (a) BASELINE config 4, run_cluster_recovery
   at CLUSTER_WORKERS workers on node B pinned only by refs held on node
   C, C's pings to B dropped, on "device" (auto): no worker may stop
   before C crashes, every worker must be collected after it, A's and
   B's roots must still run, every collector trace must equal
   trace_marks_np (OracleCheck, under a lock), and the kernel must launch
   in A's and in B's collector (NodeLaunches counts per node).  (b) The
   same on pipelined "decremental", whose harvested wakes HarvestCheck
   holds against the oracle.  (c) The partitioned collector
   (uigc.crgc.distributed) in the harness of tests/test_distributed.py
   with the sanitizer on: DIST_RINGS three-node rings dropped, DIST_KEPT
   kept; nothing may stop before the drop, every dropped ring member
   must be collected and no kept one, cross_check_distributed must be
   clean, every fold must stay in its node's slice, the wave, mark and
   round events must show, and the kernel must not launch (the
   partitioned fixpoint runs on the pointer plane).

11. Multi-process (``[procs]`` lines): BASELINE config 4 across three OS
   processes, one actor system on a NodeFabric (runtime/node.py, TCP on
   localhost) each.  Node A is this process; B and C are children
   (``chip_smoke.py --node-child <spec>``), each opening its own CUDA
   context on the same card, checking it is a Hopper card, loading the
   kernel library phase 2 built, and counting its own launches and
   oracle checks, which it reports on a ``STATS {json}`` line.  B owns
   PROC_WORKERS workers, each pinned only by a ref C holds; B drops C's
   pings.  Every collector traces a full replica on the card.  (a)
   ``device`` auto, C killed (SIGKILL: the survivors see EOF).  (b)
   pipelined ``decremental`` with the heartbeat on and the shm rings
   negotiated, C stopped (SIGSTOP: no EOF, only the phi-accrual verdict
   can remove it), then killed.  Each run: no worker stops in
   PROC_HOLD_WAKES of B's collector wakes before C's death, every worker
   stops after it, A's and B's roots run, the kernel launched in A and
   in B, and every collector trace in A and in B equals trace_marks_np
   in that process; in (b) A and B each took C down by the heartbeat and
   the A-B link ran on the shm ring.  Phase 1 prints the card's compute
   mode, which must be Default for the children to open contexts.

12. Cluster sharding (``[sharding]`` lines): three NodeFabrics, A, B
   and C, in this process over localhost TCP, each with a
   ClusterSharding (32 shards) and its collector on cuda:0, one journal
   directory under $TMPDIR shared by the three.  SHARD_KEYS keyed
   entities of one type: each incarnation spawns a held child when it is
   activated and keeps it in its snapshot; each of SHARD_WORK "work"
   commands per key adds one to the count and spawns a transient child,
   tells it one job and releases it; "drop" releases the held child;
   "probe" answers the count.  The commands go from A and B in turn.
   (a) ``device`` auto: only A and B are up while the traffic starts, C
   connects after SHARD_JOIN_ROUND rounds, and a third of the keyspace
   migrates live under the traffic.  (b) pipelined ``decremental``, the
   heartbeat on: after the traffic C dies silently (its links cut by the
   fault plan, its engine crashed), its shards move to A and B and its
   entities are recovered there from the journal.  Each run: every key
   answers its full count (in (b) at least what it answered just before
   the death), the tables settle with no migration pending, then a hold
   of SHARD_HOLD_WAKES collector wakes on every surviving node in which
   no held child of a live incarnation stops and every transient child
   on a survivor is collected; then every key gets "drop" and every held
   child must be collected.  No incarnation may restore a ref to a child
   (``cluster/sharding.py`` ``captured_state``); the kernel must launch
   in every surviving node's collector and every trace of every node
   must equal trace_marks_np (OracleCheck/HarvestCheck, counted per
   node).  Each run prints activate_s, rebalance_s (from C's connect,
   or from its death, to a settled table), collect_s after "drop", the
   migrations and their latency (shard.migration events), and the
   wakes, launches and oracle-checked traces per node.

13. The ingress gateway (``[gateway]`` lines): real TCP clients talk to
   a proxy-only gateway NodeFabric (gateway/gateway.py IngressGateway)
   in front of data NodeFabrics, all in this process, every collector on
   cuda:0.  GATEWAY_KEYS keyed entities of phase 12's shape (a held
   child per incarnation, a transient child per "work" command) answer
   the gateway's ``("gw-cmd", ref, seq, cmd)`` with ``ref.tell(("ack",
   seq, count))``, so the collectors have garbage to find while the
   clients see only the gateway.  The configuration is
   tools/ingress_bench.py's base_config with phase 12's heartbeat.  (a)
   ``device`` auto, two data nodes: GATEWAY_CONNECTIONS concurrent
   connections, each CONNECT -> AUTH_OK, held at once (the gateway's
   count and its uigc_gateway_connections gauge read them all); a fill
   of GATEWAY_FILL "work" commands a key from GATEWAY_FILL_TENANTS
   tenants under their quota; then the storm: GATEWAY_STORM_CLIENTS
   clients of one tenant drive 10x its GATEWAY_CAPACITY msgs/s quota for
   GATEWAY_STORM_S over the keyspace, and every send must resolve to an
   ACK or a clean, seq-addressed ERROR.  (b) pipelined ``decremental``,
   three data nodes and a shared journal, no quota: a FLOOD client fault
   burns on the first accept, GATEWAY_PUMP_CLIENTS clients pump over the
   keyspace, one data node dies silently after GATEWAY_DIE_AFTER_S (and
   once its collector has launched the kernel), and
   every send resolves after bounded retries; the dead node's entities
   are recovered from the journal.  Each run: every key probed through
   the gateway covers its highest ACK (acked_then_lost 0), then a hold
   of SHARD_HOLD_WAKES wakes on every surviving data node in which no
   held child stops and every transient child is collected, then "drop"
   to every key and every held child collected; the kernel launched in
   every data node's collector and every trace of every node equal to
   trace_marks_np.  Each run prints connect/s, the admitted p50/p99 ms,
   the gateway's stats and its uigc_gateway_connections gauge; (b), with
   telemetry metrics on the gateway node, also uigc_gateway_shed_total,
   which must equal the gateway's sheds.

14. The static checker and the operator tools (``[tools]`` lines),
   everything through the tools' own entry points.  (a) In subprocesses
   (this machine has no JAX), started after (b) and run beside (c),
   ``python -m uigc_tpu_torch.tools.uigc_check --strict --json
   uigc_tpu_torch/`` and ``uigc_lint --strict``: exit 0, all four passes
   run (no SKIP), the findings per pass printed.  (b) ``uigc_tpu_torch/tools/sweep_profile.py``'s ``profile`` on phase 4's 10M
   graph and layout (the host layout kept, moved to the card again), both
   kernel forms: full-, half- and no-dirty sweeps beside phase 4's
   full-walk time from this run, the word packs, and per trace mode the
   sweeps, the fixpoint's wall, its kernel time (CUDA events around every
   launch) and the glue around it; the marks of every mode must equal
   phase 4's and the launch counters must move by exactly the calls the
   profile reports (its probes and two runs of each mode's sweeps).  (c)
   Phase 6's tree at 50,000 actors on ``device`` auto with the wake
   profiler, metrics, device observatory, inspector, time series, a
   JSONL sink and an HTTP port on; while it is held: ``device_report
   --url`` (every device-active wake's launches, logged around each
   collector trace, a positive multiple of its sweeps; the per-sweep
   attribution within 10% of its device time), ``graph_inspect --url``
   (snapshot, why-live of a leaf, why-live paths validated, the
   snapshot's live set equal to trace_marks_np's on the shadow graph
   over the snapshot's actors: the held graph only gains actors),
   ``telemetry_dump --from-jsonl`` (with the event stream paused, every
   replayed counter equal to a live ``/metrics.json`` scrape) and
   ``uigc_top --url --once --plain`` (the device panel with no dash).

Then one JSON line with the kernel table (the full-walk times; launches
counted on phase 6, the live collector, with every phase's counts beside
them) and, last, {"ok": true, "device": {...}}.  Any failed check exits
non-zero before that line; there is no CPU path.
"""

import contextlib
import io
import json
import os
import re
import resource
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from collections import Counter

import numpy as np
import torch

from uigc_tpu_torch import AbstractBehavior, Behaviors, Message, NoRefs, PostStop
from uigc_tpu_torch.analysis.sanitizer import cross_check_distributed
from uigc_tpu_torch.cluster import ClusterSharding, Entity
from uigc_tpu_torch.engines.crgc import arrays
from uigc_tpu_torch.engines.crgc import mesh as mesh_backend
from uigc_tpu_torch.engines.crgc.collector import Bookkeeper
from uigc_tpu_torch.gateway import IngressGateway
from uigc_tpu_torch.gateway import protocol as gw_protocol
from uigc_tpu_torch.models import nodeproc, run_cluster_recovery, run_rings, run_tree
from uigc_tpu_torch.models.graphgen import powerlaw_actor_graph
from uigc_tpu_torch.ops import cuda_trace as ct
from uigc_tpu_torch.ops import propagate as prop
from uigc_tpu_torch.ops import scc as scc_ops
from uigc_tpu_torch.ops import trace as trace_ops
from uigc_tpu_torch.ops.cuda_decremental import DecrementalTracer
from uigc_tpu_torch.ops.cuda_incremental import EDGE, IncrementalCudaLayout
from uigc_tpu_torch.parallel import sharded_trace as st
from uigc_tpu_torch.runtime.behaviors import RawBehavior
from uigc_tpu_torch.runtime.fabric import Fabric
from uigc_tpu_torch.runtime.faults import FLOOD, FaultPlan
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.runtime.remote import RemoteSpawner
from uigc_tpu_torch.runtime.system import ActorSystem
from uigc_tpu_torch.telemetry import inspect as tel_inspect
from uigc_tpu_torch.tools import (device_report, graph_inspect, sweep_profile,
                                  telemetry_dump, uigc_top)
from uigc_tpu_torch.telemetry import (DeviceObservatory, EventMetricsBridge,
                                      MetricsRegistry, WakeProfiler,
                                      install_system_gauges, prometheus_text,
                                      validate_device_doc)
from uigc_tpu_torch.utils import events
from uigc_tpu_torch.utils.platform import require_hopper

F = trace_ops
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the
#: tensor cores (the kernel's one operation per hit is an OR)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
N_MAIN = 10_000_000
#: the push sweep (1-based) whose inputs the sparse-sweep timing reads
SPARSE_SWEEP = 8
#: sweeps of the jump kernel's 10M check and timing: an auto trace's
#: sweeps on the power-law graph (phase 4 prints them)
JUMP_SWEEPS = 7
N_CHURN = 1_000_000
MODES = ("push", "pull", "jump", "auto")
#: the kernel forms a full trace launches (the jump in jump and auto)
TRACE_FORMS = ("propagate", "propagate_gated", "jump")
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
#: phase 9: the profiled tree (phase 6's), the sanitized runs (cut so the
#: sanitizer's Python oracle keeps up)
TELEMETRY_TREE = dict(n_actors=100_000, fanout=8)
SANITIZED_TREE = dict(n_actors=10_000, fanout=8)
SANITIZED_RINGS = dict(n_rings=1_000, ring_size=10)
#: phase 10: BASELINE config 4 at CLUSTER_WORKERS workers on node B
#: (50x bench.py's 200), run on each backend of CLUSTER_RUNS (label,
#: backend, pipelined); then the partitioned collector over DIST_RINGS
#: dropped three-node rings and DIST_KEPT kept.  Cut from 30,000
#: workers, where the device run alone took 59 s (build and collect).
CLUSTER_WORKERS = 10_000
CLUSTER_RUNS = (
    ("config4/device/auto", "device", False),
    ("config4/decremental/pipelined", "decremental", True),
)
CLUSTER_TIMEOUT_S = 240.0
DIST_RINGS = 1_000
DIST_KEPT = 100
#: phase 11: config 4 across three processes at PROC_WORKERS workers on
#: node B, per run of PROC_RUNS (label, backend, pipelined, how C dies:
#: "kill" = SIGKILL, "stop" = SIGSTOP with the heartbeat and shm rings
#: on, PROC_SILENT).  B's collector must wake PROC_HOLD_WAKES times
#: before C's death with no worker stopped.
PROC_WORKERS = 10_000
PROC_RUNS = (
    ("config4/device/auto/kill", "device", False, "kill"),
    ("config4/decremental/pipelined/stop", "decremental", True, "stop"),
)
PROC_SILENT = {
    "uigc.node.heartbeat-interval": 100,
    "uigc.node.heartbeat-pause": 3000,
    "uigc.node.shm-transport": True,
}
PROC_HOLD_WAKES = 10
#: phase 12: SHARD_KEYS keyed entities of one type, SHARD_WORK "work"
#: commands each (one transient child per command, one held child per
#: incarnation), sent from A and B in turn; run per SHARD_RUNS (label,
#: backend, pipelined, what happens to C: "join" = C connects after
#: SHARD_JOIN_ROUND rounds, "die" = C is up from the start and dies
#: silently after the traffic, its entities recovered from the journal).
#: Cut from 3,000 keys, whose two runs took 104 s in a rehearsal on a
#: CPU (``phase_sharding(errs, device="cpu")``), above the phase's 90 s.
SHARD_KEYS = 2_000
SHARD_WORK = 10
SHARD_JOIN_ROUND = 5
SHARD_RUNS = (
    ("sharding/device/auto/join", "device", False, "join"),
    ("sharding/decremental/pipelined/die", "decremental", True, "die"),
)
#: lenient, as phase 11's: three nodes and their collectors share one
#: interpreter, and a starved heartbeat is a false death verdict
SHARD_HEARTBEAT = {
    "uigc.node.heartbeat-interval": 100,
    "uigc.node.heartbeat-pause": 3000,
}
SHARD_HOLD_WAKES = 10
SHARD_TIMEOUT_S = 120.0
SHARD_REPROBE_S = 2.0
#: phase 13: GATEWAY_KEYS keyed entities of phase 12's shape behind a
#: proxy-only gateway, driven by real TCP clients, per GATEWAY_RUNS
#: (label, backend, pipelined, data nodes, what the run does).  The
#: configuration is tools/ingress_bench.py's base_config with phase 12's
#: heartbeat; the connection count and the storm (4 clients at 10x a
#: 150 msgs/s tenant quota for 4 s) are that bench's defaults.
GATEWAY_KEYS = 2_000
GATEWAY_CONNECTIONS = 600
GATEWAY_FILL = 5
GATEWAY_FILL_TENANTS = 8
GATEWAY_CAPACITY = 150
GATEWAY_STORM_S = 4.0
GATEWAY_STORM_CLIENTS = 4
GATEWAY_PUMP_CLIENTS = 3
GATEWAY_DIE_AFTER_S = 2.0
GATEWAY_RUNS = (
    ("gateway/device/auto/overload", "device", False, 2, "overload"),
    ("gateway/decremental/pipelined/die", "decremental", True, 3, "die"),
)
GATEWAY_TIMEOUT_S = 120.0
GATEWAY_RETRY_ROUNDS = 8
#: phase 14: the checker's passes, the profile's repetitions per timing,
#: the live node's tree (phase 6's, cut from 100,000 actors: with the
#: JSONL sink, the time series and the HTTP port on it built in 26.8 and
#: 30.6 s and collected in 33.2 and 38.3 s, and the phase took 81.8 s),
#: how many sampled actors the why-live self-check validates beside the
#: leaf, and the subprocess time limit of each static check
TOOLS_PASSES = ("lint", "surface", "locks", "purity")
TOOLS_PROFILE_REPS = 5
TOOLS_TREE = dict(n_actors=50_000, fanout=8)
TOOLS_WHY_LIVE_SAMPLE = 8
TOOLS_CHECK_TIMEOUT_S = 300
KERNEL_SOURCE = "uigc_tpu_torch/csrc/propagate.cu"
REPLACES = "uigc_tpu/ops/pallas_trace.py:983"
#: the jump kernel replaces no Pallas kernel: the reference's jump step is
#: a jnp expression (with bits_at and the pack after it)
JUMP_REPLACES = "none (jnp: uigc_tpu/ops/pallas_trace.py:341 jump_sweep)"
#: nor does the pair tier's: the reference scatters that tier with jnp
PAIRS_REPLACES = ("none (jnp: uigc_tpu/ops/pallas_trace.py "
                  "build_sweep_contribs, its xla tier)")
#: slots of the pair tier timed at 10M: the live tier's largest capacity
#: under the layout's default freeze threshold (2^14)
PAIRS_CAPACITY = 1 << 14


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


def queued_ms(fn, reps):
    """Median milliseconds of ``fn()``'s device work over ``reps`` runs: a
    sleep kernel holds the stream while the host enqueues, so the events
    bracket the launched work alone, not the host's launch path (which is
    most of a launch-bound kernel's :func:`cuda_ms`)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
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
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    say(f"[device] compute_mode={mode[0] if mode else 'unknown'}")
    check(mode and mode[0] == "Default",
          f"the card's compute mode is {mode!r}, not Default: phase 11's "
          f"child processes could not open their own contexts on it")
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


def jump_operands(graph, r_rows, dev):
    """The jump step's word planes at the fixpoint's seed, as the trace
    fn makes them: (table, trans_w, iu_w, nh_w)."""
    n = graph["flags"].shape[0]
    flags = torch.from_numpy(graph["flags"]).to(dev)
    recv = torch.from_numpy(graph["recv_count"]).to(dev)
    in_use = F.flag_set(flags, F.FLAG_IN_USE)
    halted = F.flag_set(flags, F.FLAG_HALTED)
    iu_w = ct.pack_bools(in_use, n, r_rows)
    nh_w = ct.pack_bools(~halted, n, r_rows)
    table = ct.pack_bools(in_use & ~halted & F.seeds_torch(flags, recv), n,
                          r_rows) & nh_w
    return table, iu_w & nh_w, iu_w, nh_w


def jump_twin(table, jump_j, trans_w, iu_w, n):
    """The jump kernel's plain twin on CUDA tensors (what
    ct.jump_sweep_words runs on CPU tensors)."""
    hits, new_j = ct.jump_sweep(table, jump_j, trans_w, n)
    return ct.pack_bools(hits, n, table.shape[0]) & iu_w, new_j


def main_jump_timing(graph, jp_dev, r_rows, dev, errs):
    """The jump kernel at 10M over JUMP_SWEEPS sweeps' parents and
    tables (each sweep's doubled parents and jump hits feed the next):
    hit words and parents equal to the plain twin's, the caller's
    parents untouched, then the median of 20 launches per sweep, the
    twin's on the first sweep's inputs, and the byte bound."""
    n = jp_dev.numel() - 1
    table, trans_w, iu_w, nh_w = jump_operands(graph, r_rows, dev)
    jp_keep = jp_dev.clone()
    jk, tk, sweep_ms = jp_dev, table, []
    for k in range(JUMP_SWEEPS):
        got_w, got_j = ct.jump_sweep_words(tk, jk, trans_w, iu_w, n)
        torch.cuda.synchronize()
        want_w, want_j = jump_twin(tk, jk, trans_w, iu_w, n)
        equal = torch.equal(got_w, want_w) and torch.equal(got_j, want_j)
        errs["jump"] = max(errs["jump"], float(not equal))
        check(equal, f"jump differs from its plain version at 10M sweep "
              f"{k + 1}: {int((got_w != want_w).sum())} hit words, "
              f"{int((got_j != want_j).sum())} parents differ")
        sweep_ms.append(cuda_ms(
            lambda t=tk, j=jk: ct.jump_sweep_words(t, j, trans_w, iu_w, n),
            20))
        jk, tk = got_j, (tk | got_w) & nh_w
    check(torch.equal(jp_dev, jp_keep),
          "the jump kernel wrote into the caller's parents")
    plain_ms = cuda_ms(lambda: jump_twin(table, jp_dev, trans_w, iu_w, n), 20)
    # J read and the new J written once, the three word planes read and
    # the hit words written once; the dependent gathers of J (hub parents)
    # and of the planes are taken as L2 hits
    work_bytes = 2 * 4 * (n + 1) + 4 * 4 * table.numel()
    row = dict(name="jump", route="cuda", source=KERNEL_SOURCE,
               replaces=JUMP_REPLACES, library_ms=None, ms=sweep_ms[0],
               plain_ms=plain_ms, bound_ms=work_bytes / HBM_BYTES_S * 1e3,
               bound_by="bytes")
    say(f"[kernel] jump @10M: n={n} words={table.numel()} "
        f"sweeps={JUMP_SWEEPS} equal=True caller_parents_unchanged=True "
        f"bytes={work_bytes} ms={row['ms']:.4f} "
        f"ms_by_sweep={[round(x, 4) for x in sweep_ms]} "
        f"plain_ms={plain_ms:.4f} bound_ms={row['bound_ms']:.4f} "
        f"share_of_bound={row['bound_ms'] / row['ms']:.3f}")
    return row


def main_pairs_timing(graph, table, dev, errs):
    """The pair tier's kernel on phase 4's 10M table over PAIRS_CAPACITY
    of its graph's pairs (seeded): words equal to the plain twin's, the
    operands untouched, then the median of 20 launches (queued), the
    twin's on the card, and the byte bound."""
    n = graph["flags"].shape[0]
    rng = np.random.default_rng(0)
    pick = rng.choice(graph["edge_src"].size, PAIRS_CAPACITY, replace=False)
    src = torch.from_numpy(graph["edge_src"][pick].astype(np.int32)).to(dev)
    dst = torch.from_numpy(graph["edge_dst"][pick].astype(np.int32)).to(dev)
    kept = (table.clone(), src.clone(), dst.clone())
    got = prop.propagate_pairs(table, src, dst, torch.zeros_like(table), n)
    torch.cuda.synchronize()
    want = prop.propagate_pairs_torch(table, src, dst,
                                      torch.zeros_like(table), n)
    equal = torch.equal(got, want)
    errs["pairs"] = max(errs["pairs"], float(not equal))
    check(equal, f"pairs differs from its plain version at 10M: "
          f"{int((got != want).sum())} words differ")
    check(all(torch.equal(a, b) for a, b in zip((table, src, dst), kept)),
          "the pairs kernel wrote into its operands")
    out = torch.zeros_like(table)
    ms = queued_ms(lambda: prop.propagate_pairs(table, src, dst, out, n), 20)
    # the twin waits on its own host-to-device copy, so it cannot be
    # queued: its time is the caller's, host launches included
    plain_ms = cuda_ms(
        lambda: prop.propagate_pairs_torch(table, src, dst, out, n), 20)
    # src and dst read once (8 B a pair), a 32-byte sector of the table
    # read and of the plane ORed a pair
    work_bytes = PAIRS_CAPACITY * (8 + 32 + 32)
    row = dict(name="pairs", route="cuda", source=KERNEL_SOURCE,
               replaces=PAIRS_REPLACES, library_ms=None, ms=ms,
               plain_ms=plain_ms, bound_ms=work_bytes / HBM_BYTES_S * 1e3,
               bound_by="bytes")
    say(f"[kernel] pairs @10M: n={n} words={table.numel()} "
        f"capacity={PAIRS_CAPACITY} hit_words={int((want != 0).sum())} "
        f"equal=True operands_unchanged=True bytes={work_bytes} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={row['bound_ms']:.6f} "
        f"share_of_bound={row['bound_ms'] / ms:.3f}")
    return row


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
        jumps = prop.launches["jump"]
        t0 = time.perf_counter()
        marks, stats = fn(*args)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        jumps = prop.launches["jump"] - jumps
        check(torch.equal(in_use & ~marks, expected),
              f"{mode}: garbage set differs from expected_garbage")
        want_jumps = int(stats["n_sweeps"]) if mode in ("jump", "auto") else 0
        check(jumps == want_jumps,
              f"{mode}: the jump kernel launched {jumps} times in a trace "
              f"of {stats['n_sweeps']} sweeps, not {want_jumps}")
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
        say(f"[main] mode={mode} n_sweeps={sweeps} jump_launches={jumps} "
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
    which the keep-alive window cannot.  Safe across threads: the
    collectors of a multi-node run trace on their own."""

    def __init__(self, cls=arrays.ArrayShadowGraph, node_of=None):
        self.traces = 0
        self.mismatches = 0
        self.first = None
        self._cls = cls
        self._plain = cls.compute_marks
        #: the collectors of a multi-node run trace on their own threads
        self._lock = threading.Lock()
        #: traces per node, named by ``node_of()`` on the tracing thread
        #: (NodeLaunches.current)
        self.by_node = Counter()
        self._node_of = node_of

    def judge(self, mark, want):
        with self._lock:
            self.traces += 1
            if self._node_of is not None:
                self.by_node[self._node_of()] += 1
            if not np.array_equal(mark, want):
                self.mismatches += 1
                if self.first is None:
                    self.first = (f"trace {self.traces}: "
                                  f"{int((want & ~mark).sum())} slots missed, "
                                  f"{int((mark & ~want).sum())} extra")

    def __enter__(self):
        def checked(graph):
            mark = self._plain(graph)
            self.judge(mark, graph_oracle(graph))
            return mark

        self._cls.compute_marks = checked
        return self

    def __exit__(self, *exc):
        self._cls.compute_marks = self._plain


def graph_oracle(graph):
    return trace_ops.trace_marks_np(
        graph.flags, graph.recv_count, graph.supervisor, graph.edge_src,
        graph.edge_dst, graph.edge_weight)


class HarvestCheck:
    """OracleCheck's counterpart for pipelined wakes, which never call
    compute_marks: at ``launch_trace`` the oracle's marks are taken on
    the arrays the wake just uploaded, and at ``harvest_trace`` the marks
    read back (``arrays._readback``, label "marks.harvest") are judged
    by ``oracle`` against them."""

    def __init__(self, oracle):
        self.oracle = oracle
        self._tls = threading.local()
        self._launch = arrays.ArrayShadowGraph.launch_trace
        self._harvest = arrays.ArrayShadowGraph.harvest_trace
        self._readback = arrays._readback

    def __enter__(self):
        launch, harvest, readback = (self._launch, self._harvest,
                                     self._readback)
        tls, oracle = self._tls, self.oracle

        def launched(graph):
            before = graph._pending_wake
            launch(graph)
            if graph._pending_wake is not None and (
                    graph._pending_wake is not before):
                graph._smoke_want = graph_oracle(graph)

        def harvested(graph, should_kill):
            tls.graph = graph
            try:
                return harvest(graph, should_kill)
            finally:
                tls.graph = None

        def read(x, label):
            out = readback(x, label)
            graph = getattr(tls, "graph", None)
            if label == "marks.harvest" and graph is not None:
                oracle.judge(out, graph._smoke_want)
            return out

        arrays.ArrayShadowGraph.launch_trace = launched
        arrays.ArrayShadowGraph.harvest_trace = harvested
        arrays._readback = read
        return self

    def __exit__(self, *exc):
        arrays.ArrayShadowGraph.launch_trace = self._launch
        arrays.ArrayShadowGraph.harvest_trace = self._harvest
        arrays._readback = self._readback


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
    total = dict.fromkeys(prop.launches, 0)
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
        if mode in ("jump", "auto"):
            check(launches["jump"] > 0,
                  f"live {label}: the jump kernel never launched in the "
                  f"{mode} collector: {launches}")
        else:
            check(launches["jump"] == 0,
                  f"live {label}: the {mode} collector launched the jump "
                  f"kernel: {launches}")
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
    launches = dict.fromkeys(prop.launches, 0)
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

    launches = dict.fromkeys(prop.launches, 0)
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
    total = dict.fromkeys(prop.launches, 0)
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


# --------------------------------------------------------------------- #
# 9. telemetry and the sanitizer
# --------------------------------------------------------------------- #

#: one Prometheus sample line: name, optional labels, value
PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? '
    r'(-?[0-9.]+(e[+-]?[0-9]+)?|[+-]Inf|NaN)$')


class DeviceTraceLog:
    """Every ``tpu.device_trace`` duration of a run (the profiler keeps
    only its newest 256 wake records): how the trace phase's device
    seconds split between the few long wakes and the rest."""

    def __init__(self):
        self.durations = []

    def __call__(self, name, fields):
        if name == events.DEVICE_TRACE:
            self.durations.append(float(fields.get("duration_s") or 0.0))

    def __enter__(self):
        events.recorder.add_listener(self)
        return self

    def __exit__(self, *exc):
        events.recorder.remove_listener(self)


class HookClock:
    """Calls of, and thread CPU seconds inside, the telemetry hooks of a
    run: the per-wake ledger sample on the collector thread and the
    recorder listeners on every committing thread (the timers' own cost
    included).  CPU time, not wall time: a listener preempted for the
    interpreter lock would count the other threads' work.  What the
    instrumentation costs when it is on."""

    HOOKS = ((DeviceObservatory, "on_wake"), (DeviceObservatory, "__call__"),
             (EventMetricsBridge, "__call__"), (WakeProfiler, "__call__"))

    def __init__(self):
        self.calls = {}
        self.seconds = {}
        self._plain = {}

    def __enter__(self):
        for cls, name in self.HOOKS:
            key = f"{cls.__name__}.{name}"
            plain = self._plain[key] = getattr(cls, name)
            self.calls[key], self.seconds[key] = 0, 0.0

            def timed(obj, *args, _plain=plain, _key=key, **kw):
                t0 = time.thread_time()
                try:
                    return _plain(obj, *args, **kw)
                finally:
                    self.calls[_key] += 1  # GIL-atomic enough for a tally
                    self.seconds[_key] += time.thread_time() - t0

            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name in self.HOOKS:
            setattr(cls, name, self._plain[f"{cls.__name__}.{name}"])


class ParentsSpy:
    """Counts the why-live derivations (marking_parents_torch calls) and
    the devices they ran on."""

    def __init__(self):
        self.devices = []
        self._plain = ct.marking_parents_torch

    def __enter__(self):
        def spied(*args, device=None):
            self.devices.append(str(device))
            return self._plain(*args, device=device)

        ct.marking_parents_torch = spied
        return self

    def __exit__(self, *exc):
        ct.marking_parents_torch = self._plain


def why_live_probe(system):
    """9b, while the tree is held: why_live for the deepest actor (a
    leaf), through the inspector, then the same chain from the numpy
    parents on the same host arrays."""
    insp = system.telemetry.inspector
    graph = system.engine.bookkeeper.shadow_graph
    snap = insp.snapshot()
    leaf = max(snap["actors"].values(),
               key=lambda rec: (rec["name"].count("/"), rec["key"]))["key"]
    with ParentsSpy() as spy:
        result = insp.why_live(leaf)
    host = types.SimpleNamespace(**vars(graph))
    host.use_device, host.last_parents = False, None
    want = tel_inspect.why_live_from_parents(host, snap, leaf)
    return {"result": result, "numpy": want, "devices": spy.devices,
            "problems": tel_inspect.validate_why_live(snap, result)}


def telemetry_probe(system, stage):
    tel = system.telemetry
    out = {"profile": tel.profiler.to_json(),
           "doc": tel.observatory.to_doc(),
           "text": prometheus_text(tel.registry),
           "max_alloc": torch.cuda.max_memory_allocated()}
    if stage == "held":
        out["why_live"] = why_live_probe(system)
    return out


def profiled_run(device):
    """9a and 9b.  Returns the run's launches."""
    label = f"tree{TELEMETRY_TREE['n_actors'] // 1000}k/device/auto/profiled"
    config = {"uigc.crgc.shadow-graph": "device", "uigc.crgc.device": device,
              "uigc.crgc.trace-mode": "auto", "uigc.crgc.wakeup-interval": 10,
              "uigc.telemetry.wake-profile": True,
              "uigc.telemetry.metrics": True, "uigc.telemetry.device": True,
              "uigc.telemetry.inspect": True,
              "uigc.telemetry.leak-waves": 0}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()  # the ledger's bound: this run
    prop.reset_launches()
    try:
        with DeviceTraceLog() as traces, HookClock() as hooks:
            r = run_tree(config=config, timeout_s=LIVE_TIMEOUT_S,
                         hold_wakes=HOLD_WAKES, probe=telemetry_probe,
                         **TELEMETRY_TREE)
    except (AssertionError, RuntimeError) as exc:
        raise SmokeFailure(f"telemetry {label}: {exc}") from exc
    launches = dict(prop.launches)
    n = r["n_collected"]
    check(r["held_wakes"] >= HOLD_WAKES,
          f"telemetry {label}: held {r['held_wakes']} wakes")
    check(sum(launches.values()) > 0,
          f"telemetry {label}: the kernel never launched in the collector")
    say(f"[telemetry] {label} actors={n} build_s={r['build_s']:.3f} "
        f"collect_s={r['collect_s']:.3f} "
        f"collected_per_s={n / r['collect_s']:.1f} "
        f"held_wakes={r['held_wakes']} wakes={r['wakes']} "
        f"rebuilds={r['rebuilds']} capacity={r['capacity']} "
        f"launches={launches}")

    got = r["probe"]["collected"]
    prof = got["profile"]
    phases = prof["phases"]
    device_s = phases["trace"]["device_total_s"]
    check(device_s > 0, f"telemetry {label}: the profiler saw no device time")
    check(device_s <= phases["trace"]["total_s"],
          f"telemetry {label}: device {device_s:.6f} s is above the trace "
          f"phase's {phases['trace']['total_s']:.6f} s")
    say(f"[telemetry] {label} wake profile: wakes={prof['wakes']} "
        f"wall_total_s={prof['wall_total_s']:.6f} "
        f"wall_max_s={prof['wall_max_s']:.6f} "
        f"entries={prof['entries_total']} garbage={prof['garbage_total']}")
    for name in ("ingest", "fold", "trace", "sweep", "broadcast"):
        ph = phases[name]
        say(f"[telemetry] {label} phase {name}: total_s={ph['total_s']:.6f} "
            f"max_s={ph['max_s']:.6f} "
            f"device_total_s={ph['device_total_s']:.6f}")
    say(f"[telemetry] {label} device share: device_s={device_s:.6f} of "
        f"wall_total_s={prof['wall_total_s']:.6f} "
        f"({device_s / prof['wall_total_s']:.4f}); of the trace phase "
        f"{device_s / phases['trace']['total_s']:.4f}")
    say(f"[telemetry] {label} collect split: wake wall "
        f"{prof['wall_total_s']:.3f} s of build+hold+collect; collect_s "
        f"{r['collect_s']:.3f}")
    say(f"[telemetry] {label} hooks: " + "; ".join(
        f"{key} calls={hooks.calls[key]} cpu_s={hooks.seconds[key]:.6f}"
        for key in hooks.calls))
    # every device trace of the run: the longest (one per layout rebuild,
    # and one more) against the rest
    dev = sorted(traces.durations, reverse=True)
    check(dev, f"telemetry {label}: no device trace was committed")
    k = r["rebuilds"] + 1
    rest = dev[k:] or [0.0]
    say(f"[telemetry] {label} device traces: n={len(dev)} "
        f"sum_s={sum(dev):.6f} longest {k} sum_s={sum(dev[:k]):.6f} "
        f"({sum(dev[:k]) / sum(dev):.4f}) each={[round(d, 4) for d in dev[:k]]}"
        f"; the other {len(dev) - k}: sum_s={sum(dev[k:]):.6f} "
        f"p50_s={float(np.median(rest)):.6f} "
        f"p90_s={float(np.percentile(rest, 90)):.6f} max_s={rest[0]:.6f}; "
        f"sweeps per traced wake (newest records) "
        f"{sorted({w.get('n_sweeps', 0) for w in prof['recent'] if w['device_s']})}")

    held = r["probe"]["held"]
    ledger = held["doc"]["ledger"]
    for fam, tally in sorted(ledger["families"].items()):
        say(f"[telemetry] {label} ledger {fam}: host={tally['host']} "
            f"device={tally['device']} items={tally['items']} "
            f"peak={ledger['peaks'].get(fam, 0)}")
    device_bytes = ledger["device_bytes"]
    check(device_bytes > 0,
          f"telemetry {label}: the ledger's device families read 0 bytes")
    check(device_bytes <= held["max_alloc"],
          f"telemetry {label}: ledger device bytes {device_bytes} above "
          f"max_memory_allocated {held['max_alloc']}")
    builds = held["doc"]["compile"]["kernel_build"]
    say(f"[telemetry] {label} ledger device_bytes={device_bytes} "
        f"total_bytes={ledger['total_bytes']} "
        f"max_memory_allocated={held['max_alloc']} compile_entries="
        f"{len(held['doc']['compile']['entries'])} kernel_build={builds} "
        f"host_transfers={held['doc']['transfers']['total_count']} "
        f"donation_copies={held['doc']['donation']['copies_total']}")

    lines = got["text"].splitlines()
    bad = [ln for ln in lines if not ln.startswith("#")
           and not PROM_SAMPLE.match(ln)]
    check(not bad, f"telemetry {label}: unparsable exposition lines {bad[:3]}")
    check(any(ln.startswith("uigc_wake_phase_seconds_count") for ln in lines),
          f"telemetry {label}: no wake-phase histogram in the exposition")
    say(f"[telemetry] {label} exposition: {len(lines)} lines parse, "
        f"{sum(not ln.startswith('#') for ln in lines)} samples")

    wl = held["why_live"]
    res, want = wl["result"], wl["numpy"]
    check(res.get("verdict") == "live" and res.get("parents") == "derived",
          f"telemetry {label}: why-live came out {res.get('verdict')}/"
          f"{res.get('parents')}, not live/derived")
    check(wl["devices"] and all(d.startswith(device) for d in wl["devices"]),
          f"telemetry {label}: the derivation ran on {wl['devices']}, "
          f"not {device}")
    check(want is not None and res["chain"] == want["chain"],
          f"telemetry {label}: why-live chain differs from the numpy "
          f"parents' chain")
    check(not wl["problems"], f"telemetry {label}: why-live {wl['problems']}")
    say(f"[telemetry] {label} why-live {res['actor']} ({res['name']}): "
        f"parents=derived on {wl['devices'][0]}, chain of "
        f"{len(res['chain'])} equal to trace_marks_np_parents'; "
        f"pseudoroot {res['pseudoroot_name']} ({res['root_reasons']})")
    return launches


def sanitizer_probe(system, stage):
    san = system.sanitizer
    if stage == "collected":
        san.check_quiescent()
    return san.report()


def sanitized_runs(device):
    """9c.  Returns the launches of the CRGC run."""
    runs = (
        (f"tree{SANITIZED_TREE['n_actors'] // 1000}k/decremental/pipelined"
         f"/sanitized", run_tree, SANITIZED_TREE,
         {"uigc.crgc.shadow-graph": "decremental",
          "uigc.crgc.device": device, "uigc.crgc.pipelined": True,
          "uigc.crgc.wakeup-interval": 10}),
        (f"rings{SANITIZED_RINGS['n_rings']}x{SANITIZED_RINGS['ring_size']}"
         f"/mac/sanitized", run_rings, SANITIZED_RINGS,
         {"uigc.engine": "mac", "uigc.mac.cycle-detection": True,
          "uigc.mac.wakeup-interval": 10, "uigc.mac.device": device}),
    )
    launches = dict.fromkeys(prop.launches, 0)
    for label, workload, args, config in runs:
        config = dict(config, **{"uigc.analysis.sanitizer": True})
        prop.reset_launches()
        try:
            r = workload(config=config, timeout_s=LIVE_TIMEOUT_S,
                         hold_wakes=HOLD_WAKES, probe=sanitizer_probe, **args)
        except (AssertionError, RuntimeError) as exc:
            raise SmokeFailure(f"telemetry {label}: {exc}") from exc
        for form, count in prop.launches.items():
            launches[form] += count
        rep = r["probe"]["collected"]
        mac = config.get("uigc.engine") == "mac"
        checked = rep["tap"]["recvs"] if mac else rep["checks"]
        check(r["held_wakes"] >= HOLD_WAKES,
              f"telemetry {label}: held {r['held_wakes']} wakes")
        check(not rep["violations"],
              f"telemetry {label}: sanitizer violations {rep['by_rule']}: "
              f"{rep['violations'][:3]}")
        check(checked > 0, f"telemetry {label}: nothing was checked")
        if mac:
            check(r["total_cycles_collected"] == SANITIZED_RINGS["n_rings"],
                  f"telemetry {label}: {r['total_cycles_collected']} cycles")
        else:
            check(sum(prop.launches.values()) > 0,
                  f"telemetry {label}: the kernel never launched")
        n = r["n_collected"]
        what = ("tap facts checked (MAC has no oracle: receives against "
                "sends)" if mac else "collector verdicts checked against "
                "the oracle")
        say(f"[telemetry] {label} actors={n} build_s={r['build_s']:.3f} "
            f"collect_s={r['collect_s']:.3f} held_wakes={r['held_wakes']} "
            f"violations=0 {what}={checked} tap={rep['tap']} "
            f"oracle_population={rep['oracle_population']} "
            f"launches={dict(prop.launches)}")
    return launches


def phase_telemetry(device="cuda"):
    """Phase 9.  Returns the launches per form over its runs."""
    launches = profiled_run(device)
    for form, count in sanitized_runs(device).items():
        launches[form] += count
    say(f"[telemetry] launches={launches}")
    return launches


# --------------------------------------------------------------------- #
# 10. multi-node
# --------------------------------------------------------------------- #


class NodeLaunches:
    """Kernel launches per node: ``Bookkeeper.on_message`` (a collector
    wake, or the undo-log fold a membership message triggers) names the
    node whose collector runs on the calling thread, and the wrappers of
    the three kernels (propagate, jump and pairs) add each launch to that
    node's count (under a lock: the collectors of the three systems launch
    from their own threads)."""

    def __init__(self):
        self.by_node = Counter()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._on_message = Bookkeeper.on_message
        self._propagate = prop.propagate_words_cuda
        self._jump = ct.jump_sweep_words_cuda
        self._pairs = prop.propagate_pairs_cuda

    def __enter__(self):
        on_message, tls = self._on_message, self._tls

        def named(bookkeeper, msg):
            prev = getattr(tls, "node", None)
            tls.node = bookkeeper.engine.system.name
            try:
                return on_message(bookkeeper, msg)
            finally:
                tls.node = prev

        def counting(wrapped):
            def counted(*args, **kw):
                out = wrapped(*args, **kw)
                with self._lock:
                    self.by_node[getattr(tls, "node", None)] += 1
                return out
            return counted

        Bookkeeper.on_message = named
        prop.propagate_words_cuda = counting(self._propagate)
        # ops/cuda_trace.py calls the jump launcher by its imported name
        ct.jump_sweep_words_cuda = counting(self._jump)
        prop.propagate_pairs_cuda = counting(self._pairs)
        return self

    def __exit__(self, *exc):
        Bookkeeper.on_message = self._on_message
        prop.propagate_words_cuda = self._propagate
        ct.jump_sweep_words_cuda = self._jump
        prop.propagate_pairs_cuda = self._pairs

    def current(self):
        """The node whose collector runs on the calling thread, or None."""
        return getattr(self._tls, "node", None)


def cluster_run(label, backend, pipelined, errs):
    """BASELINE config 4 (run_cluster_recovery) at CLUSTER_WORKERS with
    the three collectors on the card, in wire mode (the default Fabric:
    serialized, async links) with C's pings to B dropped.  Every trace
    of every collector is held against trace_marks_np.  Returns its
    launches."""
    config = {
        "uigc.crgc.shadow-graph": backend,
        "uigc.crgc.device": "cuda",
        "uigc.crgc.trace-mode": "auto",
        "uigc.crgc.pipelined": pipelined,
    }
    prop.reset_launches()
    with LaunchCapture() as cap, NodeLaunches() as nodes, \
            OracleCheck() as oc, HarvestCheck(oc):
        try:
            r = run_cluster_recovery(CLUSTER_WORKERS, drop_pings=True,
                                     config=config,
                                     timeout_s=CLUSTER_TIMEOUT_S)
        except (AssertionError, RuntimeError) as exc:
            raise SmokeFailure(
                f"cluster {label}: {exc} (oracle: {oc.mismatches} of "
                f"{oc.traces} traces differ; first {oc.first})") from exc
    launches = dict(prop.launches)
    by_node = dict(nodes.by_node)
    check(all(r["roots_alive"].values()),
          f"cluster {label}: a survivor's root stopped: {r['roots_alive']}")
    check(oc.traces > 0, f"cluster {label}: no trace was checked")
    check(oc.mismatches == 0,
          f"cluster {label}: {oc.mismatches} of {oc.traces} traces differ "
          f"from trace_marks_np; first {oc.first}")
    check(sum(launches.values()) > 0,
          f"cluster {label}: the kernel never launched in a collector")
    check(sum(by_node.values()) == sum(launches.values())
          and None not in by_node,
          f"cluster {label}: launches outside a collector: {by_node} "
          f"against {launches}")
    for node in ("benchA", "benchB"):
        check(by_node.get(node, 0) > 0,
              f"cluster {label}: {node}'s collector never launched: "
              f"{by_node}")
    n = r["n_collected"]
    say(f"[cluster] {label} workers={n} drop_pings=True "
        f"build_s={r['build_s']:.3f} collect_s={r['collect_s']:.3f} "
        f"collected_per_s={n / r['collect_s']:.1f} wakes={r['wakes']} "
        f"oracle_traces={oc.traces} launches={launches} "
        f"launches_by_node={by_node} roots_alive={r['roots_alive']}")
    live_kernel_checks(cap.kept, errs, f"cluster {label}")
    return launches


class DHold(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


class DGo(NoRefs):
    def __init__(self, rings, kept):
        self.rings = rings
        self.kept = kept


class DDrop(NoRefs):
    pass


class RingTally:
    """Spawns and PostStops of the partitioned run's workers, counted on
    whichever thread they happen."""

    def __init__(self):
        self.spawned = 0
        self.stopped = Counter()
        self._cond = threading.Condition()

    def spawn(self):
        with self._cond:
            self.spawned += 1
            self._cond.notify_all()

    def stop(self, kept):
        with self._cond:
            self.stopped[kept] += 1
            self._cond.notify_all()

    def wait(self, pred, timeout_s):
        with self._cond:
            return self._cond.wait_for(pred, timeout_s)


class DWorker(AbstractBehavior):
    def __init__(self, context, tally):
        super().__init__(context)
        self.tally = tally
        self.held = []
        self.kept = False
        tally.spawn()

    def on_message(self, msg):
        if isinstance(msg, DHold):
            self.held.append(msg.ref)
        elif isinstance(msg, DGo):  # the master marks the kept rings
            self.kept = True
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.tally.stop(self.kept)
        return None


class DRingMaster(AbstractBehavior):
    """tests/test_distributed.py's RingMaster: rings of workers, one per
    node through the spawner services, each ring a cycle across the
    cluster; the kept rings stay pinned by the master's refs."""

    def __init__(self, context, spawners):
        super().__init__(context)
        self.spawners = spawners
        self.workers = []
        self.kept = []

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, DGo):
            for r in range(msg.rings + msg.kept):
                ring = [ctx.spawn_remote("worker", sc) for sc in self.spawners]
                for i, w in enumerate(ring):
                    w.tell(DHold(ctx.create_ref(ring[(i + 1) % len(ring)], w)),
                           ctx)
                    if r >= msg.rings:
                        w.tell(DGo(0, 0), ctx)
                (self.kept if r >= msg.rings else self.workers).extend(ring)
        elif isinstance(msg, DDrop):
            for w in self.workers:
                ctx.release(w)
            self.workers = []
        return self


class EventLog:
    """The events of a run: a count per name, and the durations of those
    that carry one."""

    def __init__(self):
        self.counts = Counter()
        self.durations = {}
        self._lock = threading.Lock()

    def __call__(self, name, fields):
        with self._lock:
            self.counts[name] += 1
            if fields.get("duration_s") is not None:
                self.durations.setdefault(name, []).append(
                    fields["duration_s"])

    def __enter__(self):
        events.recorder.enable()
        events.recorder.add_listener(self)
        return self

    def __exit__(self, *exc):
        events.recorder.remove_listener(self)
        events.recorder.disable()
        events.recorder.reset()


def partitioned_run():
    """The partitioned collector (uigc.crgc.distributed) on three nodes of
    one Fabric, the harness of tests/test_distributed.py build_inproc,
    with the sanitizer on: DIST_RINGS + DIST_KEPT rings across the three
    nodes, the first DIST_RINGS dropped.  Its local fixpoint runs on the
    pointer plane, so no kernel launches.  Returns its launches."""
    config = {
        "uigc.crgc.wakeup-interval": 10,
        "uigc.crgc.egress-finalize-interval": 5,
        "uigc.crgc.num-nodes": 3,
        "uigc.crgc.distributed": True,
        "uigc.analysis.sanitizer": True,
    }
    tally = RingTally()
    total = 3 * (DIST_RINGS + DIST_KEPT)
    prop.reset_launches()
    with EventLog() as log:
        fabric = Fabric()
        systems = [ActorSystem(None, name=f"dn{i}", config=config,
                               fabric=fabric) for i in range(3)]
        try:
            spawners = [RemoteSpawner.spawn_service(s, {"worker": Behaviors.setup(
                lambda ctx: DWorker(ctx, tally))}) for s in systems]
            master = systems[0].spawn_root(Behaviors.setup_root(
                lambda ctx: DRingMaster(ctx, spawners)), "master")
            t0 = time.perf_counter()
            master.tell(DGo(DIST_RINGS, DIST_KEPT))
            check(tally.wait(lambda: tally.spawned == total,
                             CLUSTER_TIMEOUT_S),
                  f"partitioned: {tally.spawned} of {total} workers spawned")
            time.sleep(0.4)
            check(sum(tally.stopped.values()) == 0,
                  f"partitioned: {dict(tally.stopped)} stopped before the drop")
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            master.tell(DDrop())
            check(tally.wait(lambda: tally.stopped[False] >= 3 * DIST_RINGS,
                             CLUSTER_TIMEOUT_S),
                  f"partitioned: {tally.stopped[False]} of {3 * DIST_RINGS} "
                  f"dropped ring members collected")
            collect_s = time.perf_counter() - t0
            time.sleep(0.5)  # the kept rings must outlive a few more waves
            check(tally.stopped[True] == 0,
                  f"partitioned: {tally.stopped[True]} kept members stopped")
            time.sleep(0.3)
            graphs = [s.engine.bookkeeper.shadow_graph for s in systems]
            for s, g in zip(systems, graphs):
                check(g.audit_fold_locality() == [],
                      f"partitioned: {s.name} folded outside its slice")
                check(s.sanitizer.violations == [],
                      f"partitioned: {s.name} sanitizer: "
                      f"{s.sanitizer.violations[:3]}")
                check(s.sanitizer.dist_sweeps > 0,
                      f"partitioned: {s.name} ran no distributed sweep")
            cross = cross_check_distributed(systems)
            check(cross == [], f"partitioned: cross-check: {cross[:3]}")
            for name in (events.DIST_WAVE, events.DIST_MARKS,
                         events.DIST_ROUND):
                check(log.counts[name] > 0, f"partitioned: no {name} event")
            check(log.counts[events.DIST_LOCALITY] == 0,
                  "partitioned: a fold-locality violation was committed")
            owned = [g.owned_population() for g in graphs]
            pops = [len(g.from_set) for g in graphs]
        finally:
            for s in systems:
                s.terminate()
    launches = dict(prop.launches)
    check(sum(launches.values()) == 0,
          f"partitioned: the pointer plane launched the kernel: {launches}")
    say(f"[cluster] partitioned rings={DIST_RINGS} kept={DIST_KEPT} "
        f"workers={total} build_s={build_s:.3f} collect_s={collect_s:.3f} "
        f"waves={log.counts[events.DIST_WAVE]} "
        f"mark_frames={log.counts[events.DIST_MARKS]} "
        f"rounds={log.counts[events.DIST_ROUND]} owned={owned} "
        f"populations={pops} cross_check=[] launches={launches} "
        f"(0 expected: the partitioned fixpoint runs on the pointer plane)")
    return launches


def phase_cluster(errs):
    """Phase 10.  Returns the launches per form over its runs."""
    total = dict.fromkeys(prop.launches, 0)
    for label, backend, pipelined in CLUSTER_RUNS:
        for form, count in cluster_run(label, backend, pipelined,
                                       errs).items():
            total[form] += count
    for form, count in partitioned_run().items():
        total[form] += count
    say(f"[cluster] launches={total}")
    return total


# --------------------------------------------------------------------- #
# 11. multi-process
# --------------------------------------------------------------------- #


def node_child(spec):
    """The main of a phase-11 child (``chip_smoke.py --node-child``): one
    node of nodeproc's roles, with its collector on the card, its own
    launches counted and every trace held against trace_marks_np in this
    process, reported on its ``STATS`` lines."""
    if spec.get("device", "cuda") == "cuda":
        require_hopper()
        prop.load_library()  # built by the driver's phase 2: the cache
    prop.reset_launches()
    with OracleCheck() as oc, HarvestCheck(oc):
        nodeproc.run_child(spec, lambda: {
            "launches": dict(prop.launches), "oracle_traces": oc.traces,
            "oracle_mismatches": oc.mismatches, "oracle_first": oc.first})


def proc_count(node):
    spawned, stopped = node.ask("count", "COUNT").split()[1:]
    return int(spawned), int(stopped)


def wait_for(what, pred, timeout_s):
    deadline = time.monotonic() + timeout_s
    while not pred():
        check(time.monotonic() < deadline, what)
        time.sleep(0.05)


def proc_run(label, backend, pipelined, death, device, errs):
    """One config-4 run across three processes (the module note, phase
    11).  Returns the launches per form of A's and B's collectors."""
    config = {
        "uigc.crgc.shadow-graph": backend,
        "uigc.crgc.device": device,
        "uigc.crgc.trace-mode": "auto",
        "uigc.crgc.pipelined": pipelined,
    }
    if death == "stop":
        config.update(PROC_SILENT)
    argv = [sys.executable, os.path.abspath(__file__), "--node-child"]
    spec = {"config": config, "device": device}
    links = nodeproc.LinkTally().attach()
    prop.reset_launches()
    child_b = child_c = system = None
    try:
        with LaunchCapture() as cap, OracleCheck() as oc, HarvestCheck(oc):
            t0 = time.perf_counter()
            fabric = NodeFabric()
            system = ActorSystem(None, name="procA",
                                 config=dict(nodeproc.BASE, **config),
                                 fabric=fabric)
            fabric.listen()
            child_c = nodeproc.Child(dict(spec, role="holder",
                                          address="procC"), argv, wait=False)
            child_b = nodeproc.Child(dict(spec, role="owner", address="procB",
                                          with_drops=True,
                                          n_workers=PROC_WORKERS),
                                     argv, wait=False)
            fabric.connect("127.0.0.1", child_b.wait_ready())
            fabric.connect("127.0.0.1", child_c.wait_ready())
            child_b.ask(f"connect 127.0.0.1:{child_c.port}", "CONNECTED")
            start_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            child_b.ask("spawn_owner procC procA", "OWNER_SPAWNED",
                        CLUSTER_TIMEOUT_S)
            child_b.ask("share", "SHARED")
            wait_for(f"procs {label}: the ref hand-off timed out",
                     lambda: int(child_c.ask("held", "HELD").split()[1])
                     >= PROC_WORKERS, CLUSTER_TIMEOUT_S)
            child_b.ask("drop", "DROPPED")
            build_s = time.perf_counter() - t0
            wakes0 = child_b.stats()["wakes"]
            wait_for(f"procs {label}: B's collector did not wake "
                     f"{PROC_HOLD_WAKES} times",
                     lambda: child_b.stats()["wakes"] - wakes0
                     >= PROC_HOLD_WAKES, CLUSTER_TIMEOUT_S)
            check(proc_count(child_b) == (PROC_WORKERS, 0),
                  f"procs {label}: workers (spawned, stopped) before C's "
                  f"death: {proc_count(child_b)}")
            stats_c = child_c.stats()
            t0 = time.perf_counter()
            child_c.signal(signal.SIGKILL if death == "kill"
                           else signal.SIGSTOP)
            wait_for(f"procs {label}: workers not all collected after C's "
                     f"death", lambda: proc_count(child_b)[1] >= PROC_WORKERS,
                     CLUSTER_TIMEOUT_S)
            collect_s = time.perf_counter() - t0
            stats_b = child_b.stats()
            stats_a = nodeproc.node_stats(system, fabric, links)
            stats_a.update(launches=dict(prop.launches),
                           oracle_traces=oc.traces,
                           oracle_mismatches=oc.mismatches,
                           oracle_first=oc.first)
    except AssertionError as exc:  # a child died, erred or fell silent
        raise SmokeFailure(f"procs {label}: {exc}") from exc
    finally:
        links.detach()
        if child_c is not None:
            child_c.kill9()
        if child_b is not None:
            child_b.shutdown()
        if system is not None:
            system.terminate()
    launches = {}
    for node, st_ in (("A", stats_a), ("B", stats_b)):
        check(st_["roots_alive"], f"procs {label}: {node}'s root stopped")
        check(device != "cuda" or sum(st_["launches"].values()) > 0,
              f"procs {label}: {node}'s collector never launched the kernel")
        check(st_["oracle_traces"] > 0 and st_["oracle_mismatches"] == 0,
              f"procs {label}: {node}: {st_['oracle_mismatches']} of "
              f"{st_['oracle_traces']} traces differ from trace_marks_np; "
              f"first {st_['oracle_first']}")
        check(st_["downed"] == ["uigc://procC"],
              f"procs {label}: {node}'s collector downed {st_['downed']}")
        if death == "stop":
            check(st_["down"].get("uigc://procC") == "heartbeat",
                  f"procs {label}: {node} did not take C down by the "
                  f"heartbeat: {st_['down']}")
        for form, count in st_["launches"].items():
            launches[form] = launches.get(form, 0) + count
    if death == "stop":
        check(stats_a["shm"].get("uigc://procB")
              and stats_b["shm"].get("uigc://procA"),
              f"procs {label}: the A-B link never ran on the shm ring: "
              f"{stats_a['shm']} {stats_b['shm']}")
    frames = {f"{src}->{dst.split('//')[-1]}": fb
              for src, st_ in (("procA", stats_a), ("procB", stats_b),
                               ("procC", stats_c))
              for dst, fb in sorted(st_["frames"].items())}
    say(f"[procs] {label} workers={PROC_WORKERS} death={death} "
        f"start_s={start_s:.3f} build_s={build_s:.3f} "
        f"collect_s={collect_s:.3f} "
        f"collected_per_s={PROC_WORKERS / collect_s:.1f} "
        f"wakes={{A: {stats_a['wakes']}, B: {stats_b['wakes']}}} "
        f"launches={{A: {stats_a['launches']}, B: {stats_b['launches']}}} "
        f"oracle_traces={{A: {stats_a['oracle_traces']}, "
        f"B: {stats_b['oracle_traces']}}} down={{A: {stats_a['down']}, "
        f"B: {stats_b['down']}}} shm={{A: {stats_a['shm']}, "
        f"B: {stats_b['shm']}}}")
    say(f"[procs] {label} frames_bytes_per_link={frames}")
    if device == "cuda":
        live_kernel_checks(cap.kept, errs, f"procs {label}")
    return launches


def phase_procs(errs, device="cuda"):
    """Phase 11.  Returns the launches per form of A's and B's
    collectors over its runs."""
    total = dict.fromkeys(prop.launches, 0)
    for label, backend, pipelined, death in PROC_RUNS:
        for form, count in proc_run(label, backend, pipelined, death,
                                    device, errs).items():
            total[form] += count
    say(f"[procs] launches={total}")
    return total


# --------------------------------------------------------------------- #
# 12. cluster sharding
# --------------------------------------------------------------------- #


class ShardTally:
    """What phase 12's actors did, per node (system name): transient
    children spawned and stopped, the held children alive and those
    stopped, and the incarnations that were handed a ref to a child in
    their restored state (``captured_state`` hands None)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.transient_spawned = Counter()
        self.transient_stopped = Counter()
        self.held_stopped = Counter()
        self.held_live = {}
        self.restored_refs = 0

    def transient(self, node, stopped):
        with self._lock:
            (self.transient_stopped if stopped
             else self.transient_spawned)[node] += 1

    def held(self, node, path, alive):
        with self._lock:
            live = self.held_live.setdefault(node, set())
            if alive:
                live.add(path)
            else:
                live.discard(path)
                self.held_stopped[node] += 1

    def restored_ref(self):
        with self._lock:
            self.restored_refs += 1

    def sums(self, nodes):
        """(transients spawned, transients stopped, held stopped, held
        alive) over the system names ``nodes``."""
        with self._lock:
            return (sum(self.transient_spawned[n] for n in nodes),
                    sum(self.transient_stopped[n] for n in nodes),
                    sum(self.held_stopped[n] for n in nodes),
                    sum(len(self.held_live.get(n, ())) for n in nodes))


class SJob(NoRefs):
    pass


class STransient(AbstractBehavior):
    """The child of one "work" command: told one job, released at once."""

    def __init__(self, context, tally):
        super().__init__(context)
        self.tally = tally

    def on_message(self, msg):
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.tally.transient(self.context.system.name, True)
        return self


class SHeld(AbstractBehavior):
    """The child an incarnation spawns when it is activated and keeps."""

    def __init__(self, context, tally):
        super().__init__(context)
        self.tally = tally

    def on_message(self, msg):
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.tally.held(self.context.system.name,
                            self.context.cell.path, False)
        return self


class SEntity(Entity):
    """Phase 12's entity: a counter, with a held child kept in its
    snapshot and a transient child per "work" command."""

    def __init__(self, ctx, key, state, tally):
        super().__init__(ctx, key)
        self.tally = tally
        state = state or {}
        self.count = state.get("count", 0)
        self.held = state.get("held")
        if self.held is not None:
            tally.restored_ref()
        else:
            self.held = ctx.spawn(
                Behaviors.setup(lambda c: SHeld(c, tally)), "held")
            tally.held(ctx.system.name, self.held.target.path, True)

    def receive(self, msg):
        ctx = self.context
        if msg[0] == "work":
            self.count += 1
            child = ctx.spawn_anonymous(
                Behaviors.setup(lambda c: STransient(c, self.tally)))
            self.tally.transient(ctx.system.name, False)
            child.tell(SJob(), ctx)
            ctx.release(child)
        elif msg[0] == "drop":
            if self.held is not None:
                ctx.release(self.held)
                self.held = None
        elif msg[0] == "probe":
            msg[1].tell(("probed", self.key, self.count))
        return self

    def snapshot_state(self):
        return {"count": self.count, "held": self.held}


class SProbeSink(RawBehavior):
    def __init__(self):
        self.got = {}
        self._lock = threading.Lock()

    def on_message(self, msg):
        if isinstance(msg, tuple) and msg and msg[0] == "probed":
            with self._lock:
                self.got[msg[1]] = msg[2]

    def snapshot(self):
        with self._lock:
            return dict(self.got)


class ShardNode:
    """One node of phases 12 and 13: a NodeFabric, its system and its
    cluster, with a region of ``entity``."""

    def __init__(self, name, config, plan, tally, type_name="sentity",
                 entity=SEntity):
        self.fabric = NodeFabric(fault_plan=plan)
        self.system = ActorSystem(None, name=name, config=config,
                                  fabric=self.fabric)
        self.port = self.fabric.listen()
        self.address = self.system.address
        self.cluster = ClusterSharding.attach(self.system)
        self.region = self.cluster.start(
            type_name, lambda ctx, key, state: entity(ctx, key, state,
                                                      tally))

    def wakes(self):
        return self.system.engine.bookkeeper.wakes

    def table(self):
        return sorted(self.cluster.table_snapshot().assignments.items())


def shard_converged(nodes):
    """Every node sees exactly ``nodes`` as members, no handoff pending,
    one table."""
    addresses = sorted(n.address for n in nodes)
    return (all(sorted(n.cluster.members()) == addresses for n in nodes)
            and all(n.cluster.migrations.pending_count() == 0 for n in nodes)
            and len({tuple(n.table()) for n in nodes}) == 1)


def shard_probe(node, keys, expect, at_least=False):
    """Probe every key from ``node`` until it answers ``expect[key]`` (or
    more, with ``at_least``), within SHARD_TIMEOUT_S; the answers.  A key
    is probed again only after SHARD_REPROBE_S without the answer (a
    probe may overtake a command sent from another node), so the probes
    do not flood the mailboxes they wait on."""
    sink = SProbeSink()
    cell = node.system.spawn_system_raw(sink, f"probe-{time.monotonic_ns()}")
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    sent = {}
    while time.monotonic() < deadline:
        got = sink.snapshot()
        due = [k for k in keys if k not in got or (
            got[k] < expect[k] if at_least else got[k] != expect[k])]
        if not due:
            break
        now = time.monotonic()
        for k in due:
            if now - sent.get(k, -SHARD_REPROBE_S) >= SHARD_REPROBE_S:
                sent[k] = now
                node.cluster.entity_ref("sentity", k).tell(("probe", cell))
        time.sleep(0.05)
    return sink.snapshot()


def shard_drive(label, fate, config, keys, nodes, tally):
    """The traffic, the fate of C and the checks of one phase-12 run on
    ``nodes`` (filled as the nodes are built, so the caller can stop
    them).  Returns the run's numbers."""
    plan = FaultPlan(12)
    n_keys = len(keys)
    full = {k: SHARD_WORK for k in keys}
    a = ShardNode("shardA", config, plan, tally)
    nodes.append(a)
    b = ShardNode("shardB", config, plan, tally)
    nodes.append(b)
    a.fabric.connect("127.0.0.1", b.port)
    if fate == "die":
        c = ShardNode("shardC", config, plan, tally)
        nodes.append(c)
        a.fabric.connect("127.0.0.1", c.port)
        b.fabric.connect("127.0.0.1", c.port)
    wait_for(f"{label}: the first table", lambda: shard_converged(nodes),
             SHARD_TIMEOUT_S)

    def send_round(r):
        for i, k in enumerate(keys):
            sender = (a, b)[(r * n_keys + i) % 2]
            sender.cluster.entity_ref("sentity", k).tell(("work",))

    t0 = time.perf_counter()
    send_round(0)
    wait_for(f"{label}: activation", lambda: sum(
        n.region.active_count() for n in nodes) == n_keys, SHARD_TIMEOUT_S)
    out = {"activate_s": time.perf_counter() - t0}
    for r in range(1, SHARD_WORK):
        if fate == "join" and r == SHARD_JOIN_ROUND:
            c = ShardNode("shardC", config, plan, tally)
            nodes.append(c)
            t_join = time.perf_counter()
            a.fabric.connect("127.0.0.1", c.port)
            b.fabric.connect("127.0.0.1", c.port)
        send_round(r)
    if fate == "join":
        wait_for(f"{label}: the rebalance", lambda: shard_converged(nodes)
                 and c.region.active_count() > 0, SHARD_TIMEOUT_S)
        out["rebalance_s"] = time.perf_counter() - t_join
        out["homed_on_c"] = sum(a.cluster.home_of(k) == c.address
                                for k in keys)
        counts = shard_probe(a, keys, full)
        check(counts == full, f"{label}: "
              f"{sum(counts.get(k) != SHARD_WORK for k in keys)} keys short "
              f"of {SHARD_WORK}")
        survivors = list(nodes)
    else:
        pre = shard_probe(a, keys, full)
        check(pre == full, f"{label}: before the death "
              f"{sum(pre.get(k) != SHARD_WORK for k in keys)} keys short of "
              f"{SHARD_WORK}")
        homed_c = {k for k in keys if a.cluster.home_of(k) == c.address}
        out["homed_on_c"] = len(homed_c)
        t_death = time.perf_counter()
        plan.isolate(c.address)
        c.system.engine.on_crash()
        survivors = [a, b]
        wait_for(f"{label}: the table without C",
                 lambda: shard_converged(survivors), SHARD_TIMEOUT_S)
        out["rebalance_s"] = time.perf_counter() - t_death
        counts = shard_probe(a, keys, pre, at_least=True)
        short = [k for k in keys if counts.get(k, -1) < pre[k]]
        check(not short, f"{label}: {len(short)} keys lost acked commands "
              f"after C died, e.g. {short[:3]}")
        moved = [k for k in keys if counts[k] != pre[k] and k not in homed_c]
        check(not moved, f"{label}: {len(moved)} keys homed on a survivor "
              f"changed count")
    names = [n.system.name for n in survivors]
    owners = set(a.cluster.table_snapshot().assignments.values())
    check(owners <= {n.address for n in survivors},
          f"{label}: a shard is owned outside the survivors: {owners}")

    # The hold: SHARD_HOLD_WAKES wakes on every survivor, no held child
    # of a live incarnation stops, every transient child on a survivor
    # is collected.
    held_stopped0 = tally.sums(names)[2]
    w0 = {n.system.name: n.wakes() for n in survivors}

    def held_enough():
        spawned, stopped, _, _ = tally.sums(names)
        return stopped == spawned and all(
            n.wakes() - w0[n.system.name] >= SHARD_HOLD_WAKES
            for n in survivors)

    wait_for(f"{label}: transient children on the survivors collected",
             held_enough, SHARD_TIMEOUT_S)
    spawned, stopped, held_stopped, held_alive = tally.sums(names)
    active = sum(n.region.active_count() for n in survivors)
    check(held_stopped == held_stopped0,
          f"{label}: {held_stopped - held_stopped0} held children of live "
          f"incarnations stopped in the hold")
    check(held_alive == active == n_keys,
          f"{label}: {held_alive} held children alive for {active} "
          f"incarnations of {n_keys} keys")
    check(tally.restored_refs == 0,
          f"{label}: {tally.restored_refs} incarnations restored a ref to "
          f"a stopped child")
    out["transient"] = (spawned, stopped)
    out["hold_wakes"] = {n.system.name: n.wakes() - w0[n.system.name]
                         for n in survivors}

    t0 = time.perf_counter()
    for k in keys:
        a.cluster.entity_ref("sentity", k).tell(("drop",))
    wait_for(f"{label}: held children collected after drop",
             lambda: tally.sums(names)[3] == 0, SHARD_TIMEOUT_S)
    out["collect_s"] = time.perf_counter() - t0
    check(all(n.cluster.migrations.pending_count() == 0 for n in survivors),
          f"{label}: migrations pending")
    check(a.table() == b.table(), f"{label}: A's and B's tables differ")
    out["names"] = names
    out["wakes"] = {n.system.name: n.wakes() for n in nodes}
    out["migrations"] = sum(n.cluster.migrations.completed for n in nodes)
    out["recovered"] = sum(n.cluster.journal.recovered_entities
                           for n in survivors)
    return out


def shard_run(label, backend, pipelined, fate, device, n_keys, errs):
    """One run of phase 12 (the module note).  Returns the launches per
    form of its collectors."""
    tally = ShardTally()
    journal_dir = tempfile.mkdtemp(prefix="uigc-shard-")
    config = {
        "uigc.crgc.shadow-graph": backend,
        "uigc.crgc.device": device,
        "uigc.crgc.trace-mode": "auto",
        "uigc.crgc.pipelined": pipelined,
        "uigc.crgc.wakeup-interval": 10,
        "uigc.crgc.egress-finalize-interval": 5,
        "uigc.crgc.num-nodes": 3,
        "uigc.cluster.tick-interval": 40,
        "uigc.cluster.handoff-retry": 120,
        "uigc.cluster.journal-dir": journal_dir,
    }
    if fate == "join":
        # The hold on a gained shard outlasts a handoff under load (as in
        # tests/test_cluster.py's rebalance under traffic).
        config["uigc.cluster.hold-timeout"] = 15000
    else:
        config.update(SHARD_HEARTBEAT)
    keys = [f"key-{i}" for i in range(n_keys)]
    nodes = []
    prop.reset_launches()
    try:
        with LaunchCapture() as cap, NodeLaunches() as nl, \
                OracleCheck(node_of=nl.current) as oc, HarvestCheck(oc), \
                EventLog() as log:
            try:
                r = shard_drive(label, fate, config, keys, nodes, tally)
            finally:
                # inside the counters: the last wakes' launches count in
                # both
                for n in nodes:
                    try:
                        n.system.terminate(timeout_s=5.0)
                    except Exception:
                        pass
    except (AssertionError, RuntimeError) as exc:
        raise SmokeFailure(f"sharding {label}: {exc} (oracle: "
                           f"{oc.mismatches} of {oc.traces} traces differ; "
                           f"first {oc.first})") from exc
    finally:
        shutil.rmtree(journal_dir, ignore_errors=True)
    launches = dict(prop.launches)
    by_node = dict(nl.by_node)
    traced = dict(oc.by_node)
    check(oc.mismatches == 0,
          f"sharding {label}: {oc.mismatches} of {oc.traces} traces differ "
          f"from trace_marks_np; first {oc.first}")
    for name in r["names"]:
        check(traced.get(name, 0) > 0,
              f"sharding {label}: no trace of {name} was checked: {traced}")
    if device == "cuda":
        check(None not in by_node and sum(by_node.values()) == sum(
            launches.values()), f"sharding {label}: launches outside a "
              f"collector: {by_node} against {launches}")
        for name in r["names"]:
            check(by_node.get(name, 0) > 0,
                  f"sharding {label}: {name}'s collector never launched: "
                  f"{by_node}")
    lat = log.durations.get(events.SHARD_MIGRATION, [])
    check(len(lat) == r["migrations"], f"sharding {label}: {len(lat)} "
          f"migration events for {r['migrations']} migrations")
    say(f"[sharding] {label} keys={n_keys} work={SHARD_WORK} "
        f"actors={n_keys * (SHARD_WORK + 2)} homed_on_c={r['homed_on_c']} "
        f"activate_s={r['activate_s']:.3f} "
        f"rebalance_s={r['rebalance_s']:.3f} "
        f"collect_s={r['collect_s']:.3f} "
        f"transient={r['transient'][0]}/{r['transient'][1]} "
        f"migrations={r['migrations']} "
        f"migration_mean_s={(np.mean(lat) if lat else 0.0):.4f} "
        f"migration_max_s={(max(lat) if lat else 0.0):.4f} "
        f"recovered={r['recovered']} hold_wakes={r['hold_wakes']} "
        f"wakes={r['wakes']} launches={launches} launches_by_node={by_node} "
        f"oracle_traces_by_node={traced}")
    if device == "cuda":
        live_kernel_checks(cap.kept, errs, f"sharding {label}")
    return launches


def phase_sharding(errs, device="cuda", n_keys=SHARD_KEYS):
    """Phase 12.  Returns the launches per form over its runs."""
    total = dict.fromkeys(prop.launches, 0)
    for label, backend, pipelined, fate in SHARD_RUNS:
        for form, count in shard_run(label, backend, pipelined, fate,
                                     device, n_keys, errs).items():
            total[form] += count
    say(f"[sharding] launches={total}")
    return total


# --------------------------------------------------------------------- #
# 13. the ingress gateway
# --------------------------------------------------------------------- #


class GEntity(SEntity):
    """Phase 13's entity: phase 12's, driven through the gateway.  A
    ``("gw-cmd", ref, seq, cmd)`` with op "work" or "drop" runs that
    command, "probe" only reads; each is acked with the count after it
    (``ref.tell(("ack", seq, count))``)."""

    def receive(self, msg):
        if msg[0] != "gw-cmd":
            return super().receive(msg)
        _kind, ref, seq, cmd = msg
        op = cmd.get("op") if isinstance(cmd, dict) else None
        if op in ("work", "drop"):
            super().receive((op,))
        ref.tell(("ack", seq, self.count))
        return self


class GatewayNode:
    """The gateway node of phase 13: a proxy-only cluster member (it owns
    no shard) with an IngressGateway listening for clients."""

    def __init__(self, name, config, plan):
        self.fabric = NodeFabric(fault_plan=plan)
        self.system = ActorSystem(None, name=name, config=config,
                                  fabric=self.fabric)
        self.port = self.fabric.listen()
        self.address = self.system.address
        self.cluster = ClusterSharding.attach(self.system, proxy_only=True)
        self.gateway = IngressGateway(self.system)
        self.client_port = self.gateway.listen()


class GwClient:
    """One raw-TCP client connection (the framing of
    tools/ingress_bench.py's BenchClient, through the port's protocol)
    with a reader thread tallying ACKs and their latency, and the
    seq-addressed ERROR frames."""

    def __init__(self, port, tenant):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.lock = threading.Lock()
        self.sent_at = {}
        self.acked = {}  # seq -> (result, latency_s)
        self.errors = {}  # seq -> (code, retry_after_ms)
        self.anon_errors = []
        self.closed = False
        self.seq = 0
        self.auth_ok = threading.Event()
        self.reader = threading.Thread(target=self._read_loop, daemon=True)
        self.reader.start()
        self.sock.sendall(gw_protocol.encode_frame(
            gw_protocol.OP_CONNECT, {"tenant": tenant, "proto": 1}))
        check(self.auth_ok.wait(20.0),
              f"gateway: no AUTH_OK for a client of tenant {tenant}")

    def _read_loop(self):
        buf = bytearray()
        while True:
            try:
                data = self.sock.recv(65536)
            except OSError:
                data = b""
            if not data:
                self.closed = True
                return
            buf += data
            while len(buf) >= 4:
                (n,) = struct.unpack_from(">I", buf, 0)
                if len(buf) < 4 + n:
                    break
                op, value = gw_protocol.decode_frame_body(bytes(buf[4:4 + n]))
                del buf[:4 + n]
                now = time.perf_counter()
                if op == gw_protocol.OP_AUTH_OK:
                    self.auth_ok.set()
                elif op == gw_protocol.OP_ACK and isinstance(value, dict):
                    seq = value.get("seq")
                    with self.lock:
                        t0 = self.sent_at.get(seq)
                        self.acked[seq] = (value.get("result"), (
                            now - t0) if t0 is not None else 0.0)
                elif op == gw_protocol.OP_ERROR and isinstance(value, dict):
                    with self.lock:
                        if "seq" in value:
                            self.errors[value["seq"]] = (
                                value.get("code"), value.get("retry_after_ms"))
                        else:
                            self.anon_errors.append(value.get("code"))

    def send_cmd(self, seq, key, cmd):
        frame = gw_protocol.encode_frame(gw_protocol.OP_SEND, {
            "seq": seq, "type": "gentity", "key": key, "cmd": cmd})
        with self.lock:
            self.sent_at[seq] = time.perf_counter()
        self.sock.sendall(frame)

    def next_seq(self):
        with self.lock:
            self.seq += 1
            return self.seq

    def unresolved(self):
        with self.lock:
            return [s for s in self.sent_at
                    if s not in self.acked and s not in self.errors]

    def close(self):
        for fn in (lambda: self.sock.shutdown(socket.SHUT_RDWR),
                   self.sock.close):
            try:
                fn()
            except OSError:
                pass


def gw_resolved(clients):
    return all(not c.unresolved() for c in clients)


def front_door(label, clients, items, rate):
    """Send each (key, cmd) of ``items`` through the gateway, spread over
    ``clients`` and paced at ``rate`` msgs/s per client; re-send what was
    shed (a clean, seq-addressed ERROR) after its retry-after, for up to
    GATEWAY_RETRY_ROUNDS rounds.  Returns (the acked result of each item
    by index, the sheds)."""
    pending = list(range(len(items)))
    results, sheds = {}, 0
    for _ in range(GATEWAY_RETRY_ROUNDS):
        if not pending:
            break
        seqs = [{} for _ in clients]

        def pump(ci):
            client, burst = clients[ci], 16
            mine = pending[ci::len(clients)]
            for j in range(0, len(mine), burst):
                t0 = time.perf_counter()
                for idx in mine[j:j + burst]:
                    seq = client.next_seq()
                    seqs[ci][seq] = idx
                    client.send_cmd(seq, *items[idx])
                pause = burst / rate - (time.perf_counter() - t0)
                if pause > 0:
                    time.sleep(pause)

        threads = [threading.Thread(target=pump, args=(ci,), daemon=True)
                   for ci in range(len(clients))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wait_for(f"{label}: every command through the front door resolved",
                 lambda: gw_resolved(clients), GATEWAY_TIMEOUT_S)
        pending, retry_ms = [], 0
        for client, sent in zip(clients, seqs):
            with client.lock:
                for seq, idx in sent.items():
                    if seq in client.acked:
                        results[idx] = client.acked[seq][0]
                    else:
                        pending.append(idx)
                        retry_ms = max(retry_ms, client.errors[seq][1] or 0)
        sheds += len(pending)
        if pending:
            time.sleep(retry_ms / 1e3)
    check(not pending, f"{label}: {len(pending)} commands still shed after "
          f"{GATEWAY_RETRY_ROUNDS} rounds")
    return results, sheds


def percentile(samples, p):
    return float(np.percentile(samples, p)) if samples else 0.0


def gw_metrics(gw):
    """The gateway node's Prometheus samples of uigc_gateway_connections
    and uigc_gateway_shed_total (summed over reasons; None without
    telemetry metrics on the node, whose event bridge counts it).
    Without them the gauge is read through a registry of the system's
    gauges alone (install_system_gauges), which needs no events."""
    tel = gw.system.telemetry
    if tel is not None:
        registry = tel.registry
    else:
        registry = MetricsRegistry()
        install_system_gauges(registry, gw.system)
    out = {"connections": None,
           "shed_total": 0.0 if tel is not None else None}
    for line in prometheus_text(registry).splitlines():
        name = re.match(r"(\w+)(\{[^}]*\})? ", line)
        if name and name.group(1) == "uigc_gateway_connections":
            out["connections"] = float(line.split()[-1])
        elif name and name.group(1) == "uigc_gateway_shed_total":
            out["shed_total"] += float(line.split()[-1])
    return out


def gw_connection_scale(label, gw):
    """600 concurrent connections, each CONNECT -> AUTH_OK, all held at
    once; the gateway's count and its gauge must read them all."""
    frame = gw_protocol.encode_frame(gw_protocol.OP_CONNECT,
                                     {"tenant": "scale", "proto": 1})
    socks = []
    t0 = time.perf_counter()
    try:
        for _ in range(GATEWAY_CONNECTIONS):
            sock = socket.create_connection(("127.0.0.1", gw.client_port))
            sock.settimeout(20.0)
            sock.sendall(frame)
            head = b""
            while len(head) < 4:
                chunk = sock.recv(4 - len(head))
                check(chunk, f"{label}: the gateway closed a CONNECT")
                head += chunk
            (n,) = struct.unpack(">I", head)
            body = b""
            while len(body) < n:
                chunk = sock.recv(n - len(body))
                check(chunk, f"{label}: the gateway closed a CONNECT")
                body += chunk
            op, _value = gw_protocol.decode_frame_body(body)
            check(op == gw_protocol.OP_AUTH_OK,
                  f"{label}: CONNECT answered by op {op}")
            socks.append(sock)
        seconds = time.perf_counter() - t0
        held = gw.gateway.connection_count()
        gauge = gw_metrics(gw)["connections"]
    finally:
        for sock in socks:
            sock.close()
    check(held == GATEWAY_CONNECTIONS and gauge == GATEWAY_CONNECTIONS,
          f"{label}: {held} connections held, gauge {gauge}, of "
          f"{GATEWAY_CONNECTIONS}")
    wait_for(f"{label}: the scale connections closed",
             lambda: gw.gateway.connection_count() == 0, GATEWAY_TIMEOUT_S)
    return {"connections": held, "connect_s": seconds,
            "connect_per_s": len(socks) / seconds, "gauge": gauge}


def gw_storm(label, gw, keys):
    """tools/ingress_bench.py's overload phase: GATEWAY_STORM_CLIENTS
    clients of one tenant drive 10x its quota for GATEWAY_STORM_S over
    the keyspace.  Every send must resolve to an ACK or a clean ERROR."""
    clients = [GwClient(gw.client_port, "bench")
               for _ in range(GATEWAY_STORM_CLIENTS)]
    per_client = GATEWAY_CAPACITY * 10 // len(clients)
    stop = threading.Event()

    def storm(ci, client):
        burst, i = 32, ci
        while not stop.is_set():
            t0 = time.perf_counter()
            for _ in range(burst):
                client.send_cmd(client.next_seq(), keys[i % len(keys)],
                                {"op": "work"})
                i += len(clients)
            pause = burst / per_client - (time.perf_counter() - t0)
            if pause > 0:
                time.sleep(pause)

    threads = [threading.Thread(target=storm, args=(ci, c), daemon=True)
               for ci, c in enumerate(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(GATEWAY_STORM_S)
    stop.set()
    for t in threads:
        t.join()
    storm_s = time.perf_counter() - t0
    wait_for(f"{label}: every storm send resolved",
             lambda: gw_resolved(clients) or any(c.closed for c in clients),
             GATEWAY_TIMEOUT_S)
    check(gw_resolved(clients), f"{label}: storm sends unresolved "
          f"{[len(c.unresolved()) for c in clients]}, clients closed "
          f"{[c.closed for c in clients]}, gateway {dict(gw.gateway.stats)}")
    sent = sum(len(c.sent_at) for c in clients)
    acked = sum(len(c.acked) for c in clients)
    errors = sum(len(c.errors) for c in clients)
    shed = sent - acked
    latencies = [lat for c in clients for _r, lat in c.acked.values()]
    high = {}
    for ci, c in enumerate(clients):
        for seq, (result, _lat) in c.acked.items():
            key = keys[(ci + (seq - 1) * len(clients)) % len(keys)]
            high[key] = max(high.get(key, 0), result)
    anon = sum(len(c.anon_errors) for c in clients)
    for c in clients:
        c.close()
    check(errors == shed and anon == 0,
          f"{label}: {shed} sends shed, {errors} clean ERRORs, {anon} "
          f"without a seq")
    return high, {"storm_s": storm_s, "sent": sent, "acked": acked,
                  "shed": shed, "clean_shed_fraction": (
                      errors / shed if shed else 1.0),
                  "admitted_per_s": acked / storm_s,
                  "admitted_p50_ms": percentile(latencies, 50) * 1e3,
                  "admitted_p99_ms": percentile(latencies, 99) * 1e3}


def gw_pump_and_die(label, gw, keys, victim, plan, survivors, worked):
    """tests/test_gateway.py's chaos run at the phase's scale: a FLOOD
    fault burns on the first accept, GATEWAY_PUMP_CLIENTS clients pump
    over the keyspace, ``victim`` dies silently after
    GATEWAY_DIE_AFTER_S once ``worked()`` (its collector launched the
    kernel, or traced off the card), the pumps go on until the survivors
    and the gateway see it gone and a while after; then every send
    resolves, after bounded retries of the same seq.  Returns the highest
    acked count per key, the keys sent to, and the run's numbers."""
    burn = socket.create_connection(("127.0.0.1", gw.client_port), timeout=5)
    burn.settimeout(10.0)
    try:
        answer = burn.recv(64)
    except ConnectionError:  # a reset is a slammed socket too
        answer = b""
    burn.close()
    check(answer == b"", f"{label}: the flooded accept answered {answer!r}")
    wait_for(f"{label}: the FLOOD fault did not burn on the first accept",
             lambda: gw.gateway.stats["shed:flood"] == 1, GATEWAY_TIMEOUT_S)
    clients = [GwClient(gw.client_port, f"t{i}")
               for i in range(GATEWAY_PUMP_CLIENTS)]
    stop = threading.Event()
    key_of = [{} for _ in clients]

    def pump(ci, client):
        i = ci * len(keys) // len(clients)
        while not stop.is_set():
            seq, key = client.next_seq(), keys[i % len(keys)]
            key_of[ci][seq] = key
            try:
                client.send_cmd(seq, key, {"op": "work"})
            except OSError:
                return
            i += 1
            time.sleep(0.01)

    threads = [threading.Thread(target=pump, args=(ci, c), daemon=True)
               for ci, c in enumerate(clients)]
    for t in threads:
        t.start()
    time.sleep(GATEWAY_DIE_AFTER_S)
    # The victim's journaling dispatchers leave its collector a few wakes
    # in that time; it dies once it has traced (launched, on the card).
    wait_for(f"{label}: the victim's collector never traced",
             worked, GATEWAY_TIMEOUT_S)
    homed = sum(gw.cluster.home_of(k) == victim.address for k in keys)
    t_death = time.perf_counter()
    plan.isolate(victim.address)
    victim.system.engine.on_crash()
    wait_for(f"{label}: the survivors and the gateway without the victim",
             lambda: shard_converged(survivors) and sorted(
                 gw.cluster.members()) == sorted(
                     n.address for n in survivors), GATEWAY_TIMEOUT_S)
    rebalance_s = time.perf_counter() - t_death
    time.sleep(GATEWAY_DIE_AFTER_S)
    stop.set()
    for t in threads:
        t.join()
    retried = 0
    for _ in range(4):
        deadline = time.monotonic() + 20.0
        while not gw_resolved(clients) and time.monotonic() < deadline:
            time.sleep(0.05)
        if gw_resolved(clients):
            break
        for ci, c in enumerate(clients):
            for seq in c.unresolved():
                retried += 1
                c.send_cmd(seq, key_of[ci][seq], {"op": "work"})
    unresolved = sum(len(c.unresolved()) for c in clients)
    check(unresolved == 0, f"{label}: {unresolved} sends never resolved")
    sent = sum(len(c.sent_at) for c in clients)
    acked = sum(len(c.acked) for c in clients)
    errors = sum(len(c.errors) for c in clients)
    check(acked > 0 and acked + errors == sent,
          f"{label}: {acked} acked + {errors} errors of {sent} sends")
    high = {}
    for ci, c in enumerate(clients):
        for seq, (result, _lat) in c.acked.items():
            key = key_of[ci][seq]
            high[key] = max(high.get(key, 0), result)
    for c in clients:
        c.close()
    latencies = [lat for c in clients for _r, lat in c.acked.values()]
    return high, sorted({k for m in key_of for k in m.values()}), {
        "sent": sent, "acked": acked, "errors": errors, "retried": retried,
        "homed_on_victim": homed, "rebalance_s": rebalance_s,
        "admitted_p50_ms": percentile(latencies, 50) * 1e3,
        "admitted_p99_ms": percentile(latencies, 99) * 1e3}


def gateway_drive(label, n_data, fate, config, keys, nodes, tally, worked):
    """The topology, the traffic and the checks of one phase-13 run on
    ``nodes`` (filled as the nodes are built, so the caller can stop
    them); ``worked(name)`` says whether a node's collector has worked.
    Returns the run's numbers."""
    plan = FaultPlan(13)
    if fate == "die":
        plan.client_fault(FLOOD, count=1)
    data = []
    for i in range(n_data):
        node = ShardNode(f"gwd{'ABC'[i]}", config, plan, tally,
                         type_name="gentity", entity=GEntity)
        nodes.append(node)
        data.append(node)
    # Telemetry metrics turn on the process-global event recorder for all
    # four nodes of this process.  Under the storm (a), whose every shed
    # commits an event from a gateway reader, its lock convoys with the
    # interpreter lock and the readers fall seconds behind (PERF.md), so
    # only (b) counts uigc_gateway_shed_total through the event bridge.
    gw = GatewayNode("gwG", dict(
        config, **{"uigc.telemetry.metrics": fate == "die"}), plan)
    nodes.append(gw)
    for i, a in enumerate(data):
        for b in data[i + 1:]:
            a.fabric.connect("127.0.0.1", b.port)
    for n in data:
        gw.fabric.connect("127.0.0.1", n.port)
    wait_for(f"{label}: the edge settled", lambda: shard_converged(data)
             and sorted(gw.cluster.members()) == sorted(
                 n.address for n in data)
             and gw.cluster.home_of(keys[0]) is not None, GATEWAY_TIMEOUT_S)
    out = {"gw": gw, "data": [n.system.name for n in data]}
    if fate == "overload":
        out.update(gw_connection_scale(label, gw))
        fillers = [GwClient(gw.client_port, f"fill{i}")
                   for i in range(GATEWAY_FILL_TENANTS)]
        items = [(k, {"op": "work"}) for _ in range(GATEWAY_FILL)
                 for k in keys]
        t0 = time.perf_counter()
        filled, out["fill_sheds"] = front_door(
            f"{label}: fill", fillers, items, GATEWAY_CAPACITY * 0.9)
        out["fill_s"] = time.perf_counter() - t0
        high = {}
        for idx, result in filled.items():
            high[items[idx][0]] = max(high.get(items[idx][0], 0), result)
        check(all(high.get(k) == GATEWAY_FILL for k in keys),
              f"{label}: after the fill "
              f"{sum(high.get(k) != GATEWAY_FILL for k in keys)} keys short "
              f"of {GATEWAY_FILL}")
        storm_high, storm = gw_storm(label, gw, keys)
        out.update(storm)
        for k, v in storm_high.items():
            high[k] = max(high[k], v)
        survivors, probed_keys = data, keys
    else:
        survivors = data[:2]
        high, probed_keys, pumped = gw_pump_and_die(
            label, gw, keys, data[2], plan, survivors,
            lambda: worked(data[2].system.name))
        out.update(pumped)
        fillers = [GwClient(gw.client_port, f"probe{i}")
                   for i in range(GATEWAY_FILL_TENANTS)]
    # acked-then-lost: every probed key's count covers its highest ACK
    probes, _ = front_door(f"{label}: probes", fillers,
                           [(k, {"op": "probe"}) for k in probed_keys],
                           GATEWAY_CAPACITY * 0.9)
    finals = {probed_keys[i]: r for i, r in probes.items()}
    lost = [k for k, h in high.items() if finals.get(k, -1) < h]
    out["probed"] = len(finals)
    out["acked_then_lost"] = len(lost)
    check(not lost, f"{label}: {len(lost)} keys lost acked commands, e.g. "
          f"{[(k, high[k], finals.get(k)) for k in lost[:3]]}")
    names = [n.system.name for n in survivors]
    active = sum(n.region.active_count() for n in survivors)

    # The hold: SHARD_HOLD_WAKES wakes on every surviving data node, no
    # held child of a live incarnation stops, every transient child on a
    # survivor is collected.
    held_stopped0 = tally.sums(names)[2]
    w0 = {n.system.name: n.wakes() for n in survivors}

    def held_enough():
        spawned, stopped, _, _ = tally.sums(names)
        return stopped == spawned and all(
            n.wakes() - w0[n.system.name] >= SHARD_HOLD_WAKES
            for n in survivors)

    wait_for(f"{label}: transient children collected", held_enough,
             GATEWAY_TIMEOUT_S)
    spawned, stopped, held_stopped, held_alive = tally.sums(names)
    check(held_stopped == held_stopped0,
          f"{label}: {held_stopped - held_stopped0} held children of live "
          f"incarnations stopped in the hold")
    check(held_alive == active, f"{label}: {held_alive} held children alive "
          f"for {active} incarnations")
    check(tally.restored_refs == 0,
          f"{label}: {tally.restored_refs} incarnations restored a ref to "
          f"a stopped child")
    out["transient"] = (spawned, stopped)
    t0 = time.perf_counter()
    front_door(f"{label}: drops", fillers,
               [(k, {"op": "drop"}) for k in probed_keys],
               GATEWAY_CAPACITY * 0.9)
    wait_for(f"{label}: held children collected after drop",
             lambda: tally.sums(names)[3] == 0, GATEWAY_TIMEOUT_S)
    out["collect_s"] = time.perf_counter() - t0
    for c in fillers:
        c.close()
    out["recovered"] = sum(n.cluster.journal.recovered_entities
                           for n in survivors) if fate == "die" else 0
    if fate == "die":
        check(out["recovered"] > 0,
              f"{label}: no entity of the victim recovered from the journal")
    out["stats"] = dict(gw.gateway.stats)
    out["metrics"] = gw_metrics(gw)
    shed = sum(v for k, v in out["stats"].items() if k.startswith("shed:"))
    check(out["metrics"]["shed_total"] in (None, shed),
          f"{label}: uigc_gateway_shed_total {out['metrics']['shed_total']} "
          f"against the gateway's {shed} sheds")
    out["names"] = names
    out["wakes"] = {n.system.name: n.wakes() for n in data}
    return out


def gateway_run(label, backend, pipelined, n_data, fate, device, n_keys, errs):
    """One run of phase 13 (the module note).  Returns the launches per
    form of its collectors."""
    tally = ShardTally()
    journal_dir = tempfile.mkdtemp(prefix="uigc-gateway-")
    config = {
        "uigc.crgc.shadow-graph": backend,
        "uigc.crgc.device": device,
        "uigc.crgc.trace-mode": "auto",
        "uigc.crgc.pipelined": pipelined,
        "uigc.crgc.wakeup-interval": 50,
        "uigc.crgc.egress-finalize-interval": 10,
        "uigc.crgc.num-nodes": n_data + 1,
        "uigc.cluster.tick-interval": 40,
        "uigc.cluster.handoff-retry": 150,
        "uigc.runtime.throughput": 256,
        "uigc.node.max-batch-frames": 1024,
        "uigc.node.writer-queue-limit": 32768,
        "uigc.gateway.tenant-msgs-per-sec": (
            GATEWAY_CAPACITY if fate == "overload" else 0),
        "uigc.gateway.tenant-max-connections": 4096,
        "uigc.gateway.egress-queue-limit": 1024,
        "uigc.gateway.reader-threads": 2,
    }
    config.update(SHARD_HEARTBEAT)
    if fate == "die":
        config["uigc.cluster.journal-dir"] = journal_dir
    keys = [f"key-{i}" for i in range(n_keys)]
    nodes = []
    prop.reset_launches()
    try:
        with LaunchCapture() as cap, NodeLaunches() as nl, \
                OracleCheck(node_of=nl.current) as oc, HarvestCheck(oc):
            try:
                # a node has worked once its collector launched the
                # kernel (on the card) or had a trace checked (CPU)
                r = gateway_drive(
                    label, n_data, fate, config, keys, nodes, tally,
                    lambda name: (nl.by_node if device == "cuda"
                                  else oc.by_node)[name] > 0)
            finally:
                # inside the counters: the last wakes' launches count
                for n in nodes:
                    if isinstance(n, GatewayNode):
                        n.gateway.close()
                for n in nodes:
                    try:
                        n.system.terminate(timeout_s=5.0)
                    except Exception:
                        pass
    except (AssertionError, RuntimeError, OSError) as exc:
        raise SmokeFailure(f"gateway {label}: {exc} (oracle: "
                           f"{oc.mismatches} of {oc.traces} traces differ; "
                           f"first {oc.first})") from exc
    finally:
        shutil.rmtree(journal_dir, ignore_errors=True)
    launches = dict(prop.launches)
    by_node = dict(nl.by_node)
    traced = dict(oc.by_node)
    check(oc.mismatches == 0,
          f"gateway {label}: {oc.mismatches} of {oc.traces} traces differ "
          f"from trace_marks_np; first {oc.first}")
    for name in r["data"]:
        check(traced.get(name, 0) > 0,
              f"gateway {label}: no trace of {name} was checked: {traced}")
    if device == "cuda":
        check(None not in by_node and sum(by_node.values()) == sum(
            launches.values()), f"gateway {label}: launches outside a "
              f"collector: {by_node} against {launches}")
        for name in r["data"]:
            check(by_node.get(name, 0) > 0,
                  f"gateway {label}: {name}'s collector never launched: "
                  f"{by_node}")
    numbers = " ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in r.items() if k not in ("gw", "names", "data", "stats",
                                           "metrics", "wakes"))
    say(f"[gateway] {label} keys={n_keys} data_nodes={n_data} {numbers} "
        f"stats={r['stats']} metrics={r['metrics']} wakes={r['wakes']} "
        f"launches={launches} launches_by_node={by_node} "
        f"oracle_traces_by_node={traced}")
    if device == "cuda":
        live_kernel_checks(cap.kept, errs, f"gateway {label}")
    return launches


def phase_gateway(errs, device="cuda", n_keys=GATEWAY_KEYS):
    """Phase 13.  Returns the launches per form over its runs."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = 4 * GATEWAY_CONNECTIONS + 1024
    if soft != resource.RLIM_INFINITY and soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (
            want if hard == resource.RLIM_INFINITY else min(want, hard), hard))
    total = dict.fromkeys(prop.launches, 0)
    for label, backend, pipelined, n_data, fate in GATEWAY_RUNS:
        for form, count in gateway_run(label, backend, pipelined, n_data,
                                       fate, device, n_keys, errs).items():
            total[form] += count
    say(f"[gateway] launches={total}")
    return total


# --------------------------------------------------------------------- #
# 14. the static checker and the operator tools
# --------------------------------------------------------------------- #


def tools_checker_start(root):
    """14a: the port's checker and linter, --strict over the package, in
    subprocesses (this machine has no JAX: they need neither it nor the
    reference), started together; 14c runs while they do.  Returns
    {module: (process, start time)}."""
    procs = {}
    for module in ("uigc_check", "uigc_lint"):
        args = [sys.executable, "-m", f"uigc_tpu_torch.tools.{module}",
                "--strict", "uigc_tpu_torch/"]
        if module == "uigc_check":
            args.append("--json")
        procs[module] = (subprocess.Popen(
            args, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), time.perf_counter())
    return procs


def tools_checker_finish(procs):
    """14a's verdicts: rc 0, no SKIP, every pass run, nothing fresh."""
    for module, (proc, t0) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=TOOLS_CHECK_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"tools: {module} --strict exited {proc.returncode}: "
              f"{(stdout + stderr)[-2000:]}")
        check("SKIP" not in stderr,
              f"tools: {module} skipped a pass: {stderr[-1000:]}")
        if module == "uigc_check":
            doc = json.loads(stdout)
            passes = doc["passes"]
            check(sorted(passes) == sorted(TOOLS_PASSES) and all(
                passes[p]["status"] == "ok" for p in TOOLS_PASSES),
                f"tools: uigc_check passes {passes}")
            check(doc["fresh"] == [], f"tools: fresh findings {doc['fresh']}")
            say(f"[tools] uigc_check --strict uigc_tpu_torch/: rc=0 "
                f"files={doc['files']} findings per pass "
                + " ".join(f"{p}={passes[p]['findings']}"
                           for p in TOOLS_PASSES)
                + f" grandfathered={doc['grandfathered']} fresh=0 "
                f"locks={passes['locks']['locks']} "
                f"lock_edges={passes['locks']['edges']} "
                f"purity_entries={passes['purity']['entries']} "
                f"eager_device_functions={passes['purity']['eager']} "
                f"(run beside 14c, done within {seconds:.1f} s)")
        else:
            tail = stderr.strip().splitlines()
            say(f"[tools] uigc_lint --strict uigc_tpu_torch/: rc=0 "
                f"{tail[-1] if tail else 'clean'} (done within "
                f"{seconds:.1f} s)")


def tools_profile(graph, prep, jump_parent, marks, kernels, device):
    """14b: sweep_profile on phase 4's graph and layout, both gate forms:
    the marks of every mode equal phase 4's, and the launch counters
    move by exactly the kernel calls the profile reports.  Returns the
    launches per form."""
    dev = torch.device(device)
    lay = ct.layout_to_device(prep, dev)
    prop.reset_launches()
    t0 = time.perf_counter()
    doc = sweep_profile.profile(graph, lay, jump_parent, device=dev,
                                reps=TOOLS_PROFILE_REPS)
    seconds = time.perf_counter() - t0
    launches = dict(prop.launches)
    del lay
    probes = 3 * (TOOLS_PROFILE_REPS + 1)
    for form in sweep_profile.FORMS:
        want = probes + 2 * sum(row["n_sweeps"]
                                for mode, row in doc["modes"].items()
                                if sweep_profile.MODE_FORM[mode] == form)
        check(doc["launches"][form] == want,
              f"tools: the profile reports {doc['launches'][form]} {form} "
              f"calls, its probes and sweeps make {want}")
        if dev.type == "cuda":
            check(launches[form] == want,
                  f"tools: {form} launched {launches[form]} times in the "
                  f"profile, which reports {want} (probes {probes} and two "
                  f"runs of its sweeps)")
    for mode, got in doc["marks"].items():
        check(np.array_equal(got, marks),
              f"tools: sweep_profile's {mode} marks differ from phase 4's")
    say(f"[tools] sweep_profile n={doc['n_actors']} blocks={doc['n_blocks']} "
        f"walk_groups={doc['n_chunks']} reps={TOOLS_PROFILE_REPS} "
        f"seconds={seconds:.2f} launches={launches} "
        f"reported={doc['launches']}; marks of "
        f"{sorted(doc['marks'])} equal to phase 4's")
    for form in sweep_profile.FORMS:
        p4 = kernels.get(form, {}).get("ms")
        say(f"[tools] sweep_profile {form}: full_dirty_ms="
            f"{doc['sweep_full_dirty_ms'][form]:.4f} (phase 4 in this run: "
            f"{'%.4f' % p4 if p4 is not None else 'not run'}) "
            f"half_dirty_ms={doc['sweep_half_dirty_ms'][form]:.4f} "
            f"no_dirty_ms={doc['sweep_no_dirty_ms'][form]:.4f}")
    say(f"[tools] sweep_profile packs: pack_bools_ms="
        f"{doc['pack_bools_ms']:.4f} pack_hits_words_ms="
        f"{doc['pack_hits_words_ms']:.4f}")
    for mode, row in doc["modes"].items():
        say(f"[tools] sweep_profile mode={mode} n_sweeps={row['n_sweeps']} "
            f"host_syncs={row['host_syncs']} fixpoint_ms="
            f"{row['fixpoint_ms']:.3f} kernel_ms={row['kernel_ms']:.3f} "
            f"kernel_share={row['kernel_ms'] / row['fixpoint_ms']:.3f} "
            f"glue_ms={row['glue_ms']:.3f} glue_per_sweep_ms="
            f"{row['glue_per_sweep_ms']:.4f} dirty_groups={row['dirty_chunks']} "
            f"changed_supers={row['changed_supers']} "
            f"tiles_skipped={row['tiles_skipped']} pull_on={row['pull_on']}")
    return launches


class TraceLaunches:
    """The kernel launches of each collector trace of a one-system run:
    wraps ArrayShadowGraph.compute_marks (the ``device`` backend traces
    through it once per traced wake) and logs the propagate kernel's
    launches (both forms; not the jump kernel's) around each call."""

    def __init__(self):
        self.deltas = []
        self._plain = arrays.ArrayShadowGraph.compute_marks

    def __enter__(self):
        plain = self._plain

        def propagate_launches():
            return prop.launches["propagate"] + prop.launches["propagate_gated"]

        def logged(graph):
            before = propagate_launches()
            out = plain(graph)
            self.deltas.append(propagate_launches() - before)
            return out

        arrays.ArrayShadowGraph.compute_marks = logged
        return self

    def __exit__(self, *exc):
        arrays.ArrayShadowGraph.compute_marks = self._plain


def tool_main(main, args):
    """A tool's main(args) with its standard output captured: (rc, out)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    return rc, buf.getvalue()


def snapshot_live_set(snap):
    """The keys a snapshot's own reachability marks: BFS from its
    pseudoroots over positive created edges and supervisor pointers,
    halted actors absorbing (why_live's traversal, once for all)."""
    actors = snap["actors"]
    out_edges = {}
    for src, dst, weight in snap.get("edges", []):
        if weight > 0:
            out_edges.setdefault(src, []).append(dst)
    for child, parent in snap.get("supervisors", []):
        out_edges.setdefault(child, []).append(parent)
    seen = {k for k, rec in actors.items() if rec["pseudoroot"]}
    frontier = list(seen)
    while frontier:
        cur = frontier.pop()
        if actors[cur].get("halted"):
            continue
        for dst in out_edges.get(cur, ()):
            if dst not in seen and dst in actors:
                seen.add(dst)
                frontier.append(dst)
    return seen


def tools_live_probe(log, jsonl_path):
    def probe(system, stage):
        if stage != "held":
            return None
        tel = system.telemetry
        base = f"http://127.0.0.1:{tel.http.port}"
        res = {"base": base}
        # device_report --url: the doc and the rendered report
        rc, out = tool_main(device_report.main, ["--url", base, "--json"])
        res["device_rc"], res["device_doc"] = rc, json.loads(out)
        res["trace_launches"] = list(log.deltas)
        rc, res["device_report"] = tool_main(device_report.main,
                                             ["--url", base])
        res["device_report_rc"] = rc
        # graph_inspect --url: snapshot, why-live of a leaf, self-check
        rc, out = tool_main(graph_inspect.main,
                            ["snapshot", "--url", base, "--json"])
        snap = json.loads(out)
        res["snapshot_rc"] = rc
        res["snapshot_actors"] = len(snap["actors"])
        leaf = max(snap["actors"].values(),
                   key=lambda rec: (rec["name"].count("/"), rec["key"]))["key"]
        rc, out = tool_main(graph_inspect.main,
                            ["why-live", leaf, "--url", base, "--json"])
        leaf_result = json.loads(out)
        res["why_live_rc"] = rc
        res["why_live_leaf"] = (leaf_result.get("verdict"),
                                len(leaf_result.get("path", [])),
                                leaf_result.get("parents"))
        problems = [f"{leaf}: {p}" for p in
                    tel_inspect.validate_why_live(snap, leaf_result)]
        rng = np.random.default_rng(14)
        keys = sorted(snap["actors"])
        sample = [keys[i] for i in rng.choice(len(keys), TOOLS_WHY_LIVE_SAMPLE,
                                               replace=False)]
        for key in sample:
            result = tel_inspect.why_live(snap, key)
            problems += [f"{key}: {p}" for p in
                         tel_inspect.validate_why_live(snap, result)]
        res["selfcheck_problems"] = problems
        res["selfcheck_checked"] = 1 + len(sample)
        # The graph gains actors as their entries arrive while the tree
        # is held (nothing leaves it), so the oracle, read after the
        # snapshot, is judged over the actors the snapshot holds.
        graph = system.engine.bookkeeper.shadow_graph
        mark = graph_oracle(graph)
        live = {tel_inspect._cell_key(cell)
                for cell, slot in list(graph.slot_of.items())
                if slot < mark.size and mark[slot]}
        res["oracle_marked"] = len(live)
        res["oracle_live"] = live & set(snap["actors"])
        res["snapshot_live"] = snapshot_live_set(snap)
        # telemetry_dump --from-jsonl against a live scrape, the event
        # stream paused so both see the same events
        events.recorder.disable()
        try:
            time.sleep(0.2)  # commits in flight reach every listener
            tel.jsonl.flush()
            with urllib.request.urlopen(base + "/metrics.json",
                                        timeout=30) as rsp:
                res["scrape"] = json.loads(rsp.read())
            rc, out = tool_main(telemetry_dump.main,
                                ["--from-jsonl", jsonl_path, "--format",
                                 "json"])
            res["replay_rc"], res["replay"] = rc, json.loads(out)
        finally:
            events.recorder.enable()
        # uigc_top --url --once --plain
        res["top_rc"], res["top"] = tool_main(
            uigc_top.main, ["--url", base, "--once", "--plain"])
        return res

    return probe


def counter_samples(snapshot):
    """{(metric, suffix, labels without node): value} of a registry
    snapshot's counters."""
    out = {}
    for name, entry in snapshot.items():
        if entry.get("kind") != "counter":
            continue
        for sample in entry["samples"]:
            labels = tuple(sorted((k, v) for k, v in sample["labels"].items()
                                  if k != "node"))
            out[(name, sample["suffix"], labels)] = sample["value"]
    return out


def tools_live(device):
    """14c: phase 6's tree on ``device`` auto with the device observatory,
    the inspector, the time series, a JSONL sink and an HTTP port on;
    while it is held, each tool reads the live node.  Returns the run's
    launches per form."""
    label = f"tree{TOOLS_TREE['n_actors'] // 1000}k/device/auto/tools"
    sink_dir = tempfile.mkdtemp(prefix="uigc_tools_")
    jsonl_path = os.path.join(sink_dir, "events.jsonl")
    config = {"uigc.crgc.shadow-graph": "device", "uigc.crgc.device": device,
              "uigc.crgc.trace-mode": "auto", "uigc.crgc.wakeup-interval": 10,
              "uigc.telemetry.wake-profile": True,
              "uigc.telemetry.metrics": True, "uigc.telemetry.device": True,
              "uigc.telemetry.inspect": True, "uigc.telemetry.leak-waves": 0,
              "uigc.telemetry.timeseries": True,
              "uigc.telemetry.http-port": 0,
              "uigc.telemetry.jsonl-path": jsonl_path}
    prop.reset_launches()
    t0 = time.perf_counter()
    try:
        with TraceLaunches() as log:
            r = run_tree(config=config, timeout_s=LIVE_TIMEOUT_S,
                         hold_wakes=HOLD_WAKES,
                         probe=tools_live_probe(log, jsonl_path),
                         **TOOLS_TREE)
    except (AssertionError, RuntimeError, OSError, ValueError) as exc:
        raise SmokeFailure(f"tools {label}: {exc}") from exc
    finally:
        shutil.rmtree(sink_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    launches = dict(prop.launches)
    res = r["probe"]["held"]
    check(r["held_wakes"] >= HOLD_WAKES,
          f"tools {label}: held {r['held_wakes']} wakes")
    if device == "cuda":
        check(sum(launches.values()) > 0,
              f"tools {label}: the kernel never launched in the collector")
    say(f"[tools] {label} actors={r['n_collected']} "
        f"build_s={r['build_s']:.3f} collect_s={r['collect_s']:.3f} "
        f"held_wakes={r['held_wakes']} wakes={r['wakes']} "
        f"launches={launches} seconds={seconds:.2f} url={res['base']}")

    # device_report: per-wake attribution against the launch log
    check(res["device_rc"] == 0 and res["device_report_rc"] == 0,
          f"tools {label}: device_report exited {res['device_rc']}, "
          f"{res['device_report_rc']}")
    doc = res["device_doc"]
    problems = validate_device_doc(doc)
    check(not problems, f"tools {label}: /device {problems}")
    wakes = [w for w in doc["recent_wakes"] if w.get("n_sweeps")]
    traced = res["trace_launches"]
    check(wakes and len(traced) >= len(wakes),
          f"tools {label}: {len(wakes)} device-active wakes in /device, "
          f"{len(traced)} collector traces logged")
    tail = traced[-len(wakes):]
    per_sweep = []
    for wake, delta in zip(wakes, tail):
        k = int(wake["n_sweeps"])
        attributed = sum(wake.get("sweep_device_ms") or [])
        device_ms = wake["device_s"] * 1e3
        check(abs(attributed - device_ms) <= 0.10 * device_ms + 1e-6,
              f"tools {label}: sweep attribution {attributed:.4f} ms of "
              f"a wake's {device_ms:.4f} ms")
        if device == "cuda":
            check(delta > 0 and delta % k == 0,
                  f"tools {label}: a wake of {k} sweeps launched {delta}")
            per_sweep.append(delta // k)
    sweeps = sum(int(w["n_sweeps"]) for w in wakes)
    say(f"[tools] device_report --url: {len(wakes)} device-active wakes, "
        f"{sweeps} sweeps, {sum(tail)} launches logged for them "
        f"(launches per sweep {sorted(set(per_sweep))}: one per packed "
        f"layout); attribution within 10% of each wake's device time; "
        f"device_per_wake_ms="
        f"{device_report.measured_wake_figures(doc)['device_per_wake_ms']:.4f}"
        f" committed=none (no H100 round); ledger total_bytes="
        f"{doc['ledger']['total_bytes']} device_bytes="
        f"{doc['ledger']['device_bytes']} by family "
        + str({fam: t["host"] + t["device"]
               for fam, t in sorted(doc["ledger"]["families"].items())}))
    check("wake budget" in res["device_report"],
          f"tools {label}: device_report rendered no wake budget")

    # graph_inspect: snapshot, why-live, self-check, the oracle
    check(res["snapshot_rc"] == 0 and res["why_live_rc"] == 0,
          f"tools {label}: graph_inspect exited {res['snapshot_rc']}, "
          f"{res['why_live_rc']}")
    verdict, hops, parents = res["why_live_leaf"]
    check(verdict == "live" and hops > 0,
          f"tools {label}: why-live of the leaf came out {verdict}")
    check(not res["selfcheck_problems"],
          f"tools {label}: why-live problems {res['selfcheck_problems'][:3]}")
    check(res["snapshot_live"] == res["oracle_live"],
          f"tools {label}: the snapshot's live set ({len(res['snapshot_live'])}"
          f") differs from trace_marks_np's over the snapshot's actors "
          f"({len(res['oracle_live'])}): "
          f"{len(res['snapshot_live'] ^ res['oracle_live'])} keys")
    say(f"[tools] graph_inspect --url: snapshot of "
        f"{res['snapshot_actors']} actors, live set "
        f"{len(res['snapshot_live'])} equal to trace_marks_np's over them "
        f"(the graph, read after it, marked {res['oracle_marked']}); why-live "
        f"of a leaf live in {hops} hops (parents {parents}); "
        f"{res['selfcheck_checked']} why-live paths validated, 0 problems")

    # telemetry_dump --from-jsonl against the live scrape
    check(res["replay_rc"] == 0, f"tools {label}: telemetry_dump exited "
          f"{res['replay_rc']}")
    replay = counter_samples(res["replay"])
    live = counter_samples(res["scrape"])
    differ = {k: (v, live.get(k)) for k, v in replay.items()
              if live.get(k) != v}
    check(replay and not differ,
          f"tools {label}: replayed counters differ from the scrape: "
          f"{list(differ.items())[:5]}")
    say(f"[tools] telemetry_dump --from-jsonl: {len(replay)} counter "
        f"samples of {len({k[0] for k in replay})} counters equal to the "
        f"live /metrics.json scrape")

    # uigc_top: the device panel with numbers
    check(res["top_rc"] == 0, f"tools {label}: uigc_top exited "
          f"{res['top_rc']}")
    panel = [ln for ln in res["top"].splitlines() if ln.startswith("device:")]
    check(panel and panel[0].startswith("device: ledger")
          and not re.search(r"(^|[\s(/])-($|[\s)hmB/])", panel[0]),
          f"tools {label}: uigc_top's device panel has a dash: {panel}")
    say(f"[tools] uigc_top --url --once --plain: {panel[0]}")
    return launches


def phase_tools(graph, prep, jump_parent, marks, kernels, device="cuda"):
    """Phase 14.  Returns the launches per form of its profile and its
    live run (the checkers, in their own processes, launch nothing)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    total = tools_profile(graph, prep, jump_parent, marks, kernels, device)
    t1 = time.perf_counter()
    # after the profile, whose host clock they would share
    checkers = tools_checker_start(root)
    try:
        for form, count in tools_live(device).items():
            total[form] += count
        t2 = time.perf_counter()
    except BaseException:
        for proc, _t0 in checkers.values():
            proc.kill()
            proc.wait()
        raise
    tools_checker_finish(checkers)
    t3 = time.perf_counter()
    say(f"[tools] launches={total} seconds: profile={t1 - t0:.1f} "
        f"live={t2 - t1:.1f} checker_wait={t3 - t2:.1f} phase={t3 - t0:.1f}")
    return total


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
    errs = dict.fromkeys(prop.launches, 0.0)
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
    kernels["jump"] = main_jump_timing(graph, jp_dev, lay["r_rows"], dev,
                                       errs)
    kernels["pairs"] = main_pairs_timing(graph, table, dev, errs)

    prop.reset_launches()
    push_dirty, p50s = phase_main(graph, lay, jp_dev, dev, n_garbage)
    main_launches = dict(prop.launches)
    say(f"[main] launches={main_launches}")
    # the main path's one dense layout has no raw pair tier
    check(all(main_launches[f] > 0 for f in TRACE_FORMS),
          f"a kernel form was never launched on the main path: {main_launches}")
    sparse_sweep_timing(graph, lay, dev, push_dirty, errs)
    phase_profile(graph, lay, jp_dev, dev)
    elapsed("phases 1-4")
    # the graph and marks stay for phase 8, the host layout for phase 14
    del lay, table, jp_dev
    torch.cuda.empty_cache()

    prop.reset_launches()
    phase_churn(dev)
    churn_launches = dict(prop.launches)
    say(f"[churn] launches={churn_launches}")
    check(churn_launches["propagate_gated"] > 0,
          "the gated kernel never launched under churn")
    check(churn_launches["jump"] > 0,
          "the jump kernel never launched in the auto-mode churn wakes")
    elapsed("phase 5")
    torch.cuda.empty_cache()

    live_launches = phase_live(errs)
    say(f"[live] launches={live_launches}")
    check(all(live_launches[f] > 0 for f in TRACE_FORMS),
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

    torch.cuda.empty_cache()
    telemetry_launches = phase_telemetry()
    check(telemetry_launches["propagate_gated"] > 0,
          f"the gated kernel never launched in phase 9: {telemetry_launches}")
    elapsed("phase 9")

    torch.cuda.empty_cache()
    cluster_launches = phase_cluster(errs)
    check(sum(cluster_launches.values()) > 0,
          f"the kernel never launched in phase 10: {cluster_launches}")
    elapsed("phase 10")

    torch.cuda.empty_cache()
    procs_launches = phase_procs(errs)
    elapsed("phase 11")

    torch.cuda.empty_cache()
    sharding_launches = phase_sharding(errs)
    elapsed("phase 12")

    torch.cuda.empty_cache()
    gateway_launches = phase_gateway(errs)
    elapsed("phase 13")

    torch.cuda.empty_cache()
    tools_launches = phase_tools(graph, prep, jp, marks, kernels)
    check(sum(tools_launches.values()) > 0,
          f"the kernel never launched in phase 14: {tools_launches}")
    elapsed("phase 14")

    for form, row in kernels.items():
        row["launches"] = live_launches[form]
        row["launches_by_phase"] = {"trace_10M": main_launches[form],
                                    "churn_1M": churn_launches[form],
                                    "live": live_launches[form],
                                    "mac": mac_launches[form],
                                    "mesh": mesh_launches[form],
                                    "telemetry": telemetry_launches[form],
                                    "multi_node": cluster_launches[form],
                                    "multi_process": procs_launches[form],
                                    "sharding": sharding_launches[form],
                                    "gateway": gateway_launches[form],
                                    "tools": tools_launches[form]}
        row["max_abs_err"] = errs[form]
    order = ("name", "route", "source", "replaces", "launches",
             "launches_by_phase", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")
    say(card)  # the numbers above ran on this card, at this power limit
    say(json.dumps({"kernels": [{k: kernels[f][k] for k in order}
                                for f in TRACE_FORMS + ("pairs",)]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--node-child"]:
        node_child(json.loads(sys.argv[2]))
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
