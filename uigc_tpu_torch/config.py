"""Copy of ``uigc_tpu/config.py`` (pure Python), with the same ``DEFAULTS``
plus two keys: ``uigc.crgc.device``, where the port's ``device`` and
``decremental`` backends trace, and ``uigc.mac.device``, where the MAC
cycle detector runs its device SCC ("cuda", the default, or "cpu").  They
are the port's counterpart of ``JAX_PLATFORMS``.  In the port, "device" and
"decremental" trace on the CUDA card through the hand-written propagate
kernel (``ops/cuda_incremental.py``, ``ops/cuda_decremental.py``), and
"mesh"/"mesh-decremental" run that kernel on every shard of a mesh of
``uigc.crgc.mesh-devices`` cards (``engines/crgc/mesh.py``).

Configuration system for uigc-tpu.

Mirrors the reference's Typesafe-Config keys (reference: src/main/resources/
reference.conf:15-51) so users of the reference can carry their settings
over unchanged.  Keys are dotted strings; defaults below correspond
one-to-one with the reference defaults, plus TPU-specific additions under
``uigc.crgc.shadow-graph`` and ``uigc.runtime``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

DEFAULTS: Dict[str, Any] = {
    # Which GC engine to use. May be "crgc" (alias "tpu-crgc"), "mac",
    # "manual", or "drl".  (reference: reference.conf:16-20, UIGC.scala:12-19)
    "uigc.engine": "crgc",
    # --- CRGC engine settings (reference: reference.conf:22-41) ---
    # How actors are reminded to send an entry: "on-idle", "on-block" or
    # "wave".  (reference: reference.conf:27-33)
    "uigc.crgc.collection-style": "on-block",
    # Milliseconds between GC control waves (wave style only).
    "uigc.crgc.wave-frequency": 50,
    # Maximum number of nodes in the cluster; GC is gated on full membership.
    # (reference: GUIDE.md:44-47, LocalGC.scala:53,69-75)
    "uigc.crgc.num-nodes": 1,
    # Batch capacity of a cross-node delta graph, in shadows.
    "uigc.crgc.delta-graph-size": 64,
    # Capacity of each per-actor entry field (created/spawned/updated arrays).
    "uigc.crgc.entry-field-size": 4,
    # Milliseconds between collector (Bookkeeper) wakeups.
    # (reference: LocalGC.scala:213 hard-codes 50ms; we make it a knob.)
    "uigc.crgc.wakeup-interval": 50,
    # Milliseconds between egress-entry finalizations (multi-node only).
    # (reference: LocalGC.scala:219-224 hard-codes 10ms.)
    "uigc.crgc.egress-finalize-interval": 10,
    # Which shadow-graph implementation the collector uses:
    #   "oracle" - pointer-based graph mirroring the JVM semantics exactly
    #   "array"  - dense-array graph folded on host (numpy)
    #   "device" - dense-array graph with the trace run on the card: the
    #              propagate kernel's fixpoint (ops/cuda_trace.py)
    #   "native" - C++ data plane (uigc_tpu_torch/native/), batch fold +
    #              trace
    #   "mesh"   - fold/trace state sharded by node range across the
    #              cards of a mesh (engines/crgc/mesh.py); per-wake deltas
    #              stream to the shards, each trace sweep runs the
    #              propagate kernel on every shard and gathers the packed
    #              mark words onto every card (peer copies over NVLink)
    #   "decremental" - device trace that re-derives only the churn's
    #              affected region per wake from the previous fixpoint
    #              (ops/cuda_decremental.py: suspect closure + repair)
    #   "mesh-decremental" - the mesh backend with the decremental wake
    #              per shard (one word gather per sweep)
    "uigc.crgc.shadow-graph": "array",
    # Where the "device", "decremental" and "mesh*" backends run their
    # trace: "cuda" (the card; the backend raises at construction when
    # none is visible) or "cpu" (the kernels' plain PyTorch versions;
    # tests and CPU users).  The host backends ("oracle", "array",
    # "native") ignore it.
    "uigc.crgc.device": "cuda",
    # Shards of the mesh backends: on "cuda" one per card, cuda:0 ..
    # cuda:n-1 (0 = every visible card; more than are visible raises);
    # on "cpu" that many shards on the CPU (0 = one).
    "uigc.crgc.mesh-devices": 0,
    # Propagation strategy for the card's mark fixpoint (the "device",
    # "decremental" and "mesh*" backends; ops/cuda_trace.py):
    #   "push" - source-push sweeps over the dirty-chunk frontier (the
    #            pre-mode behavior; O(diameter) sweeps)
    #   "pull" - push + destination-pull saturation gates: blocks whose
    #            output supertile has no unmarked in-use node left are
    #            skipped outright (dense mid-sweep pruning)
    #   "jump" - push + pointer-jumping through a min-source parent
    #            array squared each sweep (O(log diameter) sweeps)
    #   "auto" - jump always on, pull gates switched per sweep when the
    #            dirty-chunk density crosses the pull threshold
    # A config knob so A/B runs (tools/sweep_profile.py, portbench's
    # configurations) need no code edits.
    "uigc.crgc.trace-mode": "auto",
    # Dirty-chunk density (fraction of walk chunks dirty) above which
    # "auto" turns the pull gates on for a sweep; tuned from
    # tools/sweep_profile.py per-sweep decompositions.
    "uigc.crgc.pull-density": 0.25,
    # Pipelined collection: the collector dispatches the device wake
    # asynchronously and sweeps the PREVIOUS wake's verdicts while the
    # current one runs, overlapping host ingest with the device trace
    # (SURVEY §7 hard parts).  Sound because CRGC garbage is monotone —
    # a consistent-snapshot verdict never kills a live actor.  The
    # decremental and mesh-decremental backends support it; others
    # ignore the flag.
    "uigc.crgc.pipelined": False,
    # Distributed (partitioned) collection across cluster nodes
    # (engines/crgc/distributed.py): each node owns only the
    # shadow-graph slice for the partitions the rendezvous map assigns
    # it, mutator entries route to the owner as targeted deltas, trace
    # waves exchange boundary marks ("dmark" frames) and decide global
    # convergence with Safra-style rounds over a reduction tree — no
    # node ever folds the full graph.  Requires num-nodes > 1; off,
    # multi-node collection keeps the replicated (full-copy) mode.
    "uigc.crgc.distributed": False,
    # Partitions in the cross-node shadow-graph key space; 0 aligns
    # with uigc.cluster.num-shards so entity placement and shadow
    # partitioning share one granularity (and one rendezvous family).
    "uigc.crgc.dist-partitions": 0,
    # Mirror decay (distributed mode): a foreign-owned boundary mirror
    # that no fold has mentioned for this many completed waves / idle
    # wakes leaves the traversal working set (its shadow object stays
    # pinned by the owned edges that reference it, so edge identity and
    # fold cancellation are untouched).  Keeps hub nodes — whose owned
    # actors reference most of the cluster — from converging to a full
    # resident replica.  0 disables.
    "uigc.crgc.mirror-decay-waves": 6,
    # Packed mutator->collector entry plane (SURVEY §7): flushes write
    # int64 rows into per-thread ring buffers instead of object Entries,
    # so the Bookkeeper's fold is pure array work.  Automatically falls
    # back to object entries when a fabric is attached (the multi-node
    # fold builds delta graphs from objects) or when the backend has no
    # array fold (oracle, native).
    "uigc.crgc.packed-entries": True,
    # --- MAC engine settings (reference: reference.conf:43-50) ---
    "uigc.mac.cycle-detection": False,
    # Milliseconds between cycle-detector wakeups (reference:
    # CycleDetector.scala:48 hard-codes 50ms).
    "uigc.mac.wakeup-interval": 50,
    # Whether the cycle detector actually collects cycles.  The reference's
    # detector is a stub (reference.conf:48); ours implements SCC-based
    # detection and this flag gates the kill decision.
    "uigc.mac.collect-cycles": True,
    # Blocked-candidate count at which the cycle detector switches from
    # host Tarjan to the device SCC kernel (ops/scc.py).  0 forces the
    # device path; large values keep detection host-side.
    "uigc.mac.device-scc-threshold": 4096,
    # Where the cycle detector runs its device SCC: "cuda" (the card;
    # building a system with cycle detection on raises when none is
    # visible) or "cpu" (the same torch ops on the CPU).  Read only with
    # uigc.mac.cycle-detection on.
    "uigc.mac.device": "cuda",
    # --- Node transport settings (runtime/node.py; no reference
    # analogue — the reference delegates failure detection to Akka
    # Cluster, we carry our own) ---
    # Milliseconds between heartbeat pings on each peer link; 0 disables
    # the phi-accrual failure detector (EOF remains the only signal).
    "uigc.node.heartbeat-interval": 0,
    # Phi threshold at which a silent peer is declared dead
    # (phi = -log10 P(still alive); 8 ~= one false positive in 1e8).
    "uigc.node.phi-threshold": 8.0,
    # Milliseconds of acceptable extra pause folded into the phi model
    # (absorbs GC/compile stalls on loaded hosts).
    "uigc.node.heartbeat-pause": 500,
    # Reconnect attempts after a torn link before declaring the peer
    # dead; 0 = declare on first EOF (the pre-heartbeat behavior).
    "uigc.node.reconnect-retries": 0,
    # Milliseconds of backoff before the first reconnect attempt,
    # doubled per attempt.
    "uigc.node.reconnect-backoff": 50,
    # Re-admit a SAME-incarnation peer that reconnects after its
    # MemberRemoved verdict (a healed partition).  The rejoin retires
    # the old transport state wholesale — fresh stream, fresh links,
    # MemberUp to subscribers — and the cluster/collector layers run
    # their own reconciliation (split-brain resolver, undo-log reset).
    # False restores the legacy refusal: a removed member can only come
    # back as a fresh incarnation (process restart).
    "uigc.node.heal-rejoin": True,
    # Multi-frame batch units on peer links: every frame queued for one
    # peer is coalesced by its writer thread into a single "fb" wire
    # unit flushed in one sendall.  The capability is negotiated in the
    # hello tuple, so a batching node automatically sends classic
    # singleton units to peers that never advertised it.  Off, this
    # node neither advertises nor emits batches (the mixed-version
    # interop mode; frames still ride the writer thread, one flush per
    # frame).
    "uigc.node.frame-batching": True,
    # Per-peer writer queue high-water mark, in frames; senders to a
    # peer whose writer cannot keep up block briefly at this depth
    # (backpressure) instead of growing the queue unboundedly.
    "uigc.node.writer-queue-limit": 8192,
    # Maximum frames coalesced into one batch flush (bounds worst-case
    # batch latency and the receiver's per-unit work).
    "uigc.node.max-batch-frames": 256,
    # Schema-native wire codec (runtime/schema.py): known message
    # shapes cross the link as fixed binary envelopes + a marshal value
    # plane, batch-encoded per writer drain, instead of per-message
    # pickle.  Negotiated in the hello caps (like "fb"); peers that
    # never advertised a matching schema table — or message types no
    # schema fits — transparently fall back to pickle, so mixed-version
    # links keep working.  Off, this node neither advertises nor emits
    # schema frames.
    "uigc.node.schema-codec": True,
    # Shared-memory ring transport for co-located peers (runtime/
    # shm_ring.py): when both sides advertise the "shm" capability and
    # the link is loopback, the dialer creates a pair of SPSC byte
    # rings and traffic leaves the socket entirely (same framing, same
    # seq/FaultPlan/dead-letter semantics; the socket stays open as the
    # fallback and EOF detector).  Off by default: the bench and
    # co-located deployments opt in.
    "uigc.node.shm-transport": False,
    # Byte capacity of each shm ring direction.  A full ring
    # backpressures the writer (uigc_shm_ring_full_total); a peer that
    # stops draining AND whose process died flips the link back to the
    # socket path.
    "uigc.node.shm-ring-bytes": 1 << 20,
    # Per-peer decode workers (runtime/dispatcher.py DecodeLane):
    # "off" decodes inbound units inline on the link's receive thread
    # (the classic path); "on" hands each peer's units to a dedicated
    # decode worker so decode + delivery leave the transport thread;
    # "auto" enables workers only when the interpreter can actually run
    # them in parallel (free-threaded 3.13t; the stock GIL gains
    # nothing from the extra hop and stays inline).
    "uigc.node.decode-workers": "auto",
    # --- Cluster sharding (uigc_tpu/cluster; no reference analogue —
    # the reference stops at GC middleware, this is the serving layer
    # above it) ---
    # Shards in the key space.  Placement is rendezvous hashing of
    # shards over members, so this bounds rebalance granularity: more
    # shards = finer-grained, smoother rebalances.
    "uigc.cluster.num-shards": 32,
    # Milliseconds of mailbox idleness after which an entity passivates
    # (state spilled to the region's store, cell stopped, recreated on
    # next send).  0 disables passivation.
    "uigc.cluster.passivate-after": 0,
    # Milliseconds between cluster coordinator ticks (anti-entropy
    # shard-table gossip, migration retries, passivation scans,
    # deferred-route flushes).
    "uigc.cluster.tick-interval": 100,
    # Milliseconds before an unacked entity handoff is re-shipped (the
    # at-least-once leg of the migration protocol; the receiver dedups).
    "uigc.cluster.handoff-retry": 300,
    # Entity-message forward hops before a message is parked for the
    # next tick instead of ping-ponging between diverging shard tables.
    "uigc.cluster.max-forward-hops": 8,
    # Milliseconds a newly GAINED shard's traffic is held waiting for
    # the previous owner's grant (the handoff-completion signal) before
    # the hold times out.  The hold is what stops traffic during a
    # rebalance from spawning a fresh on-demand entity that would win
    # against — and silently discard — the in-flight migrated state.
    "uigc.cluster.hold-timeout": 3000,
    # --- Durability plane (uigc_tpu/cluster/journal.py) ---
    # Base directory of the event-sourced entity journal; "" disables
    # journaling entirely (the pre-durability behavior: entity state
    # dies with the node).  Nodes of one cluster share the directory
    # (shared-disk model); each node appends only to its own per-shard
    # segment files, so there is no write contention.
    "uigc.cluster.journal-dir": "",
    # When appended records reach the disk: "always" fsyncs per append
    # (every acked command is crash-durable), "interval" fsyncs on the
    # journal-fsync-interval cadence (bounded loss window), "never"
    # leaves flushing to the OS.
    "uigc.cluster.journal-fsync": "interval",
    # Milliseconds between interval-mode fsync sweeps (driven by the
    # cluster tick).
    "uigc.cluster.journal-fsync-interval": 50,
    # Segment roll threshold, in bytes: a shard segment past this size
    # rolls to a fresh file and the entities whose epoch lives in the
    # old one are re-snapshotted so the old segment compacts away.
    "uigc.cluster.journal-segment-bytes": 1 << 20,
    # Commands journaled per entity between automatic snapshot records
    # (bounds replay length after a crash).
    "uigc.cluster.journal-snapshot-every": 64,
    # Per-key cap on the EntityRef buffer-during-handoff path (and the
    # per-shard hold buffers); past it the oldest buffered message is
    # shed with a shard.buffer_dropped event +
    # uigc_entity_buffer_dropped_total.  0 = unbounded (legacy).
    "uigc.cluster.buffer-limit": 4096,
    # Global cap on the deferred-route queue (messages parked waiting
    # for table convergence); same shed-oldest accounting.
    "uigc.cluster.deferred-limit": 65536,
    # Mailbox bound applied to entity cells specifically; 0 inherits
    # uigc.runtime.mailbox-limit.
    "uigc.cluster.entity-mailbox-limit": 0,
    # --- Partition tolerance (uigc_tpu/cluster/membership.py) ---
    # Split-brain resolution strategy applied when heartbeat verdicts
    # split the membership: "keep-majority" (the larger half survives;
    # 50/50 keeps the half with the lowest address), "static-quorum"
    # (survive iff >= sbr-quorum-size members stay live), "keep-oldest"
    # (the half holding the most senior member survives), "down-all"
    # (any partition downs every side; operators restart), or "off"
    # (no arbitration — every verdict acts immediately, the pre-fencing
    # behavior).  The LOSING side quarantines: it drains its entities
    # to the journal, freezes the append plane, and stops serving until
    # a heal-time handshake hands it the survivor's fence.
    "uigc.cluster.sbr-strategy": "keep-majority",
    # Milliseconds an unreachability verdict waits for the full
    # unreachable set to form before a strategy judges it (one crash
    # and a half-cluster partition look identical to the FIRST
    # verdict).  Shard inheritance is deferred for the window.
    "uigc.cluster.sbr-settle": 200,
    # static-quorum only: members that must stay live to survive; 0
    # derives the majority quorum from the era's membership.
    "uigc.cluster.sbr-quorum-size": 0,
    # Cluster size below which arbitration is skipped (majority is
    # undefined for 1-2 nodes): removals act immediately, the legacy
    # availability behavior.
    "uigc.cluster.sbr-min-members": 3,
    # --- Correctness tooling (uigc_tpu/analysis; no reference analogue,
    # the reference debugged with in-source asserts) ---
    # Attach the uigcsan online sanitizer at system creation: a shadow
    # oracle re-derives every collection verdict and cross-checks the
    # engine's quiescence decisions, balances and fold discipline
    # (analysis/sanitizer.py).  Costly; meant for tests and debugging.
    "uigc.analysis.sanitizer": False,
    # Raise SanitizerViolation at the point of detection instead of only
    # recording it.  Fail-fast debugging mode: a raise from an engine
    # hook or the collector fold propagates into the cell batch, where
    # default supervision prints the traceback and STOPS that actor
    # (for collector-side checks, the Bookkeeper — halting GC); a raise
    # from a stop-decision tap is printed and the stop proceeds.  The
    # violation is always recorded on system.sanitizer and emitted as an
    # ``analysis.violation`` event first, so no evidence is lost.
    "uigc.analysis.sanitizer-raise": False,
    # Emit ``sched.*`` scheduling events from the cell/dispatcher layer
    # (consumed by the vector-clock race detector, analysis/race.py).
    # Requires the event recorder to be enabled as well.
    "uigc.analysis.sched-events": False,
    # --- Telemetry (uigc_tpu/telemetry; the exportable layer above the
    # in-process event counters — the reference stops at JFR events,
    # PROFILING.md:1-10) ---
    # Attach the metrics registry: typed counters/gauges/histograms
    # populated from the event stream plus direct taps (shadow-graph
    # size, mailbox depth, per-link phi).  Enables the event recorder.
    "uigc.telemetry.metrics": False,
    # Causal message tracing: trace/span ids stamped on every send,
    # propagated across NodeFabric frames as an optional header
    # (version-tolerant: peers without tracing ignore it), exportable as
    # Chrome-trace/Perfetto JSON, with each gc_wave holding the mark
    # fixpoint's uigc.* spans as children (a running torch profiler
    # records those spans too, tracing on or off).  The spans are the
    # layout sync, upload, seed, sweeps and their glue, changed-flag
    # waits, unpack and readback.  Off by default — it is per-message
    # overhead.
    "uigc.telemetry.tracing": False,
    # Collector wake profiler: break each Bookkeeper wake into
    # ingest/fold/trace/sweep/broadcast phases with device-vs-host time
    # (hooks the tpu.device_trace / crgc.sweep events); dump BENCH-style
    # JSON via system.telemetry.profiler.  Enables the event recorder.
    "uigc.telemetry.wake-profile": False,
    # Localhost HTTP exposition: serve /metrics (Prometheus text) and
    # /metrics.json on 127.0.0.1.  -1 disables; 0 binds an ephemeral
    # port (read it from system.telemetry.http.port).  A fixed port
    # that is already bound (several systems sharing one config in one
    # process) degrades to an ephemeral port instead of failing system
    # construction.
    "uigc.telemetry.http-port": -1,
    # Persist every committed event as one JSON line to this path
    # (replayable offline into RaceDetector.feed() and the violation
    # summaries; see uigc_tpu/telemetry/exporter.py).  "" disables.
    "uigc.telemetry.jsonl-path": "",
    # Size-capped rotation for the JSONL sink: when the live file would
    # exceed this many bytes it rotates to <path>.1 (shifting the set,
    # keeping jsonl-keep rotated files) — long chaos runs hold at most
    # (keep+1)*max bytes of events.  0 disables rotation (unbounded,
    # the pre-rotation behavior).  replay_jsonl reads a rotated set
    # oldest-first as one ordered stream.
    "uigc.telemetry.jsonl-max-bytes": 0,
    "uigc.telemetry.jsonl-keep": 3,
    # Liveness inspector (uigc_tpu/telemetry/inspect.py): why-live
    # retaining paths, flight-recorder snapshots and the cross-node
    # merged graph ("snap" NodeFabric frames + /inspect and /snapshot
    # on the metrics HTTP server), and the leak watchdog emitting
    # telemetry.leak_suspect events.  Enables the event recorder.
    "uigc.telemetry.inspect": False,
    # Collector waves between automatic flight-recorder snapshots;
    # 0 = only on demand / on crash.  (The leak watchdog samples every
    # wave regardless while the inspector is attached.)
    "uigc.telemetry.snapshot-every": 0,
    # Snapshots retained in the flight-recorder ring.
    "uigc.telemetry.snapshot-keep": 8,
    # Consecutive zero-traffic collection waves after which the
    # watchdog flags an actor as a leak suspect; 0 disables the
    # watchdog.
    "uigc.telemetry.leak-waves": 3,
    # Capture the marking-parent array on every trace (verdict-exact
    # why-live provenance).  Off, why-live queries derive parents on
    # demand and the wake path runs the parent-free kernels — plain
    # wakes pay nothing (the stats-variant gating discipline).
    "uigc.telemetry.why-live-capture": False,
    # Crash/teardown dump path for the flight recorder ("" disables):
    # on NodeFabric crash injection and on telemetry close, the ring +
    # a final snapshot are written here as one JSON document.
    "uigc.telemetry.inspect-dump-path": "",
    # --- Telemetry time plane (uigc_tpu/telemetry/timeseries.py) ---
    # Attach the per-node time-series store + sampler thread: metric
    # history in multi-resolution ring buffers, the /timeseries HTTP
    # route, tsq/tsr cluster aggregation on a NodeFabric, and (with
    # uigc.telemetry.alerts) the anomaly/SLO engine.  Implies the
    # metrics registry.
    "uigc.telemetry.timeseries": False,
    # Milliseconds between sampler ticks (each tick snapshots the
    # registry into the store and evaluates alert rules).
    "uigc.telemetry.ts-sample-interval": 1000,
    # Downsampling tiers as "res_sxcount" pairs: the default keeps 120s
    # of 1s buckets, 30min of 10s buckets and 4h of 1min buckets per
    # series — O(1) memory per series regardless of sample count.
    "uigc.telemetry.ts-tiers": "1x120,10x180,60x240",
    # Per-metric labelset bound, shared by the metrics registry and the
    # time-series store: past it, new labelsets fold into one
    # overflow="true" labelset and a telemetry.labelset_overflow event
    # fires once per metric — dynamic labels (per-peer, per-shard)
    # can no longer grow a metric's memory without bound.
    "uigc.telemetry.max-labelsets": 512,
    # Evaluate the built-in anomaly/SLO rules (wake-latency regression,
    # frame-gap/dup spikes, writer-queue saturation, leak-suspect
    # growth, heartbeat-phi climb) on the sampler cadence; firing rules
    # emit telemetry.alert events, count into
    # uigc_alerts_total{rule,severity} and serve on /alerts.  Only
    # meaningful with uigc.telemetry.timeseries on.
    "uigc.telemetry.alerts": True,
    # --- Device-plane observatory (uigc_tpu/telemetry/device.py) ---
    # Attach the device observatory: the per-family HBM/array memory
    # ledger (uigc_device_ledger_bytes{family} + peak watermarks),
    # compile-cache hit/miss telemetry with the recompile_storm alert,
    # host-transfer accounting for the annotated readback sites, the
    # donation audit, and per-sweep device-time attribution on the wake
    # records.  Serves /device on the metrics HTTP server.  Implies the
    # metrics registry and the wake profiler (attribution needs both).
    "uigc.telemetry.device": False,
    # Compile-cache miss rate (misses/s over the rule window) above
    # which recompile_storm fires — a healthy steady state compiles
    # each geometry once, so any sustained rate is a shape-key bug.
    "uigc.telemetry.alert-recompile-rate": 0.2,
    # Absolute device-seconds floor for the device_wake_regression rule
    # (fires regardless of the learned EWMA baseline); 0 = EWMA-only.
    "uigc.telemetry.alert-device-wake-threshold": 0.0,
    # EWMA-sigma deviation at which a regression rule fires.
    "uigc.telemetry.alert-ewma-sigma": 3.0,
    # Absolute wake-latency floor (seconds) that fires the wake rule
    # regardless of the learned baseline; 0 = EWMA-only.
    "uigc.telemetry.alert-wake-threshold": 0.0,
    # Frame gap/duplicate rate (frames/s over the rule window) above
    # which the spike rules fire.
    "uigc.telemetry.alert-gap-rate": 1.0,
    # Backpressure-rate (fabric.backpressure events/s over the rule
    # window) above which the backpressure_spike alert fires.
    "uigc.telemetry.alert-backpressure-rate": 5.0,
    # Shed-rate (gateway.shed events/s over the rule window) above
    # which the gateway_overload alert fires — sustained shedding means
    # the edge is refusing real traffic, not absorbing a blip.
    "uigc.telemetry.alert-shed-rate": 10.0,
    # --- Host runtime settings (no reference analogue; ours) ---
    # Number of dispatcher worker threads.
    "uigc.runtime.num-workers": 4,
    # Maximum messages an actor processes per scheduling slot (Akka calls
    # this dispatcher "throughput").
    "uigc.runtime.throughput": 16,
    # Application-mailbox bound per cell, in messages; 0 = unbounded
    # (legacy).  A full mailbox applies the overflow policy below and
    # commits a fabric.backpressure event — on a remote delivery path
    # the "block" policy stalls the transport's receive thread, which
    # stalls the TCP stream, which surfaces on the SENDER as writer-
    # queue pushback: end-to-end backpressure with no protocol changes.
    # System messages (the stop protocol) are never bounded.
    "uigc.runtime.mailbox-limit": 0,
    # What a full mailbox does to the incoming message:
    #   "block"       the sender waits (up to mailbox-block-ms) for
    #                 space; on timeout — or when the sender is the
    #                 cell's own processing thread, where waiting would
    #                 deadlock — degrade to shed-oldest
    #   "shed-oldest" drop the oldest queued message through the
    #                 dead-letter accounting and admit the new one
    #   "error"       raise MailboxOverflowError to a LOCAL sender;
    #                 batch/transport deliveries degrade to shed-oldest
    #                 (a raise would kill the link's receive loop)
    "uigc.runtime.overflow-policy": "block",
    # Upper bound on one blocked send, in milliseconds.
    "uigc.runtime.mailbox-block-ms": 2000,
    # --- Ingress gateway (uigc_tpu/gateway) ---
    # Hard cap on concurrent client connections one gateway holds;
    # accepts past it are closed immediately (shed{reason=conn-limit}).
    "uigc.gateway.max-connections": 65536,
    # Per-tenant concurrent connection quota; 0 = unlimited.
    "uigc.gateway.tenant-max-connections": 1024,
    # Per-tenant admitted commands per second (token bucket, burst ==
    # one second of budget); 0 = unlimited.  Excess commands get a
    # clean ERROR{msg-rate, retry_after_ms}.
    "uigc.gateway.tenant-msgs-per-sec": 0,
    # Static token table as "token=tenant[,token=tenant...]"; empty
    # runs the gateway open (every CONNECT admitted, tenant taken from
    # the CONNECT frame).
    "uigc.gateway.auth-tokens": "",
    # Per-connection egress queue bound, in frames.  Past half of it
    # the connection's reads throttle; at the bound the connection is
    # closed as a slow consumer — an unread reply queue must never
    # balloon gateway memory.
    "uigc.gateway.egress-queue-limit": 256,
    # Largest client frame body accepted, in bytes; larger frames are
    # a protocol violation (the connection is shed and closed).
    "uigc.gateway.max-frame-bytes": 1048576,
    # Admitted-traffic p99 latency band, in milliseconds (decode to
    # routed): above it the overload controller sheds NEW work with
    # ERROR{overload, retry_after_ms} until p99 falls to 80% of the
    # band.  0 disables the latency trigger.
    "uigc.gateway.overload-p99-ms": 250.0,
    # Fabric writer-queue depth band: above it the overload controller
    # sheds new work AND per-connection reads throttle (the one-hop
    # extension of the durability/backpressure plane); exit at half.
    # 0 disables the depth trigger.
    "uigc.gateway.overload-queue-depth": 4096,
    # The retry_after_ms hint stamped on every shed ERROR frame.
    "uigc.gateway.shed-retry-after-ms": 1000,
    # Selector reader threads; each owns conn_id % N of the sockets.
    "uigc.gateway.reader-threads": 2,
}


class Config:
    """Immutable dotted-key configuration with reference-compatible defaults."""

    def __init__(self, overrides: Optional[Mapping[str, Any]] = None):
        self._data: Dict[str, Any] = dict(DEFAULTS)
        if overrides:
            for key, value in overrides.items():
                self._data[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self._data[key]
        if default is not None:
            return default
        raise KeyError(f"unknown config key: {key}")

    def get_int(self, key: str) -> int:
        return int(self.get(key))

    def get_float(self, key: str) -> float:
        return float(self.get(key))

    def get_bool(self, key: str) -> bool:
        value = self.get(key)
        if isinstance(value, str):
            return value.lower() in ("on", "true", "yes", "1")
        return bool(value)

    def get_string(self, key: str) -> str:
        return str(self.get(key))

    def with_overrides(self, overrides: Mapping[str, Any]) -> "Config":
        merged = dict(self._data)
        merged.update(overrides)
        return Config(merged)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({self._data!r})"
