"""Port of ``uigc_tpu/engines/crgc/mesh.py``: ``MeshShadowGraph`` on the
port's ``ArrayShadowGraph``, its trace sharded over a :class:`Mesh` of
devices (``parallel/sharded_trace.py``), held against the reference by
``tests/test_torch_mesh.py``.  What differs from the reference:

- The mesh is built, and its devices pinned, when the backend is built:
  ``n_devices`` cards cuda:0 .. cuda:n-1 on ``"cuda"`` (0 means every
  visible card; more than are visible raises), or ``n_devices`` shards
  on the CPU on ``"cpu"`` (0 means one).
- The device state is per-shard tensors updated in place
  (``index_put_``) where the reference donates buffers.  The scatter
  batches are built exactly, with no padding to power-of-two sizes: the
  port compiles nothing per shape, so the reference's padding, its
  program caches (``_SHARED_PROGRAM_CACHE``, ``_HELPER_CACHE``,
  ``_jit``) and their ``COMPILE`` events are gone, and so is the cached
  zero word array.
- There is no collective lock.  The reference serializes its
  all_gather-bearing programs process-wide because two XLA collectives
  interleaved on one device set can deadlock; a wake here is host code
  issuing kernels and copies on the current streams, with no rendezvous
  between shards, so two systems' wakes cannot wait on each other.
- A pipelined wake is ready when the CUDA event recorded after it on
  each of the mesh's cards has completed (always ready on the CPU), as
  the port's ``_WakeHandle`` is.
- ``audit_donation`` and the ``donation_audit`` switch belong to device
  telemetry (ROADMAP.md Queue 1 item 6): nothing is donated here.
- Full rebuilds are counted on the base's ``rebuilds``.

Mesh shadow-graph backend: the collector's data plane sharded over a
device mesh.

This is the node-level sharding capability of the reference
(LocalGC.scala:191-196 replicates per-node graphs via DeltaGraph gossip)
re-expressed for a machine of several devices, per SURVEY §7: instead of
replicating the graph per host, the detection state is *partitioned*
across the devices —

- node feature arrays (flags, recv_count) live device-resident, sharded
  by contiguous slot range over the mesh;
- propagation pairs (positive refob edges + supervisor pointers) live
  device-resident as per-destination-shard packed layouts plus insert
  buckets, so each device's sweep lands only in its own node shard;
- each sweep gathers the packed mark words (the collective analogue of
  the DeltaMsg broadcast) and decides convergence on the gathered table.

The host keeps its mirror (interning, edge dict, sweep bookkeeping) and
streams *only the per-wake changes* to the devices: dirty node rows
(``_node_log``) and pair transitions (``_pair_log``) are scatter-applied
in place, so steady-state host->device traffic is O(churn), not
O(graph).  Full rebuilds happen only on capacity growth or log overflow.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...ops import cuda_trace as pt
from ...ops.cuda_incremental import IncrementalCudaLayout
from ...ops.slotmap import PackedSlotMap, fold_log, pack_keys, unpack_keys
from ...parallel import sharded_trace
from ...utils import events
from .arrays import ArrayShadowGraph, _readback
from .state import CrgcContext


def _pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _by_shard(shard: np.ndarray, n_shards: int, *cols: np.ndarray) -> list:
    """Split batch columns by owning shard: one tuple of column slices per
    shard, in shard order (a shard with no entry gets empty slices)."""
    order = np.argsort(shard, kind="stable")
    cuts = np.cumsum(np.bincount(shard, minlength=n_shards))[:-1]
    split = [np.split(c[order], cuts) for c in cols]
    return list(zip(*split))


class MeshShadowGraph(ArrayShadowGraph):
    """Shadow graph whose fold/trace state is sharded across a device
    mesh; liveness semantics identical to the host oracle (differential
    tests drive both over the same entry streams)."""

    def __init__(
        self,
        context: CrgcContext,
        local_address: Optional[str] = None,
        n_devices: int = 0,
        initial_capacity: int = 1024,
        decremental: bool = False,
        trace_mode: str = "auto",
        pull_density: float = 0.25,
        device="cuda",
    ):
        super().__init__(
            context,
            local_address,
            use_device=True,
            initial_capacity=initial_capacity,
            trace_mode=trace_mode,
            pull_density=pull_density,
            device=device,
        )
        kind = self.device.type
        if n_devices <= 0:
            n_devices = torch.cuda.device_count() if kind == "cuda" else 1
        self.n_devices = n_devices
        self.mesh = sharded_trace.build_mesh(n_devices, kind)
        self._fold_fn = sharded_trace.make_sharded_fold(self.mesh)
        self._mask_fn = sharded_trace.make_sharded_mask(self.mesh)
        self._node_log = set()  # enable dirty-slot tracking in the base

        self.s_rows = pt.S_ROWS
        #: jump/auto trace modes jump marks through a REPLICATED
        #: min-source parent array (every replica runs the same pointer
        #: doubling over replicated tables — no collective needed);
        #: maintained O(churn) from the raw pair log like the
        #: single-device IncrementalCudaLayout.jump_parent
        self._use_jump = trace_mode in (pt.MODE_JUMP, pt.MODE_AUTO)
        self._jump_parent: Optional[np.ndarray] = None
        self._jump_writes: Dict[int, int] = {}
        self._jump_dev: Optional[List[torch.Tensor]] = None

        # device state (built lazily on first trace)
        self._dev_ready = False
        self._dev_flags: Optional[List[torch.Tensor]] = None
        self._dev_recv: Optional[List[torch.Tensor]] = None
        self._n_pad = 0
        self._shard_size = 0
        # --- packed base plane: per-shard layouts --------------------- #
        self._layout_meta: Optional[dict] = None
        self._stacked: Optional[dict] = None  # host truth of the layouts
        self._dev_stacked: Optional[Dict[str, List[torch.Tensor]]] = None
        #: packed (src, dst, kind) key -> (shard << 40 | ri << 8 | col)
        self._base_slot = PackedSlotMap()
        #: queued deletion masks for the device layouts [(shard, ri, col)]
        self._mask_writes: List[Tuple[int, int, int]] = []
        # --- insert buckets: scatter-max tier for new pairs ----------- #
        self._bucket_m = 0  # columns per shard (pow2)
        self._pb_src: Optional[np.ndarray] = None  # [D, M] global src ids
        self._pb_dst: Optional[np.ndarray] = None  # [D, M] local dst ids
        self._pb_count: Optional[np.ndarray] = None
        self._pb_free: List[List[int]] = []
        #: packed (src, dst, kind) key -> packed (shard << 32 | column)
        self._pb_slot = PackedSlotMap()
        self.stats = {"wakes": 0, "anomalies": 0}

        #: per-wake closure+repair detection on the mesh
        #: (parallel/sharded_trace.make_sharded_decremental_wake)
        self.decremental = decremental
        self._wake_state: Optional[list] = None  # mark/seed/halt/iu/active
        self._pending_del_dst: set = set()
        self._pending_fresh_dst: set = set()

    @property
    def can_pipeline(self) -> bool:
        # The mesh pipelined wake overlaps host ingest with the SHARDED
        # decremental wake: launch_trace syncs the shard layouts
        # mesh-natively (the base-class path would have routed through
        # the single-device tracer and desynced them) and dispatches
        # the wake; the base class's harvest machinery sweeps the
        # snapshot verdicts through _MeshWakeHandle.
        return self.decremental

    def _start_wake(self) -> tuple:
        """Dispatch the sharded decremental wake (the base launch_trace
        keeps the snapshot bookkeeping).  The shard layouts sync
        mesh-natively first; state commits at dispatch (like
        DecrementalTracer.wake_device), so a pending wake discarded by a
        synchronous trace loses nothing."""
        with events.recorder.timed(events.DEVICE_TRACE) as ev:
            ev.fields["trace_mode"] = self.trace_mode
            self._sync_device()
            self.stats["wakes"] += 1
            out = self._dispatch_decremental_wake()
        ready = []
        for dev in self.mesh.distinct:
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                ready.append(event)
        return _MeshWakeHandle(self, ready), out[0]

    def _geometry(self) -> tuple:
        """The sharded trace's and wake's positional geometry arguments."""
        meta = self._layout_meta
        return (self.mesh, self._n_pad, self._shard_size, meta["n_blocks"],
                meta["r_rows"], self.s_rows, self._bucket_m)

    def _device_operands(self) -> tuple:
        """The layout, bucket and (jump/auto) jump-parent operands, in the
        sharded trace's order."""
        st = self._dev_stacked
        jump = (self._jump_dev,) if self._use_jump else ()
        return (st["bmeta1"], st["bmeta2"], st["row_pos"], st["emeta"],
                self._dev_psrc, self._dev_pdst) + jump

    # ------------------------------------------------------------- #
    # Device state construction
    # ------------------------------------------------------------- #

    def _full_rebuild(self) -> None:
        self.rebuilds += 1
        D = self.n_devices
        super_sz = self.s_rows * 128
        chunk = D * super_sz
        n_pad = ((self.capacity + chunk - 1) // chunk) * chunk
        self._n_pad = n_pad
        self._shard_size = n_pad // D

        # --- packed base layouts from the host truth -------------- #
        esrc, edst, kinds = IncrementalCudaLayout.pairs_from_graph(
            self.edge_src, self.edge_dst, self.edge_weight, self.supervisor
        )
        stacked, meta, slot_vals = sharded_trace.pack_shard_layouts(
            esrc, edst, n_pad, D, s_rows=self.s_rows
        )
        self._stacked = stacked
        self._layout_meta = meta
        self._base_slot = PackedSlotMap(
            pack_keys(esrc, edst, kinds), slot_vals
        )
        self._mask_writes = []
        if self._use_jump:
            self._jump_parent = pt.jump_parents(esrc, edst, n_pad)
            self._jump_writes = {}
            self._jump_dev = None  # re-uploaded (replicated) on first sync

        # --- empty insert buckets --------------------------------- #
        # Sized so the bucket tier absorbs a meaningful fraction of the
        # graph's scale in new pairs before the next rebuild folds them
        # into the packed base (the freeze/consolidate analogue).
        m = _pow2(max(1024, self.capacity // (4 * D)))
        self._bucket_m = m
        self._pb_src = np.full((D, m), self._n_pad, dtype=np.int32)
        self._pb_dst = np.zeros((D, m), dtype=np.int32)
        self._pb_count = np.zeros(D, dtype=np.int64)
        self._pb_free = [[] for _ in range(D)]
        self._pb_slot = PackedSlotMap()

        # --- device arrays ---------------------------------------- #
        flags = np.zeros(n_pad, dtype=np.uint8)
        flags[: self.capacity] = self.flags
        recv = np.zeros(n_pad, dtype=np.int64)
        recv[: self.capacity] = self.recv_count
        put_nodes, put_stacked = (sharded_trace.put_nodes,
                                  sharded_trace.put_stacked)
        self._dev_flags = put_nodes(self.mesh, flags)
        self._dev_recv = put_nodes(self.mesh, recv)
        self._dev_stacked = {
            k: put_stacked(self.mesh, v) for k, v in stacked.items()
        }
        self._dev_psrc = put_stacked(self.mesh, self._pb_src)
        self._dev_pdst = put_stacked(self.mesh, self._pb_dst)
        # Host mirror of the last recv values synced to the devices: the
        # sharded fold applies *deltas* (reference: ShadowGraph.java:75-83
        # folds counts, not absolutes), so per-wake sync needs the diff
        # against what the devices already hold.
        self._recv_synced = recv.copy()

        self._pair_log = []
        self._node_log = set()
        self._wake_state = None
        self._pending_del_dst.clear()
        self._pending_fresh_dst.clear()
        self._dev_ready = True

    # ------------------------------------------------------------- #
    # Incremental device sync (O(churn) per wake)
    # ------------------------------------------------------------- #

    def _apply_pair_log(self) -> Optional[list]:
        """Fold pair transitions into the host plane; returns the bucket
        device-scatter batch, or None if the buckets overflowed (full
        rebuild required).  Deletions hitting the packed base mask its
        slot in place (host + queued device mask); deletions hitting the
        bucket free its column; inserts land in the bucket tier.

        Batched like IncrementalCudaLayout.apply_log (the net-effect
        argument and anomaly accounting live in slotmap.fold_log): slot
        lookups are one vectorized binary search per batch."""
        if self._use_jump:
            # Batched jump-parent maintenance — the same
            # pt.fold_jump_log rules as the single-device layout plane
            # (min-fold on insert, invalidate-on-remove, conservative
            # about pairs both inserted and removed in one batch), so
            # the backends cannot diverge on which edges the jump
            # sweep may cross.
            pt.fold_jump_log(
                self._jump_parent, self._pair_log, self._n_pad,
                self._jump_writes,
            )
        removes, cond_removes, inserts = fold_log(self._pair_log)
        if self.decremental:
            # Suspect bookkeeping for the decremental wake: removal
            # destinations must re-derive; insert destinations must see
            # their new pair once.  Over-approximation is sound.
            rem = removes + cond_removes
            if rem:
                _, d = unpack_keys(np.fromiter(rem, np.int64, len(rem)))
                self._pending_del_dst.update(d.tolist())
            if inserts:
                _, d = unpack_keys(
                    np.fromiter(inserts, np.int64, len(inserts))
                )
                self._pending_fresh_dst.update(d.tolist())
        writes: Dict[Tuple[int, int], Tuple[int, int]] = {}
        stacked = self._stacked

        def mask_base(packed: int) -> None:
            shard = packed >> 40
            ri = (packed >> 8) & 0xFFFFFFFF
            col = packed & 0xFF
            stacked["row_pos"][shard, ri, col] = pt._PAD_ROW
            stacked["emeta"][shard, ri, col] = 0
            self._mask_writes.append((shard, ri, col))

        def free_slot_batch(keys: list, found_is_anomaly: bool) -> None:
            karr = np.fromiter(keys, np.int64, len(keys))
            bucket_vals = self._pb_slot.pop_batch(karr)
            missing = bucket_vals < 0
            base_vals = np.full(karr.size, -1, dtype=np.int64)
            if missing.any():
                base_vals[missing] = self._base_slot.pop_batch(karr[missing])
            for bval, sval in zip(bucket_vals.tolist(), base_vals.tolist()):
                if bval >= 0:
                    if found_is_anomaly:
                        self.stats["anomalies"] += 1
                    shard, colm = bval >> 32, bval & 0xFFFFFFFF
                    self._pb_src[shard, colm] = self._n_pad  # sink
                    self._pb_dst[shard, colm] = 0
                    self._pb_free[shard].append(colm)
                    writes[(shard, colm)] = (self._n_pad, 0)
                elif sval >= 0:
                    if found_is_anomaly:
                        self.stats["anomalies"] += 1
                    mask_base(sval)
                elif not found_is_anomaly:
                    self.stats["anomalies"] += 1

        if removes:
            free_slot_batch(removes, found_is_anomaly=False)
        if cond_removes:
            # insert-first/remove-last: net no-op unless the key was
            # already live (anomalous duplicate insert + real remove).
            free_slot_batch(cond_removes, found_is_anomaly=True)

        if inserts:
            karr = np.fromiter(inserts, np.int64, len(inserts))
            present = (self._pb_slot.get_batch(karr) >= 0) | (
                self._base_slot.get_batch(karr) >= 0
            )
            srcs, dsts = unpack_keys(karr)
            for key, src, dst, dup in zip(
                inserts, srcs.tolist(), dsts.tolist(), present.tolist()
            ):
                if dup:
                    self.stats["anomalies"] += 1
                    continue
                shard = dst // self._shard_size
                free = self._pb_free[shard]
                if free:
                    colm = free.pop()
                else:
                    colm = int(self._pb_count[shard])
                    if colm >= self._bucket_m:
                        return None  # bucket overflow
                    self._pb_count[shard] = colm + 1
                self._pb_slot.add(key, (shard << 32) | colm)
                self._pb_src[shard, colm] = src
                local = dst - shard * self._shard_size
                self._pb_dst[shard, colm] = local
                writes[(shard, colm)] = (src, local)
        self._pair_log = []
        return list(writes.items())

    def _sync_jump_mirror(self) -> None:
        """Replicated jump-parent device mirror: full upload once per
        rebuild, O(churn) in-place writes after (same policy as the node
        arrays; replicated because the pointer doubling gathers globally
        on every device)."""
        if not self._use_jump:
            return
        if self._jump_dev is None:
            self._jump_dev = sharded_trace.put_replicated(
                self.mesh, self._jump_parent
            )
            self._jump_writes = {}
        elif self._jump_writes:
            w = self._jump_writes
            self._jump_writes = {}
            idx = torch.from_numpy(np.fromiter(w.keys(), np.int64, len(w)))
            vals = torch.from_numpy(np.fromiter(w.values(), np.int32, len(w)))
            for jp in self._jump_dev:
                jp[idx.to(jp.device)] = vals.to(jp.device)

    def _sync_device(self) -> None:
        if (
            not self._dev_ready
            or self._pair_log is None
            or self._n_pad < self.capacity
        ):
            self._full_rebuild()
            self._sync_jump_mirror()
            return
        pair_writes = self._apply_pair_log() if self._pair_log else []
        if pair_writes is None:
            self._full_rebuild()
            self._sync_jump_mirror()
            return
        D = self.n_devices

        if pair_writes:
            # insert-bucket columns: per-shard in-place writes
            w = np.array([k + v for k, v in pair_writes], dtype=np.int64)
            per_shard = _by_shard(w[:, 0], D, w[:, 1], w[:, 2], w[:, 3])
            for i, (c, s, d) in enumerate(per_shard):
                if c.size:
                    dev = self._dev_psrc[i].device
                    c = torch.from_numpy(c).to(dev)
                    self._dev_psrc[i][c] = torch.from_numpy(
                        s.astype(np.int32)).to(dev)
                    self._dev_pdst[i][c] = torch.from_numpy(
                        d.astype(np.int32)).to(dev)

        if self._mask_writes:
            # base-layout deletions: per-shard in-place masking
            sh, ri, col = np.array(self._mask_writes, dtype=np.int64).T
            self._mask_writes = []
            per_shard = _by_shard(sh, D, ri, col)
            self._mask_fn(
                self._dev_stacked["row_pos"],
                self._dev_stacked["emeta"],
                [p[0] for p in per_shard],
                [p[1] for p in per_shard],
            )

        if self._node_log:
            slots_arr = np.fromiter(
                self._node_log, np.int64, len(self._node_log)
            )
            self._node_log = set()
            # Bucket dirty slots by owning shard and run the sharded fold
            # (parallel/sharded_trace.make_sharded_fold): each shard
            # scatter-applies only its own rows — recv as deltas against
            # the synced mirror, flags as set/clear masks that reproduce
            # absolute assignment ((old | set) & ~clear = new).
            ss = self._shard_size
            new_flags = self.flags[slots_arr]
            new_recv = self.recv_count[slots_arr]
            per_shard = _by_shard(
                slots_arr // ss, D, slots_arr % ss,
                new_recv - self._recv_synced[slots_arr], new_flags,
                ~new_flags,
            )
            self._recv_synced[slots_arr] = new_recv
            self._fold_fn(self._dev_flags, self._dev_recv,
                          *([p[k] for p in per_shard] for k in range(4)))

        self._sync_jump_mirror()

    # ------------------------------------------------------------- #
    # Trace
    # ------------------------------------------------------------- #

    def _word_array(self, id_set: set) -> List[torch.Tensor]:
        """Scatter an id set into the node-word array, sharded like the
        node arrays (word w of shard d covers nodes d*shard + 32w..)."""
        words = np.zeros(self._n_pad // 32, dtype=np.uint32)
        if id_set:
            ids = np.fromiter(id_set, np.int64, len(id_set))
            np.bitwise_or.at(
                words, ids >> 5, np.uint32(1) << (ids & 31).astype(np.uint32)
            )
        return sharded_trace.put_nodes(self.mesh, words.view(np.int32))

    def compute_marks(self) -> np.ndarray:
        with events.recorder.timed(events.DEVICE_TRACE) as ev:
            ev.fields["trace_mode"] = self.trace_mode
            self._sync_device()
            self.stats["wakes"] += 1
            if self.decremental:
                return self._compute_marks_decremental()
            traced = sharded_trace.make_sharded_cuda_trace(
                *self._geometry(),
                sub=self._layout_meta["sub"],
                group=self._layout_meta["group"],
                mode=self.trace_mode,
                pull_density=self.pull_density,
            )
            mark = traced(self._dev_flags, self._dev_recv,
                          *self._device_operands())
            return _readback(sharded_trace.to_host(mark),
                             "marks.mesh")[: self.capacity]

    def _dispatch_decremental_wake(self) -> tuple:
        """Run one closure+repair wake on the mesh (regional
        re-derivation per shard, one table gather per sweep; a zeroed
        previous state — cold start, post-rebuild — is the full
        derivation).  State and suspects COMMIT here; a wake whose result
        fails at its readback invalidates, so the next wake re-derives
        from zero state instead of feeding on a failed one."""
        wake = sharded_trace.make_sharded_decremental_wake(
            *self._geometry(),
            sub=self._layout_meta["sub"],
            group=self._layout_meta["group"],
            mode=self.trace_mode,
            pull_density=self.pull_density,
        )
        if self._wake_state is None:
            self._wake_state = [self._word_array(set())] * 5
        try:
            out = wake(
                self._dev_flags,
                self._dev_recv,
                self._word_array(self._pending_del_dst),
                self._word_array(self._pending_fresh_dst),
                *self._wake_state,
                *self._device_operands(),
            )
        except Exception:
            self.invalidate_wake_state()
            raise
        self._wake_state = list(out[1:])
        self._pending_del_dst.clear()
        self._pending_fresh_dst.clear()
        return out

    def _compute_marks_decremental(self) -> np.ndarray:
        # same readback + failed-result recovery as the pipelined path
        return _MeshWakeHandle(self, []).unpack_marks(
            self._dispatch_decremental_wake()[0]
        )

    def invalidate_wake_state(self) -> None:
        """Drop the previous-fixpoint state (failed wake): the next wake
        is a full derivation and pending suspects are moot."""
        self._wake_state = None
        self._pending_del_dst.clear()
        self._pending_fresh_dst.clear()


class _MeshWakeHandle:
    """Adapter giving the base class's pipelined harvest machinery
    (ArrayShadowGraph.harvest_ready / harvest_trace /
    expire_stalled_wake) the operations it needs from a dispatched mesh
    wake.  The wake's state was already committed at dispatch, so
    unpacking is a pure readback; a failed readback invalidates, the
    same contract as DecrementalTracer's."""

    __slots__ = ("graph", "n", "ready")

    def __init__(self, graph: MeshShadowGraph, ready: list):
        self.graph = graph
        #: capacity at launch: the harvest sweeps against the LAUNCH
        #: snapshot, so the mark vector must match the snapshot's
        #: length even if capacity grew in between (the base harvest
        #: pads the grown tail — no verdict exists for it)
        self.n = graph.capacity
        #: one CUDA event per card of the mesh, recorded after the wake
        self.ready = ready

    def is_ready(self) -> bool:
        return all(event.query() for event in self.ready)

    def unpack_marks(self, mark) -> np.ndarray:
        try:
            return sharded_trace.to_host(mark)[: self.n]
        except Exception:
            self.graph.invalidate_wake_state()
            raise

    def invalidate(self) -> None:
        self.graph.invalidate_wake_state()
