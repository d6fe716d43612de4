"""Port of ``uigc_tpu/engines/crgc/arrays.py``: the host side (interning,
the folds, the sweep) is the reference's, copied; the device paths run on
the CUDA card (``uigc.crgc.device``) through the port's
``IncrementalCudaLayout`` and ``DecrementalTracer``, and so through the
hand-written propagate kernel.  What differs from the reference:

- ``compute_marks`` on the ``device`` backend always traces through the
  incremental layout (``_compute_marks_cuda``, the reference's
  ``_compute_marks_pallas``) on the configured device; there is no
  off-TPU XLA branch.  On the CPU the same layout runs the kernels'
  plain PyTorch versions.
- ``_readback`` takes a tensor and keeps its ``tpu.host_transfer`` event.
- Parent capture on the device runs ``cuda_trace.marking_parents_torch``.
- A pipelined wake uploads flags and receive counts with a synchronous
  host-to-device copy (the host keeps folding into ``self.flags`` after
  ``launch_trace`` returns) and is ready when the CUDA event recorded
  after it has completed (``_WakeHandle``); on the CPU it is always
  ready.
- ``audit_donation`` keeps its name and its ``tpu.donation_copy``
  event, with the torch meaning: the port's mesh updates its shard
  tensors in place (``mesh.py``) where the reference donates buffers, so
  the audit reads each tensor's ``data_ptr()`` before the update and
  commits the event when the update left the tensor on new storage (a
  silent copy, the reference's bug class).  The ``donation_audit``
  switch is the reference's, set by the device observatory's attach.
- ``rebuilds`` counts full layout rebuilds (each capacity growth is a new
  geometry and one of them).

The array-oriented shadow graph: dense slots + COO edges.

The TPU-first redesign of the collector's detection structure.  Where the
reference holds a ``HashMap<ActorRef, Shadow>`` of pointer-linked shadows
(reference: ShadowGraph.java:9-21, Shadow.java:10-54), this implementation
interns actors into dense integer slots and keeps all node state in flat
numpy arrays — exactly the layout the trace kernels (ops/trace.py) consume
and the layout that ships to the device.  The fold (merge_entry) is a
host-side scatter; the trace runs either on host (numpy) or on the
device (PyTorch and the propagate kernel), selected by ``use_device``.

Liveness semantics are identical to the oracle ShadowGraph; differential
tests (tests/test_torch_arrays.py here, tests/test_trace_parity.py in the
reference) drive both over the same entry streams and compare verdicts — the reference author's own dual-graph technique
(reference: ShadowGraph.java:176-199).

One deliberate divergence: when a garbage node's slot is freed, all edges
incident to it are deleted.  The oracle (like the reference) leaves inert
negative-count edges keyed by dead Shadow objects in live actors' outgoing
maps (reference: ShadowGraph.java:64-73 never purges); those edges can
never propagate marks again (a positive edge to garbage is impossible), so
dropping them preserves liveness verdicts while keeping slots recyclable.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Set

import numpy as np
import torch

from ...ops import cuda_decremental
from ...ops import cuda_incremental
from ...ops import cuda_trace as _pt
from ...ops import trace as trace_ops
from ...ops.i64map import I64Map, IntStack
from ...utils import events
from ...utils.platform import resolve_device
from ...utils.validation import require
from . import refob as refob_info
from .messages import StopMsg, WaveMsg
from .state import CrgcContext, Entry

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell
    from .refob import CrgcRefob

_F = trace_ops
_PAIR_EDGE = cuda_incremental.EDGE
_PAIR_SUP = cuda_incremental.SUP


def _readback(value, site: str) -> np.ndarray:
    """The sanctioned device->host crossing on collector paths:
    materialize ``value`` (a tensor on any device, or an array) on host
    and account the transfer as a ``tpu.host_transfer`` event (site +
    bytes; the device observatory attributes it to the active wake
    phase).  Route readbacks through here."""
    if isinstance(value, torch.Tensor):
        out = value.cpu().numpy()  # readback: the sanctioned crossing itself
    else:
        out = np.asarray(value)  # readback: already on the host
    if events.recorder.enabled:
        events.recorder.commit(
            events.HOST_TRANSFER, site=site, bytes=int(out.nbytes)
        )
    return out


def storage_ptrs(bufs) -> list:
    """``data_ptr()`` of every tensor in ``bufs`` (None for anything
    else): what :func:`audit_donation` compares after the update."""
    return [b.data_ptr() if isinstance(b, torch.Tensor) else None
            for b in bufs]


def audit_donation(site: str, before: list, *bufs) -> None:
    """After an update in place of device state: every tensor in
    ``bufs`` must still live where ``before`` (:func:`storage_ptrs`,
    read before the update) says it lived.  One that moved means the
    update allocated new storage and copied, instead of writing in place
    — the wake pays a second copy of that state at that site every time
    — committed as ``tpu.donation_copy`` (the device observatory's
    donation-audit plane)."""
    if not events.recorder.enabled:
        return
    for ptr, buf in zip(before, bufs):
        if ptr is None or not isinstance(buf, torch.Tensor):
            continue
        if buf.data_ptr() != ptr:
            events.recorder.commit(
                events.DONATION_COPY,
                site=site,
                bytes=buf.nelement() * buf.element_size(),
            )


class _WakeHandle:
    """One dispatched pipelined wake: the decremental tracer it ran on
    (``unpack_marks`` / ``invalidate``, the contract ``harvest_trace`` and
    ``expire_stalled_wake`` consume) and the CUDA event recorded after it
    on the device's current stream (None on the CPU, where the wake ran
    to its end before ``launch_trace`` returned)."""

    __slots__ = ("dec", "event")

    def __init__(self, dec, event):
        self.dec = dec
        self.event = event

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def unpack_marks(self, mark_w):
        """Packed mark words -> the (n,) bool mark tensor (still on the
        device).  A wake that fails here invalidates its tracer, so the
        next wake re-derives instead of building on poisoned state."""
        try:
            return _pt.unpack_table(mark_w, self.dec.n)
        except Exception:
            self.dec.invalidate()
            raise

    def invalidate(self) -> None:
        self.dec.invalidate()


class ArrayShadowGraph:
    """Dense-slot shadow graph with kernel-backed tracing."""

    def __init__(
        self,
        context: CrgcContext,
        local_address: Optional[str] = None,
        use_device: bool = False,
        decremental: bool = False,
        initial_capacity: int = 1024,
        trace_mode: str = "auto",
        pull_density: float = 0.25,
        device="cuda",
    ):
        self.context = context
        self.local_address = local_address
        self.use_device = use_device
        #: where the device backends trace (uigc.crgc.device), resolved
        #: and pinned here: a CUDA device raises now when no card is
        #: visible, and the collector's dispatcher thread never picks its
        #: own current card
        self.device = resolve_device(device) if use_device else None
        #: device-trace propagation strategy (uigc.crgc.trace-mode;
        #: cuda_trace MODE_* docs) + the auto mode's pull threshold
        require(
            trace_mode in _pt.TRACE_MODES, "config.trace_mode",
            "bad uigc.crgc.trace-mode", mode=trace_mode,
            valid=_pt.TRACE_MODES,
        )
        self.trace_mode = trace_mode
        self.pull_density = pull_density
        #: collect the per-sweep frontier decomposition (with_stats
        #: fixpoint + device->host stat readback) this wake.  Set by the
        #: collector when a wake profiler is attached — the only
        #: consumer that carries the fields into per-wake records — so
        #: metrics-only or sanitizer-only telemetry setups never pay
        #: the stats variant on the wake path.
        self.sweep_stats = False
        #: capture the marking-parent array on the next trace (the
        #: why-live provenance forest, telemetry/inspect.py).  Gated
        #: exactly like ``sweep_stats``: the collector sets it per wake
        #: only when a liveness inspector asked for verdict-exact
        #: capture, so plain wakes run the parent-free kernels and pay
        #: nothing.
        self.capture_parents = False
        #: (mark, parent) of the last captured trace: ``last_parents[i]``
        #: is the slot whose propagation first marked slot ``i`` at that
        #: verdict, -1 for pseudoroot seeds/unmarked.  Slots on a parent
        #: chain are all marked, so the sweep that follows the capture
        #: never frees a slot the chain names.
        self.last_parents: Optional[np.ndarray] = None
        self.last_parents_mark: Optional[np.ndarray] = None
        #: audit the device state's updates in place and commit
        #: ``tpu.donation_copy`` when one moved a tensor to new storage
        #: (see audit_donation).  Enabled by the device observatory's
        #: attach (telemetry.Telemetry); off, the updating sites pay
        #: one bool check.
        self.donation_audit = False
        #: accumulated per-edge send matrix: packed (src << 32 | dst)
        #: slot key -> messages sent since enablement.  None (default)
        #: = off; the liveness inspector's attach enables it by
        #: assigning a dict.  Fed by every fold plane; rows naming a
        #: swept slot are purged with the slot.
        self.send_matrix: Optional[Dict[int, int]] = None
        #: per-wake closure+repair detection relative to the previous
        #: fixpoint (ops/cuda_decremental.py) instead of a full re-trace
        #: from seeds.
        assert not decremental or use_device, (
            "decremental detection runs on the device trace path"
        )
        self.decremental = decremental
        self._dec = None
        #: full layout rebuilds (the first build, each capacity growth,
        #: log overflows and churn repacks)
        self.rebuilds = 0
        self.total_actors_seen = 0

        cap = max(16, initial_capacity)
        self.capacity = cap
        self.flags = np.zeros(cap, dtype=np.uint8)
        self.recv_count = np.zeros(cap, dtype=np.int64)
        self.supervisor = np.full(cap, -1, dtype=np.int32)
        self.cells: List[Optional["ActorCell"]] = [None] * cap
        self.locations: List[Optional[str]] = [None] * cap

        self.slot_of: Dict["ActorCell", int] = {}
        self.free_slots = IntStack.from_range(0, cap)

        #: packed-plane maps (merge_packed): dense uid -> slot, and the
        #: reverse per-slot uid so freeing a slot invalidates its uid
        #: mapping.  -1 = unmapped.
        self._uid_to_slot = np.full(1024, -1, dtype=np.int64)
        self._slot_uid = np.full(cap, -1, dtype=np.int64)
        #: per-slot flush stamps guarding last-writer-wins writes
        #: against out-of-order ring drains (see _apply_batch)
        self._br_seq = np.full(cap, -1, dtype=np.int64)
        self._sup_seq = np.full(cap, -1, dtype=np.int64)
        self._plane = None
        self._resolve_cell = None

        ecap = max(16, initial_capacity * 2)
        self.edge_capacity = ecap
        self.edge_src = np.zeros(ecap, dtype=np.int32)
        self.edge_dst = np.zeros(ecap, dtype=np.int32)
        self.edge_weight = np.zeros(ecap, dtype=np.int64)
        #: packed (owner << 32 | target) int64 key -> edge id.  An edge is
        #: allocated iff its weight is nonzero, which is what lets the
        #: sweep find every edge incident to a garbage set with one
        #: vectorized scan instead of per-slot incident sets.  A
        #: vectorized hash table, not a dict: the fold's per-batch key
        #: traffic is the collector's hottest map (ops/i64map.py).
        self.edge_of = I64Map()
        self.free_edges = IntStack.from_range(0, ecap)

        #: changelog of pair transitions since the device layout last
        #: consumed it: (insert?, src, dst, kind).  ``None`` means either
        #: "no consumer yet" or "too much churn / geometry change" — the
        #: consumer does a full rebuild (which re-enables the log).  Off
        #: by default so backends that never consume it (the host array)
        #: pay one None check per mutation instead of
        #: accumulating up to ``_log_cap`` dead tuples.
        self._pair_log: Optional[List[tuple]] = None
        self._log_cap = 1 << 20
        self._inc = None  # lazily-built IncrementalCudaLayout
        #: slots whose flags/recv changed since last consumed; enabled
        #: (non-None) by backends that mirror node features elsewhere
        #: (the mesh backend's sharded device arrays)
        self._node_log: Optional[Set[int]] = None

    # ------------------------------------------------------------- #
    # Capacity management (static-shape friendly: powers of two)
    # ------------------------------------------------------------- #

    def _grow_nodes(self) -> None:
        old = self.capacity
        new = old * 2
        self.flags = np.concatenate([self.flags, np.zeros(old, dtype=np.uint8)])
        self.recv_count = np.concatenate(
            [self.recv_count, np.zeros(old, dtype=np.int64)]
        )
        self.supervisor = np.concatenate(
            [self.supervisor, np.full(old, -1, dtype=np.int32)]
        )
        self.cells.extend([None] * old)
        self.locations.extend([None] * old)
        self.free_slots.push_range(old, new)
        self._slot_uid = np.concatenate(
            [self._slot_uid, np.full(old, -1, dtype=np.int64)]
        )
        self._br_seq = np.concatenate(
            [self._br_seq, np.full(old, -1, dtype=np.int64)]
        )
        self._sup_seq = np.concatenate(
            [self._sup_seq, np.full(old, -1, dtype=np.int64)]
        )
        self.capacity = new
        # Node capacity sets the bit-table/supertile geometry: the whole
        # device layout must be rebuilt.
        self._pair_log = None
        self._inc = None
        self._dec = None

    def _grow_edges(self, min_free: int = 1) -> None:
        """Grow in one jump to whatever power-of-two capacity yields
        ``min_free`` free ids — a large batch must not pay one
        array-copy per doubling."""
        old = self.edge_capacity
        new = old * 2
        while new - old + len(self.free_edges) < min_free:
            new *= 2
        self.edge_src = np.concatenate(
            [self.edge_src, np.zeros(new - old, dtype=np.int32)]
        )
        self.edge_dst = np.concatenate(
            [self.edge_dst, np.zeros(new - old, dtype=np.int32)]
        )
        self.edge_weight = np.concatenate(
            [self.edge_weight, np.zeros(new - old, dtype=np.int64)]
        )
        self.free_edges.push_range(old, new)
        self.edge_capacity = new

    # ------------------------------------------------------------- #
    # Interning
    # ------------------------------------------------------------- #

    def slot_for(self, cell: "ActorCell") -> int:
        """Get-or-create the dense slot for an actor (the analogue of
        makeShadow; reference: ShadowGraph.java:45-62)."""
        slot = self.slot_of.get(cell)
        if slot is not None:
            return slot
        if not self.free_slots:
            self._grow_nodes()
        slot = self.free_slots.pop()
        self.total_actors_seen += 1
        self.slot_of[cell] = slot
        self.cells[slot] = cell
        self.locations[slot] = cell.system.address
        self.flags[slot] = _F.FLAG_IN_USE  # not interned, not local
        self.recv_count[slot] = 0
        self.supervisor[slot] = -1
        self._touch(slot)
        return slot

    def _touch(self, slot: int) -> None:
        if self._node_log is not None:
            self._node_log.add(slot)

    def _log_pair(self, insert: bool, src: int, dst: int, kind: int) -> None:
        """Record a live-pair transition for the incremental layout; collapse to a full-rebuild sentinel under extreme churn."""
        log = self._pair_log
        if log is None:
            return
        if len(log) >= self._log_cap:
            self._pair_log = None
            return
        log.append((insert, src, dst, kind))

    def _log_pairs_batch(
        self, insert: bool, srcs: np.ndarray, dsts: np.ndarray, kind: int
    ) -> None:
        """Batched :meth:`_log_pair`; collapses to the rebuild sentinel
        when the batch would overflow the log (a sweep that frees a large
        fraction of the graph crosses the layout's repack threshold
        anyway)."""
        log = self._pair_log
        k = len(srcs)
        if log is None or k == 0:
            return
        if len(log) + k > self._log_cap:
            self._pair_log = None
            return
        log.extend(zip([insert] * k, srcs.tolist(), dsts.tolist(), [kind] * k))

    def _update_edge(self, owner: int, target: int, delta: int) -> None:
        """Zero-count edges are deleted (reference: ShadowGraph.java:64-73)."""
        key = (owner << 32) | target
        eid = self.edge_of.get(key)
        if eid is None:
            if delta == 0:
                return
            if not self.free_edges:
                self._grow_edges()
            eid = self.free_edges.pop()
            self.edge_of[key] = eid
            self.edge_src[eid] = owner
            self.edge_dst[eid] = target
            self.edge_weight[eid] = delta
            if delta > 0:
                self._log_pair(True, owner, target, _PAIR_EDGE)
            return
        w_old = self.edge_weight[eid]
        w = w_old + delta
        if w == 0:
            self._free_edge(eid)
        else:
            self.edge_weight[eid] = w
            # The packer layout depends only on edge *liveness* (weight
            # sign), not magnitude; don't invalidate the layout for
            # plain message-count deltas.
            if (w_old > 0) != (w > 0):
                self._log_pair(w > 0, owner, target, _PAIR_EDGE)

    def _free_edge(self, eid: int) -> None:
        owner = int(self.edge_src[eid])
        target = int(self.edge_dst[eid])
        if self.edge_weight[eid] > 0:
            self._log_pair(False, owner, target, _PAIR_EDGE)
        self.edge_of.pop((owner << 32) | target, None)
        self.edge_weight[eid] = 0
        self.free_edges.push(eid)

    def _set_supervisor(self, child_slot: int, new_sup: int) -> None:
        old = int(self.supervisor[child_slot])
        if old == new_sup:
            return
        if old >= 0:
            self._log_pair(False, child_slot, old, _PAIR_SUP)
        if new_sup >= 0:
            self._log_pair(True, child_slot, new_sup, _PAIR_SUP)
        self.supervisor[child_slot] = new_sup

    # ------------------------------------------------------------- #
    # Folding entries (reference: ShadowGraph.java:75-125)
    # ------------------------------------------------------------- #

    def merge_entry(self, entry: Entry) -> None:
        self_slot = self.slot_for(entry.self_ref.target)
        flags = self.flags
        flags[self_slot] |= _F.FLAG_INTERNED | _F.FLAG_LOCAL
        self.recv_count[self_slot] += entry.recv_count
        if entry.is_busy:
            flags[self_slot] |= _F.FLAG_BUSY
        else:
            flags[self_slot] &= ~_F.FLAG_BUSY
        if entry.is_root:
            flags[self_slot] |= _F.FLAG_ROOT
        else:
            flags[self_slot] &= ~_F.FLAG_ROOT
        self._touch(self_slot)

        field_size = self.context.entry_field_size

        for i in range(field_size):
            owner = entry.created_owners[i]
            if owner is None:
                break
            target_slot = self.slot_for(entry.created_targets[i].target)
            owner_slot = self.slot_for(owner.target)
            self._update_edge(owner_slot, target_slot, 1)

        for i in range(field_size):
            child = entry.spawned_actors[i]
            if child is None:
                break
            child_slot = self.slot_for(child.target)
            self._set_supervisor(child_slot, self_slot)

        sm = self.send_matrix
        for i in range(field_size):
            target = entry.updated_refs[i]
            if target is None:
                break
            target_slot = self.slot_for(target.target)
            info = entry.updated_infos[i]
            send_count = refob_info.count(info)
            if send_count > 0:
                self.recv_count[target_slot] -= send_count
                self._touch(target_slot)
                if sm is not None:
                    key = (self_slot << 32) | target_slot
                    sm[key] = sm.get(key, 0) + send_count
            if not refob_info.is_active(info):
                self._update_edge(self_slot, target_slot, -1)

    def merge_entries(self, entries) -> None:
        """Batched fold of a drained entry queue: one pass of Python to
        flatten the object-world entries into slot arrays, then vectorized
        scatter-applies — instead of per-refob field loops per entry
        (reference semantics: ShadowGraph.java:75-125, applied per wake at
        LocalGC.scala:149-177 cadence).

        Equivalent to ``merge_entry`` in queue order: busy/root are
        last-writer-wins per actor, receive counts are commutative sums,
        and edge deltas are aggregated to their per-pair net effect (the
        layout cares only about liveness transitions of the *final* weight
        against the initial one, and intermediate flip-flops fold to
        net no-ops — the same argument slotmap.fold_log documents)."""
        slot_for = self.slot_for
        slot_of_get = self.slot_of.get
        sm = self.send_matrix

        self_slots: List[int] = []
        busyroot: List[int] = []
        recv_deltas: List[int] = []
        ek: List[int] = []  # packed (owner << 32 | target) edge keys
        esign: List[int] = []
        sp_child: List[int] = []
        sp_parent: List[int] = []

        busy = int(_F.FLAG_BUSY)
        root = int(_F.FLAG_ROOT)
        rows_append = self_slots.append
        br_append = busyroot.append
        rd_append = recv_deltas.append
        ek_append = ek.append
        es_append = esign.append

        for entry in entries:
            sc = entry.self_ref._target
            self_slot = slot_of_get(sc)
            if self_slot is None:
                self_slot = slot_for(sc)
            rows_append(self_slot)
            br_append(
                (busy if entry.is_busy else 0) | (root if entry.is_root else 0)
            )
            rd_append(entry.recv_count)

            for owner, target in zip(
                entry.created_owners, entry.created_targets
            ):
                if owner is None:
                    break
                oc = owner._target
                tc = target._target
                os_ = slot_of_get(oc)
                if os_ is None:
                    os_ = slot_for(oc)
                ts = slot_of_get(tc)
                if ts is None:
                    ts = slot_for(tc)
                ek_append((os_ << 32) | ts)
                es_append(1)

            for child in entry.spawned_actors:
                if child is None:
                    break
                cc = child._target
                cs = slot_of_get(cc)
                if cs is None:
                    cs = slot_for(cc)
                sp_child.append(cs)
                sp_parent.append(self_slot)

            for target, info in zip(entry.updated_refs, entry.updated_infos):
                if target is None:
                    break
                tc = target._target
                target_slot = slot_of_get(tc)
                if target_slot is None:
                    target_slot = slot_for(tc)
                send_count = info >> 1
                if send_count > 0:
                    rows_append(target_slot)
                    br_append(-1)  # recv-only row
                    rd_append(-send_count)
                    if sm is not None:
                        key = (self_slot << 32) | target_slot
                        sm[key] = sm.get(key, 0) + send_count
                if info & 1:  # deactivated (refob_info.is_active == False)
                    ek_append((self_slot << 32) | target_slot)
                    es_append(-1)
        self._apply_batch(
            np.asarray(self_slots, dtype=np.int64),
            np.asarray(busyroot, dtype=np.int64),
            np.asarray(recv_deltas, dtype=np.int64),
            np.asarray(ek, dtype=np.int64),
            np.asarray(esign, dtype=np.int64),
            np.asarray(sp_child, dtype=np.int64),
            np.asarray(sp_parent, dtype=np.int64),
        )

    def _apply_batch(
        self,
        sl: np.ndarray,
        br: np.ndarray,
        rd: np.ndarray,
        ek: np.ndarray,
        esign: np.ndarray,
        sp_child: np.ndarray,
        sp_parent: np.ndarray,
        sl_seq: Optional[np.ndarray] = None,
        sp_seq: Optional[np.ndarray] = None,
    ) -> None:
        """The vectorized scatter-applies shared by both fold planes
        (object entries and packed rows).

        ``sl``/``br``/``rd`` run in queue order; rows with ``br == -1``
        are recv-only (no busy/root write).  ``ek``/``esign`` are packed
        ``owner << 32 | target`` edge keys with signs, order-free (only
        net deltas matter).  ``sp_child``/``sp_parent`` run in queue
        order (last writer wins a child's supervisor).

        ``sl_seq``/``sp_seq`` (packed plane only): global flush stamps
        for the last-writer-wins writes.  Per-thread rings drain
        independently, so a LATER batch can carry an EARLIER flush of
        the same actor — the stamps let the graph refuse stale busy/
        root/supervisor writes across batches.  Additive facts (recv
        sums, interning, net edge deltas) commute and need no guard.
        The object plane passes None: its single FIFO queue already
        totally orders flushes."""
        if sl.size:
            np.add.at(self.recv_count, sl, rd)
            selfrows = br >= 0
            ssl = sl[selfrows]
            sbr = br[selfrows]
            # Last entry wins busy/root: unique() on the reversed slot
            # array returns each slot's first reversed occurrence = its
            # last occurrence in queue order.
            u, ridx = np.unique(ssl[::-1], return_index=True)
            last_bits = sbr[::-1][ridx].astype(np.uint8)
            f = self.flags
            interned = np.uint8(int(_F.FLAG_INTERNED) | int(_F.FLAG_LOCAL))
            keep = np.uint8(0xFF & ~(int(_F.FLAG_BUSY) | int(_F.FLAG_ROOT)))
            if sl_seq is not None:
                seqs = sl_seq[selfrows][::-1][ridx]
                fresh = seqs >= self._br_seq[u]
                self._br_seq[u[fresh]] = seqs[fresh]
                # Interning is monotone — applies even for stale rows.
                f[u] |= interned
                uf = u[fresh]
                f[uf] = (f[uf] & keep) | last_bits[fresh]
            else:
                f[u] = ((f[u] | interned) & keep) | last_bits
            if self._node_log is not None:
                self._node_log.update(sl.tolist())

        if sp_child.size:
            u, ridx = np.unique(sp_child[::-1], return_index=True)
            newp = sp_parent[::-1][ridx]
            if sp_seq is not None:
                seqs = sp_seq[::-1][ridx]
                fresh = seqs >= self._sup_seq[u]
                self._sup_seq[u[fresh]] = seqs[fresh]
                u, newp = u[fresh], newp[fresh]
            old = self.supervisor[u].astype(np.int64)
            changed = old != newp
            uu, oo, nn = u[changed], old[changed], newp[changed]
            has_old = oo >= 0
            self._log_pairs_batch(False, uu[has_old], oo[has_old], _PAIR_SUP)
            self._log_pairs_batch(True, uu, nn, _PAIR_SUP)
            self.supervisor[uu] = nn

        if ek.size:
            u, inv = np.unique(ek, return_inverse=True)
            delta = np.zeros(u.size, dtype=np.int64)
            np.add.at(delta, inv, esign)
            nz = delta != 0
            self._apply_edge_deltas(u[nz], delta[nz])

    # ------------------------------------------------------------- #
    # Packed-plane fold (packed.py row layout)
    # ------------------------------------------------------------- #

    def attach_packed_plane(self, plane, resolve_cell) -> None:
        """Wire the engine's packed plane in: ``plane.uid_strong`` pins
        cells named by in-flight rows; ``resolve_cell`` (the system's
        weak uid registry) is the fallback for uids whose pin was
        already consumed."""
        self._plane = plane
        self._resolve_cell = resolve_cell

    def _slots_for_uids(self, uids: np.ndarray) -> np.ndarray:
        """Map uids -> slots through the dense array, interning unseen
        uids (the only per-item Python in the packed fold, bounded by
        the spawn rate rather than the flush rate).

        An unresolvable uid maps to -1 and the caller drops the fields
        naming it.  That is sound, not lossy: a uid resolves through
        the plane's strong pin (held from flush until the actor's slot
        is swept) or the system's weak registry (hit for any cell the
        runtime still references, i.e. every live actor), so
        unresolvable means the collector already PROVED the actor
        garbage and swept it — and garbage is monotone, so late facts
        about it (receive deltas, deactivations, edges) change nothing
        the sweep has not already settled."""
        m = self._uid_to_slot
        maxu = int(uids.max(initial=0))
        if maxu >= m.shape[0]:
            grown = max(m.shape[0] * 2, maxu + 1)
            m = np.concatenate(
                [m, np.full(grown - m.shape[0], -1, dtype=np.int64)]
            )
            self._uid_to_slot = m
        slots = m[uids]
        missing = slots < 0
        if missing.any():
            us = self._plane.uid_strong
            resolve = self._resolve_cell
            for uid in np.unique(uids[missing]).tolist():
                cell = us.get(uid)
                if cell is None:
                    cell = resolve(uid)
                    if cell is None:
                        continue  # proven-garbage uid: fields dropped
                slot = self.slot_for(cell)
                m[uid] = slot
                self._slot_uid[slot] = uid
            slots = m[uids]
        return slots

    def merge_packed(self, rows: np.ndarray) -> None:
        """Fold a drained batch of packed rows: restore global flush
        order from the seq column, map uids to slots, and run the same
        vectorized scatter-applies as the object plane — semantically
        ``merge_entry`` per row, in seq order, with flush stamps
        guarding cross-batch staleness (see _apply_batch) and fields
        naming proven-garbage uids dropped (see _slots_for_uids)."""
        E = self.context.entry_field_size
        order = np.argsort(rows[:, 0], kind="stable")
        R = rows[order]

        self_slots = self._slots_for_uids(R[:, 1])
        c0 = 4

        # Created (owner,target) pairs are extracted BEFORE the
        # self-uid keep filter: the facts name only the owner and the
        # target, not the flushing actor, so an unresolvable flusher
        # must not drop edges between two other, still-live actors —
        # an under-counted live edge is exactly the over-collection
        # hazard the soundness invariant forbids (ADVICE r5).
        created = R[:, c0 : c0 + 2 * E]
        ow = created[:, 0::2].ravel()
        tg = created[:, 1::2].ravel()
        vc = ow >= 0
        ow, tg = ow[vc], tg[vc]
        ow_s = self._slots_for_uids(ow) if ow.size else ow
        tg_s = self._slots_for_uids(tg) if tg.size else tg
        cok = (ow_s >= 0) & (tg_s >= 0)
        ow_s, tg_s = ow_s[cok], tg_s[cok]

        if (self_slots < 0).any():
            # Only the flusher's OWN facts (self state, recv delta,
            # spawned children, updated refobs) drop with it.
            keep = self_slots >= 0
            R = R[keep]
            self_slots = self_slots[keep]
        seq = R[:, 0]
        bits = R[:, 2]
        recv = R[:, 3]
        spawned = R[:, c0 + 2 * E : c0 + 3 * E]
        upd = R[:, c0 + 3 * E : c0 + 5 * E]

        sp = spawned.ravel()
        vs = sp >= 0
        sp_s = self._slots_for_uids(sp[vs]) if vs.any() else sp[vs]
        sp_parent = np.repeat(self_slots, E)[vs]
        sp_seq = np.repeat(seq, E)[vs]
        sok = sp_s >= 0
        sp_s, sp_parent, sp_seq = sp_s[sok], sp_parent[sok], sp_seq[sok]

        ut = upd[:, 0::2].ravel()
        ui = upd[:, 1::2].ravel()
        vu = ut >= 0
        ut_s = self._slots_for_uids(ut[vu]) if vu.any() else ut[vu]
        uok = ut_s >= 0
        ut_s = ut_s[uok]
        uiv = ui[vu][uok]
        upd_self = np.repeat(self_slots, E)[vu][uok]

        # busy/root bit pairs -> flag bytes
        lb = np.array(
            [
                0,
                int(_F.FLAG_BUSY),
                int(_F.FLAG_ROOT),
                int(_F.FLAG_BUSY) | int(_F.FLAG_ROOT),
            ],
            dtype=np.int64,
        )
        br = lb[bits & 3]

        send = uiv >> 1
        has_send = send > 0
        deact = (uiv & 1) == 1

        sm = self.send_matrix
        if sm is not None and has_send.any():
            skeys = (upd_self[has_send] << 32) | ut_s[has_send]
            for key, count in zip(skeys.tolist(), send[has_send].tolist()):
                sm[key] = sm.get(key, 0) + count

        sl = np.concatenate([self_slots, ut_s[has_send]])
        brr = np.concatenate([br, np.full(int(has_send.sum()), -1, np.int64)])
        rdd = np.concatenate([recv, -send[has_send]])
        sl_seq = np.concatenate([seq, np.zeros(int(has_send.sum()), np.int64)])

        ek = np.concatenate(
            [(ow_s << 32) | tg_s, (upd_self[deact] << 32) | ut_s[deact]]
        )
        esign = np.concatenate(
            [
                np.ones(ow_s.size, dtype=np.int64),
                np.full(int(deact.sum()), -1, dtype=np.int64),
            ]
        )

        self._apply_batch(
            sl, brr, rdd, ek, esign, sp_s, sp_parent,
            sl_seq=sl_seq, sp_seq=sp_seq,
        )

    def _apply_edge_deltas(self, keys: np.ndarray, deltas: np.ndarray) -> None:
        """Vectorized ``_update_edge`` over unique packed keys with
        nonzero net deltas: bulk id allocation, array scatter, batch dict
        update, and batched liveness-transition logging."""
        eo = self.edge_of
        eids = eo.get_batch(keys)
        existing = eids >= 0

        ex_eids = eids[existing]
        if ex_eids.size:
            w = self.edge_weight
            ex_keys = keys[existing]
            w_old = w[ex_eids]
            w_new = w_old + deltas[existing]
            live_old = w_old > 0
            live_new = w_new > 0
            went_live = ~live_old & live_new
            went_dead = live_old & ~live_new
            if went_live.any():
                self._log_pairs_batch(
                    True,
                    ex_keys[went_live] >> 32,
                    ex_keys[went_live] & 0xFFFFFFFF,
                    _PAIR_EDGE,
                )
            if went_dead.any():
                self._log_pairs_batch(
                    False,
                    ex_keys[went_dead] >> 32,
                    ex_keys[went_dead] & 0xFFFFFFFF,
                    _PAIR_EDGE,
                )
            w[ex_eids] = w_new
            freed = w_new == 0
            if freed.any():
                fr = ex_eids[freed]
                w[fr] = 0
                self.free_edges.push_batch(fr)
                eo.pop_batch(ex_keys[freed])

        new_keys = keys[~existing]
        if new_keys.size:
            d_new = deltas[~existing]
            need = int(new_keys.size)
            if len(self.free_edges) < need:
                self._grow_edges(min_free=need)
            aa = self.free_edges.pop_batch(need)
            self.edge_src[aa] = (new_keys >> 32).astype(np.int32)
            self.edge_dst[aa] = (new_keys & 0xFFFFFFFF).astype(np.int32)
            self.edge_weight[aa] = d_new
            eo.put_batch_new(new_keys, aa)
            pos = d_new > 0
            if pos.any():
                self._log_pairs_batch(
                    True,
                    new_keys[pos] >> 32,
                    new_keys[pos] & 0xFFFFFFFF,
                    _PAIR_EDGE,
                )

    def merge_delta(self, delta) -> None:
        """Fold a peer node's compressed batch
        (reference: ShadowGraph.java:127-156)."""
        decoder = delta.decoder()
        slots = [self.slot_for(cell) for cell in decoder]
        for i, delta_shadow in enumerate(delta.shadows):
            slot = slots[i]
            if delta_shadow.interned:
                self.flags[slot] |= _F.FLAG_INTERNED
                if delta_shadow.is_busy:
                    self.flags[slot] |= _F.FLAG_BUSY
                else:
                    self.flags[slot] &= ~_F.FLAG_BUSY
                if delta_shadow.is_root:
                    self.flags[slot] |= _F.FLAG_ROOT
                else:
                    self.flags[slot] &= ~_F.FLAG_ROOT
            self.recv_count[slot] += delta_shadow.recv_count
            self._touch(slot)
            if delta_shadow.supervisor >= 0:
                self._set_supervisor(slot, slots[delta_shadow.supervisor])
            for target_id, count in delta_shadow.outgoing.items():
                self._update_edge(slot, slots[target_id], count)

    def merge_undo_log(self, log) -> None:
        """Halt a dead node's actors and revert its unadmitted effects
        (reference: ShadowGraph.java:158-174).

        The worklist grows while folding: applying admitted created-refs
        can intern previously-unknown target actors, and those must also
        be visited (halted if they lived on the dead node) — the oracle
        gets this by iterating its live from_set list, which visits
        shadows appended mid-fold."""
        cells = list(self.slot_of.keys())
        seen = set(cells)
        i = 0
        while i < len(cells):
            cell = cells[i]
            i += 1
            slot = self.slot_of[cell]
            if self.locations[slot] == log.node_address:
                self.flags[slot] |= _F.FLAG_HALTED
                self._touch(slot)
            field = log.admitted.get(cell)
            if field is not None:
                self.recv_count[slot] += field.message_count
                self._touch(slot)
                for target_cell, count in field.created_refs.items():
                    if target_cell not in seen:
                        seen.add(target_cell)
                        cells.append(target_cell)
                    self._update_edge(slot, self.slot_for(target_cell), count)

    # ------------------------------------------------------------- #
    # Trace + sweep (reference: ShadowGraph.java:205-289)
    # ------------------------------------------------------------- #

    def compute_marks(self) -> np.ndarray:
        if self.use_device:
            with events.recorder.timed(events.DEVICE_TRACE) as ev:
                if self.decremental:
                    return _readback(
                        self._compute_marks_decremental(ev),
                        "marks.decremental",
                    )
                return _readback(self._compute_marks_cuda(ev), "marks.cuda")
        # Host path: slice to the occupancy watermark.  Slots allocate
        # lowest-first (IntStack from_range), so live slots cluster low
        # and the 12-sweep fixpoint need not scan the grown capacity —
        # two O(capacity) scans here replace O(capacity) work in every
        # sweep.  Safe: flags beyond the last in-use slot are zero, and
        # every nonzero-weight edge/supervisor references in-use slots.
        nz = np.flatnonzero(self.flags)
        h = int(nz[-1]) + 1 if nz.size else 0
        enz = np.flatnonzero(self.edge_weight)
        eh = int(enz[-1]) + 1 if enz.size else 0
        mark = np.zeros(self.capacity, dtype=bool)
        if h:
            mark[:h] = trace_ops.trace_marks_np(
                self.flags[:h],
                self.recv_count[:h],
                self.supervisor[:h],
                self.edge_src[:eh],
                self.edge_dst[:eh],
                self.edge_weight[:eh],
            )
        return mark

    def _compute_marks_with_parents(self) -> np.ndarray:
        """Mark fixpoint with why-live parent capture: stores the
        (mark, parent) pair on ``last_parents``/``last_parents_mark``
        and returns the marks.  Marks are bit-identical to
        :meth:`compute_marks` (parity-tested against both kernels), so
        the sweep that consumes them is unchanged.  The device form is
        one extra scatter-min fixpoint (ops/cuda_trace.py
        marking_parents_torch — the propagate kernel ORs bits and cannot
        attribute sources); the host form is the numpy twin.  Reached
        only when ``capture_parents`` was set for this wake."""
        if self.use_device:
            with events.recorder.timed(events.DEVICE_TRACE) as ev:
                ev.fields["trace_mode"] = self.trace_mode
                ev.fields["capture_parents"] = True
                mark, parent = _pt.marking_parents_torch(
                    self.flags,
                    self.recv_count,
                    self.supervisor,
                    self.edge_src,
                    self.edge_dst,
                    self.edge_weight,
                    device=self.device,
                )
                mark = _readback(mark, "marks.parents")
                parent = _readback(parent, "parents.capture")
        else:
            mark, parent = trace_ops.trace_marks_np_parents(
                self.flags,
                self.recv_count,
                self.supervisor,
                self.edge_src,
                self.edge_dst,
                self.edge_weight,
            )
        # Both branches materialized host arrays above (the device one
        # through the accounted _readback), so these are plain aliases.
        self.last_parents = parent
        self.last_parents_mark = mark
        return mark

    def _stamp_sweep_stats(self, ev, stats: Optional[dict]) -> None:
        """Attach the fixpoint's per-sweep frontier decomposition to the
        enclosing DEVICE_TRACE event — the wake profiler
        (telemetry/profile.py) carries these fields into its per-wake
        records, which is where the pull-density threshold is tuned
        from data (tools/sweep_profile.py reads the same shapes)."""
        ev.fields["trace_mode"] = self.trace_mode
        if stats is None:
            return
        stats = {k: _readback(v, "sweep.stats") for k, v in stats.items()}
        k = int(stats["n_sweeps"])
        ev.fields["n_sweeps"] = k
        k = min(k, len(stats["dirty_chunks"]))
        ev.fields["sweep_dirty_chunks"] = stats["dirty_chunks"][:k].tolist()
        if "changed_supers" in stats:
            ev.fields["sweep_changed_supers"] = (
                stats["changed_supers"][:k].tolist()
            )
        ev.fields["sweep_tiles_skipped"] = stats["tiles_skipped"][:k].tolist()
        ev.fields["sweep_pull_on"] = stats["pull_on"][:k].tolist()

    def _upload(self) -> tuple:
        """Flags and receive counts as tensors on the device: synchronous
        copies, so the host may go on folding into ``self.flags`` and
        ``self.recv_count`` once this returns."""
        return (
            torch.from_numpy(self.flags).to(self.device, copy=True),
            torch.from_numpy(self.recv_count).to(self.device, copy=True),
        )

    def _compute_marks_cuda(self, ev=None) -> torch.Tensor:
        """Device trace through the propagate kernel; returns the (n,)
        bool mark tensor on the device.

        Layout maintenance is incremental (ops/cuda_incremental.py):
        pair transitions recorded in ``_pair_log`` are folded into the
        cached base+delta layout in O(changes), and its operands stay on
        the device between wakes, so a churning graph pays neither a
        full O(E log E) repack nor a re-upload before every wake.  A full
        rebuild happens only on node-capacity growth, log overflow, or
        when accumulated churn crosses the layout's repack threshold."""
        self._inc = self._sync_layout(
            self._inc,
            lambda: cuda_incremental.IncrementalCudaLayout(
                self.capacity,
                mode=self.trace_mode,
                pull_density=self.pull_density,
                device=self.device,
            ),
            lambda l: l.needs_repack,
        )
        flags_dev, recv_dev = self._upload()
        if ev is not None and self.sweep_stats:
            marks, stats = self._inc.trace_device(
                flags_dev, recv_dev, with_stats=True
            )
            self._stamp_sweep_stats(ev, stats)
            return marks
        return self._inc.trace_device(flags_dev, recv_dev)

    def _sync_layout(self, obj, make, needs_repack) -> object:
        """The pair-log consumption state machine shared by the device
        and decremental paths: (re)build on a missing object, geometry
        change, or log overflow (``_pair_log is None``); otherwise fold
        the log and repack when accumulated churn crosses the layout's
        threshold.  Returns the up-to-date object."""
        if obj is None or self._pair_log is None:
            if obj is None or obj.n != self.capacity:
                obj = make()
            obj.rebuild(
                self.edge_src, self.edge_dst, self.edge_weight, self.supervisor
            )
            self.rebuilds += 1
            self._pair_log = []
        elif self._pair_log:
            obj.apply_log(self._pair_log)
            self._pair_log.clear()
            if needs_repack(obj):
                obj.rebuild(
                    self.edge_src,
                    self.edge_dst,
                    self.edge_weight,
                    self.supervisor,
                )
                self.rebuilds += 1
        return obj

    def _compute_marks_decremental(self, ev=None) -> torch.Tensor:
        """Per-wake detection through the decremental tracer: the wake
        cost is proportional to the churn's affected region, not the
        graph (ops/cuda_decremental.py; the steady-state analogue of
        the reference's 50ms incremental collect, LocalGC.scala:144-186,
        at scales where a full re-trace cannot meet the cadence).
        Returns the (n,) bool mark tensor on the device."""
        self._dec = self._synced_dec()
        self._dec.collect_stats = ev is not None and self.sweep_stats
        try:
            mark_w = self._dec.wake_device(*self._upload())
            if self._dec.collect_stats:
                self._stamp_sweep_stats(ev, self._dec.last_stats)
            return _pt.unpack_table(mark_w, self._dec.n)
        except Exception:
            # A wake that raises part way may have committed state; drop
            # it so the next wake re-derives instead of building on it.
            self._dec.invalidate()
            raise

    # ------------------------------------------------------------- #
    # Pipelined collection (SURVEY §7 "hard parts": the 50ms cadence
    # can't meet a 10ms detection budget without overlapping host
    # ingest and the device trace).  launch_trace() snapshots the node
    # features and dispatches the device wake asynchronously;
    # harvest_trace() later sweeps with the SNAPSHOT verdicts.  Sound
    # because CRGC garbage is monotone: an actor unreachable and
    # quiescent at any consistent snapshot can never be resurrected
    # (only garbage held references to it), so acting on a stale
    # verdict kills nothing live — and slots are freed only by the
    # harvest itself, so the snapshot's slot bindings still hold.
    # ------------------------------------------------------------- #

    _pending_wake = None

    @property
    def can_pipeline(self) -> bool:
        return self.use_device and self.decremental

    @property
    def has_pending_wake(self) -> bool:
        return self._pending_wake is not None

    def _synced_dec(self):
        """The decremental tracer, synced with the pair log (the one
        construction site for both the synchronous and pipelined
        paths)."""
        self._dec = self._sync_layout(
            self._dec,
            lambda: cuda_decremental.DecrementalTracer(
                self.capacity,
                mode=self.trace_mode,
                pull_density=self.pull_density,
                device=self.device,
            ),
            lambda d: d.layout.needs_repack,
        )
        return self._dec

    def _start_wake(self) -> tuple:
        """Dispatch one wake; returns ``(handle, mark_dev)`` where the
        handle provides ``is_ready`` / ``unpack_marks`` / ``invalidate``
        (the contract harvest_ready, harvest_trace and
        expire_stalled_wake consume).  The uploads are synchronous copies
        (``_upload``): ``launch_trace`` snapshots and the host keeps
        folding into the same arrays right after.  The wake reads one
        changed flag per sweep on the host (ops/cuda_decremental.py), so
        on the card this returns when the wake's last sweep is issued,
        not before."""
        dec = self._synced_dec()
        mark_dev = dec.wake_device(*self._upload())
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return _WakeHandle(dec, event), mark_dev

    def launch_trace(self) -> None:
        """Dispatch the device wake without waiting for its result.
        No-op while a wake is already in flight."""
        import time

        if self._pending_wake is not None:
            return
        handle, mark_dev = self._start_wake()
        self._pending_wake = (
            handle,
            mark_dev,
            self.flags.copy(),
            self.supervisor.copy(),
            time.monotonic(),
        )

    def harvest_ready(self) -> bool:
        if self._pending_wake is None:
            return False
        is_ready = getattr(self._pending_wake[0], "is_ready", None)
        return bool(is_ready()) if is_ready is not None else True

    def expire_stalled_wake(self, max_age_s: float) -> bool:
        """A wake whose device result never lands (wedged transport)
        must not deadlock the pipeline: past ``max_age_s`` the pending
        wake is abandoned and the tracer invalidated, so the next wake
        is a clean full re-derivation.  Returns True if expired."""
        import time

        if self._pending_wake is None:
            return False
        dec, _, _, _, t0 = self._pending_wake
        if time.monotonic() - t0 < max_age_s:
            return False
        self._pending_wake = None
        dec.invalidate()
        return True

    def harvest_trace(self, should_kill: bool) -> int:
        """Sweep with the pending wake's verdicts against its snapshot.
        Returns the number of garbage actors (0 if nothing pending)."""
        if self._pending_wake is None:
            return 0
        dec, mark_w, snap_flags, snap_sup, _ = self._pending_wake
        self._pending_wake = None
        with events.recorder.timed(events.TRACING) as ev:
            # unpack_marks invalidates the tracer on failure, so a
            # poisoned wake needs no handling here.
            mark = _readback(dec.unpack_marks(mark_w), "marks.harvest")
            with events.recorder.timed(events.SWEEP):
                garbage, kill = trace_ops.garbage_and_kills_np(
                    snap_flags, snap_sup, mark
                )
                if garbage.shape[0] < self.capacity:
                    # capacity grew between launch and harvest: slots beyond
                    # the snapshot were interned after it, so they carry no
                    # verdict (not garbage) — pad so the sweep's edge scans
                    # index the grown arrays safely
                    pad = np.zeros(self.capacity - garbage.shape[0], bool)
                    garbage = np.concatenate([garbage, pad])
                    kill = np.concatenate([kill, pad])
                garbage_slots = np.nonzero(garbage)[0]
                kill_slots = np.nonzero(kill)[0]
                if should_kill and kill_slots.size:
                    self._kill_slots_bulk(kill_slots)
                if garbage_slots.size:
                    self._free_slots_batch(garbage, garbage_slots)
            ev.fields["num_garbage_actors"] = int(garbage_slots.size)
            ev.fields["num_live_actors"] = int(np.count_nonzero(mark))
        return int(garbage_slots.size)

    def trace(self, should_kill: bool) -> int:
        # A synchronous trace sweeps against CURRENT state; an
        # unharvested pipelined wake would later sweep a snapshot whose
        # slot bindings this sweep is about to invalidate (freed or
        # re-interned slots) — discard it.  Nothing is lost: the fresh
        # verdicts computed here are a superset of the snapshot's
        # (garbage is monotone).
        self._pending_wake = None
        with events.recorder.timed(events.TRACING) as ev:
            if self.capture_parents:
                mark = self._compute_marks_with_parents()
            else:
                mark = self.compute_marks()
            # The sweep (kill decisions + slot frees) nests in its own
            # timed event so the wake profiler can attribute
            # trace-vs-sweep time (telemetry/profile.py).
            with events.recorder.timed(events.SWEEP):
                garbage, kill = trace_ops.garbage_and_kills_np(
                    self.flags, self.supervisor, mark
                )
                garbage_slots = np.nonzero(garbage)[0]
                kill_slots = np.nonzero(kill)[0]

                if should_kill and kill_slots.size:
                    self._kill_slots_bulk(kill_slots)

                if garbage_slots.size:
                    self._free_slots_batch(garbage, garbage_slots)

            ev.fields["num_garbage_actors"] = int(garbage_slots.size)
            ev.fields["num_live_actors"] = int(np.count_nonzero(mark))
        return int(garbage_slots.size)

    def _kill_slots_bulk(self, kill_slots: np.ndarray) -> None:
        """Send StopMsg to every kill slot's cell as ONE bulk teardown:
        the finalize cascade is batched per dispatcher (and, for remote
        cells, per peer writer), so a wake that kills K actors costs
        O(batches) dispatcher operations, not O(K)."""
        from ...runtime.cell import tell_bulk

        cells = self.cells
        tell_bulk((cells[slot], StopMsg) for slot in kill_slots.tolist())

    def _free_slots_batch(
        self, garbage: np.ndarray, garbage_slots: np.ndarray
    ) -> None:
        """Free every garbage slot in one vectorized pass (the sweep,
        reference: ShadowGraph.java:273-289).

        Incident edges are found by scanning the flat edge arrays — an
        edge is allocated iff its weight is nonzero — instead of per-slot
        incident sets, so the sweep is O(edge capacity) numpy + O(dead
        edges) dict deletions rather than Python set surgery per slot.

        Supervisor pointers *into* a garbage slot need no scan: a live,
        non-halted child marks its supervisor, so the pointing node is
        garbage in the same sweep and its pointer is cleared here too."""
        w = self.edge_weight
        em = (w != 0) & (garbage[self.edge_src] | garbage[self.edge_dst])
        eids = np.nonzero(em)[0]
        if eids.size:
            srcs = self.edge_src[eids]
            dsts = self.edge_dst[eids]
            live = w[eids] > 0
            self._log_pairs_batch(False, srcs[live], dsts[live], _PAIR_EDGE)
            eo = self.edge_of
            if eids.size * 2 > len(eo):
                # Most edges die: rebuild the key map from the survivors
                # in one pass instead of popping each dead key.
                w[eids] = 0
                alive = np.nonzero(w != 0)[0]
                keys = (self.edge_src[alive].astype(np.int64) << 32) | (
                    self.edge_dst[alive]
                )
                self.edge_of = I64Map.build(keys, alive)
            else:
                eo.pop_batch((srcs.astype(np.int64) << 32) | dsts)
                w[eids] = 0
            self.free_edges.push_batch(eids)

        sup = self.supervisor[garbage_slots]
        has_sup = sup >= 0
        self._log_pairs_batch(
            False, garbage_slots[has_sup], sup[has_sup], _PAIR_SUP
        )
        self.supervisor[garbage_slots] = -1
        self.flags[garbage_slots] = 0
        self.recv_count[garbage_slots] = 0

        # Invalidate packed-plane uid mappings and drop the strong pins
        # for freed slots.  A proven-garbage actor can never matter
        # again (CRGC garbage is monotone), so any later row naming its
        # uid is droppable — _slots_for_uids handles the unresolvable
        # case.  Slot reuse also resets the flush-stamp guards.
        su = self._slot_uid
        freed_uids = su[garbage_slots]
        had_uid = freed_uids >= 0
        if had_uid.any():
            self._uid_to_slot[freed_uids[had_uid]] = -1
            su[garbage_slots] = -1
            if self._plane is not None:
                pop = self._plane.uid_strong.pop
                for uid in freed_uids[had_uid].tolist():
                    pop(uid, None)
        self._br_seq[garbage_slots] = -1
        self._sup_seq[garbage_slots] = -1

        sm = self.send_matrix
        if sm:
            # Traffic rows naming a swept slot die with it: a freed slot
            # may re-intern a different actor, and a proven-garbage
            # actor's history is useless to placement.
            dead_keys = [
                key
                for key in sm
                if garbage[key >> 32] or garbage[key & 0xFFFFFFFF]
            ]
            for key in dead_keys:
                del sm[key]

        cells = self.cells
        locations = self.locations
        slot_of = self.slot_of
        slots_list = garbage_slots.tolist()
        for slot in slots_list:
            cell = cells[slot]
            if cell is not None:
                slot_of.pop(cell, None)
                cells[slot] = None
            locations[slot] = None
        self.free_slots.push_batch(garbage_slots)
        if self._node_log is not None:
            self._node_log.update(slots_list)

    # ------------------------------------------------------------- #
    # Waves (reference: ShadowGraph.java:291-299)
    # ------------------------------------------------------------- #

    def start_wave(self) -> int:
        flags = self.flags
        rootmask = (
            ((flags & _F.FLAG_ROOT) != 0)
            & ((flags & _F.FLAG_LOCAL) != 0)
            & ((flags & _F.FLAG_IN_USE) != 0)
        )
        count = 0
        for slot in np.nonzero(rootmask)[0]:
            cell = self.cells[slot]
            if cell is not None:
                count += 1
                cell.tell(WaveMsg)
        return count

    # ------------------------------------------------------------- #
    # Diagnostics
    # ------------------------------------------------------------- #

    @property
    def num_in_use(self) -> int:
        return len(self.slot_of)

    def addresses_in_graph(self) -> Dict[str, int]:
        """Uncollected shadows per node address
        (reference: ShadowGraph.java:331-340, structured instead of
        printed)."""
        counts: Dict[str, int] = {}
        for slot in self.slot_of.values():
            loc = self.locations[slot]
            counts[loc] = counts.get(loc, 0) + 1
        return counts

    def investigate_live_set(self) -> Dict[str, object]:
        """Structured dump of the live set, vectorized over the slot
        arrays (reference: ShadowGraph.java:342-394; same fields as the
        oracle's implementation, differentially tested)."""
        from .shadow import _cell_path

        slots = np.fromiter(
            self.slot_of.values(), np.int64, len(self.slot_of)
        )
        f = self.flags[slots]
        local = (f & _F.FLAG_LOCAL) != 0
        root_slots = slots[(f & _F.FLAG_ROOT) != 0]

        # an edge exists iff weight != 0 (negative = more deactivations
        # seen than creations so far), matching the oracle's outgoing map
        eids = np.nonzero(self.edge_weight != 0)[0]
        esrc = self.edge_src[eids]
        edst = self.edge_dst[eids]
        ew = self.edge_weight[eids]
        out_degree = np.bincount(esrc, minlength=self.capacity)
        local_all = (self.flags & _F.FLAG_LOCAL) != 0
        src_local = local_all[esrc]
        dst_local = local_all[edst]
        ltr = np.nonzero(src_local & ~dst_local)[0]
        local_to_remote = sorted(
            (
                _cell_path(self.cells[int(esrc[e])]),
                _cell_path(self.cells[int(edst[e])]),
                int(ew[e]),
            )
            for e in ltr.tolist()
        )
        return {
            "total": int(slots.size),
            "non_interned": int((~((f & _F.FLAG_INTERNED) != 0)).sum()),
            "roots": int(root_slots.size),
            "busy": int(((f & _F.FLAG_BUSY) != 0).sum()),
            "nonzero_recv": int((self.recv_count[slots] != 0).sum()),
            "nonlocal": int((~local).sum()),
            "root_acquaintances": {
                _cell_path(self.cells[int(s)]): int(out_degree[int(s)])
                for s in root_slots.tolist()
            },
            "local_to_remote": local_to_remote,
            "remote_to_local_count": int((~src_local & dst_local).sum()),
        }

    def count_reachable_from(self, address: str) -> int:
        """(reference: ShadowGraph.java:302-330)"""
        seed = np.zeros(self.capacity, dtype=bool)
        for cell, slot in self.slot_of.items():
            if self.locations[slot] == address:
                seed[slot] = True
        halted = (self.flags & _F.FLAG_HALTED) != 0
        live_edge = self.edge_weight > 0
        esrc = self.edge_src[live_edge]
        edst = self.edge_dst[live_edge]
        mark = seed
        while True:
            active = mark & ~halted
            new_mark = mark.copy()
            if esrc.size:
                new_mark[edst[active[esrc]]] = True
            new_mark &= (self.flags & _F.FLAG_IN_USE) != 0
            new_mark |= mark
            if np.array_equal(new_mark, mark):
                return int(np.count_nonzero(mark))
            mark = new_mark
