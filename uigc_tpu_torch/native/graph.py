"""Copy of ``uigc_tpu/native/graph.py`` (pure Python).

NativeShadowGraph: the ctypes wrapper over the C++ collector data plane.

Drop-in shadow-graph backend (``uigc.crgc.shadow-graph = "native"``) with
the same interface and liveness semantics as the Python oracle
(engines/crgc/shadow.py) and the array/device graphs.  Entries are
flattened into int64 batches and folded in one C call per collection —
the batch-amortized analogue of the reference collector's drain loop
(reference: LocalGC.scala:149-177 folding into ShadowGraph.java:75-125).

Actor cells get per-graph dense 64-bit ids with the node id (location) in
the top bits, so the native side can halt a dead node's actors by integer
compare alone.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np

from ..engines.crgc import refob as refob_info
from ..engines.crgc.messages import StopMsg, WaveMsg
from ..engines.crgc.state import CrgcContext, Entry
from ..utils import events
from . import load

if TYPE_CHECKING:  # pragma: no cover
    from ..runtime.cell import ActorCell

_NODE_SHIFT = 40  # must match crgc_shadow.cpp

_I64 = np.int64
_U8 = np.uint8


def _p64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _p32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _pu8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeShadowGraph:
    """C++-backed shadow graph (reference: ShadowGraph.java:9-299)."""

    def __init__(self, context: CrgcContext, local_address: Optional[str] = None):
        self.context = context
        self.local_address = local_address
        # Set before load() so __del__ is safe if the toolchain is missing.
        self._lib = None
        self._handle = None
        self._lib = load()
        self._handle = ctypes.c_void_p(self._lib.uigc_graph_new())
        self._id_of_cell: Dict["ActorCell", int] = {}
        self._cell_of_id: Dict[int, "ActorCell"] = {}
        self._node_ids: Dict[str, int] = {}
        self._next_seq = 0
        self._reset_batch()

    def __del__(self):  # pragma: no cover - interpreter-shutdown ordering
        handle, self._handle = self._handle, None
        if handle and self._lib is not None:
            self._lib.uigc_graph_free(handle)

    # ------------------------------------------------------------- #
    # Identity
    # ------------------------------------------------------------- #

    def _node_id(self, address: Optional[str]) -> int:
        nid = self._node_ids.get(address)
        if nid is None:
            nid = len(self._node_ids) + 1
            self._node_ids[address] = nid
        return nid

    def _id(self, cell: "ActorCell") -> int:
        aid = self._id_of_cell.get(cell)
        if aid is None:
            self._next_seq += 1
            aid = (self._node_id(cell.system.address) << _NODE_SHIFT) | self._next_seq
            self._id_of_cell[cell] = aid
            self._cell_of_id[aid] = cell
        return aid

    # ------------------------------------------------------------- #
    # Entry batching (reference: ShadowGraph.java:75-125)
    # ------------------------------------------------------------- #

    def _reset_batch(self) -> None:
        self._b_self: List[int] = []
        self._b_recv: List[int] = []
        self._b_eflags: List[int] = []
        self._b_created_off: List[int] = [0]
        self._b_created_owners: List[int] = []
        self._b_created_targets: List[int] = []
        self._b_spawned_off: List[int] = [0]
        self._b_spawned: List[int] = []
        self._b_updated_off: List[int] = [0]
        self._b_updated: List[int] = []
        self._b_send_counts: List[int] = []
        self._b_deact: List[int] = []

    def merge_entry(self, entry: Entry) -> None:
        """Flatten one snapshot into the pending batch; the fold happens
        natively at the next flush point (trace/delta/undo/wave)."""
        self._b_self.append(self._id(entry.self_ref.target))
        self._b_recv.append(entry.recv_count)
        self._b_eflags.append(
            (1 if entry.is_busy else 0) | (2 if entry.is_root else 0)
        )
        field_size = self.context.entry_field_size
        for i in range(field_size):
            owner = entry.created_owners[i]
            if owner is None:
                break
            self._b_created_owners.append(self._id(owner.target))
            self._b_created_targets.append(self._id(entry.created_targets[i].target))
        self._b_created_off.append(len(self._b_created_owners))
        for i in range(field_size):
            child = entry.spawned_actors[i]
            if child is None:
                break
            self._b_spawned.append(self._id(child.target))
        self._b_spawned_off.append(len(self._b_spawned))
        for i in range(field_size):
            target = entry.updated_refs[i]
            if target is None:
                break
            info = entry.updated_infos[i]
            self._b_updated.append(self._id(target.target))
            self._b_send_counts.append(refob_info.count(info))
            self._b_deact.append(0 if refob_info.is_active(info) else 1)
        self._b_updated_off.append(len(self._b_updated))

    def _flush(self) -> None:
        n = len(self._b_self)
        if n == 0:
            return
        self._lib.uigc_merge_entries(
            self._handle,
            n,
            _p64(np.array(self._b_self, dtype=_I64)),
            _p64(np.array(self._b_recv, dtype=_I64)),
            _pu8(np.array(self._b_eflags, dtype=_U8)),
            _p64(np.array(self._b_created_off, dtype=_I64)),
            _p64(np.array(self._b_created_owners, dtype=_I64)),
            _p64(np.array(self._b_created_targets, dtype=_I64)),
            _p64(np.array(self._b_spawned_off, dtype=_I64)),
            _p64(np.array(self._b_spawned, dtype=_I64)),
            _p64(np.array(self._b_updated_off, dtype=_I64)),
            _p64(np.array(self._b_updated, dtype=_I64)),
            _p64(np.array(self._b_send_counts, dtype=_I64)),
            _pu8(np.array(self._b_deact, dtype=_U8)),
        )
        self._reset_batch()

    # ------------------------------------------------------------- #
    # Peer folds (reference: ShadowGraph.java:127-174)
    # ------------------------------------------------------------- #

    def merge_delta(self, delta) -> None:
        self._flush()
        decoder = delta.decoder()
        n = len(delta.shadows)
        ids = np.array([self._id(cell) for cell in decoder], dtype=_I64)
        recv = np.empty(n, dtype=_I64)
        sup = np.empty(n, dtype=np.int32)
        dflags = np.empty(n, dtype=_U8)
        out_off = np.empty(n + 1, dtype=_I64)
        out_idx: List[int] = []
        out_count: List[int] = []
        out_off[0] = 0
        for i, shadow in enumerate(delta.shadows):
            recv[i] = shadow.recv_count
            sup[i] = shadow.supervisor
            dflags[i] = (
                (1 if shadow.interned else 0)
                | (2 if shadow.is_busy else 0)
                | (4 if shadow.is_root else 0)
            )
            for target_id, count in shadow.outgoing.items():
                out_idx.append(target_id)
                out_count.append(count)
            out_off[i + 1] = len(out_idx)
        self._lib.uigc_merge_delta(
            self._handle,
            n,
            _p64(ids),
            _p64(recv),
            _p32(sup),
            _pu8(dflags),
            _p64(out_off),
            _p32(np.array(out_idx, dtype=np.int32)),
            _p64(np.array(out_count, dtype=_I64)),
        )

    def merge_undo_log(self, log) -> None:
        self._flush()
        n = len(log.admitted)
        admitted_ids = np.empty(n, dtype=_I64)
        msg_counts = np.empty(n, dtype=_I64)
        created_off = np.empty(n + 1, dtype=_I64)
        created_targets: List[int] = []
        created_counts: List[int] = []
        created_off[0] = 0
        for i, (cell, field) in enumerate(log.admitted.items()):
            admitted_ids[i] = self._id(cell)
            msg_counts[i] = field.message_count
            for target_cell, count in field.created_refs.items():
                created_targets.append(self._id(target_cell))
                created_counts.append(count)
            created_off[i + 1] = len(created_targets)
        self._lib.uigc_merge_undo(
            self._handle,
            self._node_id(log.node_address),
            n,
            _p64(admitted_ids),
            _p64(msg_counts),
            _p64(created_off),
            _p64(np.array(created_targets, dtype=_I64)),
            _p64(np.array(created_counts, dtype=_I64)),
        )
        # The undo fold only interns actors already in the graph or reached
        # through a visited field; admitted cells the graph never saw must
        # not linger in the id maps (they would never be swept).
        self._prune_id_maps()

    def _prune_id_maps(self) -> None:
        cap = int(self._lib.uigc_num_in_use(self._handle))
        live = np.empty(max(cap, 1), dtype=_I64)
        n = int(self._lib.uigc_live_ids(self._handle, _p64(live)))
        keep = set(int(aid) for aid in live[:n])
        for aid in [a for a in self._cell_of_id if a not in keep]:
            cell = self._cell_of_id.pop(aid)
            self._id_of_cell.pop(cell, None)

    # ------------------------------------------------------------- #
    # Trace + sweep (reference: ShadowGraph.java:205-289)
    # ------------------------------------------------------------- #

    def trace(self, should_kill: bool) -> int:
        with events.recorder.timed(events.TRACING) as ev:
            self._flush()
            cap = int(self._lib.uigc_num_in_use(self._handle))
            garbage_ids = np.empty(max(cap, 1), dtype=_I64)
            kill_ids = np.empty(max(cap, 1), dtype=_I64)
            n_kill = ctypes.c_int64(0)
            n_live = ctypes.c_int64(0)
            n_garbage = int(
                self._lib.uigc_trace(
                    self._handle,
                    _p64(garbage_ids),
                    _p64(kill_ids),
                    ctypes.byref(n_kill),
                    ctypes.byref(n_live),
                )
            )
            # Host-side sweep (the C trace already freed its own state)
            # in its own timed event for the wake profiler's
            # trace-vs-sweep attribution (telemetry/profile.py).
            with events.recorder.timed(events.SWEEP):
                if should_kill and n_kill.value:
                    from ..runtime.cell import tell_bulk

                    cell_of_id = self._cell_of_id
                    tell_bulk(
                        (cell_of_id[int(aid)], StopMsg)
                        for aid in kill_ids[: n_kill.value]
                    )
                for aid in garbage_ids[:n_garbage]:
                    cell = self._cell_of_id.pop(int(aid), None)
                    if cell is not None:
                        self._id_of_cell.pop(cell, None)
            ev.fields["num_garbage_actors"] = n_garbage
            ev.fields["num_live_actors"] = int(n_live.value)
        return n_garbage

    def start_wave(self) -> int:
        """(reference: ShadowGraph.java:291-299)"""
        self._flush()
        cap = int(self._lib.uigc_num_in_use(self._handle))
        root_ids = np.empty(max(cap, 1), dtype=_I64)
        n = int(self._lib.uigc_local_roots(self._handle, _p64(root_ids)))
        count = 0
        for aid in root_ids[:n]:
            cell = self._cell_of_id.get(int(aid))
            if cell is not None:
                count += 1
                cell.tell(WaveMsg)
        return count

    # ------------------------------------------------------------- #
    # Diagnostics
    # ------------------------------------------------------------- #

    @property
    def total_actors_seen(self) -> int:
        self._flush()
        return int(self._lib.uigc_total_seen(self._handle))

    @property
    def num_in_use(self) -> int:
        self._flush()
        return int(self._lib.uigc_num_in_use(self._handle))

    def count_reachable_from(self, address: str) -> int:
        """(reference: ShadowGraph.java:302-330)"""
        self._flush()
        return int(
            self._lib.uigc_count_reachable_from(
                self._handle, self._node_id(address)
            )
        )
