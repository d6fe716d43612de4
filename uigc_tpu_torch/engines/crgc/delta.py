"""Copy of ``uigc_tpu/engines/crgc/delta.py`` (pure Python).

Delta graphs: bandwidth-compressed cross-node entry batches.

Mirrors the reference's DeltaGraph/DeltaShadow (reference:
crgc/DeltaGraph.java:22-253, crgc/DeltaShadow.java:11-85): entries are
folded into per-actor delta shadows whose actor refs are encoded as short
ids via a compression table; full graphs are broadcast to every peer
collector, which replays them into its shadow-graph replica.  Binary
serialization uses the same field layout as the reference's hand-rolled
writers (DeltaShadow.serialize: recvCount int, supervisor short, three
flags, outgoing size + (short,int) pairs).
"""

from __future__ import annotations

import struct
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

from ...utils import events
from . import refob as refob_info
from .state import CrgcContext, Entry

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell


class DeltaShadow:
    """(reference: crgc/DeltaShadow.java:11-51)"""

    __slots__ = ("outgoing", "recv_count", "supervisor", "interned", "is_root", "is_busy")

    def __init__(self) -> None:
        self.outgoing: Dict[int, int] = {}
        self.recv_count = 0
        self.supervisor = -1
        self.interned = False
        self.is_root = False
        self.is_busy = False

    def serialize(self) -> bytes:
        """(reference: DeltaShadow.java:57-75 field order)"""
        parts = [
            struct.pack(
                ">ih???i",
                self.recv_count,
                self.supervisor,
                self.interned,
                self.is_root,
                self.is_busy,
                len(self.outgoing),
            )
        ]
        for key, value in self.outgoing.items():
            parts.append(struct.pack(">hi", key, value))
        return b"".join(parts)

    @staticmethod
    def deserialize(buf: bytes, offset: int) -> tuple:
        """Returns (shadow, new_offset) (reference: DeltaShadow.java:77-84)."""
        shadow = DeltaShadow()
        (
            shadow.recv_count,
            shadow.supervisor,
            shadow.interned,
            shadow.is_root,
            shadow.is_busy,
            size,
        ) = struct.unpack_from(">ih???i", buf, offset)
        offset += struct.calcsize(">ih???i")
        for _ in range(size):
            key, value = struct.unpack_from(">hi", buf, offset)
            offset += struct.calcsize(">hi")
            shadow.outgoing[key] = value
        return shadow, offset

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, DeltaShadow)
            and self.outgoing == other.outgoing
            and self.recv_count == other.recv_count
            and self.supervisor == other.supervisor
            and self.interned == other.interned
            and self.is_root == other.is_root
            and self.is_busy == other.is_busy
        )


class DeltaGraph:
    """(reference: crgc/DeltaGraph.java:22-253)"""

    def __init__(self, address: Optional[str], context: CrgcContext):
        self.compression_table: Dict["ActorCell", int] = {}
        self.shadows: List[DeltaShadow] = []
        self.address = address
        self.context = context

    @property
    def size(self) -> int:
        return len(self.shadows)

    def _encode(self, cell: "ActorCell") -> int:
        """(reference: DeltaGraph.java:141-156)"""
        idx = self.compression_table.get(cell)
        if idx is not None:
            return idx
        idx = len(self.shadows)
        self.compression_table[cell] = idx
        self.shadows.append(DeltaShadow())
        return idx

    def merge_entry(self, entry: Entry) -> None:
        """Mirror of the shadow-graph fold, in compressed-id space
        (reference: DeltaGraph.java:73-125)."""
        self_id = self._encode(entry.self_ref.target)
        self_shadow = self.shadows[self_id]
        self_shadow.interned = True
        self_shadow.recv_count += entry.recv_count
        self_shadow.is_busy = entry.is_busy
        self_shadow.is_root = entry.is_root

        field_size = self.context.entry_field_size
        for i in range(field_size):
            owner = entry.created_owners[i]
            if owner is None:
                break
            target_id = self._encode(entry.created_targets[i].target)
            owner_shadow = self.shadows[self._encode(owner.target)]
            self._update_outgoing(owner_shadow.outgoing, target_id, 1)

        for i in range(field_size):
            child = entry.spawned_actors[i]
            if child is None:
                break
            self.shadows[self._encode(child.target)].supervisor = self_id

        for i in range(field_size):
            target = entry.updated_refs[i]
            if target is None:
                break
            info = entry.updated_infos[i]
            target_id = self._encode(target.target)
            send_count = refob_info.count(info)
            if send_count > 0:
                self.shadows[target_id].recv_count -= send_count
            if not refob_info.is_active(info):
                self._update_outgoing(self_shadow.outgoing, target_id, -1)

    @staticmethod
    def _update_outgoing(outgoing: Dict[int, int], target: int, delta: int) -> None:
        count = outgoing.get(target, 0) + delta
        if count == 0:
            outgoing.pop(target, None)
        else:
            outgoing[target] = count

    # ------------------------------------------------------------- #
    # Routed folds (engines/crgc/distributed.py): one entry's effects
    # split per owning partition.  Each method applies exactly the
    # slice of merge_entry that touches ONE actor's authoritative
    # state, so the distributed router can direct every effect to the
    # delta bound for that actor's owner — and nothing else.
    # ------------------------------------------------------------- #

    def touch(self, cell: "ActorCell") -> None:
        """Bare mention: ensure the cell has a (default, non-interned)
        shadow in this delta so the owner's graph learns the actor
        exists — the partitioned twin of merge_entry's on-demand
        ``get_shadow`` for edge endpoints (a never-interned shadow is a
        pseudoroot, which is what keeps the single-host and partitioned
        verdicts identical for actors that only ever appear as created
        targets)."""
        self._encode(cell)

    def fold_self(
        self, cell: "ActorCell", recv_count: int, is_busy: bool, is_root: bool
    ) -> None:
        """The entry's self-actor slice (flags + receive balance)."""
        shadow = self.shadows[self._encode(cell)]
        shadow.interned = True
        shadow.recv_count += recv_count
        shadow.is_busy = is_busy
        shadow.is_root = is_root

    def fold_created(self, owner: "ActorCell", target: "ActorCell") -> None:
        """A created ref: the owner gains an outgoing edge (edges live
        at the SOURCE actor's owner)."""
        target_id = self._encode(target)
        owner_shadow = self.shadows[self._encode(owner)]
        self._update_outgoing(owner_shadow.outgoing, target_id, 1)

    def fold_spawned(self, child: "ActorCell", supervisor: "ActorCell") -> None:
        """A spawn: the child's supervisor pointer (lives at the
        CHILD's owner)."""
        sup_id = self._encode(supervisor)
        self.shadows[self._encode(child)].supervisor = sup_id

    def fold_sends(self, target: "ActorCell", count: int) -> None:
        """Sends count against the target's receive balance (lives at
        the TARGET's owner)."""
        self.shadows[self._encode(target)].recv_count -= count

    def fold_deactivate(self, owner: "ActorCell", target: "ActorCell") -> None:
        """A released ref: the owner loses an outgoing edge (lives at
        the SOURCE actor's owner)."""
        target_id = self._encode(target)
        owner_shadow = self.shadows[self._encode(owner)]
        self._update_outgoing(owner_shadow.outgoing, target_id, -1)

    def compact(self, keep: Callable[["ActorCell", DeltaShadow], bool]) -> "DeltaGraph":
        """A new graph holding only the shadows ``keep`` accepts.  A
        dropped cell that a kept shadow still references (positive or
        negative edge, or supervisor pointer) survives as a BARE entry
        — the ``touch`` semantics — so the kept facts re-fold into an
        identical slice; a dropped cell nothing kept references
        vanishes entirely, unpinning it from the compression table.
        The distributed collector's retained-journal compaction path:
        pruning a fact can only make a re-folded actor look MORE
        alive, never less (leak-safe by construction)."""
        out = DeltaGraph(self.address, self.context)
        decoder = self.decoder()
        for i, sh in enumerate(self.shadows):
            cell = decoder[i]
            if cell is None or not keep(cell, sh):
                continue
            ns = out.shadows[out._encode(cell)]
            ns.interned = sh.interned
            ns.recv_count = sh.recv_count
            ns.is_busy = sh.is_busy
            ns.is_root = sh.is_root
            if sh.supervisor >= 0:
                sup_cell = decoder[sh.supervisor]
                if sup_cell is not None:
                    ns.supervisor = out._encode(sup_cell)
            for tid, cnt in sh.outgoing.items():
                if cnt == 0:
                    continue
                target_cell = decoder[tid]
                if target_cell is not None:
                    ns.outgoing[out._encode(target_cell)] = cnt
        return out

    def decoder(self) -> List["ActorCell"]:
        """(reference: DeltaGraph.java:162-169)"""
        refs: List[Optional["ActorCell"]] = [None] * self.size
        for cell, idx in self.compression_table.items():
            refs[idx] = cell
        return refs  # type: ignore[return-value]

    def is_full(self) -> bool:
        """Headroom guard: one entry can add at most 4*field+1 shadows
        (reference: DeltaGraph.java:174-180)."""
        return (
            self.size + 4 * self.context.entry_field_size + 1
            >= self.context.delta_graph_size
        )

    def non_empty(self) -> bool:
        return self.size > 0

    # ------------------------------------------------------------- #
    # Wire format (reference: DeltaGraph.java:189-232)
    # ------------------------------------------------------------- #

    def serialize(self, encode_cell: Callable[["ActorCell"], bytes]) -> bytes:
        addr = (self.address or "").encode()
        parts = [struct.pack(">h", len(addr)), addr, struct.pack(">h", self.size)]
        for shadow in self.shadows:
            parts.append(shadow.serialize())
        shadow_size = sum(len(p) for p in parts)
        if len(self.compression_table) != self.size:
            from ...utils.validation import WireFormatError

            raise WireFormatError(
                "delta.table_desync",
                "compression table out of sync with shadow list",
                table_size=len(self.compression_table),
                shadow_count=self.size,
                address=self.address,
            )
        for cell, idx in self.compression_table.items():
            ref = encode_cell(cell)
            parts.append(struct.pack(">hh", idx, len(ref)))
            parts.append(ref)
        data = b"".join(parts)
        if events.recorder.enabled:
            # (reference: DeltaGraph.java:190-210 records both sizes)
            events.recorder.commit(
                events.DELTA_GRAPH_SERIALIZATION,
                shadow_size=shadow_size,
                compression_table_size=len(data) - shadow_size,
            )
        return data

    @staticmethod
    def deserialize(
        buf: bytes,
        context: CrgcContext,
        decode_cell: Callable[[bytes], "ActorCell"],
    ) -> "DeltaGraph":
        offset = 0
        (alen,) = struct.unpack_from(">h", buf, offset)
        offset += 2
        address = buf[offset : offset + alen].decode() or None
        offset += alen
        (size,) = struct.unpack_from(">h", buf, offset)
        offset += 2
        graph = DeltaGraph(address, context)
        for _ in range(size):
            shadow, offset = DeltaShadow.deserialize(buf, offset)
            graph.shadows.append(shadow)
        for _ in range(size):
            idx, rlen = struct.unpack_from(">hh", buf, offset)
            offset += 4
            cell = decode_cell(buf[offset : offset + rlen])
            offset += rlen
            graph.compression_table[cell] = idx
        return graph

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, DeltaGraph)
            and self.size == other.size
            and self.compression_table == other.compression_table
            and self.address == other.address
            and self.shadows == other.shadows
        )
