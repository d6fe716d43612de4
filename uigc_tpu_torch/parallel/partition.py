"""Copy of ``uigc_tpu/parallel/partition.py`` (pure Python).

Cross-node shadow-graph partitioning: who owns which slice.

The distributed collector (engines/crgc/distributed.py) shards the
shadow graph ACROSS nodes — the level above the mesh backend's sharding
across local devices.  This module is the pure placement layer:

- :func:`cell_key` / :func:`partition_of_cell`: a stable coordinate for
  every actor — ``(address, uid)`` hashed into a partition with the SAME
  blake2b key hash cluster sharding uses (cluster/sharding.py
  ``shard_of``), so entity placement and shadow-graph partitioning can
  never fight: with ``dist-partitions == num-shards`` an entity's
  shadow slice and its shard land by the same function family.
- :class:`PartitionMap`: a fenced, versioned partition -> owner-node
  assignment via the SAME rendezvous hash sharding uses
  (``rendezvous_assign``) — pure in the member set, minimal churn on
  membership change (a death moves only the dead node's partitions).
- :class:`ReductionTree`: the Tascade-shaped asynchronous reduction
  tree (PAPERS.md) the Safra-style termination rounds aggregate over —
  a deterministic binary tree over the sorted member list, recomputed
  identically by every node with zero coordination frames.

Everything here is a pure function of ``(members, num_partitions)``;
there is no coordinator state to gossip and nothing to lock.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..cluster.sharding import rendezvous_assign, shard_of


def cell_key(cell: Any) -> Tuple[str, int]:
    """Stable cross-process coordinate for a cell (real or proxy):
    ``(home address, uid)``.  Both ActorCell and ProxyCell expose the
    pair, and ProxyCell hashes/compares by it — so a key round-trips a
    dmark frame and still folds to the same shadow slot."""
    return (cell.system.address, cell.uid)


def key_text(key: Tuple[str, int]) -> str:
    """The hashed form: same text shape as an entity key, so the same
    blake2b mixing applies."""
    return f"{key[0]}#{key[1]}"


def partition_of_cell(cell: Any, num_partitions: int) -> int:
    return shard_of(key_text(cell_key(cell)), num_partitions)


class PartitionMap:
    """A fenced partition -> owner assignment, recomputed identically by
    every node from its live-member view (rendezvous hashing: pure,
    deterministic, minimal churn).  ``fence`` is the partition era —
    bumped on every membership change so frames from before an
    ownership transfer can be told from frames after it (the same
    epoch-fencing discipline of the shard tables)."""

    __slots__ = (
        "members", "num_partitions", "fence", "_assignments", "_self",
        "_pcache",
    )

    def __init__(
        self,
        members: List[str],
        num_partitions: int,
        fence: int = 0,
        self_address: Optional[str] = None,
        cache: Optional[Dict[Tuple[str, int], int]] = None,
    ):
        self.members = sorted(members)
        self.num_partitions = num_partitions
        self.fence = fence
        self._assignments = rendezvous_assign(self.members, num_partitions)
        self._self = self_address
        #: key -> partition memo (same capped-dict discipline as
        #: ShardTable._shard_cache): key->partition is pure in
        #: num_partitions, so a successor map built at a remap passes
        #: its predecessor's cache in — only owner() changes per era.
        self._pcache: Dict[Tuple[str, int], int] = (
            cache if cache is not None else {}
        )

    def owner(self, partition: int) -> Optional[str]:
        return self._assignments.get(partition)

    def partition_of(self, key: Tuple[str, int]) -> int:
        p = self._pcache.get(key)
        if p is None:
            if len(self._pcache) >= 65536:
                self._pcache.clear()
            p = self._pcache[key] = shard_of(key_text(key), self.num_partitions)
        return p

    def owner_of(self, key: Tuple[str, int]) -> Optional[str]:
        return self._assignments.get(self.partition_of(key))

    def owns(self, key: Tuple[str, int]) -> bool:
        return self._self is not None and self.owner_of(key) == self._self

    def owns_partition(self, partition: int) -> bool:
        return (
            self._self is not None
            and self._assignments.get(partition) == self._self
        )

    def owned_partitions(self, address: Optional[str] = None) -> List[int]:
        addr = address if address is not None else self._self
        return sorted(
            p for p, a in self._assignments.items() if a == addr
        )

    def assignments(self) -> Dict[int, str]:
        return dict(self._assignments)

    def moved_partitions(self, other: "PartitionMap") -> List[int]:
        """Partitions whose owner differs between this map and an older
        one — the re-fold set after a membership change."""
        return sorted(
            p
            for p in range(self.num_partitions)
            if self._assignments.get(p) != other._assignments.get(p)
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"PartitionMap({len(self.members)} members, "
            f"{self.num_partitions} partitions, fence={self.fence})"
        )


class ReductionTree:
    """Deterministic binary reduction tree over the sorted member list.

    Per-node mark/termination statistics flow leaf -> root along
    parent edges and the verdict flows root -> leaves along child
    edges: O(log n) frame hops per round, no per-wave full-membership
    allgather, and — because every node derives the identical tree from
    its own member view — no coordinator election.  The root is simply
    the lowest address; when it dies, the recomputed tree (minus the
    dead member) makes the next-lowest address root with no handoff
    protocol (the same membership events that drove the partition remap
    drive the re-rooting)."""

    __slots__ = ("members",)

    def __init__(self, members: List[str]):
        self.members = sorted(members)

    @property
    def root(self) -> Optional[str]:
        return self.members[0] if self.members else None

    def _index(self, address: str) -> Optional[int]:
        try:
            return self.members.index(address)
        except ValueError:
            return None

    def parent(self, address: str) -> Optional[str]:
        i = self._index(address)
        if i is None or i == 0:
            return None
        return self.members[(i - 1) // 2]

    def children(self, address: str) -> List[str]:
        i = self._index(address)
        if i is None:
            return []
        n = len(self.members)
        return [self.members[c] for c in (2 * i + 1, 2 * i + 2) if c < n]

    def subtree_size(self, address: str) -> int:
        """Members in the subtree rooted at ``address`` (including it)
        — the report count an interior node waits for before it folds
        its aggregate upward."""
        i = self._index(address)
        if i is None:
            return 0
        n = len(self.members)
        count = 0
        stack = [i]
        while stack:
            j = stack.pop()
            count += 1
            for c in (2 * j + 1, 2 * j + 2):
                if c < n:
                    stack.append(c)
        return count
