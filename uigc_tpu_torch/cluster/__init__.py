"""Copy of ``uigc_tpu/cluster/__init__.py`` (the same exports).

Cluster sharding: GC-aware entity placement, passivation, and live
actor migration across nodes (GUIDE.md "Cluster sharding").

Composition: :class:`ClusterSharding` attaches to an ActorSystem (one
per node), entity types register a factory per node via ``start``, and
:class:`EntityRef` addresses entities by ``(type, key)`` wherever they
currently live.  Placement is a pure function of the member set
(rendezvous hashing over gossiped, versioned shard tables); rebalances
migrate live entities with their state; idle entities passivate to an
in-memory store and recreate on the next send.
"""

from .journal import EntityJournal
from .membership import MembershipArbiter, SbrDecision
from .migration import MigrationManager, translate_refs
from .passivation import PassivationPolicy, StateStore
from .sharding import (
    ClusterSharding,
    Entity,
    EntityRef,
    ShardRegion,
    ShardTable,
    rendezvous_assign,
    shard_of,
)

__all__ = [
    "ClusterSharding",
    "Entity",
    "EntityJournal",
    "EntityRef",
    "MembershipArbiter",
    "MigrationManager",
    "SbrDecision",
    "PassivationPolicy",
    "ShardRegion",
    "ShardTable",
    "StateStore",
    "rendezvous_assign",
    "shard_of",
    "translate_refs",
]
