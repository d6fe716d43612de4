"""Port of ``uigc_tpu/parallel/``: the sharded trace (``sharded_trace.py``).
``partition.py`` belongs to the distributed collector and is not ported
yet (ROADMAP.md Queue 1 item 7)."""

from .sharded_trace import (
    Mesh,
    build_mesh,
    make_sharded_cuda_trace,
    make_sharded_decremental_wake,
    make_sharded_fold,
    make_sharded_mask,
    make_sharded_trace,
    pack_shard_layouts,
    put_nodes,
    put_replicated,
    put_stacked,
    shard_graph,
    to_host,
)

__all__ = [
    "Mesh",
    "build_mesh",
    "make_sharded_cuda_trace",
    "make_sharded_decremental_wake",
    "make_sharded_fold",
    "make_sharded_mask",
    "make_sharded_trace",
    "pack_shard_layouts",
    "put_nodes",
    "put_replicated",
    "put_stacked",
    "shard_graph",
    "to_host",
]
