"""Port of ``uigc_tpu/parallel/``: the sharded trace (``sharded_trace.py``)
and the distributed collector's placement (``partition.py``, imported by
its users, not here)."""

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
