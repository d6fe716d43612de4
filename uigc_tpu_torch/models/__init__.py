from .graphgen import powerlaw_actor_graph, ring_graph
from .workloads import run_cluster_recovery, run_rings, run_tree

__all__ = ["powerlaw_actor_graph", "ring_graph", "run_cluster_recovery",
           "run_rings", "run_tree"]
