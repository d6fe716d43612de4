"""propagate_roofline (layer: propagate kernel): the least time one full
propagation sweep of the cell's graph could take, over the kernel's time
for one full walk of the cell's layout, in percent.

The bytes are the graph's, not the layout's: 8 per propagating (src, dst)
pair, 4 per 32 actors for the marks read and 4 per 32 actors for the hits
written, at the card's published HBM bandwidth.  The kernel's time is the
median of 20 launches timed with CUDA events.  Whatever implements the
sweep, the work counted is the same."""

from portbench.peaks import H100_HBM_BYTES_S


def sweep_bytes(n_actors: int, n_pairs: int) -> int:
    words = (n_actors + 31) // 32
    return 8 * n_pairs + 4 * words + 4 * words


def read(r):
    kernel = r.get("kernel")
    if not kernel or not kernel.get("full_walk_ms"):
        return None
    c = r["counters"]
    bound_s = sweep_bytes(c["n_actors"], c["n_pairs"]) / H100_HBM_BYTES_S
    return 100.0 * bound_s / (kernel["full_walk_ms"] * 1e-3)
