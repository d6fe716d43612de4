"""The sharded shadow-graph trace: the collector's data plane split by node
range over a list of devices, the propagate kernel run on every shard.

Port of ``uigc_tpu/parallel/sharded_trace.py``, held against it by
``tests/test_torch_sharded_trace.py``.  The reference shards over a JAX
device mesh with ``shard_map``: node arrays by slot range on the axis
"gc", propagation pairs by destination shard, and the packed mark words
``all_gather``ed over ICI once per sweep.  The port keeps that
single-controller shape: one process, one thread, holding per-shard
tensors on a tuple of ``torch.device``s (:class:`Mesh`).  What becomes
what:

- ``all_gather`` is :meth:`_ShardOps.gather_table`: every shard's packed
  word slice is copied to each distinct device of the mesh and
  concatenated into the global ``(r_rows, LANE)`` table.  Where shards
  share a device that is a ``torch.cat``; between cards it is a peer
  copy over NVLink, which PyTorch orders against the current streams of
  both cards, so a shard's kernel and the copies that read its words
  need no other synchronisation.
- ``psum`` is a sum over shards.
- The ``lax.while_loop``s are host loops with one read per sweep, as in
  ``ops/cuda_trace.py``; that one read serves both the loop's ``changed``
  decision and the auto mode's pull decision.
- State every shard must agree on (the global table, its dirty prefix,
  the transparency table, the jump-parent array and its pointer
  doubling) is computed once per distinct device, not once per shard.
- Donated buffers become in-place updates (``index_put_``) of the shard
  tensors.  The reference pads its scatter batches with out-of-range
  indices that XLA drops (``mode="drop"``) or lands on a sink row;
  torch raises on such an index, so every scatter here filters the
  padding on the host first (:func:`_kept`).

Each sweep calls the hand-written kernel (``ops/propagate.py``
``propagate_words``) in its gated form once per shard, over the shard's
own packed layout (global source ids, shard-local destinations), the
global table and its dirty prefix, with the shard's own gate and word
plane; a zero gate makes it the plain sweep.  In jump and auto modes the
jump step (``cuda_trace.jump_sweep_words``, the jump kernel on a card)
runs once per distinct device over its gathered table.  One loop,
:meth:`_ShardOps.fixpoint`, runs the trace and both phases of the wake.

Operands.  A *node-sharded* operand is a list of D tensors, shard i on
``mesh.devices[i]`` holding nodes (or packed words) ``[i * shard,
(i + 1) * shard)``; a *stacked* operand is a list of D tensors, shard i's
row of the reference's ``[D, ...]`` array; a *replicated* operand is a
list with one tensor per distinct device (``mesh.distinct``).  The
functions also take host arrays in the reference's shapes and place them
(:func:`put_nodes`, :func:`put_stacked`, :func:`put_replicated`).
Results are node-sharded; :func:`to_host` concatenates them to numpy.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops import cuda_trace as pt
from ..ops import trace as trace_ops
from ..ops.propagate import LANE, WORD_BITS, pack_hits_words, propagate_words
from ..utils.platform import resolve_device
from ..utils.validation import require

F = trace_ops
AXIS = "gc"


class Mesh:
    """The devices of a sharded trace, one per shard in shard order, and
    the axis name.  Devices may repeat: several shards may share a card."""

    def __init__(self, devices: Sequence):
        require(len(devices) >= 1, "mesh.devices", "a mesh needs a device")
        self.devices = tuple(resolve_device(d) for d in devices)
        self.axis_names = (AXIS,)
        #: the distinct devices, in order of first appearance
        self.distinct = tuple(dict.fromkeys(self.devices))
        #: for each shard, the index in ``distinct`` of its device: the
        #: replica of replicated state (tables, jump parents) it reads
        self.replica = tuple(self.distinct.index(d) for d in self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def as_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a :class:`Mesh` over a sequence of devices."""
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


def build_mesh(n_devices: int, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards.  On "cuda" shard i goes on card i,
    and a mesh larger than the visible cards raises (the reference
    asserts it, ``uigc_tpu/engines/crgc/mesh.py:114``); on "cpu" every
    shard is on the CPU, the port's stand-in for the reference's virtual
    CPU devices."""
    require(n_devices >= 1, "mesh.devices", "a mesh needs a device",
            n_devices=n_devices)
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh([torch.device("cpu")] * n_devices)
    require(kind == "cuda", "mesh.devices", "a mesh is on cuda or cpu",
            device=str(device))
    resolve_device("cuda")  # raises when no card is visible
    visible = torch.cuda.device_count()
    if n_devices > visible:
        raise ValueError(f"a mesh of {n_devices} shards needs {n_devices} "
                         f"CUDA devices; {visible} are visible")
    return Mesh([torch.device("cuda", i) for i in range(n_devices)])


# --------------------------------------------------------------------- #
# Placement
# --------------------------------------------------------------------- #


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def put_nodes(mesh: Mesh, x) -> List[torch.Tensor]:
    """A host array over the whole node (or word) space as a node-sharded
    operand: contiguous ranges, each copied to its shard's device.  A
    list of shard tensors is returned as it is."""
    if isinstance(x, (list, tuple)):
        return list(x)
    t = _tensor(x)
    require(t.shape[0] % mesh.size == 0, "mesh.shape",
            "node space does not split into equal shards",
            n=t.shape[0], shards=mesh.size)
    parts = t.split(t.shape[0] // mesh.size)
    return [p.to(dev, copy=True).contiguous()
            for p, dev in zip(parts, mesh.devices)]


def put_stacked(mesh: Mesh, x) -> List[torch.Tensor]:
    """A host ``[D, ...]`` array as a stacked operand: row i copied to
    shard i's device.  A list of shard tensors is returned as it is."""
    if isinstance(x, (list, tuple)):
        return list(x)
    t = _tensor(x)
    require(t.shape[0] == mesh.size, "mesh.shape",
            "stacked operand needs one row per shard",
            rows=t.shape[0], shards=mesh.size)
    return [t[i].to(dev, copy=True).contiguous()
            for i, dev in enumerate(mesh.devices)]


def put_replicated(mesh: Mesh, x) -> List[torch.Tensor]:
    """A host array as a replicated operand: one copy on each distinct
    device.  A list of per-device tensors is returned as it is."""
    if isinstance(x, (list, tuple)):
        return list(x)
    t = _tensor(x)
    return [t.to(dev, copy=True) for dev in mesh.distinct]


def to_host(parts) -> np.ndarray:
    """A node-sharded result concatenated to one numpy array."""
    return np.concatenate(
        [p.cpu().numpy() for p in parts]  # readback: host boundary: result -> np
    )


def _kept(idx, bound: int, *vals):
    """The entries of one shard's scatter batch whose index is below
    ``bound``, as int64 host arrays: the reference's out-of-range padding
    (its ``mode="drop"`` scatters and sink rows) is dropped here."""
    idx = np.asarray(idx, dtype=np.int64)
    keep = idx < bound
    return (idx[keep],) + tuple(
        np.asarray(v)[keep] for v in vals)  # readback: host scatter batches


# --------------------------------------------------------------------- #
# Host-side graph repacking (numpy, as the reference's)
# --------------------------------------------------------------------- #


def pad_to(x: np.ndarray, size: int, fill=0) -> np.ndarray:
    out = np.full(size, fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def shard_graph(
    graph: Dict[str, np.ndarray], n_devices: int
) -> Dict[str, np.ndarray]:
    """Repack kernel arrays for an n-device mesh.

    Nodes are padded to a multiple of n_devices and sharded by contiguous
    slot range.  Propagation pairs (positive-weight edges + supervisor
    pointers) are bucketed by destination shard and padded to equal bucket
    sizes, yielding [n_devices, m] arrays sharded on the leading axis.
    """
    n = graph["flags"].shape[0]
    n_pad = ((n + n_devices - 1) // n_devices) * n_devices

    flags = pad_to(graph["flags"], n_pad)
    recv = pad_to(graph["recv_count"], n_pad)

    live = graph["edge_weight"] > 0
    esrc = graph["edge_src"][live]
    edst = graph["edge_dst"][live]
    sup = graph["supervisor"]
    sup_src = np.nonzero(sup >= 0)[0].astype(np.int32)
    sup_dst = sup[sup_src].astype(np.int32)

    # Supervisor pointers become propagation pairs like the reference's
    # supervisor marking (reference: ShadowGraph.java:242-267).
    psrc = np.concatenate([esrc, sup_src])
    pdst = np.concatenate([edst, sup_dst])

    shard_size = n_pad // n_devices
    owner = pdst // shard_size

    buckets_src = []
    buckets_dst = []
    max_m = 1
    for d in range(n_devices):
        sel = owner == d
        buckets_src.append(psrc[sel])
        buckets_dst.append(pdst[sel])
        max_m = max(max_m, int(sel.sum()))
    # Pad buckets with a self-loop on the sink (src = n_pad, handled by
    # the kernel's padded mark vector).
    src2 = np.full((n_devices, max_m), n_pad, dtype=np.int32)
    dst2 = np.full((n_devices, max_m), 0, dtype=np.int32)
    for d in range(n_devices):
        m = buckets_src[d].shape[0]
        src2[d, :m] = buckets_src[d]
        # local destination index within the shard
        dst2[d, :m] = buckets_dst[d] - d * shard_size

    return {
        "flags": flags,
        "recv_count": recv,
        "pair_src": src2,
        "pair_dst": dst2,
        "n_pad": n_pad,
        "shard_size": shard_size,
    }


def pack_shard_layouts(
    psrc: np.ndarray,
    pdst: np.ndarray,
    n_pad: int,
    n_devices: int,
    s_rows: int = None,
    sub: int = None,
    group: int = None,
):
    """Pack propagation pairs into one kernel layout per destination
    shard, equalized to a common block count and stacked on a leading
    device axis (every shard runs the same sweep over its own blocks).

    Sources stay *global* ids — the kernel gathers them from the gathered
    packed bit table — while destinations are shard-local, so each
    shard's kernel lands only in its own node shard (prepare_pairs
    ``n_src`` mode).  ``sub``/``group`` default to the port's geometry
    (``cuda_trace.default_geometry``); the reference takes them from its
    interpret flag.

    Returns (stacked, meta, slot_vals): ``stacked`` holds [D, ...] arrays
    (bmeta1, bmeta2, row_pos, emeta); ``slot_vals`` gives each input
    pair's packed (shard << 40 | ri << 8 | col) slot for in-place
    deletion masking, aligned with the input pair order."""
    if s_rows is None:
        s_rows = pt.S_ROWS
    d_sub, d_group = pt.default_geometry()
    sub = d_sub if sub is None else sub
    group = d_group if group is None else group
    super_sz = s_rows * LANE
    shard_size = n_pad // n_devices
    require(n_pad % n_devices == 0 and shard_size % super_sz == 0,
            "mesh.shape", "n_pad must split into shards of whole supertiles",
            n_pad=n_pad, shards=n_devices, supertile=super_sz)
    psrc = np.asarray(psrc, dtype=np.int64)
    pdst = np.asarray(pdst, dtype=np.int64)
    owner = pdst // shard_size

    preps = []
    slot_vals = np.empty(psrc.size, dtype=np.int64)
    for d in range(n_devices):
        sel = np.nonzero(owner == d)[0]
        prep = pt.prepare_pairs(
            psrc[sel],
            pdst[sel] - d * shard_size,
            shard_size,
            s_rows=s_rows,
            want_slots=True,
            n_src=n_pad,
            sub=sub,
            group=group,
        )
        slot_ri = prep.pop("slot_ri")
        slot_col = prep.pop("slot_col")
        slot_vals[sel] = (d << 40) | (slot_ri << 8) | slot_col
        preps.append(prep)

    n_blocks = pt._pad_blocks_target(max(p["n_blocks"] for p in preps))
    for p in preps:
        pt.pad_layout_blocks(p, n_blocks)

    stacked = {
        "bmeta1": np.stack([p["bmeta1"] for p in preps]),
        "bmeta2": np.stack([p["bmeta2"] for p in preps]),
        "row_pos": np.stack([p["row_pos"] for p in preps]),
        "emeta": np.stack([p["emeta"] for p in preps]),
    }
    meta = {
        "n_pad": n_pad,
        "shard_size": shard_size,
        "n_blocks": n_blocks,
        "r_rows": preps[0]["r_rows"],
        "s_rows": s_rows,
        "sub": sub,
        "group": group,
    }
    return stacked, meta, slot_vals


# --------------------------------------------------------------------- #
# Per-shard primitives
# --------------------------------------------------------------------- #


def _seed_masks(flags, recv):
    """(in_use, halted, seed) bool vectors from the node features — the
    one seed definition every trace variant shares (reference semantics:
    ShadowGraph.java:205-220)."""
    return (F.flag_set(flags, F.FLAG_IN_USE), F.flag_set(flags, F.FLAG_HALTED),
            F.seeds_torch(flags, recv))


class _ShardOps:
    """The per-shard word-space primitives shared by the sharded trace
    and the sharded decremental wake (the reference's
    ``make_local_shard_ops``): local pack, the table gather, the sweep
    and the fixpoint loop.  One definition keeps the two fixpoints
    propagating identically per sweep."""

    def __init__(self, mesh: Mesh, n_pad: int, shard_size: int, r_rows: int,
                 s_rows: int, sub: int, group: int, mode: str,
                 pull_density: float):
        require(shard_size * mesh.size == n_pad
                and shard_size % (s_rows * LANE) == 0, "mesh.shape",
                "n_pad must split into shards of whole supertiles",
                n_pad=n_pad, shard_size=shard_size, shards=mesh.size)
        self.mesh = mesh
        self.n_pad = n_pad
        self.ss = shard_size
        self.r_rows = r_rows
        self.s_rows = s_rows
        self.sub = sub
        self.group = group
        self.group_rows = pt.ROWS * group
        self.n_chunks = r_rows // self.group_rows
        self.n_super = shard_size // (s_rows * LANE)
        self.sup_words = s_rows * (LANE // WORD_BITS)
        self.replica = mesh.replica
        self.mode = mode
        self.pull_cut = pt.pull_cut(pull_density, self.n_chunks)
        #: kernel calls per shard since this object was made
        self.calls = [0] * mesh.size

    def pack_words(self, local_bool):
        """A shard's (shard_size,) bool vector as its packed words."""
        return pack_hits_words(local_bool.reshape(-1, LANE))

    def gather_table(self, parts) -> List[torch.Tensor]:
        """The all-gather: every shard's words concatenated (zero padded)
        into the global (r_rows, LANE) table, one table per distinct
        device."""
        pad = self.r_rows * LANE - self.n_pad // WORD_BITS
        out = []
        for dev in self.mesh.distinct:
            tail = torch.zeros(pad, dtype=torch.int32, device=dev)
            out.append(torch.cat([p.to(dev) for p in parts] + [tail])
                       .reshape(self.r_rows, LANE))
        return out

    def dirty(self, tables, prevs=None) -> List[torch.Tensor]:
        """The dirty prefix of each replica's table against ``prevs``
        (zeros when None); identical on every device."""
        if prevs is None:
            prevs = [torch.zeros_like(t) for t in tables]
        return [pt.dirty_group_lists(t, p, self.n_chunks, self.group_rows)[0]
                for t, p in zip(tables, prevs)]

    def n_dirty(self, ds) -> int:
        """The dirty walk groups: the sweep's one host read."""
        return int(ds[0][self.n_chunks])  # readback: the loop's changed flag

    def supertile_any(self, words):
        """1 for each of the shard's supertiles holding a set bit."""
        return pt.supertile_any(words, self.n_super, self.sup_words)

    def sweep(self, i, table, d, gate, layout, bucket):
        """One propagation sweep into shard ``i``: the gated kernel over
        the shard's packed blocks, then the insert-bucket scatter-max
        tier (global sources, local destinations; padding has src =
        n_pad, which reads as 0).  Returns the shard's hit words."""
        bmeta1, bmeta2, row_pos, emeta = layout
        bsrc, bdst = bucket
        dev = table.device
        words = torch.zeros(self.ss // WORD_BITS, dtype=torch.int32,
                            device=dev)
        propagate_words(d, bmeta1, bmeta2, table, row_pos, emeta, words,
                        n_super=self.n_super, s_rows=self.s_rows,
                        sub=self.sub, group=self.group, gate=gate)
        self.calls[i] += 1
        src_active = pt.bits_at(table, bsrc, self.n_pad).to(torch.int32)
        prop = torch.zeros(self.ss + 1, dtype=torch.int32, device=dev)
        prop.scatter_reduce_(0, bdst.long(), src_active, "amax",
                             include_self=True)
        return words | pack_hits_words(prop[: self.ss].reshape(-1, LANE) > 0)

    def fixpoint(self, mark_w, prev_table, keep, active, layouts, buckets,
                 *, mode=None, jump=None, gate=None):
        """The sharded mark fixpoint: the sharded trace's loop, and the
        sharded wake's closure and repair.  Each sweep grows every
        shard's ``mark_w`` by its hits masked by ``keep``, until the
        gathered table (``mark_w & active``, or the marks where
        ``active`` is None) stops changing against ``prev_table``
        (gathered; zeros when None).

        Every sweep calls the gated kernel once per shard, with a zero
        gate where nothing is forced or skipped.  ``gate`` (per shard)
        forces the first sweep, and the loop then sweeps at least once
        when any shard has a forced tile.  The jump step (jump and auto
        modes, ``jump`` the replicated parents) runs once per replica on
        its gathered table; each shard ORs in its slice of the hits.
        Returns (mark_w, sweeps, host reads, dirty walk groups of each
        sweep)."""
        mode = self.mode if mode is None else mode
        use_jump = mode in (pt.MODE_JUMP, pt.MODE_AUTO)
        use_pull = mode in (pt.MODE_PULL, pt.MODE_AUTO)
        shards = range(self.mesh.size)
        words = self.ss // WORD_BITS

        def tables(parts):
            if active is not None:
                parts = [m & a for m, a in zip(parts, active)]
            return self.gather_table(parts)

        zero = [torch.zeros(self.n_super, dtype=torch.int32, device=dev)
                for dev in self.mesh.devices]
        base = zero if gate is None else gate
        if use_jump:
            jump = list(jump)
            trans = self.gather_table([k & a for k, a in zip(keep, active)])
            keep_all = self.gather_table(keep)
        table = tables(mark_w)
        d = self.dirty(table, prev_table)
        if gate is None:
            n_dirty = self.n_dirty(d)
            go = n_dirty > 0
        else:
            # One read for the replicated run-gate decision: the loop
            # runs when the table moved or any shard has a forced tile
            # (the reference's psum).
            dev0 = self.mesh.devices[0]
            n_dirty, *forced = torch.stack(  # readback: the run-gate decision
                [d[0][self.n_chunks].to(torch.int64)]
                + [g.sum().to(dev0) for g in gate]).tolist()
            go = n_dirty > 0 or sum(forced) > 0
        reads, dirty_hist = 1, []
        while go:
            # Both inputs to the pull decision, the dirty count (global
            # table) and the saturation of LOCAL tiles, are replicated or
            # shard-own state, so every shard agrees on the plan.
            pull_on = use_pull and pt.pull_switch(mode, n_dirty,
                                                  self.pull_cut)
            if use_jump:
                jump_w = [None] * len(jump)
                for u in range(len(jump)):
                    jump_w[u], jump[u] = pt.jump_sweep_words(
                        table[u], jump[u], trans[u], keep_all[u], self.n_pad)
            new = []
            for i in shards:
                u = self.replica[i]
                g = (pt.pull_gate(base[i], mark_w[i], keep[i], self.n_super,
                                  self.sup_words) if pull_on else base[i])
                hit = self.sweep(i, table[u], d[u], g, layouts[i], buckets[i])
                m = mark_w[i] | (hit & keep[i])
                if use_jump:
                    m = m | jump_w[u].reshape(-1)[i * words:(i + 1) * words]
                new.append(m)
            new_table = tables(new)
            d = self.dirty(new_table, table)
            mark_w, table, base = new, new_table, zero
            dirty_hist.append(n_dirty)
            n_dirty = self.n_dirty(d)
            reads += 1
            go = n_dirty > 0
        return mark_w, len(dirty_hist), reads, dirty_hist

    def unpack(self, words):
        return pt.unpack_table(words, self.ss)


def _geometry(sub, group, mode, pull_density):
    d_sub, d_group = pt.default_geometry()
    sub = d_sub if sub is None else sub
    group = d_group if group is None else group
    mode = pt.MODE_PUSH if mode is None else mode
    if pull_density is None:
        pull_density = pt.DEFAULT_PULL_DENSITY
    require(mode in pt.TRACE_MODES, "config.trace_mode", "bad trace mode",
            mode=mode, valid=pt.TRACE_MODES)
    return sub, group, mode, pull_density


def _layout_operands(mesh, bmeta1, bmeta2, row_pos, emeta, bsrc, bdst):
    layouts = list(zip(*(put_stacked(mesh, x)
                         for x in (bmeta1, bmeta2, row_pos, emeta))))
    buckets = list(zip(put_stacked(mesh, bsrc), put_stacked(mesh, bdst)))
    return layouts, buckets


def _jump_operand(mesh, jump_j):
    return [j.to(torch.int32) for j in put_replicated(mesh, jump_j)]


# --------------------------------------------------------------------- #
# The traces
# --------------------------------------------------------------------- #


def make_sharded_trace(mesh):
    """The multi-device trace step with no kernel: a bool fixpoint whose
    marks are gathered each sweep (the ``dryrun_multichip`` path).

    Returns fn(flags, recv_count, pair_src, pair_dst) -> node-sharded
    bool marks, with flags/recv node-sharded and the pair arrays stacked
    (``shard_graph``'s output places as it is)."""
    mesh = as_mesh(mesh)

    def traced(flags, recv, pair_src, pair_dst):
        flags = put_nodes(mesh, flags)
        recv = put_nodes(mesh, recv)
        pair_src = put_stacked(mesh, pair_src)
        pair_dst = put_stacked(mesh, pair_dst)
        masks = [_seed_masks(f, r) for f, r in zip(flags, recv)]
        in_use = [m[0] for m in masks]
        local = [iu & ~h & s for iu, h, s in masks]
        slot = mesh.replica

        def gather(parts):
            """bool all-gather with a False sink at n_pad, per device."""
            return [torch.cat([p.to(dev) for p in parts]
                              + [torch.zeros(1, dtype=torch.bool, device=dev)])
                    for dev in mesh.distinct]

        halted_all = gather([m[1] for m in masks])
        changed = True
        while changed:
            mark_all = gather(local)
            new = []
            for i, (src, dst) in enumerate(zip(pair_src, pair_dst)):
                src = src.long()
                active = (mark_all[slot[i]][src]
                          & ~halted_all[slot[i]][src]).to(torch.int32)
                prop = torch.zeros(local[i].numel(), dtype=torch.int32,
                                   device=src.device)
                prop.scatter_reduce_(0, dst.long(), active, "amax",
                                     include_self=True)
                new.append(local[i] | ((prop > 0) & in_use[i]))
            dev0 = mesh.devices[0]
            changed = bool(torch.stack(  # host sync: the psum of changes
                [(n != m).any().to(dev0) for n, m in zip(new, local)]).any())
            local = new
        return local

    return traced


def make_sharded_cuda_trace(
    mesh,
    n_pad: int,
    shard_size: int,
    n_blocks: int,
    r_rows: int,
    s_rows: int,
    bucket_m: int,
    sub: int = None,
    group: int = None,
    mode: str = None,
    pull_density: float = None,
    with_stats: bool = False,
):
    """The sharded trace with the propagate kernel on every shard (the
    reference's ``make_sharded_pallas_trace``).

    Per sweep each shard ORs the kernel's hits over its own packed
    blocks, and its insert bucket's scatter-max hits, into its local
    mark words; the words are gathered into the global table on each
    device, and the dirty prefix is taken on the global table, so every
    shard sweeps with the same dirty lists.  ``mode`` (cuda_trace
    MODE_*, default push): jump/auto take the replicated (n_pad + 1,)
    jump-parent array as a trailing operand, pull/auto skip the blocks
    whose local destination supertile is saturated.

    fn(flags, recv, bmeta1, bmeta2, row_pos, emeta, bsrc, bdst[, jump_j])
    -> node-sharded bool marks; flags/recv node-sharded, the layout and
    bucket operands stacked, jump_j replicated.  ``with_stats`` returns
    (marks, stats): the sweeps, the host syncs, the dirty walk groups of
    each sweep and the kernel calls per shard (one per sweep; a launch
    on the card).  ``n_blocks`` and ``bucket_m`` are the reference's
    static shapes; the port reads them off the operands."""
    mesh = as_mesh(mesh)
    sub, group, mode, pull_density = _geometry(sub, group, mode, pull_density)
    use_jump = mode in (pt.MODE_JUMP, pt.MODE_AUTO)

    def traced(flags, recv, bmeta1, bmeta2, row_pos, emeta, bsrc, bdst,
               *rest):
        ops = _ShardOps(mesh, n_pad, shard_size, r_rows, s_rows, sub, group,
                        mode, pull_density)
        flags = put_nodes(mesh, flags)
        recv = put_nodes(mesh, recv)
        layouts, buckets = _layout_operands(mesh, bmeta1, bmeta2, row_pos,
                                            emeta, bsrc, bdst)
        jump = _jump_operand(mesh, rest[0]) if use_jump else None
        masks = [_seed_masks(f, r) for f, r in zip(flags, recv)]
        iu_w = [ops.pack_words(iu) for iu, _, _ in masks]
        nh_w = [ops.pack_words(~h) for _, h, _ in masks]
        mark_w = [ops.pack_words(iu & ~h & s) for iu, h, s in masks]
        mark_w, sweeps, host_syncs, dirty_hist = ops.fixpoint(
            mark_w, None, iu_w, nh_w, layouts, buckets, jump=jump)
        marks = [ops.unpack(m) for m in mark_w]
        if not with_stats:
            return marks
        return marks, {"n_sweeps": sweeps, "host_syncs": host_syncs,
                       "dirty_chunks": dirty_hist,
                       "launches_per_shard": list(ops.calls)}

    return traced


def make_sharded_mask(mesh):
    """Per-shard deletion masking of the stacked packed layouts: the inert
    sentinel into (ri, col) slots of each shard's row_pos/emeta, in place
    (the reference donates the buffers).

    fn(row_pos, emeta, ri, col) with row_pos/emeta stacked ([nb*8, LANE]
    per shard) and ri/col one row of host indices per shard; ri >= nb*8
    is padding and is dropped.  Returns (row_pos, emeta)."""
    mesh = as_mesh(mesh)

    def mask(row_pos, emeta, ri, col):
        row_pos = put_stacked(mesh, row_pos)
        emeta = put_stacked(mesh, emeta)
        for i, (rp, em) in enumerate(zip(row_pos, emeta)):
            r, c = _kept(ri[i], rp.shape[0], col[i])
            r = torch.from_numpy(r).to(rp.device)
            c = torch.from_numpy(c.astype(np.int64)).to(rp.device)
            rp[r, c] = pt.PAD_ROW
            em[r, c] = 0
        return row_pos, emeta

    return mask


def make_sharded_fold(mesh):
    """The multi-device fold step: a batch of entry deltas (recv-count
    deltas + flag overwrites, bucketed by node shard on the host)
    scattered into the node-sharded arrays in place (the reference
    donates them).  The device-side analogue of mergeEntry's node updates
    (reference: ShadowGraph.java:75-83).

    Contract: slots within one batch must be UNIQUE per shard — the host
    bucketing must pre-combine multiple entries for the same actor (sum
    recv deltas, keep the last flag set/clear pair), because the flag
    scatter reads the pre-batch value once.

    fn(flags, recv, slot, recv_delta, flag_set, flag_clear) with
    flags/recv node-sharded and the batch one row of host arrays per
    shard (local slot ids; slot >= shard size is padding and is
    dropped).  Returns (flags, recv)."""
    mesh = as_mesh(mesh)

    def fold(flags, recv, slot, recv_delta, flag_set, flag_clear):
        flags = put_nodes(mesh, flags)
        recv = put_nodes(mesh, recv)
        for i, (f, r) in enumerate(zip(flags, recv)):
            s, rd, fs, fc = _kept(slot[i], f.numel(), recv_delta[i],
                                  flag_set[i], flag_clear[i])
            dev = f.device
            s = torch.from_numpy(s).to(dev)
            r.index_put_((s,), torch.from_numpy(rd.astype(np.int64)).to(dev),
                         accumulate=True)
            fs = torch.from_numpy(fs.astype(np.uint8)).to(dev)
            fc = torch.from_numpy(fc.astype(np.uint8)).to(dev)
            f[s] = (f[s] | fs) & ~fc
        return flags, recv

    return fold


def make_sharded_decremental_wake(
    mesh,
    n_pad: int,
    shard_size: int,
    n_blocks: int,
    r_rows: int,
    s_rows: int,
    bucket_m: int,
    sub: int = None,
    group: int = None,
    mode: str = None,
    pull_density: float = None,
):
    """The decremental wake (suspect closure + destination-gated repair,
    ops/cuda_decremental.py) on the sharded data plane: per-wake cost
    proportional to the churn's affected region per shard, with one
    table gather per sweep.

    fn(flags, recv, del_w, fresh_w, prev_mark_w, prev_seed_w,
       prev_halted_w, prev_iu_w, prev_active_w,
       bmeta1, bmeta2, row_pos, emeta, bsrc, bdst[, jump_j])
      -> (mark, mark_w, seed_w, halted_w, iu_w, active_w)

    flags/recv node-sharded; every *_w operand and result is the flat
    word array (n_pad / 32 ints) sharded by word range (the same node
    partition); layout operands as in :func:`make_sharded_cuda_trace`.
    The inputs are not modified.  A zeroed previous state degenerates to
    the full derivation from seeds, so cold start and post-rebuild wakes
    need no separate path.  ``mode`` applies to the repair fixpoint
    exactly as in the single-device wake: jump/auto take the replicated
    jump-parent operand, pull/auto skip saturated local supertiles."""
    mesh = as_mesh(mesh)
    sub, group, mode, pull_density = _geometry(sub, group, mode, pull_density)
    use_jump = mode in (pt.MODE_JUMP, pt.MODE_AUTO)

    def wake(flags, recv, del_w, fresh_w, p_mark, p_seed, p_halt, p_iu,
             p_active, bmeta1, bmeta2, row_pos, emeta, bsrc, bdst, *rest):
        ops = _ShardOps(mesh, n_pad, shard_size, r_rows, s_rows, sub, group,
                        mode, pull_density)
        flags, recv, del_w, fresh_w, p_mark, p_seed, p_halt, p_iu, p_active = (
            put_nodes(mesh, x) for x in (flags, recv, del_w, fresh_w, p_mark,
                                         p_seed, p_halt, p_iu, p_active))
        layouts, buckets = _layout_operands(mesh, bmeta1, bmeta2, row_pos,
                                            emeta, bsrc, bdst)
        jump = _jump_operand(mesh, rest[0]) if use_jump else None
        shards = range(mesh.size)
        masks = [_seed_masks(f, r) for f, r in zip(flags, recv)]
        iu_w = [ops.pack_words(iu) for iu, _, _ in masks]
        halted_w = [ops.pack_words(h) for _, h, _ in masks]
        nh_w = [ops.pack_words(~h) for _, h, _ in masks]
        seed_w = [ops.pack_words(iu & ~h & s) for iu, h, s in masks]

        # --- 1. suspect seeds (shard-local) ------------------------- #
        suspects = [
            (~iu_w[i] | (halted_w[i] & ~p_halt[i]) | (p_seed[i] & ~seed_w[i])
             | del_w[i]) & p_mark[i]
            for i in shards
        ]

        # --- 2. closure: marks that depended on a suspect ----------- #
        closure_w, *_ = ops.fixpoint(suspects, None, p_mark, None, layouts,
                                     buckets, mode=pt.MODE_PUSH)
        suspect_g = [
            ops.supertile_any(closure_w[i]) | ops.supertile_any(fresh_w[i])
            | ops.supertile_any(iu_w[i] & ~p_iu[i])
            for i in shards
        ]

        # --- 3. repair fixpoint ------------------------------------- #
        mark_w, *_ = ops.fixpoint(
            [(pm & ~c) | s for pm, c, s in zip(p_mark, closure_w, seed_w)],
            ops.gather_table(p_active), iu_w, nh_w, layouts, buckets,
            jump=jump, gate=suspect_g)

        active_w = [m & h for m, h in zip(mark_w, nh_w)]
        marks = [ops.unpack(m) for m in mark_w]
        return marks, mark_w, seed_w, halted_w, iu_w, active_w

    return wake
