"""The propagation-sweep kernel: a hand-written Hopper kernel, its plain
PyTorch twin, and the loader that builds the kernel from the repo's source.

Replaces the TPU kernel ``uigc_tpu/ops/pallas_trace.py:build_propagate``
(the only ``pl.pallas_call`` of the reference, ``:1181``) in both of its
forms: without and with the destination gate (``dst_gate=True``).  It
reads the Pallas kernel's operands, from the same host packer, but
writes what every caller of the Pallas kernel makes of its output at
once: packed hit words.  One sweep (``csrc/propagate.cu`` states it in
full):

    for every packed (src, dst) slot whose source walk group is walked
    (dirty, or its supertile's gate is FULL; never when the gate is SKIP):
        if (table bit of src): out word dst >> 5 |= 1 << (dst & 31)

``dst`` is the destination's global node id: a compact layout's tiles
map to global supertiles through its ``super_ids``, and the gate is
indexed by global supertile.  OR is order-free, so the layouts of one
sweep OR into one plane, which the caller zeroes once per sweep.

Two plain versions sit beside the kernel.  :func:`propagate_torch` is
the Pallas kernel's own f32 count contract (a gather and an
``index_add_``), kept because the CPU tests hold it against the Pallas
kernel bit for bit; :func:`propagate_words_torch` is the kernel's
contract, built on it: thresholded, scattered by ``super_ids``, packed.

:func:`propagate_words` is what the trace calls: the plain version for
CPU tensors, the kernel for CUDA tensors.  There is no fallback: a CUDA
tensor whose kernel cannot be built or launched raises.

The same source holds the jump step's kernel (``jump_sweep_kernel``),
launched by :func:`jump_sweep_words_cuda`, one launch a sweep of the
jump and auto modes.  Its plain twin is ``ops/cuda_trace.py``
``jump_sweep`` and ``pack_bools``.  It also holds the raw pair tier's
kernel (``propagate_pairs_kernel``), launched by :func:`propagate_pairs`
once a sweep of a trace whose layouts include an ``xla`` tier; its plain
twin is :func:`propagate_pairs_torch`.

The kernels are built at first use by ``nvcc`` into ``csrc/build/`` (a
shared library with a plain C interface, bound with ``ctypes``), named by
a hash of its source so an edited source is never served a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..utils import platform

# Kernel ABI of the packed layout (shared with ops/cuda_trace.py's packer).
LANE = 128  # slots per layout row; lanes of the word table
ROWS = 8  # slot row class = source table row mod 8
SPAN_BITS = 12  # bmeta2 = c_lo << SPAN_BITS | span
WORD_BITS = 32  # nodes per packed word
#: row_pos sentinel of an empty or masked slot: beyond any table row
PAD_ROW = 1 << 28
#: per-supertile gate values read by the gated form
GATE_PUSH = 0  # walk the dirty groups inside the block's span
GATE_FULL = 1  # walk the block's whole span
GATE_SKIP = 2  # walk nothing

#: launches of each kernel (form) since the last reset_launches(); the
#: wrapper adds one where it launches, and nowhere else.  ``jump`` is the
#: jump step's kernel, one launch a sweep of the jump and auto modes;
#: ``pairs`` the raw pair tier's, one launch a sweep that has the tier.
launches = {"propagate": 0, "propagate_gated": 0, "jump": 0, "pairs": 0}
#: guards ``launches``: several collectors (one per system of a
#: multi-node fabric) launch from their own threads, and ``+= 1`` on a
#: dict entry is a read, an add and a store
_launches_lock = threading.Lock()

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "propagate.cu"
BUILD_DIR = _CSRC / "build"
#: what the last build did: library path, seconds, nvcc's ptxas report
build_info: dict = {}
_lib = None
#: serializes the build and the binding: the first wake of a live
#: collector builds on a dispatcher thread, possibly beside another
_build_lock = threading.Lock()


def _count_launch(form: str) -> None:
    with _launches_lock:
        launches[form] += 1


def reset_launches() -> None:
    with _launches_lock:
        for k in launches:
            launches[k] = 0


# --------------------------------------------------------------------- #
# Build and load
# --------------------------------------------------------------------- #


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the propagate kernel cannot be built"
        )
    return found


def build_library() -> Path:
    """Compile ``csrc/propagate.cu`` for sm_90a unless a build of this
    exact source exists; returns the library's path.  Raises on failure.
    One build at a time in this process."""
    with _build_lock:
        return _build_locked()


def _build_locked() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libpropagate-{digest}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique per process and thread: no two builders share a half-written file
    tmp = lib_path.with_name(
        f"{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    )
    t0 = time.perf_counter()
    ptxas = _compile(tmp)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or nothing
    build_info.update(path=str(lib_path), seconds=seconds, cached=False,
                      ptxas=ptxas)
    platform.record_build("nvcc:propagate", seconds)
    return lib_path


def _compile(out: Path) -> str:
    """nvcc the source into ``out``; returns ptxas's report.  Raises."""
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(_SOURCE),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr[-4000:]}"
        )
    return proc.stderr.strip()


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fn = lib.uigc_propagate_words
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9
        + [ctypes.c_int64] + [ctypes.c_int32] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    jump = lib.uigc_jump_sweep_words
    jump.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int32, ctypes.c_int64,
                                 ctypes.c_void_p]
    )
    jump.restype = ctypes.c_int
    pairs = lib.uigc_propagate_pairs
    pairs.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int32, ctypes.c_int64,
                                 ctypes.c_void_p]
    )
    pairs.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built and bound on first call, by one thread."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is None:
            _lib = _bind(_build_locked())
    return _lib


# --------------------------------------------------------------------- #
# Word packing
# --------------------------------------------------------------------- #


def _bit_weights(device) -> torch.Tensor:
    """int32 word weight of each bit: 1 << b, with bit 31 wrapped to
    -2^31 so a sum of distinct bits is the two's-complement word."""
    w = np.left_shift(np.int64(1), np.arange(WORD_BITS, dtype=np.int64))
    return torch.from_numpy(w.astype(np.int32)).to(device)


def pack_hits_words(hits2d):
    """Word-pack a (t, LANE) boolean hits plane into flat int32 words:
    lane g*32+b of row t is bit b of word t*4+g (node id = 32*word + bit).

    The bits of a word are distinct powers of two, so their int32 sum is
    the word with no overflow, bit 31 included (its weight is -2^31)."""
    t = hits2d.shape[0]
    h3 = hits2d.to(torch.int32).reshape(t, LANE // WORD_BITS, WORD_BITS)
    w = (h3 * _bit_weights(hits2d.device)).sum(dim=2, dtype=torch.int32)
    return w.reshape(-1)


def bits_at(table, ids, n):
    """Gather per-node bits from a packed word table for an integer id
    vector; ids >= n (the sentinel and any padding) read as 0."""
    flat = table.reshape(-1)
    ids = ids.long()
    word = torch.clamp(ids >> 5, max=flat.numel() - 1)
    return (((flat[word] >> (ids & 31)) & 1) > 0) & (ids < n)


# --------------------------------------------------------------------- #
# The plain versions and the kernel
# --------------------------------------------------------------------- #


def _check(name, t, device, numel=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected int32")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")


def _check_operands(d, bmeta1, bmeta2, table, row_pos, emeta, out_tiles,
                    sub, group, gate):
    dev = table.device
    if table.dim() != 2 or table.shape[1] != LANE:
        raise ValueError(f"table must be (r_rows, {LANE}), got {tuple(table.shape)}")
    r_rows = table.shape[0]
    group_rows = ROWS * group
    if r_rows % group_rows:
        raise ValueError(f"r_rows {r_rows} is not a multiple of {group_rows}")
    n_blocks = bmeta1.numel()
    n_slots = n_blocks * ROWS * sub * LANE
    if row_pos.shape != emeta.shape:
        raise ValueError("row_pos and emeta differ in shape")
    _check("table", table, dev)
    _check("d", d, dev, r_rows // group_rows + 1)
    _check("bmeta1", bmeta1, dev)
    _check("bmeta2", bmeta2, dev, n_blocks)
    _check("row_pos", row_pos, dev, n_slots)
    _check("emeta", emeta, dev, n_slots)
    if gate is not None:
        _check("gate", gate, dev, out_tiles)
    return r_rows, n_slots


def _check_words_operands(d, bmeta1, bmeta2, table, row_pos, emeta, out,
                          n_super, s_rows, sub, group, gate, super_ids):
    """Checks of the words contract: the layout's operands, a word plane
    that holds every global supertile, a global gate, and a compact
    layout's tile map.  Returns the layout's tile count."""
    if not 1 <= s_rows <= 32:
        raise ValueError(f"s_rows {s_rows} outside [1, 32] (dst_sub is 5 bits)")
    dev = table.device
    out_tiles = n_super
    if super_ids is not None:
        _check("super_ids", super_ids, dev)
        out_tiles = super_ids.numel()
    _check_operands(d, bmeta1, bmeta2, table, row_pos, emeta, out_tiles,
                    sub, group, None)
    if gate is not None:
        _check("gate", gate, dev, n_super)
    _check("out", out, dev)
    words = n_super * s_rows * (LANE // WORD_BITS)
    if out.numel() < words:
        raise ValueError(f"out holds {out.numel()} words, the {n_super} "
                         f"supertiles need {words}")
    return out_tiles


def propagate_torch(d, bmeta1, bmeta2, table, row_pos, emeta, *, out_tiles,
                    s_rows, sub, group, gate=None):
    """The Pallas kernel's contract in plain PyTorch: f32[out_tiles *
    s_rows, LANE] contribution counts, a gather of the live slots' source
    bits plus an ``index_add_``.  ``gate`` is per layout tile."""
    _check_operands(d, bmeta1, bmeta2, table, row_pos, emeta, out_tiles,
                    sub, group, gate)
    dev = table.device
    r_rows = table.shape[0]
    rp = row_pos.reshape(-1).long()
    ri = torch.arange(rp.numel(), device=dev) // LANE
    live = (rp >= 0) & (rp < r_rows) & ((rp & 7) == (ri & 7))
    idx = live.nonzero().squeeze(1)
    rp, ri = rp[idx], ri[idx]
    blk = ri // (ROWS * sub)
    m2 = bmeta2.long()[blk]
    c_lo = m2 >> SPAN_BITS
    span = m2 & ((1 << SPAN_BITS) - 1)
    c = rp // (ROWS * group)
    tile = bmeta1.long()[blk] >> 1
    dl = d.long()
    dirty = dl[c + 1] != dl[c]
    walk = (c >= c_lo) & (c < c_lo + span)
    if gate is None:
        walk &= dirty
    else:
        g = gate.long()[tile]
        walk &= (g != GATE_SKIP) & (dirty | (g == GATE_FULL))
    em = emeta.reshape(-1).long()[idx]
    word = table.reshape(-1).long()[rp * LANE + (em & 127)]
    hit = walk & (((word >> ((em >> 7) & 31)) & 1) == 1)
    dst = (tile * s_rows + ((em >> 19) & 31)) * LANE + ((em >> 12) & 127)
    dst = dst[hit]
    out = torch.zeros(out_tiles * s_rows * LANE, dtype=torch.float32,
                      device=dev)
    out.index_add_(0, dst, torch.ones(dst.numel(), dtype=torch.float32,
                                      device=dev))
    return out.reshape(out_tiles * s_rows, LANE)


def propagate_words_torch(d, bmeta1, bmeta2, table, row_pos, emeta, out, *,
                          n_super, s_rows, sub, group, gate=None,
                          super_ids=None):
    """The kernel's contract in plain PyTorch: :func:`propagate_torch`,
    thresholded, scattered to global supertiles by ``super_ids``, packed,
    and ORed into ``out``.  Same operands and result as
    :func:`propagate_words_cuda`; returns ``out``."""
    out_tiles = _check_words_operands(d, bmeta1, bmeta2, table, row_pos,
                                      emeta, out, n_super, s_rows, sub, group,
                                      gate, super_ids)
    dev = table.device
    sid = None if super_ids is None else super_ids.long()
    if gate is not None and sid is not None:
        gate = gate[sid].contiguous()  # the Pallas contract's per-tile gate
    c = propagate_torch(d, bmeta1, bmeta2, table, row_pos, emeta,
                        out_tiles=out_tiles, s_rows=s_rows, sub=sub,
                        group=group, gate=gate)
    if sid is not None:
        rows = (sid[:, None] * s_rows
                + torch.arange(s_rows, device=dev)[None, :]).reshape(-1)
        glob = torch.zeros((n_super * s_rows, LANE), dtype=torch.float32,
                           device=dev)
        c = glob.index_add_(0, rows, c)
    words = pack_hits_words(c > 0)
    flat = out.view(-1)
    flat[: words.numel()] |= words
    return out


def propagate_words_cuda(d, bmeta1, bmeta2, table, row_pos, emeta, out, *,
                         n_super, s_rows, sub, group, gate=None,
                         super_ids=None):
    """The hand-written sm_90a kernel (``csrc/propagate.cu``), launched on
    the current stream: ORs one layout's hits into ``out`` and returns
    it.  Raises when an operand is not what the kernel takes, when the
    build fails, or when the launch is refused."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"propagate_words_cuda needs CUDA tensors, got {dev}")
    _check_words_operands(d, bmeta1, bmeta2, table, row_pos, emeta, out,
                          n_super, s_rows, sub, group, gate, super_ids)
    for name, t in (("row_pos", row_pos), ("emeta", emeta)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    fn = load_library().uigc_propagate_words
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(
            1 if gate is not None else 0,
            d.data_ptr(),
            gate.data_ptr() if gate is not None else None,
            bmeta1.data_ptr(), bmeta2.data_ptr(),
            super_ids.data_ptr() if super_ids is not None else None,
            table.data_ptr(), row_pos.data_ptr(), emeta.data_ptr(),
            out.data_ptr(), bmeta1.numel(), table.shape[0], ROWS * sub,
            ROWS * group, s_rows, stream,
        )
    if err != 0:
        raise RuntimeError(f"propagate kernel launch failed: CUDA error {err}")
    _count_launch("propagate_gated" if gate is not None else "propagate")
    return out


def propagate_words(d, bmeta1, bmeta2, table, row_pos, emeta, out, *,
                    n_super, s_rows, sub, group, gate=None, super_ids=None):
    """One layout's share of a propagation sweep, ORed into the int32
    word plane ``out`` (at least ``n_super * s_rows * 4`` words; the
    caller zeroes it once per sweep).  CPU tensors take the plain
    version (the CPU has no kernel); CUDA tensors take the kernel."""
    kind = table.device.type
    kw = dict(n_super=n_super, s_rows=s_rows, sub=sub, group=group,
              gate=gate, super_ids=super_ids)
    if kind == "cpu":
        return propagate_words_torch(d, bmeta1, bmeta2, table, row_pos,
                                     emeta, out, **kw)
    if kind == "cuda":
        return propagate_words_cuda(d, bmeta1, bmeta2, table, row_pos, emeta,
                                    out, **kw)
    raise ValueError(f"no propagate kernel for device type {kind!r}")


# --------------------------------------------------------------------- #
# The jump step's kernel
# --------------------------------------------------------------------- #


def check_jump_operands(table, jump_j, trans_w, iu_w, n):
    """Checks of the jump step's contract (``csrc/propagate.cu``
    ``jump_sweep_kernel``), host attribute reads only: int32, contiguous
    and on one device; three word planes of one (r_rows, LANE) shape that
    holds n nodes; n + 1 parents."""
    dev = table.device
    if table.dim() != 2 or table.shape[1] != LANE:
        raise ValueError(f"table must be (r_rows, {LANE}), got {tuple(table.shape)}")
    if not 0 <= n <= table.numel() * WORD_BITS or n >= (1 << 31) - 1:
        raise ValueError(f"n {n} does not fit the {table.numel()}-word table "
                         f"and int32 ids")
    _check("table", table, dev)
    for name, t in (("trans_w", trans_w), ("iu_w", iu_w)):
        _check(name, t, dev)
        if t.shape != table.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, the table "
                             f"{tuple(table.shape)}")
    _check("jump_j", jump_j, dev, n + 1)
    if jump_j.dim() != 1:
        raise ValueError(f"jump_j must be flat, got {tuple(jump_j.shape)}")


def jump_sweep_words_cuda(table, jump_j, trans_w, iu_w, n):
    """The jump step's sm_90a kernel, launched on the current stream:
    returns fresh (hit_words, new_jump_j), the words shaped like
    ``table``.  ``jump_j`` is only read.  Raises when an operand is not
    what the kernel takes, when the build fails, or when the launch is
    refused."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"jump_sweep_words_cuda needs CUDA tensors, got {dev}")
    check_jump_operands(table, jump_j, trans_w, iu_w, n)
    hit_words = torch.empty_like(table)
    new_j = torch.empty_like(jump_j)
    fn = load_library().uigc_jump_sweep_words
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), jump_j.data_ptr(), trans_w.data_ptr(),
                 iu_w.data_ptr(), hit_words.data_ptr(), new_j.data_ptr(), n,
                 table.numel(), stream)
    if err != 0:
        raise RuntimeError(f"jump kernel launch failed: CUDA error {err}")
    _count_launch("jump")
    return hit_words, new_j


# --------------------------------------------------------------------- #
# The raw pair tier's kernel
# --------------------------------------------------------------------- #


def check_pairs_operands(table, src, dst, out, n):
    """Checks of the raw pair tier's contract (``csrc/propagate.cu``
    ``propagate_pairs_kernel``), host attribute reads only: int32,
    contiguous and on one device; a (r_rows, LANE) table that holds n
    nodes, an ``out`` plane of its shape, and one flat (src, dst) pair a
    slot."""
    dev = table.device
    if table.dim() != 2 or table.shape[1] != LANE:
        raise ValueError(f"table must be (r_rows, {LANE}), got {tuple(table.shape)}")
    if not 0 <= n <= table.numel() * WORD_BITS or n >= (1 << 31) - 1:
        raise ValueError(f"n {n} does not fit the {table.numel()}-word table "
                         f"and int32 ids")
    _check("table", table, dev)
    _check("out", out, dev)
    if out.shape != table.shape:
        raise ValueError(f"out is {tuple(out.shape)}, the table "
                         f"{tuple(table.shape)}")
    _check("src", src, dev)
    _check("dst", dst, dev, src.numel())
    if src.dim() != 1 or dst.dim() != 1:
        raise ValueError(f"src and dst must be flat, got {tuple(src.shape)} "
                         f"and {tuple(dst.shape)}")


def propagate_pairs_torch(table, src, dst, out, n):
    """The raw pair tier's share of a sweep in plain PyTorch, the kernel's
    twin: ORs into ``out`` the bit of every ``dst`` whose ``src`` bit is
    set in ``table``, and returns ``out``.  Ids lie in [0, n], n being
    the sink of the tier's pads: a source >= n reads as 0, and a real
    pair's destination is below n."""
    check_pairs_operands(table, src, dst, out, n)
    n_pad_nodes = out.numel() * WORD_BITS
    # Source-active bits straight from the packed table; sink pads (src =
    # n) read as 0 (bits_at clamps the word index, which can be one row
    # past the table for them).
    src_active = bits_at(table, src, n).to(torch.int32)
    prop = torch.zeros(n_pad_nodes + 1, dtype=torch.int32, device=table.device)
    prop.scatter_reduce_(0, dst.long(), src_active, "amax", include_self=True)
    hits = pack_hits_words(prop[:n_pad_nodes].reshape(-1, LANE) > 0)
    flat_out = out.view(-1)
    flat_out |= hits
    return out


def propagate_pairs_cuda(table, src, dst, out, n):
    """The raw pair tier's sm_90a kernel, launched on the current stream:
    ORs the tier's hits into ``out`` and returns it.  Raises when an
    operand is not what the kernel takes, when the build fails, or when
    the launch is refused."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"propagate_pairs_cuda needs CUDA tensors, got {dev}")
    check_pairs_operands(table, src, dst, out, n)
    fn = load_library().uigc_propagate_pairs
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), src.data_ptr(), dst.data_ptr(),
                 out.data_ptr(), n, src.numel(), stream)
    if err != 0:
        raise RuntimeError(f"pairs kernel launch failed: CUDA error {err}")
    _count_launch("pairs")
    return out


def propagate_pairs(table, src, dst, out, n):
    """A raw pair tier's share of a propagation sweep, ORed into the word
    plane ``out``, shaped like ``table`` (the caller zeroes it once per
    sweep).  CPU tensors take :func:`propagate_pairs_torch`; CUDA tensors
    take the kernel, with no fallback."""
    kind = table.device.type
    if kind == "cpu":
        return propagate_pairs_torch(table, src, dst, out, n)
    if kind == "cuda":
        return propagate_pairs_cuda(table, src, dst, out, n)
    raise ValueError(f"no pairs kernel for device type {kind!r}")
