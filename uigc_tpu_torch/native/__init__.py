"""Copy of ``uigc_tpu/native/__init__.py`` (pure Python), building into
the port's ``native/build/`` (listed in ``.gitignore``) under a temporary
name unique per process and thread, and noting the build's seconds in
``utils/platform.py``'s build log (read by the device observatory,
``telemetry/device.py``).

Native (C++) data-plane bindings.

The reference keeps its collector hot tier in allocation-conscious plain
Java (reference: crgc/ShadowGraph.java and friends); ours is C++ behind a
batch-oriented C ABI, loaded via ctypes (no pybind11 in this image).  The
shared library builds lazily from the vendored source with g++ the first
time it is needed; ``is_available()`` reports whether that worked.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Optional

from ..utils import platform

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "crgc_shadow.cpp")
#: build output directory (listed in .gitignore)
_BUILD = os.path.join(_HERE, "build")
_LIB = os.path.join(_BUILD, "libuigc_crgc.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_i64 = ctypes.c_int64
_p_i64 = ctypes.POINTER(ctypes.c_int64)
_p_i32 = ctypes.POINTER(ctypes.c_int32)
_p_u8 = ctypes.POINTER(ctypes.c_uint8)


def _build() -> None:
    # Unique temp name: concurrent builders (separate processes, or
    # threads of one) must not clobber each other's half-written output
    # before the atomic replace.
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed (exit {proc.returncode}): {proc.stderr.strip()}"
            )
        os.replace(tmp, _LIB)
        platform.record_build("g++:crgc_shadow", time.perf_counter() - t0)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    lib.uigc_graph_new.restype = ctypes.c_void_p
    lib.uigc_graph_new.argtypes = []
    lib.uigc_graph_free.restype = None
    lib.uigc_graph_free.argtypes = [ctypes.c_void_p]
    lib.uigc_num_in_use.restype = _i64
    lib.uigc_num_in_use.argtypes = [ctypes.c_void_p]
    lib.uigc_total_seen.restype = _i64
    lib.uigc_total_seen.argtypes = [ctypes.c_void_p]
    lib.uigc_merge_entries.restype = None
    lib.uigc_merge_entries.argtypes = [
        ctypes.c_void_p, _i64,
        _p_i64, _p_i64, _p_u8,            # self_ids, recv_counts, eflags
        _p_i64, _p_i64, _p_i64,           # created_off, owners, targets
        _p_i64, _p_i64,                   # spawned_off, spawned_ids
        _p_i64, _p_i64, _p_i64, _p_u8,    # updated_off, ids, send_counts, deact
    ]
    lib.uigc_merge_delta.restype = None
    lib.uigc_merge_delta.argtypes = [
        ctypes.c_void_p, _i64,
        _p_i64, _p_i64, _p_i32, _p_u8,    # ids, recv, supervisor_idx, dflags
        _p_i64, _p_i32, _p_i64,           # out_off, out_target_idx, out_count
    ]
    lib.uigc_merge_undo.restype = None
    lib.uigc_merge_undo.argtypes = [
        ctypes.c_void_p, _i64, _i64,
        _p_i64, _p_i64,                   # admitted_ids, msg_counts
        _p_i64, _p_i64, _p_i64,           # created_off, targets, counts
    ]
    lib.uigc_trace.restype = _i64
    lib.uigc_trace.argtypes = [ctypes.c_void_p, _p_i64, _p_i64, _p_i64, _p_i64]
    lib.uigc_local_roots.restype = _i64
    lib.uigc_local_roots.argtypes = [ctypes.c_void_p, _p_i64]
    lib.uigc_live_ids.restype = _i64
    lib.uigc_live_ids.argtypes = [ctypes.c_void_p, _p_i64]
    lib.uigc_count_reachable_from.restype = _i64
    lib.uigc_count_reachable_from.argtypes = [ctypes.c_void_p, _i64]
    # batch probes for ops/i64map.py (table storage stays numpy-owned)
    lib.uigc_map_get_batch.restype = None
    lib.uigc_map_get_batch.argtypes = [_p_i64, _p_i64, _i64, _p_i64, _i64, _p_i64]
    lib.uigc_map_put_batch_new.restype = _i64
    lib.uigc_map_put_batch_new.argtypes = [_p_i64, _p_i64, _i64, _p_i64, _p_i64, _i64]
    lib.uigc_map_pop_batch.restype = _i64
    lib.uigc_map_pop_batch.argtypes = [_p_i64, _p_i64, _i64, _p_i64, _i64, _p_i64]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        try:
            # mtimes survive neither git checkouts nor cross-machine
            # copies, so a same-age .so is treated as stale too; and if a
            # prebuilt .so fails to load (wrong arch/libc), rebuild once
            # from source before giving up.
            if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) <= os.path.getmtime(_SRC)
            ):
                _build()
            try:
                lib = ctypes.CDLL(_LIB)
            except OSError:
                _build()
                lib = ctypes.CDLL(_LIB)
            _declare(lib)
        except Exception as exc:  # noqa: BLE001 - report any toolchain failure
            _build_error = str(exc)
            raise RuntimeError(f"native library unavailable: {exc}") from exc
        _lib = lib
        return lib


def is_available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


from .graph import NativeShadowGraph  # noqa: E402  (needs the symbols above)

__all__ = ["NativeShadowGraph", "is_available", "load"]
