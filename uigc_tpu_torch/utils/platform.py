"""Device selection for the port's entry points.

Port of ``uigc_tpu/utils/platform.py``.  The reference decides which JAX
platform is a real TPU; here the question is whether a CUDA card is
present and whether it is a Hopper part (compute capability 9.0, the
``sm_90a`` target the propagate kernel is built for).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
With no card and no such argument they raise: there is no silent fall
back to the CPU, so a run that reports device numbers ran on the device.
"""

from __future__ import annotations

import threading

import torch

#: The compute capability the hand-written kernels are built for.
HOPPER = (9, 0)

#: (tag, seconds) of every kernel or native library built in this
#: process, in build order; read by telemetry/device.py
_builds: list = []
_builds_lock = threading.Lock()


def record_build(tag: str, seconds: float) -> None:
    """Note one library build (``nvcc`` or ``g++``) and its seconds."""
    with _builds_lock:
        _builds.append((tag, float(seconds)))


def build_log() -> list:
    """The ``(tag, seconds)`` builds of this process so far, oldest first."""
    with _builds_lock:
        return list(_builds)


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none:
    the current CUDA card.  Raises when CUDA is missing."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` for None.

    A CUDA device is pinned to an index here (the current card when none
    is named), so work issued later from another thread, such as a live
    collector's dispatcher thread, lands on the card chosen now.  A CUDA
    device raises when no card is visible."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            return default_device()
        if not torch.cuda.is_available():
            default_device()  # raises: no card is visible
    return dev


def require_hopper(device=None) -> tuple:
    """Raise unless ``device`` (default: the current card) is an sm_90
    part; returns its capability."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"{dev} is not a CUDA device")
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != HOPPER:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap}; the kernels target sm_90a {HOPPER}"
        )
    return tuple(cap)
