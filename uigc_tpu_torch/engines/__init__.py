"""Copy of ``uigc_tpu/engines/__init__.py`` (pure Python).

GC engine registry.

Mirrors the reference's extension factory switch on ``uigc.engine``
(reference: UIGC.scala:12-19).  Engines: "crgc" (alias "tpu-crgc", the
default, TPU-accelerated), "mac" (weighted reference counting + cycle
detection), "manual" (GC off), and "drl" (reference listing; selectable
here, unlike the reference where it is dead code — UIGC.scala:14-18).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from .engine import Engine, TerminationDecision

if TYPE_CHECKING:  # pragma: no cover
    from ..runtime.system import ActorSystem


def create_engine(system: "ActorSystem") -> Engine:
    name = system.config.get_string("uigc.engine")
    if name in ("crgc", "tpu-crgc"):
        from .crgc.engine import CRGC

        return CRGC(system)
    if name == "mac":
        from .mac.engine import MAC

        return MAC(system)
    if name == "manual":
        from .manual import Manual

        return Manual(system)
    if name == "drl":
        from .drl.engine import DRL

        return DRL(system)
    raise ValueError(f"unknown uigc.engine: {name!r}")


__all__ = ["Engine", "TerminationDecision", "create_engine"]
