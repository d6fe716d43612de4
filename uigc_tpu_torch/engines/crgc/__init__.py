"""Copy of ``uigc_tpu/engines/crgc/__init__.py`` (pure Python)."""

from .engine import CRGC, CrgcSpawnInfo
from .messages import AppMsg, StopMsg, WaveMsg
from .refob import CrgcRefob
from .shadow import Shadow, ShadowGraph
from .state import CrgcContext, CrgcState, Entry

__all__ = [
    "AppMsg",
    "CRGC",
    "CrgcContext",
    "CrgcRefob",
    "CrgcSpawnInfo",
    "CrgcState",
    "Entry",
    "Shadow",
    "ShadowGraph",
    "StopMsg",
    "WaveMsg",
]
