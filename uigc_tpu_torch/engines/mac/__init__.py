"""Copy of ``uigc_tpu/engines/mac/__init__.py``."""

from .detector import CycleDetector, strongly_connected_components
from .engine import MAC, MacRefob, MacState, RC_INC

__all__ = [
    "CycleDetector",
    "MAC",
    "MacRefob",
    "MacState",
    "RC_INC",
    "strongly_connected_components",
]
