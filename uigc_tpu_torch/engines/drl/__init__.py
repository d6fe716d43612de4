"""Copy of ``uigc_tpu/engines/drl/__init__.py``."""

from .engine import DRL, DrlRefob, DrlState, Token

__all__ = ["DRL", "DrlRefob", "DrlState", "Token"]
