"""Copy of ``uigc_tpu/engines/crgc/refob.py`` (pure Python).

CRGC refobs and the packed send-count/status word.

``refob_info`` mirrors the reference's packed-short encoding exactly
(reference: src/main/java/.../crgc/RefobInfo.java:8-35): the least
significant bit is the deactivated flag, the upper 15 bits are the send
count, and the count saturates to force an early entry flush (reference:
CRGC.scala:215-216).  We keep the 15-bit width — not because Python needs
it, but because the saturation protocol is part of CRGC's wire behavior
and the device data plane packs these words into int16 lanes.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional

from ...interfaces import Refob

if TYPE_CHECKING:  # pragma: no cover
    from ...runtime.cell import ActorCell

SHORT_MAX = 32767

ACTIVE_REFOB = 0  # (reference: RefobInfo.java:9)


def can_increment(info: int) -> bool:
    """(reference: RefobInfo.java:11-13)"""
    return info <= SHORT_MAX - 2


def inc_send_count(info: int) -> int:
    """(reference: RefobInfo.java:15-17)"""
    return info + 2


def reset_count(info: int) -> int:
    """(reference: RefobInfo.java:19-21)"""
    return 0


def count(info: int) -> int:
    """(reference: RefobInfo.java:23-25)"""
    return info >> 1


def is_active(info: int) -> bool:
    """(reference: RefobInfo.java:27-29)"""
    return (info & 1) == 0


def deactivate(info: int) -> int:
    """Idempotent (reference: RefobInfo.java:31-34)"""
    return info | 1


class CrgcRefob(Refob):
    """A CRGC reference object (reference: crgc/Refob.scala:9-66).

    Carries a mutable packed info word and a one-shot "has been recorded"
    flag used to dedup updated-refob records within an entry period.  The
    ``target_shadow`` cache points into the collector's graph; staleness is
    benign (reference: Refob.scala:12-17).
    """

    __slots__ = ("_target", "target_shadow", "_info", "_has_been_recorded")

    def __init__(self, target: "ActorCell", target_shadow: Any = None):
        self._target = target
        self.target_shadow = target_shadow
        self._info = ACTIVE_REFOB
        self._has_been_recorded = False

    @property
    def target(self) -> "ActorCell":
        return self._target

    @property
    def info(self) -> int:
        return self._info

    @property
    def has_been_recorded(self) -> bool:
        return self._has_been_recorded

    def set_has_been_recorded(self) -> None:
        self._has_been_recorded = True

    def deactivate(self) -> None:
        self._info = deactivate(self._info)

    def inc_send_count(self) -> None:
        self._info = inc_send_count(self._info)

    def can_inc_send_count(self) -> bool:
        return can_increment(self._info)

    def reset(self) -> None:
        """Called when the owning actor flushes this refob into an entry
        (reference: Refob.scala:44-47)."""
        self._info = reset_count(self._info)
        self._has_been_recorded = False

    def __eq__(self, other: Any) -> bool:
        # Refobs compare by target actor (reference: Refob.scala:49-53).
        return isinstance(other, CrgcRefob) and self._target is other._target

    def __hash__(self) -> int:
        return hash(id(self._target))

    def __repr__(self) -> str:
        return f"CrgcRefob({self._target.path})"
