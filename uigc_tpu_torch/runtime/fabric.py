"""The membership events of ``uigc_tpu/runtime/fabric.py``, copied.

The single-node collector (``engines/crgc/collector.py``) handles
``MemberUp`` and ``MemberRemoved``, so the port carries those two classes
as the reference defines them.  The in-process ``Fabric`` itself (links,
egress/ingress interception, fault injection) is not ported yet:
ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations


class MemberUp:
    __slots__ = ("address",)

    def __init__(self, address: str):
        self.address = address

    def __repr__(self) -> str:
        return f"MemberUp({self.address})"


class MemberRemoved:
    __slots__ = ("address",)

    def __init__(self, address: str):
        self.address = address

    def __repr__(self) -> str:
        return f"MemberRemoved({self.address})"
