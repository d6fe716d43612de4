"""uigc_tpu_torch: the port of ``uigc_tpu`` to PyTorch and CUDA on Hopper.

The JAX package ``uigc_tpu`` stays beside it as the reference; every
module here names the reference module it is held against, and the
tests (``tests/test_torch_*.py``) feed both the same seeded inputs.
This package imports ``torch`` and never ``jax`` or ``uigc_tpu``.

Its entry points run on the CUDA card unless the caller passes
``device="cpu"`` (or, for a live system, sets ``uigc.crgc.device`` to
"cpu"); on the CPU every kernel runs as its plain PyTorch version.  It
carries the CRGC device trace (the static fixpoint ``ops/cuda_trace.py``,
the incremental layout ``ops/cuda_incremental.py`` and the decremental
wake ``ops/cuda_decremental.py``, all over one hand-written propagate
kernel, ``csrc/propagate.cu``) and the single-node actor runtime with the
CRGC engine, whose ``device`` and ``decremental`` shadow-graph backends
trace through that kernel in a live collector, and whose ``mesh`` and
``mesh-decremental`` backends shard that trace by node range over
several cards (``parallel/``), the kernel running on every shard.

The public API mirrors ``uigc_tpu``'s, without cluster sharding (not
ported yet).
"""

from .config import Config
from .interfaces import GCMessage, Message, NoRefs, Refob, SpawnInfo, State
from .runtime.behaviors import AbstractBehavior, ActorFactory, Behaviors, RawBehavior
from .runtime.context import ActorContext
from .runtime.signals import PostStop, Signal, Terminated
from .runtime.system import ActorSystem, RawRef
from .runtime.testkit import ActorTestKit, TestProbe

#: The reference calls managed refs ``ActorRef[T] = Refob[T]``
#: (reference: package.scala:7-9).
ActorRef = Refob

__version__ = "0.1.0"

__all__ = [
    "AbstractBehavior",
    "ActorContext",
    "ActorFactory",
    "ActorRef",
    "ActorSystem",
    "ActorTestKit",
    "Behaviors",
    "Config",
    "GCMessage",
    "Message",
    "NoRefs",
    "PostStop",
    "RawBehavior",
    "RawRef",
    "Refob",
    "Signal",
    "SpawnInfo",
    "State",
    "TestProbe",
    "__version__",
]
