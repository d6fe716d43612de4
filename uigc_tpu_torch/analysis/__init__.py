"""Copy of ``uigc_tpu/analysis/__init__.py``: the sanitizer and the race
detector; the static checker is the subpackage :mod:`.check`.

Correctness tooling for the actor runtime and its GC engines.

Three parts (see GUIDE.md "Correctness tooling"):

- :mod:`uigc_tpu.analysis.sanitizer` — **uigcsan**, an online sanitizer
  that wraps a system's engine and collector with an independent shadow
  oracle and cross-checks every collection cycle (quiescence verdicts,
  send/recv balances, created/released pairing, undo-log fold
  discipline, monotone sequence invariants).
- :mod:`uigc_tpu.analysis.race` — a vector-clock race detector over the
  ``sched.*`` scheduling event stream that checks the documented
  invariants of :mod:`uigc_tpu.runtime.cell` (single-threaded cell
  processing, system-before-app ordering, children-stop-before-PostStop).
- :mod:`uigc_tpu_torch.analysis.check` — uigc-check, the static
  checker (lint, surface registry, lock graph, purity), run as
  ``python -m uigc_tpu_torch.tools.uigc_check`` and its lint pass alone
  as ``python -m uigc_tpu_torch.tools.uigc_lint``.
"""

from .race import RaceDetector, VectorClock
from .sanitizer import Sanitizer, SanitizerViolation

__all__ = ["Sanitizer", "SanitizerViolation", "RaceDetector", "VectorClock"]
