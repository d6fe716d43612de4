"""uigc-check: whole-repo cross-plane static analysis, on the port.

The port of ``uigc_tpu/analysis/check/`` (the static half of the
correctness tooling; the online half is uigcsan,
``uigc_tpu_torch/analysis/sanitizer.py``).  One shared parse of the
analyzed tree feeds four passes:

``lint``     the UL001-UL016 file-local rules (:mod:`.lint_rules`;
             ``uigc_tpu_torch/tools/uigc_lint.py`` is a thin wrapper
             over this pass), UL011 knowing PyTorch's readback idioms
``surface``  the cross-plane surface registry: config keys, event
             names, metric names, NodeFabric frame kinds and schema
             ids harvested into one machine-readable document, with
             UC1xx rules over the seams between them (:mod:`.surface`)
``locks``    the interprocedural lock-order graph (:mod:`.locks`)
``purity``   trace purity for traced forms (JAX's and PyTorch's) and
             host reads on the eager device path: every function that
             reaches a kernel launch (:mod:`.purity`)

Every pass consumes the same :class:`~.core.ParsedFile` list, reports
through the same :class:`~.core.Diagnostic`, honors the same ``#
uigc-lint: disable=RULE`` suppression comments, and shares the one
allowlist budget file.  ``python -m uigc_tpu_torch.tools.uigc_check``
is the CLI.  The package the passes look for is a parameter
(``run_check(..., package=...)``, default ``uigc_tpu_torch``).
"""

from .core import (  # noqa: F401
    Diagnostic,
    ParsedFile,
    apply_allowlist,
    iter_py_files,
    load_allowlist,
    parse_paths,
)
from .cli import run_check, main  # noqa: F401
