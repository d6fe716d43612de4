"""uigc-check: whole-repo cross-plane static analysis — CLI shim.

The port's copy of ``tools/uigc_check.py``.  The analyzer lives in
``uigc_tpu_torch/analysis/check/`` (shared single parse; lint +
surface-registry + lock-graph + trace-purity passes); this module only
dispatches.  From the repository root::

    python -m uigc_tpu_torch.tools.uigc_check --strict uigc_tpu_torch/

See ``uigc_tpu_torch/analysis/check/cli.py`` for the flags.
"""

import sys

from uigc_tpu_torch.analysis.check import main

if __name__ == "__main__":
    sys.exit(main())
