"""The import guard: the benchmark measures the PyTorch and CUDA port only.

Two checks, each comparing the top-level name of a module (the part
before the first dot) as a whole, so ``uigc_tpu_torch`` is not taken for
``uigc_tpu``:

- :func:`loaded_forbidden`: after a run, ``sys.modules`` holds no JAX and
  nothing of the JAX package;
- :func:`source_findings`: over the AST of every file of the benchmark, no
  import of those, and nothing of the program under ``reference/``.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List

#: top-level modules no process of the benchmark may load
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "uigc_tpu"})
#: what the plain reference may not import besides
PROGRAM = "uigc_tpu_torch"

HERE = Path(__file__).resolve().parent


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> List[str]:
    """Names in ``sys.modules`` whose top level is forbidden."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if top(m) in FORBIDDEN)


def imported_names(path: Path) -> List[str]:
    """Absolute module names a file imports (relative imports stay
    inside the benchmark and are left out)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            names.append(node.args[0].value)
    return names


def source_findings(root: Path = HERE) -> List[str]:
    """Every forbidden import in the benchmark's files, as text."""
    found = []
    for path in sorted(root.rglob("*.py")):
        in_reference = "reference" in path.relative_to(root).parts
        for name in imported_names(path):
            t = top(name)
            if t in FORBIDDEN or (in_reference and t == PROGRAM):
                found.append(f"{path.relative_to(root.parent)} imports {name}")
    return found
