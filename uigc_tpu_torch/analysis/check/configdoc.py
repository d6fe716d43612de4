"""CONFIG.md: the generated config-surface reference.

The port of ``uigc_tpu/analysis/check/configdoc.py``.  Rendered
deterministically from the surface registry so it can never drift
silently: the surface pass re-renders on every run and raises UC106
when the committed file differs.  The port's reference is
``uigc_tpu_torch/CONFIG.md``; regenerate it with::

    python -m uigc_tpu_torch.tools.uigc_check --write-config uigc_tpu_torch/

For ``uigc_tpu`` the header is the reference's own, byte for byte, so
the root ``CONFIG.md`` the reference generates checks clean here too.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_REFERENCE_HEADER = """\
# Configuration reference

<!-- GENERATED FILE — do not edit by hand.
     Rendered by `python tools/uigc_check.py --write-config uigc_tpu/ tools/`
     from the surface registry; `uigc_check --strict` fails on drift (UC106). -->

Every key is read through `uigc_tpu.config.Config` (`get`, `get_int`,
`get_bool`, `get_float`, `get_string`) and defaults live in the
`DEFAULTS` dict in `uigc_tpu/config.py`. The *read by* column names the
first module that reads the key; see GUIDE.md for the narrative
documentation of each subsystem's knobs.

| key | default | read by | doc |
| --- | --- | --- | --- |
"""

_PORT_HEADER = """\
# Configuration reference of the port (`{package}`)

<!-- GENERATED FILE — do not edit by hand.
     Rendered by `python -m {package}.tools.uigc_check --write-config {package}/`
     from the surface registry; `uigc_check --strict` fails on drift (UC106). -->

Every key is read through `{package}.config.Config` (`get`, `get_int`,
`get_bool`, `get_float`, `get_string`) and defaults live in the
`DEFAULTS` dict in `{package}/config.py`. The *read by* column names the
first module that reads the key; see GUIDE.md and README.md's port
section for the narrative documentation of each subsystem's knobs.

| key | default | read by | doc |
| --- | --- | --- | --- |
"""


def _header(package: str) -> str:
    if package == "uigc_tpu":
        return _REFERENCE_HEADER
    return _PORT_HEADER.format(package=package)


def _fmt_default(value: Any) -> str:
    if isinstance(value, str):
        return f'`"{value}"`'
    return f"`{value!r}`"


def _reader_module(sites: list, package: str) -> str:
    if not sites:
        return "—"
    first = sites[0]
    path = first.rsplit(":", 1)[0]
    # <package>/runtime/node.py -> runtime/node (the sites may carry an
    # absolute prefix when the CLI was handed absolute paths; the
    # rendered document must not depend on the spelling).
    path = path.replace(os.sep, "/")
    marker = f"{package}/"
    idx = path.rfind(marker)
    if idx >= 0:
        path = path[idx + len(marker):]
    if path.endswith(".py"):
        path = path[: -len(".py")]
    extra = len(sites) - 1
    return f"`{path}`" + (f" (+{extra})" if extra else "")


def _escape(text: str) -> str:
    return text.replace("|", "\\|")


def render_config_md(registry: Dict[str, Any], package: str = "uigc_tpu_torch") -> str:
    rows = []
    for key in sorted(registry.get("config", {})):
        info = registry["config"][key]
        if not info.get("in_defaults"):
            continue  # typo-class keys are diagnostics, not documentation
        doc = info.get("doc") or ""
        rows.append(
            "| `{key}` | {default} | {reader} | {doc} |".format(
                key=key,
                default=_fmt_default(info.get("default")),
                reader=_reader_module(info.get("readers", []), package),
                doc=_escape(doc),
            )
        )
    return _header(package) + "\n".join(rows) + "\n"
