"""uigc-check CLI: one parse, four passes, one verdict.

The port of ``uigc_tpu/analysis/check/cli.py``.  Usage (from the
repository root, through the ``uigc_tpu_torch.tools.uigc_check`` shim)::

    python -m uigc_tpu_torch.tools.uigc_check uigc_tpu_torch/            # advisory
    python -m uigc_tpu_torch.tools.uigc_check --strict uigc_tpu_torch/   # CI gate
    python -m uigc_tpu_torch.tools.uigc_check --rules 'UL*' uigc_tpu_torch/
    python -m uigc_tpu_torch.tools.uigc_check --json --registry-out registry.json ...
    python -m uigc_tpu_torch.tools.uigc_check --write-config uigc_tpu_torch/

:func:`run_check`'s ``package`` names the analyzed package (default
``uigc_tpu_torch``): it picks the package-scoped lint rules' directory
and the surface pass's layout (:class:`.surface.Layout`); with
``package="uigc_tpu"`` the checker gives the reference's verdicts on
the reference's tree.

Exit codes follow uigc-lint: 0 clean or advisory, 1 strict violations
beyond the allowlist budget, 2 usage error.  Passes that find nothing
to analyze (e.g. the surface pass run on a tree without ``config.py``)
report ``SKIP`` honestly instead of a vacuous ``ok``.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys
from collections import Counter
from typing import Any, Dict, List, Optional

from . import configdoc, lint_rules, locks, purity, surface
from .core import Diagnostic, apply_allowlist, load_allowlist, parse_paths

JSON_VERSION = 1

#: repo root relative to this module: uigc_tpu_torch/analysis/check/cli.py
_DEFAULT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

#: the port's allowlist of grandfathered budgets
_DEFAULT_ALLOWLIST = os.path.join(
    _DEFAULT_ROOT, "uigc_tpu_torch", "tools", "uigc_lint_allow.txt"
)

#: pass name -> the rule ids it can emit (UL000 is the parse-error rule)
PASS_RULES: Dict[str, List[str]] = {
    "lint": ["UL000"] + sorted(lint_rules.RULES),
    "surface": sorted(surface.RULES),
    "locks": sorted(locks.RULES),
    "purity": sorted(purity.RULES),
}

ALL_RULES: Dict[str, str] = {}
ALL_RULES.update(lint_rules.RULES)
ALL_RULES.update(surface.RULES)
ALL_RULES.update(locks.RULES)
ALL_RULES.update(purity.RULES)


def _wanted_rules(patterns: Optional[List[str]]) -> Optional[set]:
    """Expand glob patterns (``UL*``, ``UC2*``, ``UC104``) against the
    full rule universe.  None means everything."""
    if not patterns:
        return None
    universe = set(ALL_RULES) | {"UL000"}
    out = set()
    for pattern in patterns:
        pattern = pattern.strip().upper()
        if not pattern:
            continue
        out.update(r for r in universe if fnmatch.fnmatch(r, pattern))
    return out


def _pass_enabled(name: str, wanted: Optional[set]) -> bool:
    if wanted is None:
        return True
    return any(rule in wanted for rule in PASS_RULES[name])


def run_check(
    paths: List[str],
    rules: Optional[List[str]] = None,
    allowlist_path: Optional[str] = None,
    repo_root: Optional[str] = None,
    registry_out: Optional[str] = None,
    write_config: bool = False,
    lint_asserts: bool = True,
    package: str = lint_rules.PACKAGE,
) -> Dict[str, Any]:
    """Run the selected passes; returns the structured result the CLI
    and the tests both consume."""
    root = repo_root or _DEFAULT_ROOT
    wanted = _wanted_rules(rules)
    files, parse_errors = parse_paths(paths)
    layout = surface.Layout(package)
    texts = surface.RepoTexts(root, layout)

    diagnostics: List[Diagnostic] = []
    passes: Dict[str, Dict[str, Any]] = {}
    registry: Optional[Dict[str, Any]] = None

    # ---- lint pass -------------------------------------------------- #
    if _pass_enabled("lint", wanted):
        lint_diags = list(parse_errors) + lint_rules.run_lint(
            files, lint_asserts=lint_asserts, package=package
        )
        diagnostics.extend(lint_diags)
        passes["lint"] = {
            "status": "ok" if files else "skip",
            "findings": len(lint_diags),
        }

    # ---- surface pass ----------------------------------------------- #
    if _pass_enabled("surface", wanted):
        surf_diags, registry, plane_status = surface.run_surface(files, texts)
        diagnostics.extend(surf_diags)
        status = (
            "ok"
            if any(s == "ok" for s in plane_status.values())
            else "skip"
        )
        passes["surface"] = {
            "status": status,
            "planes": plane_status,
            "findings": len(surf_diags),
        }

    # ---- lock pass -------------------------------------------------- #
    if _pass_enabled("locks", wanted):
        lock_diags, lock_summary = locks.run_locks(files)
        diagnostics.extend(lock_diags)
        passes["locks"] = {
            "status": "ok" if lock_summary["locks"] else "skip",
            "findings": len(lock_diags),
            "locks": len(lock_summary["locks"]),
            "edges": len(lock_summary["edges"]),
        }
        if registry is not None:
            registry["locks"] = lock_summary

    # ---- purity pass ------------------------------------------------ #
    if _pass_enabled("purity", wanted):
        pure_diags, pure_summary = purity.run_purity(files)
        diagnostics.extend(pure_diags)
        passes["purity"] = {
            "status": "ok" if pure_summary["entries"] else "skip",
            "findings": len(pure_diags),
            "entries": len(pure_summary["entries"]),
            "reachable": pure_summary["reachable"],
            "eager": pure_summary["eager"],
        }
        if registry is not None:
            registry["purity"] = pure_summary

    # ---- write-backs ------------------------------------------------ #
    if write_config and registry is not None:
        config_path = os.path.join(root, layout.config_md)
        with open(config_path, "w", encoding="utf-8") as fh:
            fh.write(configdoc.render_config_md(registry, package))
        # The file is current now; the drift finding no longer applies.
        diagnostics = [d for d in diagnostics if d.rule != "UC106"]
    if registry_out and registry is not None:
        with open(registry_out, "w", encoding="utf-8") as fh:
            json.dump(registry, fh, indent=2, sort_keys=True)
            fh.write("\n")

    # ---- rule filter + allowlist ------------------------------------ #
    if wanted is not None:
        diagnostics = [d for d in diagnostics if d.rule in wanted]
    diagnostics.sort(key=lambda d: (d.path, d.line, d.rule, d.message))
    budget = load_allowlist(allowlist_path)
    grandfathered, fresh = apply_allowlist(diagnostics, budget)

    return {
        "files": len(files),
        "passes": passes,
        "diagnostics": diagnostics,
        "grandfathered": grandfathered,
        "fresh": fresh,
        "registry": registry,
    }


def _to_json(result: Dict[str, Any], strict: bool) -> Dict[str, Any]:
    counts = Counter(d.rule for d in result["fresh"])
    return {
        "version": JSON_VERSION,
        "strict": strict,
        "files": result["files"],
        "passes": result["passes"],
        "counts": dict(sorted(counts.items())),
        "fresh": [d.to_json() for d in result["fresh"]],
        "grandfathered": len(result["grandfathered"]),
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="uigc-check", description=__doc__.splitlines()[0]
    )
    parser.add_argument("paths", nargs="+", help="files or directories")
    parser.add_argument(
        "--strict",
        action="store_true",
        help="exit nonzero on findings beyond the allowlist budget",
    )
    parser.add_argument(
        "--rules",
        default="",
        help="comma-separated rule ids or globs (UL*, UC1*, UC104); "
        "default: all passes",
    )
    parser.add_argument(
        "--allowlist",
        default=_DEFAULT_ALLOWLIST,
        help="path:RULE:count budget file (default: "
        "uigc_tpu_torch/tools/uigc_lint_allow.txt)",
    )
    parser.add_argument(
        "--no-allowlist", action="store_true", help="ignore the allowlist"
    )
    parser.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="machine-readable result on stdout (bench_check-style)",
    )
    parser.add_argument(
        "--registry-out",
        default=None,
        help="write the surface registry document to this path",
    )
    parser.add_argument(
        "--write-config",
        action="store_true",
        help="regenerate the package's CONFIG.md from the surface registry",
    )

    parser.add_argument(
        "--repo-root",
        default=None,
        help="repository root for GUIDE.md/README.md/CONFIG.md/tests cross-refs "
        "(default: inferred from the package location)",
    )
    args = parser.parse_args(argv)

    rules = [p for p in args.rules.split(",") if p.strip()] or None
    result = run_check(
        args.paths,
        rules=rules,
        allowlist_path=None if args.no_allowlist else args.allowlist,
        repo_root=args.repo_root,
        registry_out=args.registry_out,
        write_config=args.write_config,
    )

    if args.as_json:
        print(json.dumps(_to_json(result, args.strict), indent=2, sort_keys=True))
    else:
        for diag in result["fresh"]:
            print(diag.render())
        skipped = [
            name
            for name, info in result["passes"].items()
            if info["status"] == "skip"
        ]
        summary = ", ".join(
            f"{name}: {info['findings']} finding(s)"
            if info["status"] == "ok"
            else f"{name}: SKIP"
            for name, info in result["passes"].items()
        )
        print(
            f"uigc-check: {result['files']} file(s); {summary}",
            file=sys.stderr,
        )
        if skipped:
            print(
                "uigc-check: SKIP means the pass found nothing to "
                f"analyze in the given paths ({', '.join(skipped)})",
                file=sys.stderr,
            )
        if result["grandfathered"]:
            print(
                f"uigc-check: {len(result['grandfathered'])} grandfathered "
                "finding(s) suppressed by allowlist",
                file=sys.stderr,
            )
        if result["fresh"]:
            print(
                f"uigc-check: {len(result['fresh'])} new finding(s)",
                file=sys.stderr,
            )
    if result["fresh"] and args.strict:
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
