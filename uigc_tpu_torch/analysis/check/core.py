"""Shared single-parse framework for the uigc-check passes.

A copy of ``uigc_tpu/analysis/check/core.py``; only the texts that
name the linter's path changed.

Every analyzer pass (lint rules, surface registry, lock graph, trace
purity) consumes the same :class:`ParsedFile` objects — the tree is
``ast.parse``'d exactly once per file per run, and the per-file comment
planes (suppressions, ``# readback:`` / ``# unbounded:`` annotations)
are extracted once alongside it.

Also home to the structured :class:`Diagnostic` and the allowlist
budget machinery, whose semantics are bit-compatible with the original
uigc-lint: ``path:RULE:count`` budget lines, suffix-path matching,
``--strict`` failing only beyond the budget.
"""

from __future__ import annotations

import ast
import os
import re
import sys
import tokenize
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Set, Tuple

_SUPPRESS = re.compile(r"#\s*uigc-lint:\s*disable=([A-Za-z0-9,\s]+)")


class Diagnostic:
    """One structured finding: ``path:line: RULE message``."""

    __slots__ = ("path", "line", "rule", "message")

    def __init__(self, path: str, line: int, rule: str, message: str):
        self.path = path
        self.line = line
        self.rule = rule
        self.message = message

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> Dict[str, object]:
        return {
            "path": self.path.replace(os.sep, "/"),
            "line": self.line,
            "rule": self.rule,
            "message": self.message,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Diagnostic({self.render()!r})"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Diagnostic):
            return NotImplemented
        return (
            self.path == other.path
            and self.line == other.line
            and self.rule == other.rule
            and self.message == other.message
        )

    def __hash__(self) -> int:
        return hash((self.path, self.line, self.rule, self.message))


def _suppressed_lines(source: str) -> Dict[int, Set[str]]:
    """Map line -> set of rule codes disabled on that line."""
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(iter(source.splitlines(True)).__next__)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                match = _SUPPRESS.search(tok.string)
                if match:
                    codes = {
                        c.strip().upper()
                        for c in match.group(1).split(",")
                        if c.strip()
                    }
                    out[tok.start[0]] = codes
    except (tokenize.TokenError, IndentationError):
        pass
    return out


class ParsedFile:
    """One analyzed file: source, AST and the comment planes, parsed once."""

    __slots__ = (
        "path",
        "norm",
        "parts",
        "source",
        "lines",
        "tree",
        "suppressed",
        "readback_lines",
        "unbounded_lines",
        "in_tests",
    )

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.norm = path.replace(os.sep, "/")
        self.parts = path.split(os.sep)
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.suppressed = _suppressed_lines(source)
        self.readback_lines = {
            i + 1 for i, line in enumerate(self.lines) if "# readback:" in line
        }
        self.unbounded_lines = {
            i + 1 for i, line in enumerate(self.lines) if "# unbounded:" in line
        }
        self.in_tests = "tests" in self.parts

    def suppressed_on(self, line: int, rule: str) -> bool:
        codes = self.suppressed.get(line, ())
        return rule in codes or "ALL" in codes

    def endswith(self, *suffixes: str) -> bool:
        return self.norm.endswith(suffixes)


class Reporter:
    """Diagnostic sink that applies per-line suppression comments."""

    def __init__(self) -> None:
        self.diagnostics: List[Diagnostic] = []

    def add(self, pf: ParsedFile, line: int, rule: str, message: str) -> None:
        if pf.suppressed_on(line, rule):
            return
        self.diagnostics.append(Diagnostic(pf.path, line, rule, message))

    def add_raw(self, path: str, line: int, rule: str, message: str) -> None:
        self.diagnostics.append(Diagnostic(path, line, rule, message))


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out = []
    for path in paths:
        if os.path.isfile(path) and path.endswith(".py"):
            out.append(path)
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = [
                    d for d in dirs if not d.startswith((".", "__pycache__"))
                ]
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
    return sorted(out)


def parse_paths(
    paths: Iterable[str],
) -> Tuple[List[ParsedFile], List[Diagnostic]]:
    """Parse every .py file under ``paths`` once.  Unparseable files
    become UL000 diagnostics, exactly as uigc-lint reported them."""
    files: List[ParsedFile] = []
    errors: List[Diagnostic] = []
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, UnicodeDecodeError) as exc:
            errors.append(Diagnostic(path, 1, "UL000", f"unparseable: {exc}"))
            continue
        files.append(ParsedFile(path, source, tree))
    return files, errors


# ------------------------------------------------------------------- #
# Allowlist budgets (bit-compatible with the reference's uigc-lint)
# ------------------------------------------------------------------- #


def load_allowlist(path: Optional[str]) -> Dict[Tuple[str, str], int]:
    budget: Dict[Tuple[str, str], int] = {}
    if path is None or not os.path.exists(path):
        return budget
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            try:
                file_part, rule, count = line.rsplit(":", 2)
                budget[(file_part, rule.upper())] = int(count)
            except ValueError:
                print(
                    f"uigc-lint: bad allowlist line: {line!r}", file=sys.stderr
                )
    return budget


def apply_allowlist(
    violations: List[Diagnostic], budget: Dict[Tuple[str, str], int]
) -> Tuple[List[Diagnostic], List[Diagnostic]]:
    """Split diagnostics into (grandfathered, new) against per-file
    per-rule budgets.  Budget paths match exactly or as a path suffix,
    so relative allowlist entries cover absolute invocations."""

    def budget_key(path: str, rule: str) -> Optional[Tuple[str, str]]:
        path = path.replace(os.sep, "/")
        if (path, rule) in budget:
            return (path, rule)
        for (allowed, allowed_rule) in budget:
            if allowed_rule == rule and path.endswith("/" + allowed):
                return (allowed, allowed_rule)
        return None

    counts: Dict[Tuple[str, str], int] = defaultdict(int)
    grandfathered: List[Diagnostic] = []
    fresh: List[Diagnostic] = []
    for v in violations:
        key = budget_key(v.path, v.rule)
        if key is None:
            fresh.append(v)
            continue
        counts[key] += 1
        if counts[key] <= budget[key]:
            grandfathered.append(v)
        else:
            fresh.append(v)
    return grandfathered, fresh


# ------------------------------------------------------------------- #
# Small AST helpers shared by the passes
# ------------------------------------------------------------------- #


def call_name(node: ast.Call) -> Tuple[Optional[str], str]:
    """(qualifier, name) of a call: foo.bar(...) -> ("foo", "bar")."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        base = fn.value
        if isinstance(base, ast.Name):
            return base.id, fn.attr
        return None, fn.attr
    if isinstance(fn, ast.Name):
        return None, fn.id
    return None, ""


def dotted_name(node: ast.AST) -> Optional[str]:
    """Render a Name/Attribute chain as ``a.b.c``; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
