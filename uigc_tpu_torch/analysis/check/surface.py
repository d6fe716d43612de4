"""Surface registry: harvest the repo's five stringly-typed planes.

The port of ``uigc_tpu/analysis/check/surface.py``.  The rules are the
reference's; what changes is where the pass reads the texts outside the
analyzed tree, which :class:`Layout` fixes per package.  For the port
(``uigc_tpu_torch``): the config plane is ``uigc_tpu_torch/config.py``,
the event bridge ``uigc_tpu_torch/telemetry``, the tools
``uigc_tpu_torch/tools``, the tests only ``tests/test_torch_*.py`` (a
test of the reference never vouches for port code), "documented" means
GUIDE.md or README.md's port section, and the generated reference is
``uigc_tpu_torch/CONFIG.md``.  For ``uigc_tpu`` the layout is the
reference's own, so the pass gives the reference's verdicts there.

The system coordinates config keys (``uigc.*`` dotted strings), event
names (``crgc.*``/``fabric.*``/``tpu.*``/``telemetry.*``), metric
names (``uigc_*``), NodeFabric frame kinds (the codec tables in
``runtime/wire.py`` + ``register_frame_handler`` sites + the inline
dispatch in ``runtime/node.py``) and schema-codec ids — and nothing
type-checks the seams: a typo'd config key silently reads a default,
an unhandled frame kind silently drops.  This pass harvests every
surface into one machine-readable registry document and runs
cross-plane rules over the seams:

UC101  config key read in code but absent from GUIDE.md's config
       documentation (no backticked mention anywhere in the guide)
UC102  config key present in ``config.py`` DEFAULTS but never read
       anywhere, or documented in GUIDE.md but not a known key —
       dead or stale configuration surface
UC103  event name committed but never consumed: not bridged into a
       metric by any telemetry module and never asserted in tests
UC104  frame-kind coverage hole: a kind that is produced (encoder or
       frame literal) with no consumer (no handler registration, no
       inline dispatch), or consumed but never produced
UC105  a ``decode_*`` wire codec with no test reference — the
       malformed-input (``-> None``) tolerance contract is unpinned
UC106  CONFIG.md drifted from the harvested config surface (stale
       generated doc; regenerate with ``uigc_check --write-config``)
UC107  metric registered but never fed: its handle is never
       inc/observe/set and no other plane references the name
UC108  config key read via a literal that is not in DEFAULTS — the
       typo class (the read raises KeyError at runtime, or silently
       diverges from the documented surface when a local default is
       supplied)
UC401  a pickle-class deserializer (pickle/marshal/wire.decode_message)
       reachable from the ingress gateway's client-input entry points —
       untrusted client bytes must only ever meet the closed client
       value codec (runtime/schema.py), never a code-loading decoder

The registry document (``--registry-out``) is versioned and
shape-stable; ``tests/test_check.py`` pins the schema.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Any, Dict, List, Optional, Set, Tuple

from .core import (
    Diagnostic,
    ParsedFile,
    call_name,
    const_str,
    dotted_name,
)

RULES = {
    "UC101": "config key read but undocumented in GUIDE.md",
    "UC102": "config key defaulted/documented but never read (dead surface)",
    "UC103": "event committed but never bridged to a metric nor "
    "asserted in tests",
    "UC104": "frame kind with a producer but no consumer (or consumer "
    "with no producer)",
    "UC105": "wire decoder without a malformed-input tolerance test",
    "UC106": "CONFIG.md drifted from the harvested config surface",
    "UC107": "metric registered but never updated, sampled, nor referenced",
    "UC108": "config key read but absent from config DEFAULTS (typo class)",
    "UC401": "unsafe deserializer reachable from gateway client-input paths",
}

REGISTRY_VERSION = 1

#: the heading of README.md's section on the port
_PORT_SECTION = "## The PyTorch/CUDA port"


class Layout:
    """Where the surface pass finds one package's texts, relative to the
    repository root."""

    def __init__(self, package: str):
        self.package = package
        reference = package == "uigc_tpu"
        self.config_suffix = f"{package}/config.py"
        self.telemetry_dir = os.path.join(package, "telemetry")
        self.tools_dir = "tools" if reference else os.path.join(package, "tools")
        #: test files that count as a reference (None: the whole tree)
        self.tests_pattern = None if reference else "test_torch_*.py"
        self.config_md = "CONFIG.md" if reference else f"{package}/CONFIG.md"
        #: README.md section that documents config keys beside GUIDE.md
        self.readme_section = None if reference else _PORT_SECTION
        self.guide_label = (
            "GUIDE.md" if reference else "GUIDE.md or README.md's port section"
        )

_CONFIG_GETTERS = {"get", "get_int", "get_bool", "get_string", "get_float"}
_METRIC_REGISTRARS = {"counter", "gauge", "histogram"}
_METRIC_UPDATES = ("inc", "observe", "set", "labels", "add")
_FRAME_SUBSCRIPT_ROOTS = {"frame", "inner", "unit", "job"}


def _site(pf: ParsedFile, line: int) -> str:
    return f"{pf.norm}:{line}"


class Harvest:
    """Mutable accumulator for the five planes."""

    def __init__(self) -> None:
        # config
        self.defaults: Dict[str, Any] = {}
        self.default_docs: Dict[str, str] = {}
        self.default_lines: Dict[str, int] = {}
        self.config_reads: Dict[str, List[str]] = {}
        self.config_pf: Optional[ParsedFile] = None
        # events
        self.event_consts: Dict[str, str] = {}  # CONST -> name
        self.event_names: Dict[str, str] = {}  # name -> CONST
        self.event_lines: Dict[str, int] = {}
        self.event_commits: Dict[str, List[str]] = {}
        self.events_pf: Optional[ParsedFile] = None
        # metrics
        self.metrics: Dict[str, Dict[str, Any]] = {}
        self.metrics_seen: bool = False
        # frames
        self.frame_consts: Dict[str, str] = {}  # CONST/tuple name -> kind(s)
        self.kind_constants: Dict[str, List[str]] = {}  # kind -> const names
        self.kind_tuples: Dict[str, Tuple[str, ...]] = {}  # tuple const -> kinds
        self.encoders: Dict[str, List[str]] = {}  # kind -> encoder sites
        self.decoders: Dict[str, str] = {}  # decoder fn name -> site
        self.handlers: Dict[str, List[str]] = {}  # kind -> handler sites
        self.dispatch: Dict[str, List[str]] = {}  # kind -> inline dispatch sites
        self.producers: Dict[str, List[str]] = {}  # kind -> tuple-literal sites
        self.caps: Dict[str, List[str]] = {}  # capability -> sites
        self.wire_pf: Optional[ParsedFile] = None
        # schemas
        self.schema_ids: Dict[str, Dict[str, Any]] = {}
        self.schema_pf: Optional[ParsedFile] = None


# ------------------------------------------------------------------- #
# Per-plane harvesters
# ------------------------------------------------------------------- #


def _harvest_defaults(pf: ParsedFile, h: Harvest) -> None:
    """The DEFAULTS dict in uigc_tpu/config.py, with the contiguous
    comment block above each key as its documentation."""
    h.config_pf = pf
    for node in pf.tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):  # DEFAULTS: Dict[str, Any] = {...}
            targets = [node.target]
        else:
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "DEFAULTS" for t in targets
        ):
            continue
        if not isinstance(node.value, ast.Dict):
            continue
        for key_node, val_node in zip(node.value.keys, node.value.values):
            key = const_str(key_node)
            if key is None:
                continue
            try:
                value = ast.literal_eval(val_node)
            except (ValueError, SyntaxError):
                value = ast.get_source_segment(pf.source, val_node)
            h.defaults[key] = value
            h.default_lines[key] = key_node.lineno
            # Doc: contiguous '#' lines immediately above the key.
            doc_lines: List[str] = []
            i = key_node.lineno - 2  # 0-based line above
            while i >= 0:
                stripped = pf.lines[i].strip()
                if stripped.startswith("#"):
                    text = stripped.lstrip("# ").rstrip()
                    # Section banners ("--- Durability plane ... ---",
                    # possibly wrapped) delimit groups, not keys:
                    # stop, don't absorb.
                    if text.startswith("---") or text.endswith("---"):
                        break
                    doc_lines.append(text)
                    i -= 1
                else:
                    break
            doc_lines.reverse()
            doc = " ".join(doc_lines).strip()
            # One-line doc: cut at the first sentence end or the
            # reference parenthetical, whichever comes first.
            doc = re.sub(r"\s*\(reference:.*$", "", doc)
            if ". " in doc:
                doc = doc.split(". ")[0] + "."
            h.default_docs[key] = doc


def _harvest_config_reads(pf: ParsedFile, h: Harvest) -> None:
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute) or fn.attr not in _CONFIG_GETTERS:
            continue
        if not node.args:
            continue
        key = const_str(node.args[0])
        if key is None or not key.startswith("uigc."):
            continue
        h.config_reads.setdefault(key, []).append(_site(pf, node.lineno))


def _harvest_events(pf: ParsedFile, h: Harvest) -> None:
    """Module-level NAME = "category.event" constants in utils/events.py."""
    h.events_pf = pf
    for node in pf.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        value = const_str(node.value)
        if value is None or "." not in value:
            continue
        for target in node.targets:
            if isinstance(target, ast.Name) and target.id.isupper():
                h.event_consts[target.id] = value
                h.event_names[value] = target.id
                h.event_lines[value] = node.lineno


def _harvest_event_commits(pf: ParsedFile, h: Harvest) -> None:
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute) or fn.attr != "commit":
            continue
        if not node.args:
            continue
        first = node.args[0]
        name: Optional[str] = None
        lit = const_str(first)
        if lit is not None and "." in lit:
            name = lit
        elif isinstance(first, ast.Attribute):
            name = h.event_consts.get(first.attr)
        elif isinstance(first, ast.Name):
            name = h.event_consts.get(first.id)
        if name is not None:
            h.event_commits.setdefault(name, []).append(_site(pf, node.lineno))


def _harvest_metrics(pf: ParsedFile, h: Harvest, parents: Dict[int, ast.AST]) -> None:
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute) or fn.attr not in _METRIC_REGISTRARS:
            continue
        if not node.args:
            continue
        name = const_str(node.args[0])
        if name is None:
            continue
        h.metrics_seen = True
        entry = h.metrics.setdefault(
            name,
            {
                "kind": fn.attr,
                "sites": [],
                "callback": False,
                "handles": [],
            },
        )
        entry["sites"].append(_site(pf, node.lineno))
        if any(kw.arg == "fn" for kw in node.keywords):
            entry["callback"] = True
        # The binding the registration result lands in, for the
        # updated-handle check: self._x = r.counter(...) / x = ...
        parent = parents.get(id(node))
        if isinstance(parent, ast.Assign):
            for target in parent.targets:
                if isinstance(target, ast.Attribute):
                    entry["handles"].append((pf.norm, f".{target.attr}."))
                elif isinstance(target, ast.Name):
                    entry["handles"].append((pf.norm, f"{target.id}."))


def _harvest_wire(pf: ParsedFile, h: Harvest) -> None:
    """Frame-kind constants, encoder return tuples and decoder functions
    in runtime/wire.py — the codec table."""
    h.wire_pf = pf
    for node in pf.tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if not isinstance(target, ast.Name):
                    continue
                if target.id.endswith("_FRAME_KIND"):
                    kind = const_str(node.value)
                    if kind is not None:
                        h.kind_constants.setdefault(kind, []).append(target.id)
                        h.frame_consts[target.id] = kind
                elif target.id.endswith("_FRAME_KINDS"):
                    try:
                        kinds = ast.literal_eval(node.value)
                    except (ValueError, SyntaxError):
                        continue
                    if isinstance(kinds, tuple):
                        h.kind_tuples[target.id] = kinds
                        for kind in kinds:
                            h.kind_constants.setdefault(kind, []).append(
                                target.id
                            )
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.startswith("decode_"):
                h.decoders[node.name] = _site(pf, node.lineno)
            if node.name.startswith("encode_"):
                for ret in ast.walk(node):
                    if isinstance(ret, ast.Return) and isinstance(
                        ret.value, ast.Tuple
                    ):
                        elts = ret.value.elts
                        if elts:
                            kind = const_str(elts[0])
                            if kind is not None:
                                h.encoders.setdefault(kind, []).append(
                                    f"{pf.norm}:{ret.lineno}:{node.name}"
                                )


def _harvest_handlers(pf: ParsedFile, h: Harvest) -> None:
    """register_frame_handler sites: literal kinds, wire.X constants,
    and loop variables iterating a wire kinds tuple.  Duck-typed
    aliases (``reg = getattr(fabric, "register_frame_handler", None)``)
    count as registration calls too."""
    # Loop-variable bindings: for kind in wire.SHARD_FRAME_KINDS: ...
    loop_kinds: Dict[int, Tuple[str, Tuple[str, ...]]] = {}
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            dn = dotted_name(node.iter)
            if dn is not None:
                tuple_name = dn.split(".")[-1]
                kinds = h.kind_tuples.get(tuple_name)
                if kinds is not None:
                    for call in ast.walk(node):
                        if isinstance(call, ast.Call):
                            loop_kinds[id(call)] = (node.target.id, kinds)
    aliases: Set[str] = set()
    for node in ast.walk(pf.tree):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and call_name(node.value)[1] == "getattr"
            and len(node.value.args) >= 2
            and const_str(node.value.args[1]) == "register_frame_handler"
        ):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    aliases.add(target.id)
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Call):
            continue
        qual, name = call_name(node)
        if name != "register_frame_handler" and not (
            qual is None and name in aliases
        ):
            continue
        if not node.args:
            continue
        first = node.args[0]
        kinds: List[str] = []
        lit = const_str(first)
        if lit is not None:
            kinds = [lit]
        elif isinstance(first, ast.Attribute):
            kind = h.frame_consts.get(first.attr)
            if kind is not None:
                kinds = [kind]
        elif isinstance(first, ast.Name):
            bound = loop_kinds.get(id(node))
            if bound is not None and bound[0] == first.id:
                kinds = list(bound[1])
        for kind in kinds:
            h.handlers.setdefault(kind, []).append(_site(pf, node.lineno))


def _harvest_dispatch(pf: ParsedFile, h: Harvest) -> None:
    """Inline frame dispatch: ``kind == "lit"`` / ``frame[0] == "lit"``
    comparisons — the transport's built-in receive switch.  Only the
    transport modules themselves count: elsewhere a ``kind`` variable
    belongs to another domain (inspector record kinds, timeseries
    series kinds) and would pollute the frame universe."""
    if not pf.endswith("runtime/node.py", "runtime/fabric.py", "runtime/wire.py"):
        return
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Compare):
            continue
        left = node.left
        is_kind_expr = False
        if isinstance(left, ast.Name) and left.id == "kind":
            is_kind_expr = True
        elif isinstance(left, ast.Subscript) and isinstance(
            left.value, ast.Name
        ):
            if left.value.id in _FRAME_SUBSCRIPT_ROOTS:
                sl = left.slice
                if isinstance(sl, ast.Constant) and sl.value == 0:
                    is_kind_expr = True
        if not is_kind_expr:
            continue
        for comp in node.comparators:
            lit = const_str(comp)
            if lit is not None:
                h.dispatch.setdefault(lit, []).append(_site(pf, node.lineno))


def _harvest_producers(pf: ParsedFile, h: Harvest, universe: Set[str]) -> None:
    """Tuple literals whose head is a known frame kind: the frames the
    mutator plane actually builds and sends."""
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Tuple) or not node.elts:
            continue
        kind = const_str(node.elts[0])
        if kind is not None and kind in universe:
            h.producers.setdefault(kind, []).append(_site(pf, node.lineno))


def _harvest_caps(pf: ParsedFile, h: Harvest) -> None:
    """Hello capability advertisements (caps.append) and checks
    (``"x" in st.caps``)."""
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr == "append"
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "caps"
                and node.args
            ):
                lit = const_str(node.args[0])
                label = lit if lit is not None else "<dynamic>"
                h.caps.setdefault(label, []).append(_site(pf, node.lineno))
        elif isinstance(node, ast.Compare):
            if len(node.ops) == 1 and isinstance(node.ops[0], ast.In):
                lit = const_str(node.left)
                comp = node.comparators[0]
                comp_name = dotted_name(comp) or ""
                if lit is not None and comp_name.endswith("caps"):
                    h.caps.setdefault(lit, []).append(_site(pf, node.lineno))


def _harvest_schemas(pf: ParsedFile, h: Harvest) -> None:
    h.schema_pf = pf
    for node in pf.tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if (
                    isinstance(target, ast.Name)
                    and target.id.startswith("SCHEMA_")
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, int)
                ):
                    h.schema_ids[target.id] = {
                        "id": node.value.value,
                        "line": node.lineno,
                        "constructed": [],
                    }
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Call) and call_name(node)[1] == "Schema":
            for arg in node.args:
                if isinstance(arg, ast.Name) and arg.id in h.schema_ids:
                    h.schema_ids[arg.id]["constructed"].append(
                        _site(pf, node.lineno)
                    )


def _build_parent_map(tree: ast.AST) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


# ------------------------------------------------------------------- #
# Cross-plane context: texts outside the analyzed file set
# ------------------------------------------------------------------- #


class RepoTexts:
    """Lazily read repo documents the cross-plane rules consult (the
    guide, the generated CONFIG.md, and the test tree's source text)."""

    def __init__(self, repo_root: str, layout: Optional[Layout] = None):
        self.repo_root = repo_root
        self.layout = layout or Layout("uigc_tpu_torch")
        self._cache: Dict[str, str] = {}

    def guide(self) -> str:
        """GUIDE.md, plus README.md's port section where the layout has
        one: the texts UC101/UC102 count as documentation."""
        text = self.read("GUIDE.md")
        heading = self.layout.readme_section
        if heading is None:
            return text
        readme = self.read("README.md")
        start = readme.find(heading)
        if start < 0:
            return text
        end = readme.find("\n## ", start + len(heading))
        return text + "\n" + readme[start: end if end >= 0 else len(readme)]

    def tests_text(self) -> str:
        return self.tree_text("tests", self.layout.tests_pattern)

    def read(self, rel: str) -> str:
        if rel not in self._cache:
            path = os.path.join(self.repo_root, rel)
            try:
                with open(path, encoding="utf-8") as fh:
                    self._cache[rel] = fh.read()
            except OSError:
                self._cache[rel] = ""
        return self._cache[rel]

    def tree_text(self, rel_dir: str, pattern: Optional[str] = None) -> str:
        key = rel_dir + "//" + (pattern or "")
        if key not in self._cache:
            chunks: List[str] = []
            base = os.path.join(self.repo_root, rel_dir)
            if os.path.isdir(base):
                for root, dirs, files in os.walk(base):
                    dirs[:] = [
                        d for d in dirs if not d.startswith((".", "__pycache__"))
                    ]
                    for name in sorted(files):
                        if name.endswith(".py") and (
                            pattern is None or fnmatch.fnmatch(name, pattern)
                        ):
                            try:
                                with open(
                                    os.path.join(root, name), encoding="utf-8"
                                ) as fh:
                                    chunks.append(fh.read())
                            except OSError:
                                pass
            self._cache[key] = "\n".join(chunks)
        return self._cache[key]


# ------------------------------------------------------------------- #
# The pass
# ------------------------------------------------------------------- #


def harvest(files: List[ParsedFile], layout: Optional[Layout] = None) -> Harvest:
    layout = layout or Layout("uigc_tpu_torch")
    h = Harvest()
    # Pass 1: anchor files first (constants other files refer to).
    for pf in files:
        if pf.endswith(layout.config_suffix):
            _harvest_defaults(pf, h)
        elif pf.endswith("utils/events.py"):
            _harvest_events(pf, h)
        elif pf.endswith("runtime/wire.py"):
            _harvest_wire(pf, h)
        if pf.endswith("runtime/schema.py"):
            _harvest_schemas(pf, h)
    # Pass 2: the whole tree.
    for pf in files:
        if pf.in_tests:
            continue
        _harvest_config_reads(pf, h)
        _harvest_event_commits(pf, h)
        _harvest_metrics(pf, h, _build_parent_map(pf.tree))
        _harvest_handlers(pf, h)
        _harvest_dispatch(pf, h)
        _harvest_caps(pf, h)
    universe = (
        set(h.kind_constants)
        | set(h.encoders)
        | set(h.handlers)
        | set(h.dispatch)
    )
    for pf in files:
        if not pf.in_tests:
            _harvest_producers(pf, h, universe)
    return h


def build_registry(h: Harvest, texts: RepoTexts) -> Dict[str, Any]:
    """The machine-readable surface registry document."""
    guide = texts.guide()
    tests_text = texts.tests_text()
    telemetry_text = texts.tree_text(texts.layout.telemetry_dir)
    tools_text = texts.tree_text(texts.layout.tools_dir)

    config: Dict[str, Any] = {}
    for key in sorted(set(h.defaults) | set(h.config_reads)):
        config[key] = {
            "default": h.defaults.get(key),
            "doc": h.default_docs.get(key, ""),
            "readers": sorted(h.config_reads.get(key, [])),
            "in_defaults": key in h.defaults,
            "documented_guide": f"`{key}`" in guide or f'"{key}"' in guide,
        }

    events: Dict[str, Any] = {}
    for name in sorted(set(h.event_names) | set(h.event_commits)):
        const = h.event_names.get(name, "")
        # Three spellings count as a reference: the constant, the
        # dotted literal, and the underscore form (how the name
        # resurfaces inside a metric: shard.handoff_buffered ->
        # uigc_shard_handoff_buffered).
        refs = [t for t in (const, name, name.replace(".", "_")) if t]
        bridged = any(re.search(re.escape(r), telemetry_text) for r in refs)
        tested = any(re.search(re.escape(r), tests_text) for r in refs)
        events[name] = {
            "constant": const,
            "commit_sites": sorted(h.event_commits.get(name, [])),
            "bridged": bridged,
            "tested": tested,
        }

    metrics: Dict[str, Any] = {}
    for name in sorted(h.metrics):
        entry = h.metrics[name]
        updated = entry["callback"]
        if not updated:
            for norm, handle in entry["handles"]:
                # The handle is "used" when it appears with an update
                # method anywhere beyond the registration line.
                module_text = texts.read(norm) or ""
                pat = re.escape(handle) + "(?:" + "|".join(_METRIC_UPDATES) + r")\("
                if re.search(pat, module_text):
                    updated = True
                    break
        referenced = (
            name in tests_text or name in tools_text or name in guide
        )
        metrics[name] = {
            "kind": entry["kind"],
            "sites": sorted(entry["sites"]),
            "callback": entry["callback"],
            "updated": updated,
            "referenced": referenced,
        }

    frames: Dict[str, Any] = {}
    universe = (
        set(h.kind_constants)
        | set(h.encoders)
        | set(h.handlers)
        | set(h.dispatch)
        | set(h.producers)
    )
    for kind in sorted(universe):
        frames[kind] = {
            "constants": sorted(h.kind_constants.get(kind, [])),
            "encoders": sorted(h.encoders.get(kind, [])),
            "handlers": sorted(h.handlers.get(kind, [])),
            "dispatch": sorted(h.dispatch.get(kind, [])),
            "producers": sorted(h.producers.get(kind, [])),
        }

    decoders: Dict[str, Any] = {}
    for name in sorted(h.decoders):
        decoders[name] = {
            "site": h.decoders[name],
            "tested": name in tests_text,
        }

    schemas: Dict[str, Any] = {
        name: dict(h.schema_ids[name]) for name in sorted(h.schema_ids)
    }

    caps: Dict[str, Any] = {c: sorted(s) for c, s in sorted(h.caps.items())}

    return {
        "version": REGISTRY_VERSION,
        "config": config,
        "events": events,
        "metrics": metrics,
        "frames": frames,
        "decoders": decoders,
        "schemas": schemas,
        "caps": caps,
    }


def _diag_for(
    files: List[ParsedFile], norm_site: str
) -> Tuple[Optional[ParsedFile], int]:
    """Resolve a ``path:line`` harvest site back to its ParsedFile so
    suppression comments apply."""
    path, _, line = norm_site.rpartition(":")
    for pf in files:
        if pf.norm == path:
            try:
                return pf, int(line)
            except ValueError:
                return pf, 1
    return None, 1


def run_surface(
    files: List[ParsedFile],
    texts: RepoTexts,
    registry: Optional[Dict[str, Any]] = None,
    config_md_rel: Optional[str] = None,
) -> Tuple[List[Diagnostic], Dict[str, Any], Dict[str, str]]:
    """Harvest + rules.  Returns (diagnostics, registry, plane_status)
    where plane_status maps plane name -> "ok" | "skip"."""
    from . import configdoc

    layout = texts.layout
    if config_md_rel is None:
        config_md_rel = layout.config_md
    h = harvest(files, layout)
    if registry is None:
        registry = build_registry(h, texts)
    out: List[Diagnostic] = []

    def add(site: str, rule: str, message: str) -> None:
        pf, line = _diag_for(files, site)
        if pf is not None:
            if pf.suppressed_on(line, rule):
                return
            out.append(Diagnostic(pf.path, line, rule, message))
        else:
            path, _, lineno = site.rpartition(":")
            try:
                out.append(Diagnostic(path, int(lineno), rule, message))
            except ValueError:
                out.append(Diagnostic(site, 1, rule, message))

    status: Dict[str, str] = {
        "config": "ok" if h.config_pf is not None else "skip",
        "events": "ok" if h.events_pf is not None else "skip",
        "metrics": "ok" if h.metrics_seen else "skip",
        "frames": "ok" if h.wire_pf is not None else "skip",
        "schemas": "ok" if h.schema_pf is not None else "skip",
    }

    # ---- config plane ---------------------------------------------- #
    if h.config_pf is not None:
        config_pf = h.config_pf
        for key, info in registry["config"].items():
            readers = info["readers"]
            if readers and not info["in_defaults"]:
                add(
                    readers[0],
                    "UC108",
                    f"config key {key!r} read here is not in config.py "
                    "DEFAULTS — a typo'd key raises KeyError (or silently "
                    "diverges from the documented surface)",
                )
            if readers and info["in_defaults"] and not info["documented_guide"]:
                add(
                    f"{config_pf.norm}:{h.default_lines.get(key, 1)}",
                    "UC101",
                    f"config key {key!r} is read "
                    f"({len(readers)} site(s), first {readers[0]}) but "
                    f"{layout.guide_label} never documents it",
                )
            if info["in_defaults"] and not readers:
                add(
                    f"{config_pf.norm}:{h.default_lines.get(key, 1)}",
                    "UC102",
                    f"config key {key!r} has a default but no reader "
                    "anywhere in the analyzed tree — dead surface",
                )
        # GUIDE-documented keys that are not known config surface.
        guide = texts.guide()
        known = set(registry["config"])
        for m in sorted(set(re.findall(r"`(uigc\.[a-z0-9.-]+)`", guide))):
            if m not in known:
                add(
                    f"{config_pf.norm}:1",
                    "UC102",
                    f"{layout.guide_label} documents config key {m!r} which "
                    "is not in "
                    "DEFAULTS and never read — stale doc or doc typo",
                )
        # CONFIG.md drift.
        expected = configdoc.render_config_md(registry, layout.package)
        actual = texts.read(config_md_rel)
        if actual != expected:
            add(
                f"{config_pf.norm}:1",
                "UC106",
                f"{config_md_rel} is out of date with the config surface; "
                "regenerate with 'uigc_check --write-config'",
            )

    # ---- event plane ----------------------------------------------- #
    if h.events_pf is not None:
        for name, info in registry["events"].items():
            if not info["commit_sites"]:
                continue
            if not info["bridged"] and not info["tested"]:
                add(
                    info["commit_sites"][0],
                    "UC103",
                    f"event {name!r} is committed but no telemetry module "
                    "bridges it to a metric and no test asserts it — "
                    "an observability dead end",
                )

    # ---- metric plane ---------------------------------------------- #
    if h.metrics_seen:
        for name, info in registry["metrics"].items():
            if info["callback"] or info["updated"] or info["referenced"]:
                continue
            add(
                info["sites"][0],
                "UC107",
                f"metric {name!r} is registered but its handle is never "
                "inc/observe/set and nothing references the name — it "
                "scrapes as a permanently-zero series",
            )

    # ---- frame plane ------------------------------------------------ #
    if h.wire_pf is not None:
        for kind, info in registry["frames"].items():
            produced = info["encoders"] or info["producers"]
            consumed = info["handlers"] or info["dispatch"]
            if produced and not consumed:
                site = (info["encoders"] or info["producers"])[0]
                site = ":".join(site.split(":")[:2])
                add(
                    site,
                    "UC104",
                    f"frame kind {kind!r} has a producer but no receiver "
                    "(no register_frame_handler site, no inline dispatch) — "
                    "it silently drops at every peer",
                )
            elif consumed and not produced:
                site = (info["handlers"] or info["dispatch"])[0]
                add(
                    site,
                    "UC104",
                    f"frame kind {kind!r} is handled but nothing in the "
                    "tree ever produces it — dead dispatch arm or a "
                    "missing encoder",
                )
        for name, info in registry["decoders"].items():
            if not info["tested"]:
                add(
                    info["site"],
                    "UC105",
                    f"wire decoder {name}() has no test reference — its "
                    "malformed-input (-> None) tolerance contract is "
                    "unpinned",
                )

    # ---- gateway client-input plane --------------------------------- #
    # UC401: unsafe deserializers reachable from the gateway's
    # client-input entry points.  Entry points are every function in
    # the client protocol module (gateway/protocol.py parses raw socket
    # bytes) plus any gateway function named client_*/_client_* (the
    # helpers that touch pre-auth input).  Reachability is a transitive
    # closure over callee NAMES — a deliberate over-approximation: a
    # false edge costs one review, a missed edge ships pickle.loads on
    # attacker bytes.  wire.decode_message counts as a sink here too:
    # it is the trusted NODE-plane codec (pickle under a persistent-id
    # allowlist) and must never see client bytes.
    gateway_files = [
        pf
        for pf in files
        if not pf.in_tests
        and "/gateway/" in "/" + pf.norm.replace("\\", "/")
    ]
    if gateway_files:
        gw_defs: Dict[str, List[Tuple[ParsedFile, ast.AST]]] = {}
        for pf in gateway_files:
            for node in ast.walk(pf.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    gw_defs.setdefault(node.name, []).append((pf, node))
        entries: Set[str] = set()
        for fn_name, sites in gw_defs.items():
            if fn_name.startswith(("client_", "_client_")):
                entries.add(fn_name)
            for pf, _node in sites:
                if pf.endswith("gateway/protocol.py"):
                    entries.add(fn_name)
        gw_calls: Dict[str, Set[str]] = {}
        gw_sinks: Dict[str, List[Tuple[str, str]]] = {}
        for fn_name, sites in gw_defs.items():
            for pf, fnode in sites:
                for call in ast.walk(fnode):
                    if not isinstance(call, ast.Call):
                        continue
                    qual, cname = call_name(call)
                    if not cname:
                        continue
                    if cname in gw_defs:
                        gw_calls.setdefault(fn_name, set()).add(cname)
                    unsafe = (
                        (qual == "pickle" and cname in ("loads", "load", "Unpickler"))
                        or (qual == "marshal" and cname in ("loads", "load"))
                        or cname == "decode_message"
                    )
                    if unsafe:
                        label = f"{qual}.{cname}" if qual else cname
                        gw_sinks.setdefault(fn_name, []).append(
                            (_site(pf, call.lineno), label)
                        )
        reached: Set[str] = set()
        frontier = sorted(entries)
        while frontier:
            fn_name = frontier.pop()
            if fn_name in reached:
                continue
            reached.add(fn_name)
            frontier.extend(gw_calls.get(fn_name, ()))
        for fn_name in sorted(reached):
            for sink_site, sink in gw_sinks.get(fn_name, []):
                add(
                    sink_site,
                    "UC401",
                    f"{sink}() is reachable from gateway client-input "
                    f"entry points (via {fn_name}) — untrusted client "
                    "bytes must only meet the closed client value codec "
                    "(runtime/schema.py), never a code-loading "
                    "deserializer",
                )

    return out, registry, status
