"""Trace-purity pass, for an eager port and for traced forms.

The port of ``uigc_tpu/analysis/check/purity.py``.  The reference's
device path is traced: ``jax.jit`` / Pallas / ``shard_map`` entry
points, whose reachable functions run once at trace time.  The port
traces nothing: its device path is eager Python that launches
hand-written kernels, so the pass knows two kinds of device function.

*Traced* functions are reachable from a tracer entry point in ``ops/``,
``parallel/`` or ``engines/crgc/``: the reference's JAX forms
(``jax.jit``, ``pallas_call``, ``shard_map``, ``pmap``, ``checkpoint``;
decorator, ``partial`` and wrapper-call forms, kept so a JAX tree gets
the reference's verdicts) and PyTorch's (``torch.compile``,
``torch.jit.script`` / ``torch.jit.trace``,
``torch.cuda.make_graphed_callables``, and the calls made inside a
``with torch.cuda.graph(...)`` capture).  Closure over the call graph as
in the reference.

*Eager device* functions are those under ``ops/``, ``parallel/`` and
``engines/crgc/`` that reach a kernel launch through the call graph.  A
launch is a call into a native library's C interface (an ``uigc_*``
attribute of a loaded library: ``ops/propagate.py``
``propagate_words_cuda`` and the ``ctypes`` calls of
``native/graph.py``).  Reachability runs upward from the launches
through their *callers*, because an eager host read sits in the loop
that launches the kernel; call resolution here also follows imports
(``from .propagate import propagate_words``, ``from . import cuda_trace
as pt``) and closures a factory returns (``sweep =
build_sweep_contribs(...)``).

UC301  a traced-reachable function mutates Python state visible
       outside the trace (``global``/``nonlocal`` rebinding, or
       mutation of a module-level container)
UC302  a traced-reachable function calls host RNG or wall-clock time
UC303  a traced-reachable or eager-device function reads back
       off-device without a ``# readback: <why>`` annotation: the
       reference's idioms plus the torch ones of
       :func:`.lint_rules.readback_hit`; on the eager path every
       ``.tolist()`` and ``int()``/``float()``/``bool()`` of a
       subscript counts unless its operand is evidently numpy
UC304  recompile hazard: a tracer call invoked immediately or rebuilt
       in a loop, an unhashable literal at a known static position,
       or a torch tracer (``torch.compile`` ...) of a lambda built
       inside a function (a fresh callable per call: the compile
       cache never hits)

UC301/302/304 guard values that freeze into a traced program, so they
apply to traced functions only; on the eager port they fire only if a
traced form appears.
"""

from __future__ import annotations

import ast
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

from .core import Diagnostic, ParsedFile, call_name, dotted_name
from .lint_rules import chained_cpu_calls, readback_hit, tensor_scopes

RULES = {
    "UC301": "traced function mutates Python state",
    "UC302": "traced function calls host RNG or wall-clock time",
    "UC303": "traced or eager device function reads back off-device "
    "without '# readback:'",
    "UC304": "jit recompile hazard (per-call callable or unhashable static arg)",
}

_TRACERS = {"jit", "pallas_call", "shard_map", "pmap", "checkpoint"}
#: PyTorch's tracing entry points, by full dotted name (their last parts
#: — compile, script, trace — name ordinary functions too)
_TORCH_TRACERS = {
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
}
_GRAPH_CAPTURE = "torch.cuda.graph"
_DEVICE_DIRS = ("/ops/", "/parallel/", "/engines/crgc/")
_RNG_TIME = re.compile(
    r"^(random|numpy\.random|np\.random|time|datetime(\.datetime)?)\."
)
_CONTAINER_MUTATORS = {
    "append",
    "add",
    "update",
    "setdefault",
    "pop",
    "extend",
    "insert",
    "clear",
    "remove",
}
_MAX_DEPTH = 8
#: the C interface's symbol prefix (csrc/propagate.cu, native/*.cpp)
_LAUNCH_PREFIX = "uigc_"
_LIB_LOADERS = {"load_library"}


def _is_device_module(pf: ParsedFile) -> bool:
    return any(d in pf.norm for d in _DEVICE_DIRS)


def _walk_shallow(fn: ast.AST):
    """Walk a function body without descending into nested defs — those
    are separate functions with their own reachability entries."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            stack.extend(ast.iter_child_nodes(node))


def _tracer_call(node: ast.Call) -> Optional[str]:
    """'jit' / 'pallas_call' / 'torch.compile' / ... when this Call
    invokes a tracer."""
    dn = dotted_name(node.func)
    if dn is None:
        return None
    if dn in _TORCH_TRACERS:
        return dn
    last = dn.split(".")[-1]
    if last not in _TRACERS:
        return None
    # jax.jit / jit / pl.pallas_call / jax.experimental.shard_map.shard_map
    return last


def _is_torch_tracer(how: str) -> bool:
    return how.startswith("torch.")


def _launch_symbol(node: ast.AST) -> Optional[str]:
    """The C symbol when ``node`` reads one off a kernel library: the
    CUDA kernel's (``load_library().uigc_propagate_words``,
    ops/propagate.py) or a device-plane object's own native library
    (``self._lib.uigc_trace``, native/graph.py).  Helper libraries
    bound to a local (the hash maps' ``lib.uigc_map_*``) are host data
    structures, not launches."""
    if not isinstance(node, ast.Attribute) or not node.attr.startswith(
        _LAUNCH_PREFIX
    ):
        return None
    base = node.value
    if isinstance(base, ast.Call):
        if call_name(base)[1] in _LIB_LOADERS:
            return node.attr
        return None
    if (
        isinstance(base, ast.Attribute)
        and base.attr == "_lib"
        and isinstance(base.value, ast.Name)
        and base.value.id == "self"
    ):
        return node.attr
    return None


class FuncEntry:
    __slots__ = ("qual", "pf", "node", "cls")

    def __init__(
        self, qual: str, pf: ParsedFile, node: ast.AST, cls: Optional[str]
    ):
        self.qual = qual
        self.pf = pf
        self.node = node
        self.cls = cls


class PurityPass:
    def __init__(self, files: List[ParsedFile]):
        self.files = [pf for pf in files if not pf.in_tests]
        self.funcs: Dict[str, FuncEntry] = {}
        self.module_funcs: Dict[str, Dict[str, str]] = defaultdict(dict)
        self.class_methods: Dict[str, Dict[str, str]] = defaultdict(dict)
        self.method_index: Dict[str, Set[str]] = defaultdict(set)
        self.module_globals: Dict[str, Set[str]] = defaultdict(set)
        # module-level jitted names with literal static positions:
        # (module norm, name) -> set of static argument indices
        self.static_positions: Dict[Tuple[str, str], Set[int]] = {}
        self.entries: List[Tuple[str, str]] = []  # (qual, how)
        #: kernel launch sites: qual -> the C symbol it calls
        self.launches: Dict[str, str] = {}
        # import resolution (eager call graph): module norm -> alias ->
        # target module norm / name -> (target module norm, name)
        self.module_aliases: Dict[str, Dict[str, str]] = defaultdict(dict)
        self.imported: Dict[str, Dict[str, Tuple[str, str]]] = defaultdict(
            dict
        )
        #: qual -> the nested defs indexed under it
        self.nested: Dict[str, List[str]] = defaultdict(list)
        #: qual -> name -> the calls the name is bound to in its body
        self._bindings: Dict[str, Dict[str, List[ast.Call]]] = {}
        self._eager: Optional[Dict[str, Tuple[str, ...]]] = None
        self.diagnostics: List[Diagnostic] = []

    # ---- indexes ---------------------------------------------------- #

    def build(self) -> None:
        for pf in self.files:
            for node in pf.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{pf.norm}:{node.name}"
                    self.module_funcs[pf.norm][node.name] = qual
                    self.funcs[qual] = FuncEntry(qual, pf, node, None)
                    # nested defs
                    self._index_nested(pf, node, qual, None)
                elif isinstance(node, ast.ClassDef):
                    for item in node.body:
                        if isinstance(
                            item, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            qual = f"{pf.norm}:{node.name}.{item.name}"
                            self.class_methods[node.name][item.name] = qual
                            self.method_index[item.name].add(qual)
                            self.funcs[qual] = FuncEntry(
                                qual, pf, item, node.name
                            )
                            self._index_nested(pf, item, qual, node.name)
                elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for target in targets:
                        if isinstance(target, ast.Name):
                            self.module_globals[pf.norm].add(target.id)
        self._index_imports()

    def _index_nested(
        self,
        pf: ParsedFile,
        fn: ast.AST,
        parent_qual: str,
        cls: Optional[str],
    ) -> None:
        for sub in ast.walk(fn):
            if (
                isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                and sub is not fn
            ):
                qual = f"{parent_qual}.<{sub.name}>"
                if qual not in self.funcs:
                    self.funcs[qual] = FuncEntry(qual, pf, sub, cls)
                    self.nested[parent_qual].append(qual)

    def _index_imports(self) -> None:
        """``from .x import f`` / ``from . import x as m`` / ``import
        a.b as m`` resolved to analyzed modules, by path."""
        norms = {pf.norm for pf in self.files}

        def module_file(parts: List[str], base: Optional[str]) -> Optional[str]:
            rel = "/".join(parts)
            cands = (
                [f"{base}/{rel}.py", f"{base}/{rel}/__init__.py"]
                if base is not None
                else []
            )
            for cand in cands:
                cand = os.path.normpath(cand).replace(os.sep, "/")
                if cand in norms:
                    return cand
            if base is None and parts:
                for suffix in (f"/{rel}.py", f"/{rel}/__init__.py"):
                    hits = [n for n in norms if ("/" + n).endswith(suffix)]
                    if len(hits) == 1:
                        return hits[0]
            return None

        for pf in self.files:
            here = os.path.dirname(pf.norm)
            for node in ast.walk(pf.tree):
                if isinstance(node, ast.ImportFrom):
                    base: Optional[str] = None
                    if node.level:
                        base = here
                        for _ in range(node.level - 1):
                            base = os.path.dirname(base)
                    parts = node.module.split(".") if node.module else []
                    for alias in node.names:
                        name = alias.asname or alias.name
                        sub = module_file(parts + [alias.name], base)
                        if sub is not None:
                            self.module_aliases[pf.norm][name] = sub
                            continue
                        target = module_file(parts, base) if parts else None
                        if target is None and not parts and base is not None:
                            target = module_file(["__init__"], base)
                        if target is not None:
                            self.imported[pf.norm][name] = (target, alias.name)
                elif isinstance(node, ast.Import):
                    for alias in node.names:
                        if alias.asname is None:
                            continue
                        target = module_file(alias.name.split("."), None)
                        if target is not None:
                            self.module_aliases[pf.norm][alias.asname] = target

    # ---- entry-point discovery -------------------------------------- #

    def find_entries(self) -> None:
        for pf in self.files:
            if not _is_device_module(pf):
                continue
            # Decorator forms on module/class functions.
            for qual, entry in list(self.funcs.items()):
                if entry.pf is not pf:
                    continue
                node = entry.node
                for dec in getattr(node, "decorator_list", []):
                    how = self._decorator_tracer(dec)
                    if how is not None:
                        self.entries.append((qual, how))
            # Wrapper-call forms anywhere in the module.
            for node in ast.walk(pf.tree):
                if not isinstance(node, ast.Call):
                    continue
                tracer = _tracer_call(node)
                if tracer is None:
                    continue
                for target_qual in self._traced_operands(pf, node):
                    self.entries.append((target_qual, tracer))
                self._note_static_positions(pf, node)
            # CUDA-graph capture: what a `with torch.cuda.graph(g):` body
            # calls is recorded once and replayed.
            for qual, entry in list(self.funcs.items()):
                if entry.pf is not pf:
                    continue
                for node in _walk_shallow(entry.node):
                    if not isinstance(node, ast.With):
                        continue
                    if not any(
                        isinstance(item.context_expr, ast.Call)
                        and dotted_name(item.context_expr.func)
                        == _GRAPH_CAPTURE
                        for item in node.items
                    ):
                        continue
                    for stmt in node.body:
                        for call in ast.walk(stmt):
                            if isinstance(call, ast.Call):
                                callee = self._resolve_callee(entry, call)
                                if callee is not None:
                                    self.entries.append(
                                        (callee, _GRAPH_CAPTURE)
                                    )
        # Kernel launches, anywhere in the tree (native/ included).
        for qual, entry in self.funcs.items():
            for node in _walk_shallow(entry.node):
                symbol = _launch_symbol(node)
                if symbol is not None:
                    self.launches.setdefault(qual, symbol)

    def _decorator_tracer(self, dec: ast.AST) -> Optional[str]:
        dn = dotted_name(dec)
        if dn is not None:
            if dn in _TORCH_TRACERS:
                return dn
            if dn.split(".")[-1] in _TRACERS:
                return dn.split(".")[-1]
        if isinstance(dec, ast.Call):
            tracer = _tracer_call(dec)
            if tracer is not None:
                return tracer
            # @partial(jax.jit, ...) / @partial(torch.compile, ...)
            if call_name(dec)[1] == "partial" and dec.args:
                inner = dotted_name(dec.args[0])
                if inner is not None:
                    if inner in _TORCH_TRACERS:
                        return inner
                    if inner.split(".")[-1] in _TRACERS:
                        return inner.split(".")[-1]
        return None

    def _traced_operands(
        self, pf: ParsedFile, call: ast.Call
    ) -> List[str]:
        """Resolve `jax.jit(f)` / `pallas_call(kernel, ...)` operands to
        known function qualnames in the same module."""
        out: List[str] = []
        operands = list(call.args[:1])
        for kw in call.keywords:
            if kw.arg in ("fun", "f", "kernel", "model", "fn", "callables"):
                operands.append(kw.value)
        for op in operands:
            if isinstance(op, ast.Name):
                qual = self.module_funcs.get(pf.norm, {}).get(op.id)
                if qual is not None:
                    out.append(qual)
                else:
                    # nested def in the enclosing function
                    for q, entry in self.funcs.items():
                        if entry.pf is pf and q.endswith(f".<{op.id}>"):
                            out.append(q)
        return out

    def _note_static_positions(self, pf: ParsedFile, call: ast.Call) -> None:
        """Record `f = jax.jit(g, static_argnums=(1,))` so later calls
        to f can be checked for unhashable literals at static slots."""
        positions: Set[int] = set()
        for kw in call.keywords:
            if kw.arg == "static_argnums":
                try:
                    value = ast.literal_eval(kw.value)
                except (ValueError, SyntaxError):
                    continue
                if isinstance(value, int):
                    positions.add(value)
                elif isinstance(value, (tuple, list)):
                    positions.update(v for v in value if isinstance(v, int))
        if not positions:
            return
        # Find the Assign this call is the value of (module level only).
        for node in pf.tree.body:
            if isinstance(node, ast.Assign) and node.value is call:
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        self.static_positions[(pf.norm, target.id)] = positions

    # ---- reachability ----------------------------------------------- #

    def _resolve_callee(
        self, entry: FuncEntry, call: ast.Call
    ) -> Optional[str]:
        """The reference's resolution: ``f()`` in the same module (or a
        nested def of the caller), ``self.m()`` in the same class,
        ``obj.m()`` when exactly one analyzed class defines ``m``."""
        fn = call.func
        if isinstance(fn, ast.Name):
            qual = self.module_funcs.get(entry.pf.norm, {}).get(fn.id)
            if qual is not None:
                return qual
            # nested def captured by name inside the same parent
            nested = f"{entry.qual}.<{fn.id}>"
            if nested in self.funcs:
                return nested
            return None
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if (
                isinstance(base, ast.Name)
                and base.id == "self"
                and entry.cls is not None
            ):
                return self.class_methods.get(entry.cls, {}).get(fn.attr)
            candidates = self.method_index.get(fn.attr, set())
            if len(candidates) == 1:
                return next(iter(candidates))
        return None

    def _resolve_wide(self, entry: FuncEntry, call: ast.Call) -> List[str]:
        """The eager call graph's resolution: the reference's, plus
        imported functions, module aliases, and closures a factory
        returns (``sweep = build_sweep_contribs(...); sweep(...)`` calls
        the factory's nested defs)."""
        norm = entry.pf.norm
        fn = call.func
        if isinstance(fn, ast.Name):
            qual = self._resolve_callee(entry, call)
            if qual is not None:
                return [qual]
            imp = self.imported.get(norm, {}).get(fn.id)
            if imp is not None:
                target = self.module_funcs.get(imp[0], {}).get(imp[1])
                return [target] if target is not None else []
            return self._factory_closures(entry, fn.id)
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name):
                target_mod = self.module_aliases.get(norm, {}).get(base.id)
                if target_mod is not None:
                    target = self.module_funcs.get(target_mod, {}).get(fn.attr)
                    return [target] if target is not None else []
            qual = self._resolve_callee(entry, call)
            return [qual] if qual is not None else []
        return []

    def _call_bindings(self, qual: str) -> Dict[str, List[ast.Call]]:
        """name -> the calls ``name = call(...)`` binds it to in the body
        of ``qual`` (nested defs excluded)."""
        out = self._bindings.get(qual)
        if out is None:
            out = self._bindings[qual] = defaultdict(list)
            for node in _walk_shallow(self.funcs[qual].node):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            out[t.id].append(node.value)
        return out

    def _factory_closures(self, entry: FuncEntry, name: str) -> List[str]:
        """Nested defs of ``g`` when ``name`` is bound to ``g(...)`` in
        the caller or an enclosing function."""
        scope = entry.qual
        while True:
            if scope in self.funcs:
                for call in self._call_bindings(scope).get(name, ()):
                    out: List[str] = []
                    for factory in self._resolve_wide(self.funcs[scope], call):
                        out.extend(self.nested.get(factory, ()))
                    if out:
                        return out
            if ".<" not in scope:
                return []
            scope = scope.rsplit(".<", 1)[0]

    def reachable(self) -> Dict[str, Tuple[str, ...]]:
        """qual -> witness chain of quals from a traced entry point."""
        seen: Dict[str, Tuple[str, ...]] = {}
        work: List[Tuple[str, Tuple[str, ...]]] = []
        for qual, _how in self.entries:
            if qual not in seen:
                seen[qual] = (qual,)
                work.append((qual, (qual,)))
        while work:
            qual, chain = work.pop()
            if len(chain) >= _MAX_DEPTH:
                continue
            entry = self.funcs.get(qual)
            if entry is None:
                continue
            for node in ast.walk(entry.node):
                if isinstance(node, ast.Call):
                    callee = self._resolve_callee(entry, node)
                    if callee is not None and callee not in seen:
                        seen[callee] = chain + (callee,)
                        work.append((callee, chain + (callee,)))
        return seen

    def eager_reachable(self) -> Dict[str, Tuple[str, ...]]:
        """qual -> witness chain of quals down to a kernel launch, for
        every function that reaches one: the launches' callers, their
        callers, and so on (the eager call graph reversed).  Memoized."""
        if self._eager is not None:
            return self._eager
        callers: Dict[str, Set[str]] = defaultdict(set)
        for qual, entry in self.funcs.items():
            for node in _walk_shallow(entry.node):
                if isinstance(node, ast.Call):
                    for callee in self._resolve_wide(entry, node):
                        if callee != qual:
                            callers[callee].add(qual)
        seen: Dict[str, Tuple[str, ...]] = {}
        work: List[str] = []
        for qual in sorted(self.launches):
            seen[qual] = (qual,)
            work.append(qual)
        while work:
            qual = work.pop()
            chain = seen[qual]
            if len(chain) >= _MAX_DEPTH:
                continue
            for caller in sorted(callers.get(qual, ())):
                if caller not in seen:
                    seen[caller] = (caller,) + chain
                    work.append(caller)
        self._eager = seen
        return seen

    # ---- the rules --------------------------------------------------- #

    def check(self) -> None:
        reach = self.reachable()
        eager = self.eager_reachable()
        how_of: Dict[str, str] = {}
        for qual, how in self.entries:
            how_of.setdefault(qual, how)

        def add(
            pf: ParsedFile, line: int, rule: str, message: str
        ) -> None:
            if pf.suppressed_on(line, rule):
                return
            self.diagnostics.append(Diagnostic(pf.path, line, rule, message))

        def via(chain: Tuple[str, ...]) -> str:
            if len(chain) <= 1:
                return ""
            names = " -> ".join(q.split(":", 1)[-1] for q in chain)
            return f" (traced via {names})"

        scopes: Dict[str, Dict[int, Set[str]]] = {}
        chained: Dict[str, Set[int]] = {}

        def file_planes(pf: ParsedFile) -> Tuple[Dict[int, Set[str]], Set[int]]:
            if pf.norm not in scopes:
                scopes[pf.norm] = tensor_scopes(pf.tree)
                chained[pf.norm] = chained_cpu_calls(pf.tree)
            return scopes[pf.norm], chained[pf.norm]

        for qual, chain in reach.items():
            entry = self.funcs.get(qual)
            if entry is None:
                continue
            pf = entry.pf
            fn = entry.node
            torch_traced = _is_torch_tracer(how_of.get(chain[0], ""))
            rng_hint = (
                "pass the value in as a tensor argument instead"
                if torch_traced
                else "thread a jax.random key through instead"
            )
            declared: Set[str] = set()
            for node in _walk_shallow(fn):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    declared.update(node.names)
            for node in _walk_shallow(fn):
                # UC301: state mutation
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for target in targets:
                        if (
                            isinstance(target, ast.Name)
                            and target.id in declared
                        ):
                            add(
                                pf,
                                node.lineno,
                                "UC301",
                                f"traced function {fn.name!r} rebinds "
                                f"{target.id!r} via global/nonlocal — the "
                                "mutation happens once at trace time, not "
                                f"per call{via(chain)}",
                            )
                        elif isinstance(target, ast.Subscript) and isinstance(
                            target.value, ast.Name
                        ):
                            base = target.value.id
                            if base in self.module_globals.get(pf.norm, ()):
                                add(
                                    pf,
                                    node.lineno,
                                    "UC301",
                                    f"traced function {fn.name!r} mutates "
                                    f"module-level container {base!r} — "
                                    "trace-time side effect"
                                    f"{via(chain)}",
                                )
                elif isinstance(node, ast.Call):
                    dn = dotted_name(node.func) or ""
                    qualifier, name = call_name(node)
                    # UC301: module container mutation via method
                    if (
                        name in _CONTAINER_MUTATORS
                        and qualifier is not None
                        and qualifier
                        in self.module_globals.get(pf.norm, ())
                    ):
                        add(
                            pf,
                            node.lineno,
                            "UC301",
                            f"traced function {fn.name!r} mutates "
                            f"module-level container {qualifier!r} via "
                            f".{name}() — trace-time side effect"
                            f"{via(chain)}",
                        )
                    # UC302: RNG / time
                    if _RNG_TIME.match(dn) and not dn.startswith(
                        "jax.random."
                    ):
                        add(
                            pf,
                            node.lineno,
                            "UC302",
                            f"traced function {fn.name!r} calls {dn}() — "
                            "the value freezes into the compiled program; "
                            f"{rng_hint}{via(chain)}",
                        )
                    # UC303: readback without annotation
                    scope, ids = file_planes(pf)
                    hit = readback_hit(node, scope.get(id(node), set()), ids)
                    if hit is not None and node.lineno not in pf.readback_lines:
                        add(
                            pf,
                            node.lineno,
                            "UC303",
                            f"traced function {fn.name!r} reads back "
                            f"off-device via {hit} without a "
                            f"'# readback: <why>' annotation{via(chain)}",
                        )

        # UC303 on the eager device path: the functions under the device
        # directories that reach a launch, traced ones already judged.
        for qual, chain in sorted(eager.items()):
            entry = self.funcs.get(qual)
            if entry is None or qual in reach or not _is_device_module(
                entry.pf
            ):
                continue
            pf = entry.pf
            scope, ids = file_planes(pf)
            path = " -> ".join(q.split(":", 1)[-1] for q in chain)
            for node in _walk_shallow(entry.node):
                if not isinstance(node, ast.Call):
                    continue
                if node.lineno in pf.readback_lines:
                    continue
                hit = readback_hit(
                    node, scope.get(id(node), set()), ids, all_scalars=True
                )
                if hit is not None:
                    add(
                        pf,
                        node.lineno,
                        "UC303",
                        f"device-path function {entry.node.name!r} reads "
                        f"back off-device via {hit} without a "
                        "'# readback: <why>' annotation (it reaches a "
                        f"kernel launch: {path} -> "
                        f"{self.launches[chain[-1]]})",
                    )

        # UC304: recompile hazards, repo-wide over device modules.
        for pf in self.files:
            if not _is_device_module(pf):
                continue
            self._check_recompile(pf, add)

    def _check_recompile(self, pf: ParsedFile, add) -> None:
        # (a) a fresh traced callable built *and consumed* per call:
        #     `jit(f)(x)` immediately invoked, or a jit/pallas_call
        #     wrapping constructed inside a loop body.  The build-once
        #     factory idiom — `return jax.jit(f)` / `self._fn = jit(f)`
        #     — is the repo's standard caching pattern and is exempt:
        #     the wrapper object survives, so the jit cache hits.
        parents: Dict[int, ast.AST] = {}
        loop_depth: Dict[int, int] = {}
        fn_depth: Dict[int, int] = {}

        def map_tree(node: ast.AST, depth: int, in_fn: int) -> None:
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
                child_depth = depth
                child_fn = in_fn
                if isinstance(child, (ast.For, ast.While)):
                    child_depth += 1
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    child_depth = 0  # a nested def resets the loop context
                    if not isinstance(child, ast.Lambda):
                        child_fn += 1
                loop_depth[id(child)] = child_depth
                fn_depth[id(child)] = child_fn
                map_tree(child, child_depth, child_fn)

        map_tree(pf.tree, 0, 0)
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            tracer = _tracer_call(node)
            if tracer is None:
                continue
            parent = parents.get(id(node))
            invoked = isinstance(parent, ast.Call) and parent.func is node
            in_loop = loop_depth.get(id(node), 0) > 0
            operand = node.args[0] if node.args else None
            label = (
                "lambda ..."
                if isinstance(operand, ast.Lambda)
                else operand.id
                if isinstance(operand, ast.Name)
                else "..."
            )
            if not invoked and not in_loop:
                # (c) torch: a lambda compiled inside a function is a new
                #     callable per call of that function — a fresh
                #     compile-cache entry every time.
                if (
                    _is_torch_tracer(tracer)
                    and isinstance(operand, ast.Lambda)
                    and fn_depth.get(id(node), 0) > 0
                ):
                    add(
                        pf,
                        node.lineno,
                        "UC304",
                        f"recompile hazard: {tracer}({label}) is built "
                        "inside a function — a fresh callable per call "
                        "means the compile cache never hits; build once "
                        "(module scope or cached attribute) and reuse",
                    )
                continue
            where = (
                "is invoked immediately"
                if invoked
                else "is rebuilt inside a loop"
            )
            add(
                pf,
                node.lineno,
                "UC304",
                f"recompile hazard: {tracer}({label}) {where} — a fresh "
                "traced callable per call means the jit cache never "
                "hits; build once (module scope or cached attribute) "
                "and reuse",
            )
        # (b) unhashable literal at a known static position.
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Name):
                continue
            positions = self.static_positions.get((pf.norm, node.func.id))
            if not positions:
                continue
            for idx in positions:
                if idx < len(node.args) and isinstance(
                    node.args[idx], (ast.List, ast.Dict, ast.Set)
                ):
                    add(
                        pf,
                        node.lineno,
                        "UC304",
                        f"recompile hazard: call to jitted "
                        f"{node.func.id!r} passes an unhashable "
                        f"{type(node.args[idx]).__name__.lower()} literal "
                        f"at static position {idx} — jit static args must "
                        "hash; pass a tuple or hoist the constant",
                    )


def run_purity(files: List[ParsedFile]) -> Tuple[List[Diagnostic], Dict]:
    p = PurityPass(files)
    p.build()
    p.find_entries()
    p.check()
    eager = p.eager_reachable()
    summary = {
        "entries": sorted(
            {f"{q} [{how}]" for q, how in p.entries}
            | {f"{q} [launch {sym}]" for q, sym in p.launches.items()}
        ),
        "reachable": len(p.reachable()),
        "eager": len(
            [q for q in eager if _is_device_module(p.funcs[q].pf)]
        ),
    }
    return p.diagnostics, summary
