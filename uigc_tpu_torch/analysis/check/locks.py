"""Interprocedural lock-order graph.

A copy of ``uigc_tpu/analysis/check/locks.py``.

UL005/UL007 see one file at a time and identify locks by bare attribute
name, so a cross-module inversion — ``ShardRouter._table_lock`` held
across a call into ``NodeFabric`` code that takes ``_peer_lock``, while
another path nests them the other way — is invisible to them.  This
pass builds a repo-wide graph:

* **Lock identities are per-class attributes.**  ``self._lock`` inside
  class ``A`` is the node ``A._lock``, not "``_lock``"; a non-``self``
  acquisition (``st.lock``) resolves through the repo-wide table of
  lock attributes (``self.X = threading.Lock()`` assignments) when
  exactly one class owns that attribute name, and is dropped as
  ambiguous otherwise — precision over recall.
* **``with``-acquisitions connect through a call graph.**  Each
  function gets a may-acquire summary (the locks any call chain out of
  it can take, with a witness chain), propagated to fixpoint; holding
  ``L1`` across a call whose summary contains ``L2`` adds the edge
  ``L1 -> L2`` carrying the full call path.
* **Cycles report witness paths** (UC201): every strongly-connected
  component of the lock graph with more than one lock (or a self-loop
  via distinct sites) is a potential deadlock, reported once with the
  complete per-edge acquisition chains so the inversion can be read
  straight from the finding.
* **Blocking under any held lock** (UC203): socket sends/receives,
  ``Event.wait``/``join``/condition-``wait`` without a timeout, and
  ``time.sleep`` reached — directly or transitively — while a lock is
  held generalize UL007 beyond ``_PeerState``.  A ``cv.wait()`` whose
  receiver *is* the held lock is exempt (the condition releases it).

The pass is deliberately flow-insensitive within a function (a lock
acquired anywhere in a ``with`` body counts as held for every nested
statement) and resolves calls conservatively: ``self.m()`` to the same
class, bare ``f()`` to the same module, and ``obj.m()`` only when
exactly one analyzed class defines ``m``.
"""

from __future__ import annotations

import ast
import re
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

from .core import Diagnostic, ParsedFile, call_name

RULES = {
    "UC201": "lock-order inversion cycle (potential deadlock)",
    "UC203": "blocking call reachable while a lock is held",
}

_LOCK_NAME = re.compile(r"(^|_)(lock|rlock|cv|cond)$", re.IGNORECASE)
_LOCK_CTORS = {"Lock", "RLock", "Condition"}
_SOCKET_BLOCKING = {
    "sendall",
    "recv",
    "recv_into",
    "recvfrom",
    "accept",
    "connect",
    "create_connection",
    "makefile",
}
_MAX_CHAIN = 6

# Lock identity: (owner, attr). owner is a class name, a module norm
# for module-level lock globals, or "<local>" markers are never built —
# unresolvable acquisitions are skipped.
LockId = Tuple[str, str]
# Witness chain: [(function qualname, line), ...] ending at the event.
Chain = Tuple[Tuple[str, int], ...]


class FuncInfo:
    __slots__ = (
        "qual",
        "pf",
        "node",
        "cls",
        "acquires",
        "calls",
        "blocking",
        "may_acquire",
        "may_block",
    )

    def __init__(
        self,
        qual: str,
        pf: ParsedFile,
        node: ast.AST,
        cls: Optional[str],
    ):
        self.qual = qual
        self.pf = pf
        self.node = node
        self.cls = cls
        # direct acquisitions: lock -> first with-statement line
        self.acquires: Dict[LockId, int] = {}
        # call sites: (callee qual, line, frozenset of held locks,
        #              receiver lock id if the call receiver is itself
        #              a resolvable lock — used for the cv.wait exemption)
        self.calls: List[Tuple[str, int, frozenset, Optional[LockId]]] = []
        # direct blocking sites: (line, description, receiver lock id,
        #                          frozenset of held locks)
        self.blocking: List[
            Tuple[int, str, Optional[LockId], frozenset]
        ] = []
        # fixpoint summaries
        self.may_acquire: Dict[LockId, Chain] = {}
        self.may_block: Optional[Tuple[str, Chain]] = None


class LockGraph:
    """The repo-wide analysis: build, propagate, report."""

    def __init__(self, files: List[ParsedFile]):
        self.files = [pf for pf in files if not pf.in_tests]
        # class name -> set of lock attribute names it assigns
        self.class_lock_attrs: Dict[str, Set[str]] = defaultdict(set)
        # lock attr name -> owning classes (for unique resolution)
        self.attr_owners: Dict[str, Set[str]] = defaultdict(set)
        # method name -> {qualnames} across all classes
        self.method_index: Dict[str, Set[str]] = defaultdict(set)
        # module norm -> {function name -> qual}
        self.module_funcs: Dict[str, Dict[str, str]] = defaultdict(dict)
        # class name -> {method name -> qual}
        self.class_methods: Dict[str, Dict[str, str]] = defaultdict(dict)
        self.funcs: Dict[str, FuncInfo] = {}
        # module norm -> module-level lock globals
        self.module_locks: Dict[str, Set[str]] = defaultdict(set)

    # ---- phase 1: indexes ------------------------------------------ #

    def build_indexes(self) -> None:
        for pf in self.files:
            for node in pf.tree.body:
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    if call_name(node.value)[1] in _LOCK_CTORS:
                        for target in node.targets:
                            if isinstance(target, ast.Name):
                                self.module_locks[pf.norm].add(target.id)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{pf.norm}:{node.name}"
                    self.module_funcs[pf.norm][node.name] = qual
                    self.funcs[qual] = FuncInfo(qual, pf, node, None)
                elif isinstance(node, ast.ClassDef):
                    for item in node.body:
                        if isinstance(
                            item, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            qual = f"{pf.norm}:{node.name}.{item.name}"
                            self.class_methods[node.name][item.name] = qual
                            self.method_index[item.name].add(qual)
                            self.funcs[qual] = FuncInfo(
                                qual, pf, item, node.name
                            )
                            for sub in ast.walk(item):
                                if (
                                    isinstance(sub, ast.Assign)
                                    and isinstance(sub.value, ast.Call)
                                    and call_name(sub.value)[1] in _LOCK_CTORS
                                ):
                                    for target in sub.targets:
                                        if (
                                            isinstance(target, ast.Attribute)
                                            and isinstance(
                                                target.value, ast.Name
                                            )
                                            and target.value.id == "self"
                                        ):
                                            self.class_lock_attrs[
                                                node.name
                                            ].add(target.attr)
                                            self.attr_owners[
                                                target.attr
                                            ].add(node.name)

    # ---- phase 2: per-function facts ------------------------------- #

    def _lock_id(
        self, info: FuncInfo, expr: ast.AST
    ) -> Optional[LockId]:
        if isinstance(expr, ast.Attribute):
            if not _LOCK_NAME.search(expr.attr):
                return None
            base = expr.value
            if (
                isinstance(base, ast.Name)
                and base.id == "self"
                and info.cls is not None
            ):
                return (info.cls, expr.attr)
            owners = self.attr_owners.get(expr.attr, set())
            if len(owners) == 1:
                return (next(iter(owners)), expr.attr)
            return None  # ambiguous or unknown receiver type
        if isinstance(expr, ast.Name):
            if not _LOCK_NAME.search(expr.id):
                return None
            if expr.id in self.module_locks.get(info.pf.norm, ()):
                return (info.pf.norm, expr.id)
            return None
        return None

    def _resolve_callee(
        self, info: FuncInfo, call: ast.Call
    ) -> Optional[str]:
        fn = call.func
        if isinstance(fn, ast.Name):
            return self.module_funcs.get(info.pf.norm, {}).get(fn.id)
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if (
                isinstance(base, ast.Name)
                and base.id == "self"
                and info.cls is not None
            ):
                return self.class_methods.get(info.cls, {}).get(fn.attr)
            candidates = self.method_index.get(fn.attr, set())
            if len(candidates) == 1:
                return next(iter(candidates))
        return None

    def _blocking_desc(
        self, info: FuncInfo, call: ast.Call
    ) -> Optional[str]:
        """Describe a directly-blocking call, or None."""
        qual, name = call_name(call)
        has_timeout = any(kw.arg == "timeout" for kw in call.keywords)
        if name in _SOCKET_BLOCKING and qual is not None:
            if re.search(r"sock|conn|link", qual, re.IGNORECASE):
                return f"{qual}.{name}()"
        if name == "wait" and not has_timeout and not call.args:
            if qual is not None:
                return f"{qual}.wait() without timeout"
        if name == "join" and not has_timeout and not call.args:
            if qual is not None and re.search(
                r"thread|proc|worker|queue", qual, re.IGNORECASE
            ):
                return f"{qual}.join() without timeout"
        if (qual, name) == ("time", "sleep"):
            return "time.sleep()"
        return None

    def collect_facts(self) -> None:
        for info in self.funcs.values():
            self._walk(info, info.node, frozenset())

    def _walk(
        self, info: FuncInfo, node: ast.AST, held: frozenset
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ) and child is not info.node:
                continue  # nested defs are separate functions
            if isinstance(child, ast.With):
                acquired: List[LockId] = []
                for item in child.items:
                    lock = self._lock_id(info, item.context_expr)
                    if lock is not None:
                        acquired.append(lock)
                        info.acquires.setdefault(lock, child.lineno)
                self._walk(info, child, held | frozenset(acquired))
                continue
            if isinstance(child, ast.Call):
                self._visit_call(info, child, held)
            self._walk(info, child, held)

    def _visit_call(
        self, info: FuncInfo, call: ast.Call, held: frozenset
    ) -> None:
        fn = call.func
        receiver_lock: Optional[LockId] = None
        if isinstance(fn, ast.Attribute):
            receiver_lock = self._lock_id(info, fn.value)
        desc = self._blocking_desc(info, call)
        if desc is not None:
            info.blocking.append((call.lineno, desc, receiver_lock, held))
        callee = self._resolve_callee(info, call)
        if callee is not None and callee != info.qual:
            info.calls.append((callee, call.lineno, held, receiver_lock))

    # ---- phase 3: fixpoint summaries -------------------------------- #

    def propagate(self) -> None:
        for info in self.funcs.values():
            for lock, line in info.acquires.items():
                info.may_acquire[lock] = ((info.qual, line),)
            for line, desc, recv, _held in info.blocking:
                if info.may_block is None:
                    info.may_block = (desc, ((info.qual, line),))
        changed = True
        iterations = 0
        while changed and iterations < 50:
            changed = False
            iterations += 1
            for info in self.funcs.values():
                for callee_qual, line, _held, _recv in info.calls:
                    callee = self.funcs.get(callee_qual)
                    if callee is None:
                        continue
                    for lock, chain in callee.may_acquire.items():
                        if lock not in info.may_acquire and len(chain) < _MAX_CHAIN:
                            info.may_acquire[lock] = (
                                (info.qual, line),
                            ) + chain
                            changed = True
                    if info.may_block is None and callee.may_block is not None:
                        desc, chain = callee.may_block
                        if len(chain) < _MAX_CHAIN:
                            info.may_block = (
                                desc,
                                ((info.qual, line),) + chain,
                            )
                            changed = True

    # ---- phase 4: edges and findings -------------------------------- #

    def edges(self) -> Dict[Tuple[LockId, LockId], Tuple[str, int, Chain]]:
        """lock-order edges: (L1, L2) -> (path, line, witness chain)."""
        out: Dict[Tuple[LockId, LockId], Tuple[str, int, Chain]] = {}
        for info in self.funcs.values():
            # direct nesting
            self._direct_edges(info, info.node, frozenset(), out)
            # through calls
            for callee_qual, line, held, _recv in info.calls:
                callee = self.funcs.get(callee_qual)
                if callee is None or not held:
                    continue
                for lock, chain in callee.may_acquire.items():
                    for outer in held:
                        if outer == lock:
                            continue
                        key = (outer, lock)
                        if key not in out:
                            out[key] = (
                                info.pf.path,
                                line,
                                ((info.qual, line),) + chain,
                            )
        return out

    def _direct_edges(
        self,
        info: FuncInfo,
        node: ast.AST,
        held: frozenset,
        out: Dict[Tuple[LockId, LockId], Tuple[str, int, Chain]],
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ) and child is not info.node:
                continue
            if isinstance(child, ast.With):
                acquired = []
                for item in child.items:
                    lock = self._lock_id(info, item.context_expr)
                    if lock is not None:
                        acquired.append(lock)
                for outer in held:
                    for inner in acquired:
                        if outer != inner:
                            key = (outer, inner)
                            if key not in out:
                                out[key] = (
                                    info.pf.path,
                                    child.lineno,
                                    ((info.qual, child.lineno),),
                                )
                self._direct_edges(
                    info, child, held | frozenset(acquired), out
                )
            else:
                self._direct_edges(info, child, held, out)


def _fmt_lock(lock: LockId) -> str:
    return f"{lock[0]}.{lock[1]}"


def _fmt_chain(chain: Chain) -> str:
    return " -> ".join(f"{q.split(':', 1)[-1]} (line {ln})" for q, ln in chain)


def _sccs(
    nodes: Set[LockId], adj: Dict[LockId, Set[LockId]]
) -> List[List[LockId]]:
    """Tarjan's strongly connected components, iteratively."""
    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    on_stack: Set[LockId] = set()
    stack: List[LockId] = []
    out: List[List[LockId]] = []
    counter = [0]

    for root in sorted(nodes):
        if root in index:
            continue
        work: List[Tuple[LockId, int]] = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            succs = sorted(adj.get(node, ()))
            for i in range(pi, len(succs)):
                succ = succs[i]
                if succ not in index:
                    work[-1] = (node, i + 1)
                    work.append((succ, 0))
                    recurse = True
                    break
                if succ in on_stack:
                    low[node] = min(low[node], index[succ])
            if recurse:
                continue
            if low[node] == index[node]:
                comp: List[LockId] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return out


def run_locks(files: List[ParsedFile]) -> Tuple[List[Diagnostic], Dict]:
    """Returns (diagnostics, summary) where summary feeds the registry
    (`locks` section: nodes, edges, cycles)."""
    graph = LockGraph(files)
    graph.build_indexes()
    graph.collect_facts()
    graph.propagate()
    edges = graph.edges()

    out: List[Diagnostic] = []
    pf_by_path = {pf.path: pf for pf in files}

    def add(path: str, line: int, rule: str, message: str) -> None:
        pf = pf_by_path.get(path)
        if pf is not None and pf.suppressed_on(line, rule):
            return
        out.append(Diagnostic(path, line, rule, message))

    # UC201: cycles.
    adj: Dict[LockId, Set[LockId]] = defaultdict(set)
    nodes: Set[LockId] = set()
    for (a, b) in edges:
        adj[a].add(b)
        nodes.add(a)
        nodes.add(b)
    reported_cycles = []
    for comp in _sccs(nodes, adj):
        comp_set = set(comp)
        witness_lines = []
        anchor: Optional[Tuple[str, int]] = None
        for (a, b), (path, line, chain) in sorted(edges.items()):
            if a in comp_set and b in comp_set:
                if anchor is None:
                    anchor = (path, line)
                witness_lines.append(
                    f"{_fmt_lock(a)} -> {_fmt_lock(b)} via {_fmt_chain(chain)}"
                )
        if anchor is None:
            continue
        locks_s = ", ".join(_fmt_lock(lock) for lock in comp)
        add(
            anchor[0],
            anchor[1],
            "UC201",
            f"lock-order inversion among {{{locks_s}}}: "
            + "; ".join(witness_lines),
        )
        reported_cycles.append(
            {"locks": [_fmt_lock(lock) for lock in comp], "edges": witness_lines}
        )

    # UC203: blocking while holding a lock — direct sites and call paths.
    seen_block: Set[Tuple[str, int]] = set()
    for info in graph.funcs.values():
        for line, desc, recv, held in info.blocking:
            effective = set(held)
            if recv is not None:
                effective.discard(recv)  # cv.wait releases its own lock
            if not effective:
                continue
            key = (info.pf.path, line)
            if key in seen_block:
                continue
            seen_block.add(key)
            locks_s = ", ".join(sorted(_fmt_lock(lock) for lock in effective))
            add(
                info.pf.path,
                line,
                "UC203",
                f"blocking call {desc} while holding {locks_s}",
            )
        for callee_qual, line, held, recv in info.calls:
            if not held:
                continue
            callee = graph.funcs.get(callee_qual)
            if callee is None or callee.may_block is None:
                continue
            effective = set(held)
            if recv is not None:
                effective.discard(recv)
            if not effective:
                continue
            desc, chain = callee.may_block
            key = (info.pf.path, line)
            if key in seen_block:
                continue
            seen_block.add(key)
            locks_s = ", ".join(sorted(_fmt_lock(lock) for lock in effective))
            add(
                info.pf.path,
                line,
                "UC203",
                f"call path reaches blocking {desc} while holding "
                f"{locks_s}: {_fmt_chain(((info.qual, line),) + chain)}",
            )

    summary = {
        "locks": sorted(
            {
                _fmt_lock(lock)
                for info in graph.funcs.values()
                for lock in info.acquires
            }
        ),
        "edges": [
            {
                "from": _fmt_lock(a),
                "to": _fmt_lock(b),
                "witness": _fmt_chain(chain),
            }
            for (a, b), (_path, _line, chain) in sorted(edges.items())
        ],
        "cycles": reported_cycles,
    }
    return out, summary
