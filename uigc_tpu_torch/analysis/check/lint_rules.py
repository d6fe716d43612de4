"""UL001-UL016: the uigc-lint rule set as a pass over the shared parse.

The port of ``uigc_tpu/analysis/check/lint_rules.py``.  Rule ids,
message texts, suppression comments and allowlist semantics are the
reference's, with two changes:

- the package the package-scoped rules (UL004's message, UL014, UL015)
  look for is :data:`PACKAGE`, which :func:`run_lint` takes as an
  argument; set to ``"uigc_tpu"`` the pass gives the reference's
  verdicts on the reference's tree;
- UL011 also knows PyTorch's device->host idioms (``.cpu()``,
  ``.cpu().numpy()``, ``torch.cuda.synchronize()``, an event's or a
  stream's ``.synchronize()``, and ``.tolist()`` / ``int()`` /
  ``float()`` / ``bool()`` of a subscript on an expression that is
  evidently a tensor).  It favours precision over recall: a ``.tolist()``
  or an ``int(x[i])`` counts only where the file shows the value came
  out of ``torch`` (see :func:`torch_evidence`); the reachability-aware
  UC303 (:mod:`.purity`) covers the rest on the eager device path.

See ``uigc_tpu_torch/tools/uigc_lint.py`` for the rule catalogue.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Diagnostic, ParsedFile, call_name, dotted_name

#: the analyzed package's directory name (the port's own by default)
PACKAGE = "uigc_tpu_torch"

RULES = {
    "UL001": "ref captured in closure without create_ref registration",
    "UL002": "message stores refs its refs property does not export",
    "UL003": "blocking call inside a behavior callback",
    "UL004": "bare assert used for a runtime invariant in library code",
    "UL005": "inconsistent lock-acquisition order",
    "UL006": "direct ProxyCell construction outside runtime/",
    "UL007": "blocking socket call while holding a _PeerState lock",
    "UL008": "snapshot/inspect code mutates engine state",
    "UL009": "metric name violates the uigc_ prefix / unit-suffix convention",
    "UL010": "direct pickle call on a runtime hot-path module outside wire.py",
    "UL011": "unannotated device->host transfer on an engines/ops hot path",
    "UL012": "unbounded queue-shaped attribute in runtime//cluster/ "
    "without a bound or an '# unbounded:' rationale",
    "UL013": "journal append or shard-table mutation bypassing the "
    "fenced helpers in cluster/sharding.py / cluster/journal.py",
    "UL014": "shadow-graph slot mutated outside the owning partition's "
    "fold path (route through the dmark/delta plane)",
    "UL015": "dmark/dmack payload built outside the schema-codec "
    "helpers (no ad-hoc frames or JSON coordinate lists on the "
    "distributed hot path)",
    "UL016": "pickle/marshal call inside the ingress gateway (client "
    "bytes meet only the closed client value codec)",
}

_QUEUE_ATTR = re.compile(
    r"(queue|buf|pending|deferred|backlog|outq|box|_q$)", re.IGNORECASE
)
_NUMPY_QUALS = {"np", "numpy", "_np"}
_PICKLE_CALLS = {"dumps", "loads", "dump", "load", "Pickler", "Unpickler"}
_JOURNAL_APPEND_CALLS = {
    "open_epoch",
    "note_command",
    "commit_snapshot",
    "begin_snapshot",
}
_SHADOW_SLOT_ATTRS = {"interned", "is_halted", "supervisor"}
_SHADOW_FOLD_MODULES = (
    "engines/crgc/shadow.py",
    "engines/crgc/delta.py",
    "engines/crgc/distributed.py",
    "engines/crgc/state.py",
    "analysis/sanitizer.py",
)
_DMARK_FRAME_KINDS = {"dmark", "dmack"}
_METRIC_UNIT_SUFFIXES = ("_seconds", "_bytes", "_total", "_ratio")
_METRIC_REGISTRARS = {"counter", "gauge", "histogram"}
_ENGINE_MUTATORS = {
    "merge_entry",
    "merge_entries",
    "merge_packed",
    "merge_delta",
    "merge_undo_log",
    "trace",
    "harvest_trace",
    "launch_trace",
    "expire_stalled_wake",
    "start_wave",
    "tell",
    "tell_bulk",
    "tell_system",
    "tell_batch",
    "stop",
    "collect",
    "spawn",
    "release",
    "register_frame_handler",
    "send_frame",
    "die",
    "link",
    "attach_packed_plane",
}
_SOCKET_CALLS = {
    "sendall",
    "send_bytes",
    "recv",
    "accept",
    "connect",
    "create_connection",
    "makefile",
}
_REF_NAME = re.compile(r"(^|_)refs?($|_)|refob", re.IGNORECASE)
_LOCK_NAME = re.compile(r"(^|_)(lock|rlock|cv|cond)$", re.IGNORECASE)
_BLOCKING_CALLS = {
    ("time", "sleep"),
    ("socket", "recv"),
    ("socket", "accept"),
    ("queue", "get"),
    ("subprocess", "run"),
    ("subprocess", "check_output"),
}
_BLOCKING_METHODS = {"join", "wait", "acquire", "recv", "accept", "get"}
_NONBLOCKING_HINTS = {"get"}  # dict.get — exempt unless a timeout arg is used
_BLOCKING_BARE = {"input"}
#: methods a numpy array does not have and a torch tensor does: a
#: receiver chain calling one is a tensor
_TORCH_METHODS = {
    "cpu",
    "cuda",
    "to",
    "long",
    "int",
    "bool",
    "float",
    "double",
    "half",
    "contiguous",
    "clone",
    "detach",
    "index_select",
    "index_add_",
    "scatter_reduce_",
    "masked_fill",
}
_SYNC_RECEIVER = re.compile(r"(event|stream|(^|_)evt?($|_))", re.IGNORECASE)
_SCALAR_CASTS = {"int", "float", "bool"}


def torch_evidence(expr: ast.AST, tensor_names: Set[str]) -> bool:
    """True when ``expr`` is evidently a torch tensor: it calls
    ``torch.*`` or a tensor-only method somewhere in its chain, or it
    reads a name (or ``self`` attribute) that :func:`tensor_bindings`
    found bound to such an expression in scope."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func) or ""
            if dn.startswith("torch."):
                return True
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _TORCH_METHODS
            ):
                return True
        elif isinstance(node, ast.Name) and node.id in tensor_names:
            return True
        elif (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and f"self.{node.attr}" in tensor_names
        ):
            return True
    return False


def _shallow(scope: ast.AST):
    """The nodes of ``scope`` outside its nested function and class
    bodies (those are scopes of their own)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            stack.extend(ast.iter_child_nodes(node))


def tensor_bindings(scope: ast.AST, seed: Set[str] = frozenset()) -> Set[str]:
    """``seed`` plus the names (and ``self.x`` attributes) bound in
    ``scope``'s own body to an expression with torch evidence —
    flow-insensitive, to a fixpoint so ``a = torch.zeros(..); b = a[1:]``
    binds both."""
    names: Set[str] = set(seed)
    assigns = [
        node
        for node in _shallow(scope)
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign))
        and node.value is not None
    ]

    def bound(target: ast.AST) -> List[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            return [f"self.{target.attr}"]
        if isinstance(target, (ast.Tuple, ast.List, ast.Starred)):
            elts = target.elts if not isinstance(target, ast.Starred) else [
                target.value
            ]
            return [n for elt in elts for n in bound(elt)]
        return []

    changed = True
    while changed:
        changed = False
        for node in assigns:
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            fresh = [n for t in targets for n in bound(t) if n not in names]
            if fresh and torch_evidence(node.value, names):
                names.update(fresh)
                changed = True
    return names


def tensor_scopes(tree: ast.AST) -> Dict[int, Set[str]]:
    """id(call) -> the tensor names in scope at that call: its function's
    own bindings, its enclosing functions' (closures), and — inside a
    class — the ``self.x`` attributes any method of the class binds to a
    tensor."""
    out: Dict[int, Set[str]] = {}

    def visit(node: ast.AST, names: Set[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, tensor_bindings(child, names))
            elif isinstance(child, ast.ClassDef):
                attrs: Set[str] = set()
                for item in child.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        attrs |= {
                            n
                            for n in tensor_bindings(item, names)
                            if n.startswith("self.")
                        }
                visit(child, names | attrs)
            else:
                if isinstance(child, ast.Call):
                    out[id(child)] = names
                visit(child, names)

    visit(tree, tensor_bindings(tree))
    return out


def readback_hit(
    call: ast.Call,
    tensor_names: Set[str],
    chained: Set[int],
    all_scalars: bool = False,
) -> Optional[str]:
    """The device->host idiom ``call`` is, or None.  Shared by UL011
    (file-local, ``tensor_names`` from :func:`tensor_scopes`) and UC303 (``all_scalars``: on the eager device path every
    ``.tolist()`` and ``int(x[i])`` whose operand is not evidently numpy
    counts).  ``chained`` holds the ids of ``.cpu()`` calls another
    idiom already reports (``t.cpu().numpy()`` is one crossing)."""
    qual, name = call_name(call)
    fn = call.func
    bare = not call.args and not call.keywords
    if qual == "jax" and name == "device_get":
        return "jax.device_get()"
    if name == "item" and isinstance(fn, ast.Attribute) and bare:
        # Any attribute receiver, not just a bare name — the common
        # in-method forms are self._dev_x.item() / marks[0].item(),
        # for which call_name's qualifier is None.
        return f"{qual or '<expr>'}.item()"
    if (
        name == "asarray"
        and qual in _NUMPY_QUALS
        and not any(kw.arg == "dtype" for kw in call.keywords)
    ):
        return f"{qual}.asarray() without dtype="
    if not isinstance(fn, ast.Attribute) and not (
        isinstance(fn, ast.Name) and fn.id in _SCALAR_CASTS
    ):
        return None
    if name == "cpu" and bare and isinstance(fn, ast.Attribute):
        if id(call) in chained:
            return None
        return f"{qual or '<expr>'}.cpu()"
    if name == "numpy" and isinstance(fn, ast.Attribute) and _is_cpu_call(
        fn.value
    ):
        return f"{_cpu_qual(fn.value)}.cpu().numpy()"
    if name == "synchronize" and isinstance(fn, ast.Attribute):
        recv = fn.value
        dn = dotted_name(recv)
        if dn == "torch.cuda":
            return "torch.cuda.synchronize()"
        label = dn or (call_name(recv)[1] if isinstance(recv, ast.Call) else "")
        if label and _SYNC_RECEIVER.search(label):
            return f"{label}.synchronize()"
        return None
    if name == "tolist" and isinstance(fn, ast.Attribute) and bare:
        recv = fn.value
        if _is_cpu_call(recv):
            return f"{_cpu_qual(recv)}.cpu().tolist()"
        if torch_evidence(recv, tensor_names) or (
            all_scalars and not _numpy_evidence(recv)
        ):
            return f"{qual or '<expr>'}.tolist()"
        return None
    if (
        isinstance(fn, ast.Name)
        and fn.id in _SCALAR_CASTS
        and len(call.args) == 1
        and not call.keywords
        and isinstance(call.args[0], ast.Subscript)
    ):
        sub = call.args[0]
        if torch_evidence(sub.value, tensor_names) or (
            all_scalars and not _numpy_evidence(sub.value)
        ):
            base = dotted_name(sub.value) or "<expr>"
            return f"{fn.id}({base}[...])"
    return None


def _is_cpu_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "cpu"
        and not node.args
        and not node.keywords
    )


def _cpu_qual(node: ast.Call) -> str:
    return dotted_name(node.func.value) or "<expr>"


def _numpy_evidence(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func) or ""
            if dn.split(".")[0] in _NUMPY_QUALS:
                return True
    return False


def chained_cpu_calls(tree: ast.AST) -> Set[int]:
    """ids of ``.cpu()`` calls that are the receiver of a ``.numpy()``,
    ``.tolist()`` or ``.item()`` call: the outer call reports them."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("numpy", "tolist", "item")
            and _is_cpu_call(node.func.value)
        ):
            out.add(id(node.func.value))
    return out


def _contains_call(tree: ast.AST, name: str) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and call_name(node)[1] == name:
            return True
    return False


def _is_behavior_class(node: ast.ClassDef) -> bool:
    for item in node.body:
        if isinstance(item, ast.FunctionDef) and item.name in (
            "on_message",
            "on_signal",
        ):
            return True
    return False


class FileLinter:
    """All file-local UL rules over one ParsedFile."""

    def __init__(self, pf: ParsedFile, package: str = PACKAGE):
        self.pf = pf
        self.package = package
        self.path = pf.path
        self.tree = pf.tree
        self.violations: List[Diagnostic] = []
        #: (outer_lock, inner_lock) -> first line observed, for UL005
        self.lock_pairs: Dict[Tuple[str, str], int] = {}

    def add(self, line: int, rule: str, message: str) -> None:
        if self.pf.suppressed_on(line, rule):
            return
        self.violations.append(Diagnostic(self.path, line, rule, message))

    # -- rules ------------------------------------------------------- #

    def run(self, lint_asserts: bool) -> None:
        parts = self.pf.parts
        in_runtime = "runtime" in parts
        norm = self.pf.norm
        pickle_guarded = in_runtime and not norm.endswith("runtime/wire.py")
        device_plane = bool({"engines", "ops", "parallel"} & set(parts))
        gateway_plane = "gateway" in parts
        bounded_plane = in_runtime or bool({"cluster", "gateway"} & set(parts))
        fence_plane = bounded_plane and not (
            norm.endswith("cluster/sharding.py")
            or norm.endswith("cluster/journal.py")
        )
        slot_plane = (
            self.package in parts
            and "tests" not in parts
            and not norm.endswith(_SHADOW_FOLD_MODULES)
        )
        dmark_plane = self.package in parts and "tests" not in parts
        is_wire = norm.endswith("runtime/wire.py")
        if is_wire:
            self._lint_dmark_payload_json()
        if device_plane:
            self._tensor_scopes = tensor_scopes(self.tree)
            self._chained = chained_cpu_calls(self.tree)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                self._lint_class(node)
            elif isinstance(node, (ast.Tuple, ast.List)):
                if dmark_plane and not is_wire:
                    self._lint_dmark_frame_literal(node)
            elif isinstance(node, ast.Call):
                if not in_runtime:
                    self._lint_proxycell(node)
                if pickle_guarded:
                    self._lint_pickle_hot_path(node)
                if gateway_plane:
                    self._lint_gateway_codec(node)
                if device_plane:
                    self._lint_host_transfer(node)
                if fence_plane:
                    self._lint_fenced_journal(node)
                if slot_plane:
                    self._lint_shadow_slot_call(node)
                self._lint_metric_name(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._lint_socket_under_peer_lock(node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                if bounded_plane:
                    self._lint_unbounded_queue(node)
                if fence_plane:
                    self._lint_table_mutation(node)
                if slot_plane:
                    self._lint_shadow_slot_store(node)
            elif isinstance(node, ast.AugAssign):
                if slot_plane:
                    self._lint_shadow_slot_store(node)
        if norm.endswith("telemetry/inspect.py"):
            self._lint_inspect_readonly()
        if lint_asserts:
            self._lint_asserts()
        self._collect_lock_pairs()

    def _lint_inspect_readonly(self) -> None:
        """UL008: the liveness inspector is read-only by contract."""

        def import_names(node) -> List[str]:
            if isinstance(node, ast.Import):
                return [alias.name for alias in node.names]
            if isinstance(node, ast.ImportFrom):
                module = node.module or ""
                # Relative imports: from ..engines.x / from ..runtime
                # resolve inside the package; absolute spell it out.
                return [module]
            return []

        def is_type_checking_if(node: ast.AST) -> bool:
            if not isinstance(node, ast.If):
                return False
            test = node.test
            name = (
                test.id
                if isinstance(test, ast.Name)
                else getattr(test, "attr", "")
            )
            return name == "TYPE_CHECKING"

        def walk_imports(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if is_type_checking_if(child):
                    continue  # annotation-only: never executes
                if isinstance(child, (ast.Import, ast.ImportFrom)):
                    for module in import_names(child):
                        parts = module.split(".")
                        if "engines" in parts or "runtime" in parts:
                            self.add(
                                child.lineno,
                                "UL008",
                                f"runtime import of {module or '(relative)'!r}: "
                                "inspect code reaches engine/runtime state "
                                "duck-typed only (TYPE_CHECKING imports OK)",
                            )
                else:
                    walk_imports(child)

        def store_root(target: ast.AST):
            """(root name, crosses-an-attribute?) of a store target."""
            has_attr = False
            node = target
            while isinstance(node, (ast.Attribute, ast.Subscript)):
                if isinstance(node, ast.Attribute):
                    has_attr = True
                node = node.value
            if isinstance(node, ast.Name):
                return node.id, has_attr
            return None, has_attr

        def check_target(target: ast.AST, line: int) -> None:
            if isinstance(target, (ast.Tuple, ast.List)):
                for elt in target.elts:
                    check_target(elt, line)
                return
            root, has_attr = store_root(target)
            if has_attr and root is not None and root != "self":
                self.add(
                    line,
                    "UL008",
                    f"store through attribute of {root!r}: inspect code "
                    "may only mutate its own objects (root must be self)",
                )

        walk_imports(self.tree)
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for target in targets:
                    check_target(target, node.lineno)
            elif isinstance(node, ast.Delete):
                for target in node.targets:
                    check_target(target, node.lineno)
            elif isinstance(node, ast.Call):
                qual, name = call_name(node)
                if name in _ENGINE_MUTATORS and isinstance(
                    node.func, ast.Attribute
                ):
                    self.add(
                        node.lineno,
                        "UL008",
                        f"call to engine mutator .{name}() from read-only "
                        "inspect code",
                    )

    def _lint_socket_under_peer_lock(self, fn: ast.AST) -> None:
        """UL007: blocking socket I/O under a _PeerState lock.

        A 'peer lock' is approximated as ``<name>.lock`` / ``<name>.rlock``
        where ``<name>`` is the conventional ``st`` or was assigned from a
        ``_peer_state(...)`` call in the same function — the exact shape
        the pre-writer transport used (sendall under ``st.lock``)."""
        peer_vars = {"st"}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if call_name(node.value)[1] == "_peer_state":
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            peer_vars.add(target.id)

        def holds_peer_lock(with_node: ast.With) -> bool:
            for item in with_node.items:
                expr = item.context_expr
                if (
                    isinstance(expr, ast.Attribute)
                    and expr.attr in ("lock", "rlock")
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id in peer_vars
                ):
                    return True
            return False

        def walk(node: ast.AST, held: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    # A nested def's body runs later, not under the
                    # lock — and the outer ast.walk dispatch will lint
                    # it as its own function, so don't descend here
                    # (that would double-report its violations).
                    continue
                if held and isinstance(child, ast.Call):
                    name = call_name(child)[1]
                    if name in _SOCKET_CALLS:
                        self.add(
                            child.lineno,
                            "UL007",
                            f"blocking socket call {name}() while holding a "
                            "_PeerState lock; claim the seq under the lock, "
                            "write on the peer's writer thread",
                        )
                if isinstance(child, ast.With):
                    walk(child, held or holds_peer_lock(child))
                else:
                    walk(child, held)

        walk(fn, False)

    def _lint_metric_name(self, call: ast.Call) -> None:
        """UL009: metric names registered via ``.counter/.gauge/
        .histogram(...)`` must carry the ``uigc_`` prefix; counters and
        histograms also need a unit suffix."""
        fn = call.func
        if not isinstance(fn, ast.Attribute) or fn.attr not in _METRIC_REGISTRARS:
            return
        if not call.args:
            return
        first = call.args[0]
        if not isinstance(first, ast.Constant) or not isinstance(
            first.value, str
        ):
            return  # dynamic name: nothing to check statically
        name = first.value
        if not name.startswith("uigc_"):
            self.add(
                call.lineno,
                "UL009",
                f"metric {name!r} lacks the uigc_ prefix",
            )
            return
        if fn.attr != "gauge" and not name.endswith(_METRIC_UNIT_SUFFIXES):
            self.add(
                call.lineno,
                "UL009",
                f"{fn.attr} {name!r} lacks a unit suffix "
                f"({'/'.join(_METRIC_UNIT_SUFFIXES)})",
            )

    def _lint_host_transfer(self, call: ast.Call) -> None:
        """UL011: device->host crossing idioms under engines/, ops/ or
        parallel/ must be annotated (``# readback: <why>``) or routed
        through the accounted ``arrays._readback`` helper.  The flagged
        shapes: ``jax.device_get(x)``, zero-arg ``.item()``,
        ``np.asarray(x)`` without a ``dtype=`` keyword (the dtype'd form
        is host list conversion, never a readback), and the torch idioms
        of :func:`readback_hit`."""
        if call.lineno in self.pf.readback_lines:
            return
        hit = readback_hit(
            call, self._tensor_scopes.get(id(call), set()), self._chained
        )
        if hit is not None:
            self.add(
                call.lineno,
                "UL011",
                f"{hit} on a device-plane module: a device->host "
                "transfer here dodges the observatory's accounting; "
                "route through arrays._readback or annotate the line "
                "with '# readback: <why>'",
            )

    def _lint_fenced_journal(self, node: ast.Call) -> None:
        """UL013 (call half): the journal append plane may only be
        driven through the fenced region helpers — a direct
        ``open_epoch``/``note_command``/``commit_snapshot``/
        ``begin_snapshot`` call anywhere else in runtime//cluster/
        bypasses fence stamping, the frozen-journal reject site and the
        epoch-bump-at-enqueue ordering."""
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _JOURNAL_APPEND_CALLS
        ):
            self.add(
                node.lineno,
                "UL013",
                f"direct journal append '{func.attr}(...)' outside the "
                "fenced helpers (route through the ShardRegion "
                "_journal_* helpers in cluster/sharding.py)",
            )

    def _lint_table_mutation(self, node: ast.AST) -> None:
        """UL013 (store half): the shard table is installed only by
        cluster/sharding.py's fence-aware transitions
        (``_recompute_table``/``_adopt_table``); any other
        ``<x>._table = ...`` store skips the fence comparison and the
        grant/hold bookkeeping."""
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for target in targets:
            if isinstance(target, ast.Attribute) and target.attr == "_table":
                self.add(
                    node.lineno,
                    "UL013",
                    "shard-table store bypasses the fenced transition "
                    "helpers in cluster/sharding.py",
                )

    @staticmethod
    def _receiver_name(expr: ast.AST) -> str:
        if isinstance(expr, ast.Name):
            return expr.id
        if isinstance(expr, ast.Attribute):
            return expr.attr
        return ""

    def _lint_shadow_slot_store(self, node: ast.AST) -> None:
        """UL014 (store half): authoritative shadow slots — flags,
        supervisor pointers, receive balances, edge maps — are written
        only by the fold plane (_SHADOW_FOLD_MODULES), which the
        distributed collector routes every fact through so it lands at
        the owning partition.  A direct store anywhere else mutates
        state this node may not own — exactly the class the per-sweep
        fold-locality audit catches at runtime."""
        if isinstance(node, ast.Assign):
            targets = node.targets
        else:
            targets = [node.target]
        for target in targets:
            if isinstance(target, ast.Attribute):
                recv = self._receiver_name(target.value)
                if recv == "self":
                    continue
                hit = target.attr in _SHADOW_SLOT_ATTRS or (
                    target.attr == "recv_count" and "shadow" in recv.lower()
                )
                if hit:
                    self.add(
                        node.lineno,
                        "UL014",
                        f"shadow slot .{target.attr} written outside the "
                        "fold plane; route the fact through the "
                        "dmark/delta plane (engines/crgc/delta.py fold_* "
                        "-> owner merge)",
                    )
            elif isinstance(target, ast.Subscript):
                value = target.value
                if (
                    isinstance(value, ast.Attribute)
                    and value.attr == "outgoing"
                ):
                    self.add(
                        node.lineno,
                        "UL014",
                        "shadow edge map .outgoing[...] written outside "
                        "the fold plane; route through the dmark/delta "
                        "plane",
                    )

    def _lint_shadow_slot_call(self, call: ast.Call) -> None:
        """UL014 (call half): mutating calls on a shadow's edge map and
        the ``_update_outgoing`` helper are fold-plane-only for the
        same ownership reason."""
        qual, name = call_name(call)
        if name == "_update_outgoing":
            self.add(
                call.lineno,
                "UL014",
                "_update_outgoing(...) outside the fold plane mutates a "
                "shadow edge map directly; route through the dmark/delta "
                "plane",
            )
            return
        fn = call.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in ("clear", "pop", "setdefault", "update")
            and isinstance(fn.value, ast.Attribute)
            and fn.value.attr == "outgoing"
        ):
            self.add(
                call.lineno,
                "UL014",
                f"shadow edge map .outgoing.{fn.attr}(...) outside the "
                "fold plane; route through the dmark/delta plane",
            )

    def _lint_dmark_frame_literal(self, node: ast.AST) -> None:
        """UL015 (frame half): a ``("dmark", ...)``/``("dmack", ...)``
        literal outside runtime/wire.py builds a boundary-mark frame by
        hand — bypassing the payload codec, the suffix-watermark
        elements and the legacy-peer negotiation the wire helpers
        carry."""
        elts = getattr(node, "elts", ())
        if not elts:
            return
        head = elts[0]
        if (
            isinstance(head, ast.Constant)
            and head.value in _DMARK_FRAME_KINDS
        ):
            self.add(
                node.lineno,
                "UL015",
                f"ad-hoc ({head.value!r}, ...) frame literal; construct "
                "boundary-mark frames through wire.encode_dmark/"
                "encode_dmack",
            )

    def _lint_dmark_payload_json(self) -> None:
        """UL015 (payload half): inside runtime/wire.py, the dmark/
        dmack codec functions must delegate payload bytes to the
        runtime/schema.py key-set helpers — a direct json.dumps/loads
        there re-creates the ad-hoc JSON coordinate list on the hot
        path."""
        for node in self.tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            name = node.name.lower()
            if "dmark" not in name and "dmack" not in name:
                continue
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                qual, fn_name = call_name(call)
                if qual == "json" and fn_name in ("dumps", "loads"):
                    self.add(
                        call.lineno,
                        "UL015",
                        f"json.{fn_name} inside {node.name}; dmark/dmack "
                        "payloads go through the schema-codec key-set "
                        "helpers (runtime/schema.py encode_keyset / "
                        "decode_keyset_any)",
                    )

    def _lint_unbounded_queue(self, node: ast.AST) -> None:
        """UL012: queue-shaped attributes in runtime//cluster/ must be
        bounded or carry an explicit '# unbounded: <why>' rationale —
        the silent-deque-growth class the durability/backpressure plane
        exists to eliminate.  Heuristic by construction: only
        ``self.<queueish> = deque() | [] | list()`` assignments fire."""
        if node.lineno in self.pf.unbounded_lines:
            return
        value = node.value
        if value is None:
            return
        unbounded = False
        if isinstance(value, ast.Call):
            name = call_name(value)[1]
            if name == "deque":
                has_maxlen = any(kw.arg == "maxlen" for kw in value.keywords)
                if not has_maxlen and len(value.args) < 2:
                    unbounded = True
            elif name == "list" and not value.args:
                unbounded = True
        elif isinstance(value, ast.List) and not value.elts:
            unbounded = True
        if not unbounded:
            return
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for target in targets:
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
                and _QUEUE_ATTR.search(target.attr)
            ):
                self.add(
                    node.lineno,
                    "UL012",
                    f"queue-shaped attribute self.{target.attr} is an "
                    "unbounded deque()/list; bound it (maxlen / admission "
                    "check) or annotate the line with '# unbounded: <why>'",
                )

    def _lint_pickle_hot_path(self, call: ast.Call) -> None:
        """UL010: pickle stays behind the wire.py fallback on runtime
        hot-path modules — a stray direct call reintroduces per-message
        protocol dispatch (or un-negotiated bytes) the schema codec
        removed."""
        qual, name = call_name(call)
        if qual == "pickle" and name in _PICKLE_CALLS:
            self.add(
                call.lineno,
                "UL010",
                f"direct pickle.{name}() on a runtime hot-path module; "
                "route through wire.encode_message_schema / "
                "wire.decode_message (pickle is the sanctioned fallback "
                "inside runtime/wire.py only)",
            )

    def _lint_gateway_codec(self, call: ast.Call) -> None:
        """UL016: no pickle/marshal anywhere under the package's gateway/ —
        gateway modules sit on the untrusted side of the trust boundary
        and client bytes must only meet the closed client value codec
        (runtime/schema.py).  Node-plane replies cross back through
        runtime/wire.py helpers, never a local deserializer call."""
        qual, name = call_name(call)
        if (qual == "pickle" and name in _PICKLE_CALLS) or (
            qual == "marshal" and name in ("dumps", "loads", "dump", "load")
        ):
            self.add(
                call.lineno,
                "UL016",
                f"direct {qual}.{name}() inside the ingress gateway; "
                "client-plane values go through "
                "schema.encode_client_value / decode_client_value and "
                "node-plane replies through runtime/wire.py — a "
                "code-loading deserializer here is one bug away from "
                "attacker bytes",
            )

    def _lint_proxycell(self, call: ast.Call) -> None:
        """UL006: ProxyCell must come from the fabric's cache (or, for
        entity code, stay behind EntityRef) — never be constructed."""
        if call_name(call)[1] == "ProxyCell":
            self.add(
                call.lineno,
                "UL006",
                "direct ProxyCell construction bypasses the fabric's "
                "identity cache; use fabric._proxy (transport code) or "
                "EntityRef (entity code)",
            )

    def _lint_class(self, cls: ast.ClassDef) -> None:
        bases = {
            b.id if isinstance(b, ast.Name) else getattr(b, "attr", "")
            for b in cls.bases
        }
        if "Message" in bases or "NoRefs" in bases:
            self._lint_message_class(cls, bases)
        if _is_behavior_class(cls):
            for item in cls.body:
                if isinstance(item, ast.FunctionDef):
                    if item.name in ("on_message", "on_signal", "__init__"):
                        self._lint_behavior_callback(item)

    def _lint_message_class(self, cls: ast.ClassDef, bases: Set[str]) -> None:
        """UL002: stored ref-like constructor params vs the refs export."""
        init = next(
            (
                n
                for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__"
            ),
            None,
        )
        if init is None:
            return
        stored_refs: List[Tuple[str, int]] = []
        for node in ast.walk(init):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                        and _REF_NAME.search(target.attr)
                    ):
                        stored_refs.append((target.attr, node.lineno))
        if not stored_refs:
            return
        refs_prop = next(
            (
                n
                for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "refs"
            ),
            None,
        )
        if "NoRefs" in bases:
            attr, line = stored_refs[0]
            self.add(
                line,
                "UL002",
                f"class {cls.name} derives NoRefs but stores ref-like "
                f"attribute {attr!r}; derive Message and export it via refs",
            )
            return
        if refs_prop is None:
            attr, line = stored_refs[0]
            self.add(
                cls.lineno,
                "UL002",
                f"class {cls.name} stores ref-like attribute {attr!r} but "
                "defines no refs property",
            )
            return
        # refs property returning a constant empty tuple while refs are
        # stored: the classic silent leak.
        returns = [
            n for n in ast.walk(refs_prop) if isinstance(n, ast.Return)
        ]
        if returns and all(
            isinstance(r.value, ast.Tuple) and not r.value.elts
            for r in returns
            if r.value is not None
        ):
            attr, line = stored_refs[0]
            self.add(
                refs_prop.lineno,
                "UL002",
                f"class {cls.name} stores ref-like attribute {attr!r} but "
                "its refs property always returns ()",
            )

    def _lint_behavior_callback(self, fn: ast.FunctionDef) -> None:
        """UL001 + UL003 inside one behavior callback."""
        has_create_ref = _contains_call(fn, "create_ref")
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                self._check_blocking(node)
                qual, name = call_name(node)
                if name in ("setup", "setup_root", "spawn", "spawn_anonymous"):
                    for arg in node.args:
                        if isinstance(arg, ast.Lambda):
                            self._check_closure_capture(
                                fn, node, arg, has_create_ref
                            )
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node is not fn:
                    self._check_nested_def_capture(fn, node, has_create_ref)

    def _closure_captured_refs(
        self, fn: ast.FunctionDef, closure: ast.AST
    ) -> List[str]:
        """Ref-like names used inside ``closure`` but bound outside it."""
        if isinstance(closure, ast.Lambda):
            params = {a.arg for a in closure.args.args}
            body = closure.body
        elif isinstance(closure, (ast.FunctionDef, ast.AsyncFunctionDef)):
            params = {a.arg for a in closure.args.args}
            body = ast.Module(body=closure.body, type_ignores=[])
        else:
            return []
        captured = []
        for node in ast.walk(body):
            if (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id not in params
                and _REF_NAME.search(node.id)
            ):
                captured.append(node.id)
            elif (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and _REF_NAME.search(node.attr)
            ):
                captured.append(f"self.{node.attr}")
        return captured

    def _check_closure_capture(
        self,
        fn: ast.FunctionDef,
        call: ast.Call,
        closure: ast.AST,
        has_create_ref: bool,
    ) -> None:
        if has_create_ref:
            return
        captured = self._closure_captured_refs(fn, closure)
        if captured:
            self.add(
                call.lineno,
                "UL001",
                f"closure passed to {call_name(call)[1]} captures "
                f"{sorted(set(captured))} without a create_ref registration "
                f"in {fn.name}",
            )

    def _check_nested_def_capture(
        self, fn: ast.FunctionDef, nested: ast.AST, has_create_ref: bool
    ) -> None:
        if has_create_ref:
            return
        captured = self._closure_captured_refs(fn, nested)
        if captured:
            self.add(
                nested.lineno,
                "UL001",
                f"nested function {nested.name!r} captures "
                f"{sorted(set(captured))} without a create_ref registration "
                f"in {fn.name}",
            )

    def _check_blocking(self, call: ast.Call) -> None:
        qual, name = call_name(call)
        line = call.lineno
        if name in _BLOCKING_BARE and qual is None:
            self.add(line, "UL003", f"blocking call {name}() in a behavior callback")
            return
        if qual is not None and (qual, name) in _BLOCKING_CALLS:
            self.add(
                line, "UL003", f"blocking call {qual}.{name}() in a behavior callback"
            )
            return
        if qual is not None and name in _BLOCKING_METHODS:
            if name in _NONBLOCKING_HINTS and not call.args and not call.keywords:
                return
            # Attribute-based heuristic: obj.join()/obj.wait()/... on
            # thread/queue/event-like receivers.
            if re.search(
                r"thread|queue|event|cond|proc|sock|future|lock",
                qual,
                re.IGNORECASE,
            ):
                self.add(
                    line,
                    "UL003",
                    f"blocking call {qual}.{name}() in a behavior callback",
                )

    def _lint_asserts(self) -> None:
        """UL004: bare asserts in library code."""
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assert):
                self.add(
                    node.lineno,
                    "UL004",
                    "bare assert is stripped under python -O; raise a "
                    "structured error from "
                    f"{self.package}.utils.validation instead",
                )

    def _collect_lock_pairs(self) -> None:
        """Record nested with-lock orders for the cross-file UL005 pass."""

        def lock_attr(expr: ast.AST) -> Optional[str]:
            # with self._lock: / with link.recv_lock: / with st.rlock:
            if isinstance(expr, ast.Attribute) and _LOCK_NAME.search(expr.attr):
                return expr.attr
            if isinstance(expr, ast.Name) and _LOCK_NAME.search(expr.id):
                return expr.id
            return None

        def walk(node: ast.AST, held: Tuple[str, ...]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.With):
                    acquired = []
                    for item in child.items:
                        name = lock_attr(item.context_expr)
                        if name is not None:
                            acquired.append(name)
                    for outer in held:
                        for inner in acquired:
                            if outer != inner:
                                self.lock_pairs.setdefault(
                                    (outer, inner), child.lineno
                                )
                    walk(child, held + tuple(acquired))
                else:
                    walk(child, held)

        walk(self.tree, ())


def run_lint(
    files: List[ParsedFile], lint_asserts: bool = True, package: str = PACKAGE
) -> List[Diagnostic]:
    """The full UL pass over pre-parsed files: per-file rules plus the
    cross-file UL005 lock-order pairing.  Diagnostic order matches the
    original ``lint_paths`` (per-file in path order, UL005 appended)."""
    violations: List[Diagnostic] = []
    all_lock_pairs: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for pf in files:
        linter = FileLinter(pf, package)
        # Library code gets the assert rule; test trees keep asserts.
        linter.run(lint_asserts=lint_asserts and not pf.in_tests)
        violations.extend(linter.violations)
        for pair, line in linter.lock_pairs.items():
            all_lock_pairs.setdefault(pair, (pf.path, line))
    # UL005: cross-file order cycle detection over the lock-name digraph.
    for (outer, inner), (path, line) in sorted(all_lock_pairs.items()):
        reverse = all_lock_pairs.get((inner, outer))
        if reverse is not None and (outer, inner) < (inner, outer):
            rpath, rline = reverse
            violations.append(
                Diagnostic(
                    path,
                    line,
                    "UL005",
                    f"locks {outer!r} then {inner!r} here, but "
                    f"{inner!r} then {outer!r} at {rpath}:{rline}",
                )
            )
    return violations
