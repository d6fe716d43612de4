"""uigc-lint: AST-based static checks for actor code and the runtime.

The port's copy of ``tools/uigc_lint.py``, run from the repository
root as ``python -m uigc_tpu_torch.tools.uigc_lint --strict
uigc_tpu_torch/``.  The rules are the reference's (the package they
look for is ``uigc_tpu_torch``); UL011 also knows PyTorch's readback
idioms.

Catches the protocol mistakes that produce silent GC unsoundness or
scheduling hangs — the static half of the correctness tooling whose
online half is ``uigc_tpu_torch/analysis`` (uigcsan).  Runs on the
package itself and on user actor code.

Rules
=====

UL001  ref-captured-in-closure
    A name that looks like an actor ref (``*ref*``) is captured by a
    closure passed to ``Behaviors.setup``/``spawn`` inside a behavior
    method, with no ``create_ref`` call in the enclosing function.
    Handing a refob to another actor without registering it with
    ``context.create_ref`` breaks CRGC's created/released pairing: the
    collector never learns the new owner and may collect a live actor.

UL002  message-refs-not-exported
    A class deriving ``Message`` stores constructor parameters that
    look like refs but its ``refs`` property returns a constant empty
    tuple (or the class derives ``NoRefs`` while storing refs).
    Refs that ride a message invisibly are not counted at the ingress
    and leak (or over-collect) across nodes.

UL003  blocking-call-in-behavior
    A blocking call (``time.sleep``, ``socket.recv``, ``.join()``,
    ``queue.get``, ``Event.wait``, ``input``) inside a behavior
    callback (``on_message``/``on_signal`` or a ``Behaviors.setup``
    closure).  Behavior callbacks run on the shared dispatcher pool; a
    blocked callback starves every other actor on that thread.

UL004  bare-assert-invariant
    A bare ``assert`` guarding a runtime invariant in library code.
    Asserts are stripped under ``python -O``; invariants must raise
    structured errors (``uigc_tpu_torch/utils/validation.py``) that carry the
    mismatching entries.  (Asserts in ``tests/`` are fine and not
    linted.)

UL005  inconsistent-lock-order
    Two locks are acquired in opposite nesting orders somewhere across
    the analyzed files (``with a_lock: ... with b_lock:`` here,
    ``with b_lock: ... with a_lock:`` there) — the classic deadlock
    shape.  Lock identity is approximated by attribute name, so locks
    sharing a name across unrelated classes can alias; suppress a
    false pair with the comment syntax below.

UL006  direct-proxycell-construction
    ``ProxyCell(...)`` constructed outside ``runtime/``.  A ProxyCell
    is the transport's cached identity handle for a remote uid — the
    fabric's ``_proxy`` cache guarantees one instance per (address,
    uid), which the shadow graph relies on to fold one remote actor to
    one slot.  A hand-built ProxyCell bypasses the cache (two handles,
    two slots, wrong balances) and pins a raw uid that passivation or
    migration may retire at any time.  Entity-addressed code must go
    through ``EntityRef`` (uigc_tpu_torch/cluster); transport-level code that
    really needs a proxy goes through ``fabric._proxy``.

UL007  socket-io-under-peer-lock
    A blocking socket call (``sendall``/``send_bytes``/``recv``/
    ``accept``/``connect``/``create_connection``) lexically inside a
    ``with`` block holding a ``_PeerState`` lock (``st.lock`` /
    ``st.rlock``, or any ``.lock``/``.rlock`` on a name bound from
    ``_peer_state(...)``).  This is the transport convoy the writer
    refactor removed: every dispatcher worker sending to that peer
    serializes on the lock for the DURATION of socket I/O, so one slow
    link stalls the whole mutator plane.  Sequence claims and fault
    verdicts belong under the lock; encoding and socket writes belong
    on the per-peer writer thread, off-lock.  Grandfathered nowhere —
    new occurrences always fail ``--strict``.

UL010  pickle-on-runtime-hot-path
    A direct ``pickle.dumps``/``loads``/``dump``/``load``/``Pickler``/
    ``Unpickler`` call in a ``runtime/`` module other than ``wire.py``
    (the sanctioned codec module, whose pickle use IS the negotiated
    fallback).  The schema codec made pickle the fallback, not the default: known
    message shapes cross links schema-native (runtime/schema.py), and
    a stray pickle call on a hot-path module silently reintroduces the
    per-message protocol dispatch the codec removed — or worse, emits
    bytes a peer's negotiated decoder will not recognize.  Encode
    through ``wire.encode_message_schema``/``wire.encode_message``;
    legacy transport framing sites are grandfathered in the allowlist.

UL009  metric-name-convention
    A metric registered at a ``registry.counter/gauge/histogram(...)``
    call site (any receiver, first argument a string literal) whose
    name does not carry the ``uigc_`` prefix, or — for counters and
    histograms — no unit suffix (``_seconds``/``_bytes``/``_total``/
    ``_ratio``).  Gauges are exempt from the unit suffix (a gauge's
    unit is its referent: actors, frames, phi), but not the prefix.
    Unprefixed names collide in shared Prometheus scrapes; unitless
    names make dashboards guess.  Registrations built from a non-literal
    first argument are not linted (nothing to check statically).

UL011  unguarded-host-transfer
    A device->host crossing idiom (``jax.device_get(...)``, a zero-arg
    ``.item()`` call, or ``np.asarray(x)`` WITHOUT a ``dtype=`` keyword
    — the dtype'd form is the host list-conversion idiom, the bare form
    is how device arrays get read back; and PyTorch's: ``.cpu()``,
    ``.cpu().numpy()``, ``torch.cuda.synchronize()``, an event's or a
    stream's ``.synchronize()``, and ``.tolist()`` / ``int()`` /
    ``float()`` / ``bool()`` of a subscript where the file shows the
    operand is a tensor) in a module under ``engines/``,
    ``ops/`` or ``parallel/`` with no ``# readback:`` annotation on the
    line.  Stray transfers on collector hot paths serialize the device
    pipeline and dodge the observatory's transfer accounting
    (uigc_tpu_torch/telemetry/device.py); deliberate crossings route through
    ``engines/crgc/arrays._readback`` (accounted) or carry a
    ``# readback: <why>`` annotation.  Legacy conversion sites in the
    ops layer are grandfathered in the allowlist.

UL008  inspector-mutates-engine-state
    Snapshot/inspect code (``uigc_tpu_torch/telemetry/inspect.py``) broke its
    read-only contract.  The liveness inspector observes the collector's
    graph from foreign threads (HTTP handlers, link receive threads, the
    CLI); any mutation it performed would race the collector fold and
    corrupt liveness state — so the module must not (a) import
    ``uigc_tpu_torch.engines``/``uigc_tpu_torch.runtime`` at runtime (TYPE_CHECKING-
    gated imports are fine: duck-typed access only), (b) store through an
    attribute whose root object is not ``self`` (its own recorder/
    watchdog state is fair game, a graph/cell/system handle is not), or
    (c) call an engine mutator (``trace``/``merge_*``/``start_wave``/
    ``tell``/``stop``/``collect``/``send_frame``/...).  Capture
    *enablement* is engine state and lives with the engine
    (``Telemetry.attach``, ``engines/crgc/collector.py``).

UL016  pickle-in-gateway
    A direct ``pickle.*``/``marshal.*`` serializer call anywhere under
    ``uigc_tpu_torch/gateway/``.  The ingress gateway sits on the untrusted
    side of the trust boundary: client bytes must only ever meet the
    closed client value codec (``schema.encode_client_value`` /
    ``decode_client_value`` — no code loading, bounded depth/size),
    and node-plane replies cross back through ``runtime/wire.py``
    helpers.  A code-loading deserializer in gateway code is one
    routing bug away from running on attacker-controlled bytes, so it
    is banned outright there (the static half of uigc-check's UC401
    reachability rule).

Suppression
===========

Append ``# uigc-lint: disable=UL001`` (comma-separate several codes,
or ``disable=all``) to the offending line.  Legacy violations are
grandfathered in an allowlist file (default: ``uigc_lint_allow.txt``
next to this module) of ``path:RULE:count`` budget lines — ``--strict``
fails only on violations beyond the budget, so new code stays clean
while old debt is burned down deliberately.

Exit status: 0 when clean, within budget, or running advisory (no
``--strict``); 1 on new violations under ``--strict``; 2 usage error.
"""


# ------------------------------------------------------------------- #
# A thin wrapper over the shared single-parse framework in
# uigc_tpu_torch/analysis/check/: `python -m
# uigc_tpu_torch.tools.uigc_check --rules 'UL*' ...` runs the same pass
# with the same verdicts.
# ------------------------------------------------------------------- #

import os
import sys
from typing import Iterable, List

from uigc_tpu_torch.analysis.check import core as _core
from uigc_tpu_torch.analysis.check import lint_rules as _lint_rules

#: structured finding; uigc-check calls the same type Diagnostic
Violation = _core.Diagnostic
RULES = _lint_rules.RULES

iter_py_files = _core.iter_py_files
_load_allowlist = _core.load_allowlist
apply_allowlist = _core.apply_allowlist


def lint_paths(
    paths: Iterable[str],
    lint_asserts: bool = True,
) -> List[Violation]:
    files, errors = _core.parse_paths(paths)
    return list(errors) + _lint_rules.run_lint(files, lint_asserts=lint_asserts)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="uigc-lint", description=__doc__.splitlines()[0]
    )
    parser.add_argument("paths", nargs="+", help="files or directories to lint")
    parser.add_argument(
        "--strict",
        action="store_true",
        help="exit nonzero on violations beyond the allowlist budget "
        "(the default run is advisory: report, exit 0)",
    )
    parser.add_argument(
        "--allowlist",
        default=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "uigc_lint_allow.txt"
        ),
        help="path:RULE:count budget file (default: uigc_lint_allow.txt "
        "next to this script)",
    )
    parser.add_argument(
        "--no-allowlist", action="store_true", help="ignore the allowlist"
    )
    parser.add_argument(
        "--select",
        default="",
        help="comma-separated rule codes to report (default: all)",
    )
    args = parser.parse_args(argv)

    violations = lint_paths(args.paths)
    if args.select:
        wanted = {c.strip().upper() for c in args.select.split(",")}
        violations = [v for v in violations if v.rule in wanted]
    budget = {} if args.no_allowlist else _load_allowlist(args.allowlist)
    grandfathered, fresh = apply_allowlist(violations, budget)

    for v in fresh:
        print(v.render())
    if grandfathered:
        print(
            f"uigc-lint: {len(grandfathered)} grandfathered violation(s) "
            f"suppressed by allowlist",
            file=sys.stderr,
        )
    if fresh:
        print(f"uigc-lint: {len(fresh)} new violation(s)", file=sys.stderr)
        return 1 if args.strict else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
