"""Port of ``uigc_tpu/telemetry/inspect.py``, held against it by
``tests/test_torch_inspect.py``.  What differs from the reference: on a
device backend the on-demand why-live derivation runs
``ops/cuda_trace.py:marking_parents_torch`` on the graph's device (the
reference runs ``pallas_trace.marking_parents_jax``), which hands mark
and parent back as host arrays for the chain walk.  The parents are
exact, so the chains equal the reference's.

Liveness inspector: why-live paths, flight recorder, leak watchdog.

The collector answers "is this actor garbage"; this module answers the
production question that follows every un-collected actor — *why is it
still live*.  Three parts:

- **Why-live paths.**  Any live actor is explained as a concrete
  pseudoroot→actor retaining chain with per-hop provenance (a
  positive-weight created-ref edge or a supervisor pointer) resolved
  from the marking-parent forest: either the verdict-exact array a
  capture-enabled wake stored on the graph (``last_parents``,
  engines/crgc/{arrays,shadow}.py), or an on-demand derivation through
  the same kernels (``ops/trace.py trace_marks_np_parents`` on host,
  ``ops/cuda_trace.py marking_parents_torch`` on device).

- **Flight recorder + leak watchdog.**  Versioned shadow-graph
  snapshots (names, flags, recv counts, edges, mailbox depth/idle, the
  accumulated send matrix) captured on demand, on ``collect()`` cadence
  or on crash, with wave-over-wave retained-set diffing; the watchdog
  flags actors that survive N waves with zero traffic and emits
  structured ``telemetry.leak_suspect`` events.

- **Cross-node merge.**  Snapshots from every cluster node merge into
  one graph keyed by stable ``address#uid`` actor keys; the transport
  side (the ``"snap"`` NodeFabric frame) is injected as callables by
  ``telemetry.Telemetry`` so this module stays transport-free.

Read-only by contract: this module observes engine state and never
mutates it — no attribute stores outside its own objects, no calls into
engine mutators, and no runtime imports of ``uigc_tpu.engines`` /
``uigc_tpu.runtime`` (enforced by lint rule UL008, tools/uigc_lint.py).
Capture *enablement* (``capture_parents``, ``send_matrix``) is engine
state and therefore lives with the engine: the collector gates it per
wake, ``Telemetry.attach`` switches it on.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..utils import events

SNAPSHOT_VERSION = 1

#: flag bits mirrored from ops/trace.py, kept literal so this module
#: needs no engine import (UL008); parity-asserted in tests/test_inspect.
_FLAG_ROOT = 1
_FLAG_BUSY = 2
_FLAG_INTERNED = 4
_FLAG_LOCAL = 8
_FLAG_HALTED = 16
_FLAG_IN_USE = 32


def _cell_key(cell: Any) -> str:
    """Stable cross-node actor key: ``address#uid``.  Both real cells
    and transport proxies carry ``system.address`` and ``uid``, and the
    pair survives serialization — the merge key for cluster snapshots."""
    return f"{cell.system.address}#{cell.uid}"


def _cell_name(cell: Any) -> str:
    path = getattr(cell, "path", "") or ""
    return path or _cell_key(cell)


def _actor_record(
    key: str,
    name: str,
    location: Optional[str],
    flags: int,
    recv: int,
    cell: Any = None,
) -> Dict[str, Any]:
    rec: Dict[str, Any] = {
        "key": key,
        "name": name,
        "location": location,
        "recv_count": int(recv),
        "root": bool(flags & _FLAG_ROOT),
        "busy": bool(flags & _FLAG_BUSY),
        "interned": bool(flags & _FLAG_INTERNED),
        "local": bool(flags & _FLAG_LOCAL),
        "halted": bool(flags & _FLAG_HALTED),
    }
    rec["pseudoroot"] = (
        rec["root"] or rec["busy"] or rec["recv_count"] != 0
        or not rec["interned"]
    ) and not rec["halted"]
    mailbox = getattr(cell, "mailbox_size", None)
    idle = getattr(cell, "idle_seconds", None)
    if callable(mailbox):
        try:
            rec["mailbox"] = int(mailbox())
        except Exception:
            pass
    if callable(idle):
        try:
            rec["idle_s"] = round(float(idle()), 6)
        except Exception:
            pass
    return rec


# ------------------------------------------------------------------- #
# Snapshots
# ------------------------------------------------------------------- #


def _snapshot_array_graph(
    graph: Any, out: Dict[str, Any], lean: bool = False
) -> None:
    """Extract an ArrayShadowGraph (or subclass).  Tolerant of a
    concurrent fold on the collector thread: arrays are re-referenced
    locally, lengths clipped, and a torn dict iteration retried — the
    snapshot is a consistent-enough observation, never a crash."""
    for _attempt in range(8):
        try:
            slot_items = list(graph.slot_of.items())
            break
        except RuntimeError:  # dict mutated mid-iteration
            continue
    else:  # pragma: no cover - pathological churn
        slot_items = []
    flags = graph.flags
    recv = graph.recv_count
    sup = graph.supervisor
    cells = graph.cells
    locations = graph.locations
    n = min(len(flags), len(recv), len(sup), len(cells), len(locations))

    actors: Dict[str, Dict[str, Any]] = {}
    key_of_slot: Dict[int, str] = {}
    for cell, slot in slot_items:
        if slot >= n:
            continue
        key = _cell_key(cell)
        key_of_slot[slot] = key
        actors[key] = _actor_record(
            key,
            _cell_name(cell),
            locations[slot],
            int(flags[slot]),
            int(recv[slot]),
            cell=cell,
        )

    edges: List[List[Any]] = []
    ew = graph.edge_weight
    esrc = graph.edge_src
    edst = graph.edge_dst
    m = min(len(ew), len(esrc), len(edst))
    nz = np.nonzero(np.asarray(ew[:m]) != 0)[0]
    for eid in nz.tolist():
        src_key = key_of_slot.get(int(esrc[eid]))
        dst_key = key_of_slot.get(int(edst[eid]))
        if src_key is not None and dst_key is not None:
            edges.append([src_key, dst_key, int(ew[eid])])

    supervisors: List[List[str]] = []
    if not lean:
        for slot, key in key_of_slot.items():
            parent = int(sup[slot])
            if parent >= 0:
                parent_key = key_of_slot.get(parent)
                if parent_key is not None:
                    supervisors.append([key, parent_key])

    send_rows: List[List[Any]] = []
    sm = graph.send_matrix
    if sm and not lean:
        for packed, count in list(sm.items()):
            src_key = key_of_slot.get(packed >> 32)
            dst_key = key_of_slot.get(packed & 0xFFFFFFFF)
            if src_key is not None and dst_key is not None:
                send_rows.append([src_key, dst_key, int(count)])

    out["actors"] = actors
    out["edges"] = edges
    out["supervisors"] = supervisors
    out["send_matrix"] = send_rows


def _snapshot_oracle_graph(graph: Any, out: Dict[str, Any]) -> None:
    """Extract the pointer-based oracle ShadowGraph."""
    for _attempt in range(8):
        try:
            shadows = list(graph.shadow_map.items())
            break
        except RuntimeError:
            continue
    else:  # pragma: no cover
        shadows = []
    actors: Dict[str, Dict[str, Any]] = {}
    key_of: Dict[int, str] = {}  # id(shadow) -> key
    for cell, shadow in shadows:
        key = _cell_key(cell)
        key_of[id(shadow)] = key
        flags = (
            (_FLAG_ROOT if shadow.is_root else 0)
            | (_FLAG_BUSY if shadow.is_busy else 0)
            | (_FLAG_INTERNED if shadow.interned else 0)
            | (_FLAG_LOCAL if shadow.is_local else 0)
            | (_FLAG_HALTED if shadow.is_halted else 0)
            | _FLAG_IN_USE
        )
        actors[key] = _actor_record(
            key, _cell_name(cell), shadow.location, flags,
            shadow.recv_count, cell=cell,
        )
    edges: List[List[Any]] = []
    supervisors: List[List[str]] = []
    for cell, shadow in shadows:
        key = key_of[id(shadow)]
        for target, count in list(shadow.outgoing.items()):
            dst_key = key_of.get(id(target))
            if dst_key is not None and count != 0:
                edges.append([key, dst_key, int(count)])
        if shadow.supervisor is not None:
            sup_key = key_of.get(id(shadow.supervisor))
            if sup_key is not None:
                supervisors.append([key, sup_key])
    send_rows: List[List[Any]] = []
    sm = graph.send_matrix
    if sm:
        for (src_cell, dst_cell), count in list(sm.items()):
            send_rows.append(
                [_cell_key(src_cell), _cell_key(dst_cell), int(count)]
            )
    out["actors"] = actors
    out["edges"] = edges
    out["supervisors"] = supervisors
    out["send_matrix"] = send_rows


def snapshot_graph(
    graph: Any, node: str = "", wave: Optional[int] = None,
    reason: str = "demand", lean: bool = False,
) -> Dict[str, Any]:
    """One versioned, JSON-able shadow-graph snapshot.  Duck-typed over
    the backends: dense-slot graphs expose ``slot_of``/flat arrays, the
    oracle exposes ``shadow_map``; anything else yields an ``actors``-
    less document with whatever diagnostics the backend has.  ``lean``
    skips the send matrix and supervisor list — enough for the
    watchdog's per-wave sampling at a fraction of the extraction
    cost."""
    out: Dict[str, Any] = {
        "version": SNAPSHOT_VERSION,
        "node": node,
        "wave": wave,
        "t": time.time(),
        "reason": reason,
    }
    if hasattr(graph, "slot_of") and hasattr(graph, "edge_weight"):
        _snapshot_array_graph(graph, out, lean=lean)
    elif hasattr(graph, "shadow_map"):
        _snapshot_oracle_graph(graph, out)
    else:
        out["actors"] = {}
        out["edges"] = []
        out["supervisors"] = []
        out["send_matrix"] = []
        out["unsupported_backend"] = type(graph).__name__
    actors = out["actors"]
    out["summary"] = {
        "actors": len(actors),
        "edges": len(out["edges"]),
        "pseudoroots": sum(1 for a in actors.values() if a["pseudoroot"]),
        "halted": sum(1 for a in actors.values() if a["halted"]),
    }
    return out


def merge_snapshots(
    snaps: List[Dict[str, Any]], missing: Optional[List[str]] = None
) -> Dict[str, Any]:
    """Merge per-node snapshots into one cluster graph.

    Actors: the home node's record (``local=True``) wins over remote
    proxy records of the same ``address#uid`` key.  Edges: an edge is
    recorded where its *owner* folds entries, so the record from the
    source actor's home node wins; others fill gaps.  Send matrix: each
    send is recorded only on the sender's home collector, so rows merge
    by max (a duplicate key can only be the same fact seen twice)."""
    merged: Dict[str, Any] = {
        "version": SNAPSHOT_VERSION,
        "merged": True,
        "t": time.time(),
        "nodes": [s.get("node", "?") for s in snaps],
        "missing_nodes": list(missing or []),
    }
    actors: Dict[str, Dict[str, Any]] = {}
    edges: Dict[tuple, List[Any]] = {}
    edge_home: Dict[tuple, bool] = {}
    supervisors: Dict[str, str] = {}
    send: Dict[tuple, int] = {}
    for snap in snaps:
        node = snap.get("node", "?")
        for key, rec in snap.get("actors", {}).items():
            have = actors.get(key)
            if have is None or (rec.get("local") and not have.get("local")):
                actors[key] = dict(rec, reported_by=node)
        for src, dst, weight in snap.get("edges", []):
            pair = (src, dst)
            is_home = src.split("#", 1)[0] == node
            if pair not in edges or (is_home and not edge_home[pair]):
                edges[pair] = [src, dst, weight]
                edge_home[pair] = is_home
        for child, parent in snap.get("supervisors", []):
            supervisors.setdefault(child, parent)
        for src, dst, count in snap.get("send_matrix", []):
            pair = (src, dst)
            send[pair] = max(send.get(pair, 0), int(count))
    merged["actors"] = actors
    merged["edges"] = list(edges.values())
    merged["supervisors"] = [[c, p] for c, p in supervisors.items()]
    merged["send_matrix"] = [[s, d, n] for (s, d), n in send.items()]
    merged["summary"] = {
        "actors": len(actors),
        "edges": len(merged["edges"]),
        "pseudoroots": sum(1 for a in actors.values() if a["pseudoroot"]),
        "halted": sum(1 for a in actors.values() if a["halted"]),
    }
    return merged


def diff_snapshots(old: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Wave-over-wave retained-set diff: who appeared, who was
    reclaimed, who is still being retained — the flight recorder's unit
    of explanation."""
    old_actors = old.get("actors", {})
    new_actors = new.get("actors", {})
    added = sorted(set(new_actors) - set(old_actors))
    removed = sorted(set(old_actors) - set(new_actors))
    retained = sorted(set(old_actors) & set(new_actors))
    quiet = [
        key
        for key in retained
        if new_actors[key]["recv_count"] == old_actors[key]["recv_count"]
        and not new_actors[key]["busy"]
        and not new_actors[key]["root"]
    ]
    return {
        "from_wave": old.get("wave"),
        "to_wave": new.get("wave"),
        "added": added,
        "removed": removed,
        "retained": len(retained),
        "quiet_retained": quiet,
    }


# ------------------------------------------------------------------- #
# Why-live paths
# ------------------------------------------------------------------- #


def _resolve_actor_key(snapshot: Dict[str, Any], actor: str) -> Optional[str]:
    actors = snapshot.get("actors", {})
    if actor in actors:
        return actor
    matches = [
        key
        for key, rec in actors.items()
        if rec.get("name") == actor or rec.get("name", "").endswith(actor)
    ]
    if len(matches) == 1:
        return matches[0]
    if matches:
        return sorted(matches)[0]
    return None


def _root_reasons(rec: Dict[str, Any]) -> List[str]:
    reasons = []
    if rec.get("root"):
        reasons.append("root")
    if rec.get("busy"):
        reasons.append("busy")
    if rec.get("recv_count"):
        reasons.append(f"undelivered messages (recv_count={rec['recv_count']})")
    if not rec.get("interned"):
        reasons.append("never interned (no entry folded yet)")
    return reasons


def why_live(snapshot: Dict[str, Any], actor: str) -> Dict[str, Any]:
    """Explain one actor against a snapshot: BFS from the pseudoroots
    over positive created-ref edges and supervisor pointers (halted
    actors absorb marks but never propagate — the exact trace
    semantics), tracking the first marker of every node.  Returns the
    pseudoroot→actor chain with per-hop provenance, or the verdict that
    the actor is collectable/unknown."""
    key = _resolve_actor_key(snapshot, actor)
    actors = snapshot.get("actors", {})
    if key is None:
        return {"actor": actor, "verdict": "unknown", "path": []}
    out_edges: Dict[str, List[tuple]] = {}
    for src, dst, weight in snapshot.get("edges", []):
        if weight > 0:
            out_edges.setdefault(src, []).append((dst, "created", weight))
    for child, parent in snapshot.get("supervisors", []):
        out_edges.setdefault(child, []).append((parent, "supervisor", None))

    parent_of: Dict[str, tuple] = {}
    frontier = deque(
        key for key, rec in actors.items() if rec["pseudoroot"]
    )
    seen = set(frontier)
    while frontier:
        cur = frontier.popleft()
        if actors.get(cur, {}).get("halted"):
            continue
        for dst, kind, weight in out_edges.get(cur, ()):
            if dst not in seen and dst in actors:
                seen.add(dst)
                parent_of[dst] = (cur, kind, weight)
                frontier.append(dst)

    rec = actors[key]
    result: Dict[str, Any] = {"actor": key, "name": rec.get("name")}
    if key not in seen:
        result["verdict"] = "collectable"
        result["path"] = []
        result["note"] = (
            "not reachable from any pseudoroot; the next collection "
            "wave that sees this state reclaims it"
        )
        return result
    chain: List[str] = [key]
    hops: List[Dict[str, Any]] = []
    cur = key
    while cur in parent_of:
        src, kind, weight = parent_of[cur]
        hop = {
            "from": src,
            "from_name": actors.get(src, {}).get("name"),
            "to": cur,
            "to_name": actors.get(cur, {}).get("name"),
            "kind": kind,
        }
        if weight is not None:
            hop["weight"] = weight
        hops.append(hop)
        chain.append(src)
        cur = src
    chain.reverse()
    hops.reverse()
    head = actors[chain[0]]
    result["verdict"] = "live"
    result["pseudoroot"] = chain[0]
    result["pseudoroot_name"] = head.get("name")
    result["root_reasons"] = _root_reasons(head)
    result["chain"] = chain
    result["path"] = hops
    return result


def why_live_from_parents(
    graph: Any, snapshot: Dict[str, Any], actor: str,
) -> Optional[Dict[str, Any]]:
    """Resolve a why-live chain from a marking-parent forest: the
    verdict-exact array a capture-enabled wake stored (``last_parents``)
    when fresh, else an on-demand derivation through the trace kernels
    (device or host to match the graph).  Returns None when the backend
    has no parent representation (callers fall back to snapshot BFS)."""
    slot_of = getattr(graph, "slot_of", None)
    flags = getattr(graph, "flags", None)
    if slot_of is None or flags is None:
        captured = getattr(graph, "last_parents", None)
        if isinstance(captured, dict):
            return _oracle_parents_chain(graph, snapshot, actor, captured)
        return None
    key = _resolve_actor_key(snapshot, actor)
    if key is None:
        return None
    target_slot = None
    for cell, slot in list(slot_of.items()):
        if _cell_key(cell) == key:
            target_slot = slot
            break
    if target_slot is None:
        return None

    key_of_slot = {slot: _cell_key(cell) for cell, slot in list(slot_of.items())}
    actors = snapshot.get("actors", {})
    edge_weights = {
        (esrc, edst): w
        for esrc, edst, w in snapshot.get("edges", [])
        if w > 0
    }
    sup_pairs = {tuple(pair) for pair in snapshot.get("supervisors", [])}

    def resolve(mark, parent, source):
        """Chain resolution against one (mark, parent) pair; None when
        the forest is inconsistent with current graph state (a stale
        capture: an actor interned or a slot recycled since that wake)
        so the caller can fall back to a fresh derivation."""
        if target_slot >= len(mark):
            return None  # interned after the capture
        if not mark[target_slot]:
            if source == "captured":
                # An unmarked slot in the CAPTURED array proves nothing
                # about now — a retaining edge (or the actor itself) may
                # have appeared since that wake.  Only a fresh
                # derivation may answer "collectable".
                return None
            if actors.get(key, {}).get("pseudoroot"):
                return None  # raced an intern mid-derivation: BFS decides
            return {
                "actor": key, "verdict": "collectable", "path": [],
                "parents": source,
            }
        chain_slots = [target_slot]
        cur = target_slot
        for _ in range(len(parent)):
            nxt = int(parent[cur]) if cur < len(parent) else -1
            if nxt < 0:
                break
            chain_slots.append(nxt)
            cur = nxt
        chain = [key_of_slot.get(s) for s in reversed(chain_slots)]
        if any(c is None for c in chain):
            return None  # a chain slot was freed/recycled since capture
        hops = []
        for src, dst in zip(chain, chain[1:]):
            kind = "created"
            weight = edge_weights.get((src, dst))
            if weight is None:
                if (src, dst) not in sup_pairs:
                    return None  # the retaining pair no longer exists
                kind = "supervisor"
            hop = {
                "from": src, "from_name": actors.get(src, {}).get("name"),
                "to": dst, "to_name": actors.get(dst, {}).get("name"),
                "kind": kind,
            }
            if weight is not None:
                hop["weight"] = weight
            hops.append(hop)
        head = actors.get(chain[0], {})
        if not head.get("pseudoroot"):
            return None  # the head stopped being a root since capture
        return {
            "actor": key,
            "name": actors.get(key, {}).get("name"),
            "verdict": "live",
            "parents": source,
            "pseudoroot": chain[0],
            "pseudoroot_name": head.get("name"),
            "root_reasons": _root_reasons(head),
            "chain": chain,
            "path": hops,
        }

    # Verdict-exact capture first — but validated against current graph
    # state, because the capture describes the LAST wake: actors spawned
    # or slots recycled since then must not inherit a stale verdict.
    parent = getattr(graph, "last_parents", None)
    mark = getattr(graph, "last_parents_mark", None)
    if parent is not None and mark is not None:
        result = resolve(mark, parent, "captured")
        if result is not None:
            return result
    if getattr(graph, "use_device", False):
        from ..ops import cuda_trace as _ct

        mark, parent = _ct.marking_parents_torch(
            graph.flags, graph.recv_count, graph.supervisor,
            graph.edge_src, graph.edge_dst, graph.edge_weight,
            device=graph.device,
        )
    else:
        from ..ops import trace as _tr

        mark, parent = _tr.trace_marks_np_parents(
            graph.flags, graph.recv_count, graph.supervisor,
            graph.edge_src, graph.edge_dst, graph.edge_weight,
        )
    return resolve(np.asarray(mark), np.asarray(parent), "derived")


def _oracle_parents_chain(
    graph: Any, snapshot: Dict[str, Any], actor: str, captured: Dict[Any, tuple]
) -> Optional[Dict[str, Any]]:
    """Chain resolution over the oracle's captured ``{cell: (parent,
    kind)}`` map."""
    key = _resolve_actor_key(snapshot, actor)
    if key is None:
        return None
    by_key = {_cell_key(c): c for c in graph.shadow_map}
    cell = by_key.get(key)
    if cell is None:
        return None
    chain_cells = [cell]
    kinds: List[str] = []
    cur = cell
    for _ in range(len(graph.shadow_map) + 1):
        hit = captured.get(cur)
        if hit is None:
            break
        parent_cell, kind = hit
        chain_cells.append(parent_cell)
        kinds.append(kind)
        cur = parent_cell
    chain = [_cell_key(c) for c in reversed(chain_cells)]
    kinds.reverse()
    actors = snapshot.get("actors", {})
    hops = [
        {
            "from": src, "from_name": actors.get(src, {}).get("name"),
            "to": dst, "to_name": actors.get(dst, {}).get("name"),
            "kind": kind,
        }
        for (src, dst), kind in zip(zip(chain, chain[1:]), kinds)
    ]
    head = actors.get(chain[0], {})
    return {
        "actor": key,
        "name": actors.get(key, {}).get("name"),
        "verdict": "live",
        "parents": "captured",
        "pseudoroot": chain[0],
        "pseudoroot_name": head.get("name"),
        "root_reasons": _root_reasons(head) if head else [],
        "chain": chain,
        "path": hops,
    }


def validate_why_live(snapshot: Dict[str, Any], result: Dict[str, Any]) -> List[str]:
    """Self-check a why-live result against its snapshot: the head must
    be a pseudoroot, every hop must be a real positive edge or a
    supervisor pointer, no intermediate hop may leave a halted actor,
    and the chain must end at the target.  Returns human-readable
    problems (empty = valid) — the `graph_inspect selfcheck` core."""
    problems: List[str] = []
    if result.get("verdict") != "live":
        return problems
    actors = snapshot.get("actors", {})
    chain = result.get("chain", [])
    if not chain:
        return ["live verdict with an empty chain"]
    head = actors.get(chain[0])
    if head is None:
        problems.append(f"chain head {chain[0]} not in snapshot")
    elif not head["pseudoroot"]:
        problems.append(f"chain head {chain[0]} is not a pseudoroot")
    if chain[-1] != result.get("actor"):
        problems.append("chain does not end at the target actor")
    edge_set = {
        (src, dst): weight
        for src, dst, weight in snapshot.get("edges", [])
        if weight > 0
    }
    sup_set = {tuple(pair) for pair in snapshot.get("supervisors", [])}
    for hop in result.get("path", []):
        src, dst, kind = hop["from"], hop["to"], hop["kind"]
        src_rec = actors.get(src)
        if src_rec is not None and src_rec["halted"]:
            problems.append(f"hop {src} -> {dst} propagates from a halted actor")
        if kind == "created":
            if (src, dst) not in edge_set:
                problems.append(f"hop {src} -> {dst}: no positive created edge")
        elif kind == "supervisor":
            if (src, dst) not in sup_set:
                problems.append(f"hop {src} -> {dst}: no supervisor pointer")
        else:
            problems.append(f"hop {src} -> {dst}: unknown kind {kind!r}")
    return problems


# ------------------------------------------------------------------- #
# Flight recorder + leak watchdog
# ------------------------------------------------------------------- #


class FlightRecorder:
    """Bounded ring of versioned snapshots with retained-set diffing."""

    def __init__(self, keep: int = 8):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, keep))
        self._versions = 0

    def record(self, snapshot: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._versions += 1
            snapshot = dict(snapshot, recorder_version=self._versions)
            self._ring.append(snapshot)
        return snapshot

    def snapshots(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def diffs(self) -> List[Dict[str, Any]]:
        snaps = self.snapshots()
        return [
            diff_snapshots(old, new) for old, new in zip(snaps, snaps[1:])
        ]

    def to_json(self) -> Dict[str, Any]:
        snaps = self.snapshots()
        return {
            "bench": "flight_recorder",
            "versions": self._versions,
            "snapshots": snaps,
            "diffs": [
                diff_snapshots(old, new)
                for old, new in zip(snaps, snaps[1:])
            ],
        }

    def dump(self, path: str) -> Dict[str, Any]:
        doc = self.to_json()
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, default=repr)
        return doc


class LeakWatchdog:
    """Flag actors that survive ``waves`` consecutive collection waves
    with zero traffic: recv balance unchanged, mailbox empty, not busy,
    not a root.  Suspicion resets on any traffic; each suspect is
    reported once per quiet streak (re-armed by traffic).

    ``min_idle_s`` is the wall-clock floor: an actor is only flagged
    once its idle clock also exceeds it, so fast collector cadences
    (waves every few ms) cannot outrun a workload's ordinary
    inter-message gaps.  The attach wiring sets it to
    ``waves * wakeup-interval`` by default."""

    def __init__(self, waves: int = 3, min_idle_s: float = 0.0):
        self.waves = max(1, int(waves))
        self.min_idle_s = max(0.0, float(min_idle_s))
        #: key -> [streak, last_recv, reported?, last_idle_s]
        self._state: Dict[str, List[Any]] = {}

    def observe(self, snapshot: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Feed one per-wave snapshot; returns the suspects newly
        crossing the threshold this wave."""
        suspects: List[Dict[str, Any]] = []
        seen = set()
        retained_by: Dict[str, str] = {}
        for src, dst, weight in snapshot.get("edges", []):
            if weight > 0:
                retained_by.setdefault(dst, src)
        for key, rec in snapshot.get("actors", {}).items():
            seen.add(key)
            state = self._state.get(key)
            if state is None:
                self._state[key] = [
                    0, rec["recv_count"], False, rec.get("idle_s"),
                ]
                continue
            # Mailbox activity between waves shows as an idle-clock
            # reset (idle_seconds shrinks); an untouched actor's idle
            # only grows.  recv balances net to zero at quiescence, so
            # the balance alone cannot distinguish periodic traffic
            # from none — the idle clock can.
            idle = rec.get("idle_s")
            touched = (
                idle is not None
                and state[3] is not None
                and idle < state[3]
            )
            state[3] = idle
            quiet = (
                not touched
                and rec["recv_count"] == state[1]
                and not rec["busy"]
                and not rec["root"]
                and not rec["halted"]
                and rec.get("mailbox", 0) == 0
            )
            if quiet:
                state[0] += 1
                idle_enough = idle is None or idle >= self.min_idle_s
                if state[0] >= self.waves and idle_enough and not state[2]:
                    state[2] = True
                    suspects.append(
                        {
                            "actor": key,
                            "name": rec.get("name"),
                            "waves": state[0],
                            "recv_count": rec["recv_count"],
                            "idle_s": rec.get("idle_s"),
                            "retained_by": retained_by.get(key),
                        }
                    )
            else:
                state[0] = 0
                state[1] = rec["recv_count"]
                state[2] = False
        for key in list(self._state):
            if key not in seen:
                del self._state[key]  # collected: no longer suspect
        return suspects

    def suspects(self) -> List[str]:
        return sorted(
            key for key, st in self._state.items() if st[2]
        )


# ------------------------------------------------------------------- #
# The per-system inspector (composition root for the parts above)
# ------------------------------------------------------------------- #


class LivenessInspector:
    """Read-only window into one system's collector.  Attached by
    ``telemetry.Telemetry`` (``uigc.telemetry.inspect``); the collector
    calls :meth:`on_wake` once per wake on its own thread."""

    def __init__(
        self,
        node: str,
        graph_fn: Callable[[], Any],
        snapshot_every: int = 0,
        snapshot_keep: int = 8,
        leak_waves: int = 3,
        leak_min_idle_s: float = 0.0,
        parent_capture: bool = False,
        dump_path: str = "",
    ):
        self.node = node
        self._graph_fn = graph_fn
        self.snapshot_every = max(0, int(snapshot_every))
        self.recorder = FlightRecorder(keep=snapshot_keep)
        self.watchdog = (
            LeakWatchdog(waves=leak_waves, min_idle_s=leak_min_idle_s)
            if leak_waves
            else None
        )
        #: gate consumed by the collector each wake (engines/crgc/
        #: collector.py): verdict-exact marking-parent capture.
        self.parent_capture = bool(parent_capture)
        self.dump_path = dump_path
        self.wave = 0
        self.leak_suspects_total = 0
        self._lock = threading.Lock()
        # Cross-node exchange plumbing, injected by Telemetry when the
        # system sits on a NodeFabric (bind_fabric); None = single node.
        self._peers_fn: Optional[Callable[[], List[str]]] = None
        self._send_request: Optional[Callable[[str, int], Any]] = None
        self._send_response: Optional[Callable[[str, int, bytes], Any]] = None
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._req_counter = 0

    # -- graph access ------------------------------------------------- #

    def graph(self) -> Any:
        return self._graph_fn()

    def snapshot(self, reason: str = "demand") -> Dict[str, Any]:
        return snapshot_graph(
            self.graph(), node=self.node, wave=self.wave, reason=reason
        )

    def why_live(self, actor: str) -> Dict[str, Any]:
        """Why-live through the parent forest when the backend has one
        (device-computed on device graphs), snapshot BFS otherwise."""
        snap = self.snapshot(reason="why-live")
        graph = self.graph()
        result = None
        try:
            result = why_live_from_parents(graph, snap, actor)
        except Exception:
            result = None  # fall back to the snapshot derivation
        if result is None:
            result = why_live(snap, actor)
        result["node"] = self.node
        return result

    # -- collector-wake hook (collector thread) ----------------------- #

    def on_wake(self, graph: Any, entries: int, garbage: int) -> None:
        self.wave += 1
        need_watchdog = self.watchdog is not None
        need_ring = (
            self.snapshot_every and self.wave % self.snapshot_every == 0
        )
        if not (need_watchdog or need_ring):
            return
        # Watchdog-only waves take the lean extraction (no send matrix
        # or supervisor list): it samples per-actor scalars + retaining
        # edges, and it runs every wake.
        snap = snapshot_graph(
            graph, node=self.node, wave=self.wave, reason="wake",
            lean=not need_ring,
        )
        if need_ring:
            self.recorder.record(snap)
            if events.recorder.enabled:
                events.recorder.commit(
                    events.SNAPSHOT,
                    node=self.node,
                    wave=self.wave,
                    reason="wake",
                    actors=snap["summary"]["actors"],
                    edges=snap["summary"]["edges"],
                )
        if need_watchdog:
            for suspect in self.watchdog.observe(snap):
                self.leak_suspects_total += 1
                if events.recorder.enabled:
                    fields = dict(suspect, node=self.node)
                    # "name" is the commit() event-name positional.
                    fields["actor_name"] = fields.pop("name", None)
                    events.recorder.commit(events.LEAK_SUSPECT, **fields)

    def on_crash(self, reason: str = "crash") -> None:
        """Crash-path dump: best-effort snapshot + ring flush to the
        configured path (wired to the fabric's crash event by
        Telemetry)."""
        if not self.dump_path:
            return
        try:
            self.recorder.record(self.snapshot(reason=reason))
            self.recorder.dump(self.dump_path)
        except Exception:
            pass  # a crash dump must never make the crash worse

    # -- cross-node merge --------------------------------------------- #

    def bind_fabric(
        self,
        peers_fn: Callable[[], List[str]],
        send_request: Callable[[str, int], Any],
        send_response: Callable[[str, int, bytes], Any],
    ) -> None:
        self._peers_fn = peers_fn
        self._send_request = send_request
        self._send_response = send_response

    def on_snap_frame(
        self, from_address: str, kind: str, req_id: int, origin: str,
        payload: Optional[bytes],
    ) -> None:
        """Decoded ``"snap"`` frame (runtime/wire.py codec; decode and
        dispatch are wired by Telemetry so this module stays
        transport-free).  Runs on the link's receive thread."""
        if kind == "req":
            if self._send_response is None:
                return
            body = json.dumps(
                self.snapshot(reason="peer-request"), default=repr
            ).encode()
            self._send_response(origin, req_id, body)
        elif kind == "rsp":
            with self._lock:
                pending = self._pending.get(req_id)
                if pending is None:
                    return
                try:
                    pending["snaps"][origin] = json.loads(payload or b"{}")
                except ValueError:
                    pending["bad"].append(origin)
                if set(pending["snaps"]) | set(pending["bad"]) >= pending["want"]:
                    pending["done"].set()

    def merged_snapshot(self, timeout_s: float = 2.0) -> Dict[str, Any]:
        """One merged cluster graph: local snapshot plus a ``"snap"``
        round-trip to every live peer.  A peer whose response never
        lands (dropped frame, dead link) is listed in
        ``missing_nodes`` — the merge degrades, never blocks past the
        timeout."""
        local = self.snapshot(reason="merge")
        if self._peers_fn is None or self._send_request is None:
            return merge_snapshots([local])
        peers = [p for p in self._peers_fn() if p != self.node]
        if not peers:
            return merge_snapshots([local])
        with self._lock:
            self._req_counter += 1
            req_id = self._req_counter
            pending = {
                "snaps": {},
                "bad": [],
                "want": set(peers),
                "done": threading.Event(),
            }
            self._pending[req_id] = pending
        try:
            for peer in peers:
                try:
                    self._send_request(peer, req_id)
                except Exception:
                    pass  # counted as missing below
            pending["done"].wait(timeout_s)
        finally:
            with self._lock:
                self._pending.pop(req_id, None)
        snaps = [local] + list(pending["snaps"].values())
        missing = sorted(
            set(peers) - set(pending["snaps"])
        )
        return merge_snapshots(snaps, missing=missing)

    # -- HTTP faces (exporter.MetricsHTTPServer) ---------------------- #

    def snapshot_json(self, merged: bool = False) -> str:
        doc = self.merged_snapshot() if merged else self.snapshot(
            reason="http"
        )
        return json.dumps(doc, default=repr)

    def why_live_json(self, actor: str) -> str:
        return json.dumps(self.why_live(actor), default=repr)

    def to_json(self) -> Dict[str, Any]:
        return {
            "node": self.node,
            "wave": self.wave,
            "leak_suspects_total": self.leak_suspects_total,
            "current_suspects": (
                self.watchdog.suspects() if self.watchdog else []
            ),
            "flight_recorder": self.recorder.to_json(),
        }
