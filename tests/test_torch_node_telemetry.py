"""Telemetry's and the sanitizer's cross-node paths on the port's TCP
node transport (``uigc_tpu_torch/runtime/node.py``): the counterparts of
the reference's NodeFabric tests in ``tests/test_telemetry.py``,
``tests/test_timeseries.py``, ``tests/test_inspect.py`` and
``tests/test_analysis.py`` (``test_sanitizer_clean_two_nodes[node]``).

- A send span on node A is the causal parent of the invoke span on node
  B (the trace header rides the frame); a peer with tracing off ignores
  the header and still delivers.
- ``merge_series_docs`` gives the reference's document on the same
  per-node inputs; a refused ``tsq`` send folds into ``missing_nodes``
  at once; over two live NodeFabrics ``merged()`` folds both nodes'
  series through ``tsq``/``tsr`` frames and names a dead peer.
- The liveness inspector merges two nodes' snapshots over ``snap``
  frames and explains a remote actor; a seeded drop of every ``snap``
  frame degrades to a partial graph naming the missing node.
- The sanitizer stays clean on a two-node NodeFabric workload.
"""

import copy
import json
import time

import pytest

from uigc_tpu.telemetry import timeseries as ref_timeseries
from uigc_tpu_torch import AbstractBehavior, Behaviors, Message, NoRefs
from uigc_tpu_torch.runtime.behaviors import RawBehavior
from uigc_tpu_torch.runtime.faults import FaultPlan
from uigc_tpu_torch.runtime.node import NodeFabric
from uigc_tpu_torch.runtime.system import ActorSystem
from uigc_tpu_torch.runtime.testkit import TestProbe
from uigc_tpu_torch.telemetry import timeseries as port_timeseries
from uigc_tpu_torch.telemetry.inspect import validate_why_live, why_live


class _Probe:
    def __init__(self, probe):
        self.ref = probe


class _ProbeForwarder(RawBehavior):
    def __init__(self, probe):
        self.probe = probe

    def on_message(self, msg):
        self.probe._offer(msg)
        return None


class _Ping(NoRefs):
    pass


class _Spawned(NoRefs):
    def __init__(self, name):
        self.name = name


class _Give(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,) if self.ref is not None else ()


class _RemoteWorker(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        probe.ref.tell(_Spawned(context.name))

    def on_message(self, msg):
        return self


class _Driver(AbstractBehavior):
    """Root on node A pinging a worker that lives on node B."""

    def __init__(self, context, remote):
        super().__init__(context)
        self.remote = remote

    def on_message(self, msg):
        if isinstance(msg, _Ping):
            self.remote.tell(_Ping(), self.context)
        return self


class _Worker(AbstractBehavior):
    def on_message(self, msg):
        return self


class _Keeper(AbstractBehavior):
    def __init__(self, context):
        super().__init__(context)
        self.held = []

    def on_message(self, msg):
        if isinstance(msg, _Give) and msg.ref is not None:
            self.held.append(msg.ref)
        return self


class _ChainRoot(AbstractBehavior):
    """root -> keeper -> kept: after the hand-off the kept actor is
    retained only through the keeper (a two-hop why-live chain)."""

    def __init__(self, context):
        super().__init__(context)
        self.keeper = context.spawn(Behaviors.setup(_Keeper), "keeper")
        self.kept = context.spawn(Behaviors.setup(_Worker), "kept")
        self.workers = [context.spawn(Behaviors.setup(_Worker), f"w{i}")
                        for i in range(3)]

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, _Give):
            self.keeper.tell(_Give(ctx.create_ref(self.kept, self.keeper)), ctx)
            ctx.release(self.kept)
            self.kept = None
        elif isinstance(msg, _Ping):
            for worker in self.workers:
                worker.tell(_Ping(), ctx)
        return self


def _spawn_node(name, num_nodes, overrides=None, fault_plan=None):
    config = {
        "uigc.crgc.wakeup-interval": 10,
        "uigc.crgc.egress-finalize-interval": 5,
        "uigc.crgc.num-nodes": num_nodes,
    }
    config.update(overrides or {})
    fabric = NodeFabric(fault_plan=fault_plan)
    system = ActorSystem(None, name=name, config=config, fabric=fabric)
    return fabric, system, fabric.listen()


def _terminate_all(*systems):
    for system in systems:
        try:
            system.terminate(timeout_s=5.0)
        except Exception:
            pass


def _settle(pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# --------------------------------------------------------------------- #
# Causal tracing across processes' wire
# --------------------------------------------------------------------- #


TRACING = {"uigc.telemetry.tracing": True}


def test_trace_id_propagates_across_node_fabric():
    fa, sa, _ = _spawn_node("ptrca", 2, TRACING)
    fb, sb, pb = _spawn_node("ptrcb", 2, TRACING)
    try:
        fa.connect("127.0.0.1", pb)
        probe = TestProbe(default_timeout_s=20.0)
        probe_cell = sb.spawn_system_raw(_ProbeForwarder(probe), "probe-fwd")
        worker = sb.spawn_root(Behaviors.setup_root(
            lambda ctx: _RemoteWorker(ctx, _Probe(probe_cell))), "worker")
        proxy = fa._proxy(sb.address, worker.cell.uid)
        driver = sa.spawn_root(Behaviors.setup_root(
            lambda ctx: _Driver(ctx, ctx.engine.to_root_refob(proxy))), "driver")
        probe.expect_message_type(_Spawned)
        for _ in range(10):
            driver.tell(_Ping())

        def linked():
            sends = [s for s in sa.telemetry.tracer.spans()
                     if s["name"] == "send"]
            ids = {s["span_id"] for s in sends}
            traces = {s["trace_id"] for s in sends}
            return [s for s in sb.telemetry.tracer.spans()
                    if s["name"] == "invoke" and s["trace_id"] in traces
                    and s["parent_id"] in ids]

        assert _settle(lambda: bool(linked()), 10.0), (
            "no invoke span on B causally linked to a send on A")
        assert linked()[0]["node"] == sb.address
    finally:
        _terminate_all(sa, sb)


def test_trace_header_ignored_by_peer_with_tracing_off():
    """A traces, B does not: B delivers the traffic (the header is
    ignored) and records nothing."""
    fa, sa, _ = _spawn_node("ptoffa", 2, TRACING)
    fb, sb, pb = _spawn_node("ptoffb", 2)
    try:
        fa.connect("127.0.0.1", pb)
        probe = TestProbe(default_timeout_s=20.0)
        probe_cell = sb.spawn_system_raw(_ProbeForwarder(probe), "probe-fwd")

        class _Echo(AbstractBehavior):
            def on_message(self, msg):
                probe_cell.tell(_Ping())
                return self

        worker = sb.spawn_root(Behaviors.setup_root(_Echo), "worker")
        proxy = fa._proxy(sb.address, worker.cell.uid)
        driver = sa.spawn_root(Behaviors.setup_root(
            lambda ctx: _Driver(ctx, ctx.engine.to_root_refob(proxy))), "driver")
        for _ in range(5):
            driver.tell(_Ping())
        for _ in range(5):
            probe.expect_message_type(_Ping)  # traffic flows end to end
        assert sb.telemetry is None
        assert [s for s in sa.telemetry.tracer.spans() if s["name"] == "send"]
    finally:
        _terminate_all(sa, sb)


# --------------------------------------------------------------------- #
# The time plane: merge math, refused sends, tsq/tsr over sockets
# --------------------------------------------------------------------- #


def _series_doc(node, name, last):
    return {"node": node, "series": [{
        "name": name, "labels": {},
        "tiers": [{"res": 1.0, "buckets": [[100, 2, 10.0, 4.0, 6.0, last]]}],
    }]}


@pytest.mark.parametrize("name", ["uigc_x_total", "uigc_link_phi"])
def test_merge_series_docs_aligns_buckets_and_names_missing(name):
    """The port's merge equals the reference's on the same documents: a
    counter folds by sum, a gauge by max, the missing peer is named."""
    docs = [_series_doc("uigc://a", name, 6.0), _series_doc("uigc://b", name, 4.0)]
    got = port_timeseries.merge_series_docs(copy.deepcopy(docs),
                                            missing=["uigc://c"])
    want = ref_timeseries.merge_series_docs(copy.deepcopy(docs),
                                            missing=["uigc://c"])
    assert got.pop("t") <= time.time() and want.pop("t")  # the wall clock
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["missing_nodes"] == ["uigc://c"]
    last = got["cluster"][0]["buckets"][0][5]
    assert last == (10.0 if name.endswith("_total") else 6.0)


def test_merged_does_not_wait_out_timeout_for_refused_sends():
    """A peer whose tsq send the fabric refuses folds into the completion
    check at once: one dead link must not make a merge sit out its
    timeout after every reachable peer answered."""
    store = port_timeseries.TimeSeriesStore(node="uigc://a")
    store.record("uigc_x_total", 1.0)

    def send_query(peer, rid, q):
        if peer == "uigc://dead":
            return False
        store.on_response_frame(
            rid, peer, json.dumps({"node": peer, "series": []}).encode())
        return True

    store.bind_fabric(known_peers_fn=lambda: ["uigc://b", "uigc://dead"],
                      live_peers_fn=lambda: ["uigc://b", "uigc://dead"],
                      send_query=send_query, send_response=lambda *a: None)
    t0 = time.monotonic()
    merged = store.merged(timeout_s=10.0)
    assert time.monotonic() - t0 < 2.0, "merge waited out the timeout"
    assert "uigc://b" in merged["nodes"]
    assert merged["missing_nodes"] == ["uigc://dead"]


TIMESERIES = {"uigc.telemetry.timeseries": True,
              "uigc.telemetry.ts-sample-interval": 50,
              "uigc.telemetry.ts-tiers": "1x120,10x60"}


def test_merged_series_cross_two_node_fabrics_and_name_a_dead_peer():
    """Live ``tsq``/``tsr`` frames: A's merged view folds B's series;
    once B is gone the merge names it missing instead of hanging."""
    fa, sa, _ = _spawn_node("ptsa", 2, TIMESERIES)
    fb, sb, pb = _spawn_node("ptsb", 2, TIMESERIES)
    try:
        fa.connect("127.0.0.1", pb)
        root = sb.spawn_root(Behaviors.setup_root(_ChainRoot), "root")
        for _ in range(20):
            root.tell(_Ping())
        time.sleep(0.3)
        store = sa.telemetry.store
        assert _settle(lambda: set(store.merged(timeout_s=2.0)["nodes"])
                       == {sa.address, sb.address}), "B's series never merged"
        merged = store.merged(timeout_s=2.0)
        assert merged["missing_nodes"] == []
        assert any(s["name"] == "uigc_live_actors" for s in merged["cluster"])
        fb.die()
        assert _settle(lambda: sb.address not in fa.members())
        t0 = time.monotonic()
        merged = store.merged(timeout_s=3.0)
        assert time.monotonic() - t0 < 3.5
        assert sb.address not in merged["nodes"]
    finally:
        _terminate_all(sa, sb)


# --------------------------------------------------------------------- #
# The liveness inspector's merged snapshot over "snap" frames
# --------------------------------------------------------------------- #


INSPECT = {"uigc.telemetry.inspect": True}


def test_two_node_merged_snapshot_and_seeded_snap_drop():
    fa, sa, _ = _spawn_node("psnapa", 2, INSPECT)
    fb, sb, pb = _spawn_node("psnapb", 2, INSPECT)
    try:
        fa.connect("127.0.0.1", pb)
        root_b = sb.spawn_root(Behaviors.setup_root(_ChainRoot), "root")
        root_a = sa.spawn_root(Behaviors.setup_root(_ChainRoot), "root")
        root_b.tell(_Give(None))
        root_a.tell(_Give(None))
        time.sleep(0.4)
        insp_a = sa.telemetry.inspector
        merged = {}

        def both():
            nonlocal merged
            merged = insp_a.merged_snapshot(timeout_s=3.0)
            locations = {r.get("location") for r in merged["actors"].values()}
            return ({sa.address, sb.address} <= locations
                    and not merged["missing_nodes"])

        assert _settle(both), merged.get("missing_nodes")
        kept_b = next(key for key, rec in merged["actors"].items()
                      if rec.get("name", "").endswith("kept")
                      and rec.get("location") == sb.address)
        result = why_live(merged, kept_b)
        assert result["verdict"] == "live", result
        assert validate_why_live(merged, result) == []
        # every further "snap" frame dies on the wire: the merge names
        # the missing node instead of hanging or raising
        fa.fault_plan = FaultPlan(seed=1).drop(kind="snap", prob=1.0)
        fb.fault_plan = FaultPlan(seed=1).drop(kind="snap", prob=1.0)
        partial = insp_a.merged_snapshot(timeout_s=1.0)
        assert partial["missing_nodes"] == [sb.address]
        assert sa.address in {r.get("location")
                              for r in partial["actors"].values()}
    finally:
        _terminate_all(sa, sb)


# --------------------------------------------------------------------- #
# The sanitizer on two NodeFabrics
# --------------------------------------------------------------------- #


class _Share(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,) if self.ref is not None else ()


class _Drop(NoRefs):
    pass


class _Owner(AbstractBehavior):
    """Root owning a worker: pings it, shares it to a peer root,
    releases it."""

    def __init__(self, context, peer_root):
        super().__init__(context)
        self.worker = context.spawn(Behaviors.setup(_Worker), "worker")
        self.peer_root = peer_root

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, _Ping) and self.worker is not None:
            self.worker.tell(_Ping(), ctx)
        elif isinstance(msg, _Share):
            self.peer_root.tell(
                _Share(ctx.create_ref(self.worker, self.peer_root)), ctx)
        elif isinstance(msg, _Drop) and self.worker is not None:
            ctx.release(self.worker)
            self.worker = None
        return self


class _Holder(AbstractBehavior):
    """Peer root: receives a shared ref, pings through it, releases."""

    def __init__(self, context):
        super().__init__(context)
        self.held = None

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, _Share) and msg.ref is not None:
            self.held = msg.ref
        elif isinstance(msg, _Ping) and self.held is not None:
            self.held.tell(_Ping(), ctx)
        elif isinstance(msg, _Drop) and self.held is not None:
            ctx.release(self.held)
            self.held = None
        return self


def _no_nonzero_recv(system):
    graph = system.engine.bookkeeper.shadow_graph
    return graph.investigate_live_set()["nonzero_recv"] == 0


def _joined(fa, sa, fb, sb):
    """Both sides list each other as members.  ``connect`` returns once
    the dialed node's hello arrives, which that node sends before it
    installs the dialer: a send from B in that window is dropped (the
    peer is unknown), and its counted send leaves the target's receive
    balance at -1 for good."""
    return sb.address in fa.members() and sa.address in fb.members()


def _oracle_balanced(system):
    san = system.sanitizer
    with san._lock:
        return all(s.recv_count == 0 for s in san.oracle.from_set
                   if not s.is_halted)


def _sanitized_pair_workload(tag):
    """Holder on A, owner on B sharing its worker to A's holder, 15
    pings through the shared ref, then both drop: returns the two
    sanitized systems once the system is quiescent (the caller
    terminates them).

    Quiescent means the worker was collected and every receive count is
    zero, in both collectors' graphs and in both sanitizer oracles.  A
    zero read alone is not enough: while the holder's last sends are
    still in its unflushed entry, the worker's receipts folded so far
    can match the sends folded so far, and the next flush takes the
    balance to -1 again until the worker's next delta.  The worker's
    collection on B needs its balance at zero with every fact folded,
    and no fact follows it."""
    sanitized = {"uigc.analysis.sanitizer": True}
    fa, sa, _ = _spawn_node(f"{tag}0", 2, sanitized)
    fb, sb, pb = _spawn_node(f"{tag}1", 2, sanitized)
    try:
        fa.connect("127.0.0.1", pb)
        assert _settle(lambda: _joined(fa, sa, fb, sb)), "the pair never joined"
        holder = sa.spawn_root(Behaviors.setup_root(_Holder), "holder")
        peer = fb._proxy(sa.address, holder.cell.uid)
        owner = sb.spawn_root(Behaviors.setup_root(
            lambda ctx: _Owner(ctx, ctx.engine.to_root_refob(peer))), "owner")
        owner.tell(_Share(None))
        time.sleep(0.3)
        for _ in range(15):
            holder.tell(_Ping())
            time.sleep(0.005)
        holder.tell(_Drop())
        owner.tell(_Drop())
        worker = owner.cell.children["worker"]
        assert _settle(lambda: worker.is_terminated
                       and all(_no_nonzero_recv(s) and _oracle_balanced(s)
                               for s in (sa, sb))), (
            "balances never converged: the workload itself is broken")
    except BaseException:
        _terminate_all(sa, sb)
        raise
    return sa, sb


@pytest.mark.parametrize("kind", ["node"])
def test_sanitizer_clean_two_nodes(kind):
    sa, sb = _sanitized_pair_workload("pancl")
    try:
        for system in (sa, sb):
            san = system.sanitizer
            assert san.checks > 0
            assert san.violations == [], san.report()
            assert san.check_quiescent() == [], san.report()
    finally:
        _terminate_all(sa, sb)


def test_sanitizer_clean_two_nodes_under_concurrent_load():
    """Six copies of the two-node workload at once in one interpreter:
    the load under which a send from the dialed node raced its install
    of the dialer (ROADMAP Queue 3 item 13).  Every copy must end clean
    with every receive balance at zero in the oracle."""
    import threading

    copies = 6
    results = [None] * copies

    def run(i):
        try:
            sa, sb = _sanitized_pair_workload(f"panld{i}_")
        except BaseException as exc:
            results[i] = repr(exc)
            return
        try:
            found = []
            for system in (sa, sb):
                san = system.sanitizer
                if san.checks == 0:
                    found.append(f"{system.address}: no checks")
                found += [v.rule for v in san.violations]
                found += [v.rule for v in san.check_quiescent()]
            results[i] = found
        finally:
            _terminate_all(sa, sb)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(copies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [[]] * copies, results
