"""The port's static checker (``uigc_tpu_torch/analysis/check`` and
``uigc_tpu_torch/tools/uigc_check.py``): the counterpart of
``tests/test_check.py``, test for test with names and assertions kept,
over mini trees rooted at ``uigc_tpu_torch/``; then parity with the
reference's checker, PyTorch's readback and tracing idioms, and the
port itself strict-clean.

- seeded positives and negatives: the reference's planted mini-repo,
  planted under ``uigc_tpu_torch/``;
- parity: the same mini tree through the reference's ``run_check``
  (under ``uigc_tpu/``) and the port's gives equal (rule, line,
  message) lists once the package's name and layout are mapped, and the
  port's checker set to ``package="uigc_tpu"`` reproduces the
  reference's 33 diagnostics over ``uigc_tpu/`` and ``tools/``;
- torch idioms: UC303 on the eager device path (a function that reaches
  the propagate kernel and reads back) with the ``# readback:`` note and
  a host-only helper silent, UC304 for a ``torch.compile`` of a lambda
  built inside a function, UL011's torch shapes;
- the port is strict-clean with ``jax`` and ``uigc_tpu`` blocked, and
  the wire decoders the checker found untested (UC105) hold their
  malformed-input contract.
"""

import importlib.util
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "uigc_tpu_torch"

from uigc_tpu_torch.analysis.check import cli
from uigc_tpu_torch.runtime import wire
from uigc_tpu_torch.telemetry import EventMetricsBridge, MetricsRegistry
from uigc_tpu_torch.utils import events


# ------------------------------------------------------------------- #
# The planted mini-repo
# ------------------------------------------------------------------- #


def _plant(root, rel, source):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(textwrap.dedent(source))
    return path


def _mini_repo(root, package=PKG):
    """The reference's mini tree (tests/test_check.py), rooted at
    ``package/``: one defect of each family, plus a clean counterpart
    proving the rule does not overfire."""
    _plant(
        root,
        f"{package}/config.py",
        '''\
        DEFAULTS = {
            # A knob GUIDE.md documents.
            "uigc.good.knob": 1,
            # Read by the engine but absent from GUIDE.md.
            "uigc.planted.undocumented": 2,
            # Defaulted, documented nowhere, read nowhere.
            "uigc.planted.dead": 3,
        }
        ''',
    )
    _plant(
        root,
        f"{package}/engine.py",
        '''\
        def setup(config):
            a = config.get_int("uigc.good.knob")
            b = config.get_int("uigc.planted.undocumented")
            c = config.get("uigc.planted.typo")
            return a, b, c
        ''',
    )
    _plant(
        root,
        "GUIDE.md",
        """\
        # Guide

        | Key | Default | Meaning |
        |---|---|---|
        | `uigc.good.knob` | `1` | the documented knob |
        """,
    )
    _plant(
        root,
        f"{package}/runtime/wire.py",
        '''\
        PING_FRAME_KIND = "ping"
        ORPHAN_FRAME_KIND = "orph"


        def encode_ping(origin):
            return ("ping", origin)


        def encode_orphan(origin):
            return ("orph", origin)


        def decode_ping(frame):
            try:
                return frame[1]
            except IndexError:
                return None
        ''',
    )
    _plant(
        root,
        f"{package}/runtime/node.py",
        """\
        def bind(fabric):
            fabric.register_frame_handler("ping", _on_ping)


        def _on_ping(frame):
            return frame
        """,
    )
    _plant(
        root,
        f"{package}/runtime/locka.py",
        """\
        import threading
        import time


        class Pool:
            def __init__(self):
                self.alpha_lock = threading.Lock()
                self.beta_lock = threading.Lock()

            def forward(self):
                with self.alpha_lock:
                    with self.beta_lock:
                        return 1

            def slow(self):
                with self.alpha_lock:
                    time.sleep(0.1)
        """,
    )
    _plant(
        root,
        f"{package}/runtime/lockb.py",
        """\
        def backward(pool):
            with pool.beta_lock:
                with pool.alpha_lock:
                    return 2
        """,
    )
    _plant(
        root,
        f"{package}/gateway/ingest.py",
        '''\
        import marshal
        import pickle

        from ..runtime import schema


        def client_ingest(buf):
            # Planted: a client-input entry point whose helper pickles.
            return _hydrate(buf)


        def _hydrate(buf):
            return pickle.loads(buf)


        def client_parse_ok(buf):
            # Clean counterpart: the closed client codec fires nothing.
            return schema.decode_client_value(buf)


        def _archive_restore(blob):
            # A gateway-side deserializer no client entry point reaches:
            # UL016 territory, but not UC401.
            return marshal.loads(blob)
        ''',
    )
    _plant(
        root,
        f"{package}/ops/kernel.py",
        """\
        import time

        import jax
        import jax.numpy as jnp

        _CACHE = {}


        def _impure(x):
            _CACHE["last"] = time.time()
            return x + 1


        @jax.jit
        def traced_step(x):
            return _impure(x)


        def _tile(x, shape):
            return jnp.zeros(shape) + x


        tile = jax.jit(_tile, static_argnums=(1,))


        def drive(x):
            return tile(x, [4, 4])
        """,
    )
    return root


@pytest.fixture()
def mini(tmp_path):
    return _mini_repo(str(tmp_path))


def _check(mini, rules):
    return cli.run_check(
        [os.path.join(mini, PKG)], rules=rules, repo_root=mini
    )


def _by_rule(result, rule):
    return [d for d in result["fresh"] if d.rule == rule]


# ------------------------------------------------------------------- #
# Seeded positives
# ------------------------------------------------------------------- #


def test_seeded_config_plane_rules(mini):
    result = _check(mini, ["UC101", "UC102", "UC106", "UC108"])
    rendered = "\n".join(d.render() for d in result["fresh"])
    undocumented = _by_rule(result, "UC101")
    assert len(undocumented) == 1
    assert "'uigc.planted.undocumented'" in undocumented[0].message
    assert undocumented[0].path.endswith("config.py")
    typo = _by_rule(result, "UC108")
    assert len(typo) == 1
    assert "'uigc.planted.typo'" in typo[0].message
    assert typo[0].path.endswith("engine.py")  # anchored at the read site
    dead = _by_rule(result, "UC102")
    assert len(dead) == 1
    assert "'uigc.planted.dead'" in dead[0].message
    # The documented + read key fires nothing.
    assert "uigc.good.knob" not in rendered
    # CONFIG.md does not exist yet -> drift.
    assert len(_by_rule(result, "UC106")) == 1


def test_seeded_orphan_frame_kind(mini):
    result = _check(mini, ["UC104"])
    findings = _by_rule(result, "UC104")
    assert len(findings) == 1
    assert "'orph'" in findings[0].message
    assert "no receiver" in findings[0].message
    assert "'ping'" not in findings[0].message


def test_seeded_untested_decoder(mini):
    result = _check(mini, ["UC105"])
    findings = _by_rule(result, "UC105")
    assert len(findings) == 1
    assert "decode_ping()" in findings[0].message


def test_seeded_cross_module_lock_inversion_with_witness(mini):
    result = _check(mini, ["UC201"])
    findings = _by_rule(result, "UC201")
    assert len(findings) == 1
    message = findings[0].message
    assert "alpha_lock" in message and "beta_lock" in message
    # The witness names both acquisition paths, not just the cycle.
    assert " -> " in message and "via" in message


def test_seeded_blocking_under_lock(mini):
    result = _check(mini, ["UC203"])
    findings = _by_rule(result, "UC203")
    assert len(findings) == 1
    assert "time.sleep()" in findings[0].message
    assert "alpha_lock" in findings[0].message


def test_seeded_impure_traced_function(mini):
    result = _check(mini, ["UC301", "UC302"])
    mutation = _by_rule(result, "UC301")
    assert len(mutation) == 1
    assert "_CACHE" in mutation[0].message
    assert "traced via" in mutation[0].message  # witness chain to the entry
    rng = _by_rule(result, "UC302")
    assert len(rng) == 1
    assert "time.time" in rng[0].message


def test_seeded_unhashable_static_arg(mini):
    result = _check(mini, ["UC304"])
    findings = _by_rule(result, "UC304")
    assert len(findings) == 1
    assert "'tile'" in findings[0].message
    assert "list" in findings[0].message
    assert "static position 1" in findings[0].message


def test_seeded_gateway_unsafe_deserializer_reachability(mini):
    result = _check(mini, ["UC401"])
    findings = _by_rule(result, "UC401")
    assert len(findings) == 1
    message = findings[0].message
    assert "pickle.loads" in message
    assert "via _hydrate" in message  # the transitive closure, not the entry
    assert findings[0].path.endswith("gateway/ingest.py")
    # marshal.loads also sits in gateway code but no client entry point
    # reaches it: reachability, not mere presence, drives UC401.
    assert "marshal" not in message


def test_seeded_gateway_pickle_lint_both_directions(mini):
    result = _check(mini, ["UL016"])
    findings = _by_rule(result, "UL016")
    # Presence, not reachability: both deserializer calls fire.
    assert len(findings) == 2
    rendered = "\n".join(d.render() for d in findings)
    assert "pickle.loads()" in rendered
    assert "marshal.loads()" in rendered
    # The closed client codec is the sanctioned path and stays silent:
    # findings anchor only at the two deserializer call sites, not at
    # client_parse_ok's schema.decode_client_value line.
    assert "ingest.py:13" in rendered  # pickle.loads in _hydrate
    assert "ingest.py:24" in rendered  # marshal.loads in _archive_restore
    assert "ingest.py:18" not in rendered  # the clean codec call


def test_suppression_comment_silences_surface_rule(mini):
    config = os.path.join(mini, PKG, "config.py")
    with open(config, encoding="utf-8") as fh:
        source = fh.read()
    source = source.replace(
        '"uigc.planted.undocumented": 2,',
        '"uigc.planted.undocumented": 2,  # uigc-lint: disable=UC101',
    )
    with open(config, "w", encoding="utf-8") as fh:
        fh.write(source)
    result = _check(mini, ["UC101"])
    assert _by_rule(result, "UC101") == []


# ------------------------------------------------------------------- #
# The refactored linter
# ------------------------------------------------------------------- #


def _load_standalone_lint():
    spec = importlib.util.spec_from_file_location(
        "uigc_lint_for_torch_check_suite",
        os.path.join(REPO, PKG, "tools", "uigc_lint.py"),
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_lint_wrapper_and_check_produce_identical_verdicts(tmp_path):
    """The port's uigc_lint.py is a thin wrapper over the shared
    framework, so it and ``uigc_check --rules UL*`` must render
    byte-identical findings (same rule id, line, message,
    suppression)."""
    path = _plant(
        str(tmp_path),
        f"{PKG}/engines/thing.py",
        """\
        def apply(entries, n):
            assert len(entries) == n
            assert n >= 0  # uigc-lint: disable=UL004
            return entries
        """,
    )
    lint = _load_standalone_lint()
    standalone = [v.render() for v in lint.lint_paths([path])]
    via_check = [
        d.render()
        for d in cli.run_check([path], rules=["UL*"], repo_root=str(tmp_path))[
            "fresh"
        ]
    ]
    assert standalone == via_check
    assert len(standalone) == 1 and "UL004" in standalone[0]


# ------------------------------------------------------------------- #
# Registry + CONFIG.md round-trip
# ------------------------------------------------------------------- #


def test_registry_schema_is_stable(mini):
    result = _check(mini, None)
    registry = result["registry"]
    assert registry["version"] == 1
    assert set(registry) == {
        "version",
        "config",
        "events",
        "metrics",
        "frames",
        "decoders",
        "schemas",
        "caps",
        "locks",
        "purity",
    }
    knob = registry["config"]["uigc.good.knob"]
    assert knob["default"] == 1
    assert knob["in_defaults"] and knob["documented_guide"]
    assert knob["readers"] and knob["readers"][0].endswith(
        f"{PKG}/engine.py:2"
    )
    assert registry["frames"]["ping"]["encoders"]
    assert registry["frames"]["ping"]["handlers"]
    assert registry["decoders"]["decode_ping"]["tested"] is False
    assert registry["locks"]["edges"]
    assert registry["purity"]["entries"]
    # The JSON envelope the --json flag emits is versioned too.
    payload = cli._to_json(result, strict=True)
    assert payload["version"] == 1
    assert set(payload) == {
        "version",
        "strict",
        "files",
        "passes",
        "counts",
        "fresh",
        "grandfathered",
    }


def test_write_config_round_trip_clears_drift(mini):
    assert _by_rule(_check(mini, ["UC106"]), "UC106")
    written = cli.run_check(
        [os.path.join(mini, PKG)],
        rules=["UC106"],
        repo_root=mini,
        write_config=True,
    )
    assert _by_rule(written, "UC106") == []
    config_md = os.path.join(mini, PKG, "CONFIG.md")
    with open(config_md, encoding="utf-8") as fh:
        text = fh.read()
    assert "GENERATED FILE" in text
    assert "`uigc.planted.undocumented`" in text
    # Regenerated is current: the drift finding stays cleared.
    assert _by_rule(_check(mini, ["UC106"]), "UC106") == []


# ------------------------------------------------------------------- #
# Negatives: the port itself
# ------------------------------------------------------------------- #


def _run_blocked(module, *args):
    """``python -m <module> args`` in a fresh interpreter where importing
    jax or uigc_tpu fails."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['uigc_tpu'] = None\n"
        f"sys.argv = [{module!r}] + {list(args)!r}\n"
        f"runpy.run_module({module!r}, run_name='__main__')\n"
    )
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=300,
    )


def test_repo_is_strict_clean():
    """The acceptance gate: the port passes --strict with its own
    allowlist, in an interpreter that cannot import jax or the
    reference — the checker needs neither."""
    proc = _run_blocked("uigc_tpu_torch.tools.uigc_check", "--strict",
                        os.path.join(REPO, PKG))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # All four passes ran (none degraded to SKIP on the real tree).
    assert "SKIP" not in proc.stderr
    summary = [ln for ln in proc.stderr.splitlines()
               if ln.startswith("uigc-check:") and "file(s)" in ln]
    assert summary, proc.stderr
    for name in ("lint", "surface", "locks", "purity"):
        assert f"{name}: " in summary[0] and "finding(s)" in summary[0]


def test_port_lint_is_strict_clean_with_jax_blocked():
    proc = _run_blocked("uigc_tpu_torch.tools.uigc_lint", "--strict",
                        os.path.join(REPO, PKG))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_allowlist_budgets_stay_at_or_below_the_reference():
    """Every budget of the port's allowlist has a counterpart in the
    reference's (the same module, or the module it ports) at or above
    it."""
    from uigc_tpu_torch.analysis.check.core import load_allowlist

    port = load_allowlist(os.path.join(REPO, PKG, "tools",
                                       "uigc_lint_allow.txt"))
    ref = load_allowlist(os.path.join(REPO, "tools", "uigc_lint_allow.txt"))
    renamed = {"ops/cuda_trace.py": "ops/pallas_trace.py",
               "ops/cuda_incremental.py": "ops/pallas_incremental.py"}
    assert port
    for (path, rule), count in port.items():
        rel = path.split(f"{PKG}/", 1)[1]
        counterpart = ("uigc_tpu/" + renamed.get(rel, rel), rule)
        assert counterpart in ref, (path, rule)
        assert count <= ref[counterpart], (path, rule, count)


# ------------------------------------------------------------------- #
# Parity with the reference's checker
# ------------------------------------------------------------------- #


def _as_reference(text):
    """A port diagnostic's text in the reference's layout: the package's
    name, its CONFIG.md's place and its documentation's name mapped."""
    return (text.replace(f"{PKG}/CONFIG.md", "CONFIG.md")
            .replace("GUIDE.md or README.md's port section", "GUIDE.md")
            .replace(PKG, "uigc_tpu"))


@pytest.mark.parametrize("rules", [None, ["UL*"], ["UC1*"], ["UC2*"],
                                   ["UC3*"], ["UC401"]],
                         ids=lambda r: "all" if r is None else r[0])
def test_mini_tree_diagnostics_equal_the_reference(tmp_path, rules):
    from uigc_tpu.analysis.check import cli as ref_cli

    ref_root = _mini_repo(str(tmp_path / "ref"), "uigc_tpu")
    port_root = _mini_repo(str(tmp_path / "port"), PKG)
    want = ref_cli.run_check([os.path.join(ref_root, "uigc_tpu")],
                             rules=rules, repo_root=ref_root)
    got = cli.run_check([os.path.join(port_root, PKG)], rules=rules,
                        repo_root=port_root)

    def keyed(result, root, mapped):
        out = []
        for d in result["diagnostics"]:
            path = os.path.relpath(d.path, root)
            message = _as_reference(d.message) if mapped else d.message
            out.append((_as_reference(path) if mapped else path, d.line,
                        d.rule, message.replace(root, "<root>")))
        return out

    assert keyed(got, port_root, True) == keyed(want, ref_root, False)
    assert want["diagnostics"]  # the planted defects fire


def test_full_size_parity_on_the_reference_tree():
    """Set to ``uigc_tpu``, the port's checker gives the reference's
    exact diagnostics over the reference's tree: 33 findings, all
    within tools/uigc_lint_allow.txt's budgets."""
    from uigc_tpu.analysis.check import cli as ref_cli

    paths = [os.path.join(REPO, "uigc_tpu"), os.path.join(REPO, "tools")]
    allow = os.path.join(REPO, "tools", "uigc_lint_allow.txt")
    want = ref_cli.run_check(paths, allowlist_path=allow, repo_root=REPO)
    got = cli.run_check(paths, allowlist_path=allow, repo_root=REPO,
                        package="uigc_tpu")
    def keyed(diags):
        return [(d.path, d.line, d.rule, d.message) for d in diags]

    assert keyed(got["diagnostics"]) == keyed(want["diagnostics"])
    assert len(got["diagnostics"]) == 33
    assert got["fresh"] == [] and len(got["grandfathered"]) == 33
    for name in ("lint", "surface", "locks", "purity"):
        assert got["passes"][name]["status"] == "ok"


# ------------------------------------------------------------------- #
# PyTorch's idioms
# ------------------------------------------------------------------- #


def _eager_tree(root):
    """A kernel wrapper in the shape of ops/propagate.py and callers of
    it: a fixpoint loop that reads back in each of the four shapes (one
    line annotated), and a host-only helper that reads the same shapes
    but reaches no kernel."""
    _plant(
        root,
        f"{PKG}/ops/propagate.py",
        """\
        def load_library():
            return None


        def propagate_words_cuda(table, out):
            fn = load_library().uigc_propagate_words
            fn(table, out)
            return out


        def propagate_words(table, out):
            return propagate_words_cuda(table, out)
        """,
    )
    _plant(
        root,
        f"{PKG}/ops/fixpoint.py",
        """\
        import numpy as np
        import torch

        from .propagate import propagate_words


        def trace(t, d, out):
            while True:
                out = propagate_words(t, out)
                a = t.item()
                b = t.tolist()
                c = t.cpu()
                n = int(d[3])
                ok = int(d[4])  # readback: the loop's changed flag
                if not n:
                    return a, b, c, ok


        def host_only(t, d):
            return t.item(), t.tolist(), t.cpu(), int(d[3])


        def host_lists(keys):
            arr = np.asarray(keys, dtype=np.int64)
            return arr.tolist(), int(arr[0])
        """,
    )
    return root


def test_eager_device_path_readbacks_are_uc303(tmp_path):
    root = _eager_tree(str(tmp_path))
    result = cli.run_check([os.path.join(root, PKG)], rules=["UC303"],
                           repo_root=root)
    found = sorted((os.path.basename(d.path), d.line)
                   for d in result["fresh"])
    # the four shapes in the loop that launches; the annotated line,
    # the host-only helper and the numpy helper stay silent
    assert found == [("fixpoint.py", 10), ("fixpoint.py", 11),
                     ("fixpoint.py", 12), ("fixpoint.py", 13)], found
    messages = " ".join(d.message for d in result["fresh"])
    for shape in ("t.item()", "t.tolist()", "t.cpu()", "int(d[...])"):
        assert shape in messages
    assert "propagate_words_cuda -> uigc_propagate_words" in messages
    assert result["passes"]["purity"]["status"] == "ok"
    assert result["passes"]["purity"]["eager"] >= 3


def test_torch_compile_of_a_lambda_in_a_function_is_uc304(tmp_path):
    root = str(tmp_path)
    _plant(
        root,
        f"{PKG}/ops/compiled.py",
        """\
        import torch


        def _step(x):
            return x + 1


        STEP = torch.compile(_step)


        def fresh_each_call(x):
            fn = torch.compile(lambda y: y * 2)
            return fn(x)


        def cached_once(x):
            return STEP(x)
        """,
    )
    result = cli.run_check([os.path.join(root, PKG)], rules=["UC304"],
                           repo_root=root)
    assert [(d.line, d.rule) for d in result["fresh"]] == [(12, "UC304")]
    assert "torch.compile(lambda ...)" in result["fresh"][0].message
    entries = cli.run_check([os.path.join(root, PKG)], repo_root=root)[
        "registry"]["purity"]["entries"]
    assert any(e.endswith("compiled.py:_step [torch.compile]")
               for e in entries), entries


def test_ul011_knows_the_torch_readback_idioms(tmp_path):
    target = tmp_path / "ops" / "hot.py"
    target.parent.mkdir()
    target.write_text(
        "import numpy as np\n"
        "import torch\n"
        "def f(x, keys, ev):\n"
        "    t = torch.zeros(4)\n"
        "    a = t.cpu()\n"                               # flagged
        "    b = t.cpu().numpy()\n"                       # flagged once
        "    torch.cuda.synchronize()\n"                  # flagged
        "    ev.synchronize()\n"                          # flagged
        "    c = t.tolist()\n"                            # flagged
        "    d = int(t[0])\n"                             # flagged
        "    e = keys.tolist()\n"                         # no evidence
        "    g = int(keys[0])\n"                          # no evidence
        "    h = int(t[1])  # readback: tested\n"         # annotated
        "    k = np.asarray(keys, dtype=np.int64).tolist()\n"  # host
        "    return a, b, c, d, e, g, h, k\n"
    )
    lint = _load_standalone_lint()
    hits = [v for v in lint.lint_paths([str(tmp_path)]) if v.rule == "UL011"]
    assert sorted(v.line for v in hits) == [5, 6, 7, 8, 9, 10]
    assert "t.cpu().numpy()" in hits[1].message


# ------------------------------------------------------------------- #
# Regression pins for what the checker surfaced on the port
# ------------------------------------------------------------------- #


def _hist_count(snapshot, name):
    return sum(
        s["value"] for s in snapshot[name]["samples"] if s["suffix"] == "_count"
    )


def test_event_bridge_covers_previously_unbridged_events():
    """The reference's checker flagged seven committed events (UC103)
    that no telemetry module bridged: the port's bridge folds them as
    the reference's does."""
    registry = MetricsRegistry()
    bridge = EventMetricsBridge(registry)
    bridge(events.LINK_HEALED, {"address": "uigc://b"})
    bridge(events.NODE_DRAINING, {"address": "uigc://a"})
    bridge(events.SBR_QUARANTINE, {"entities": 3, "checkpointed": True})
    bridge(
        events.STALE_WINDOW,
        {"peer": "uigc://a", "ingress": "uigc://b", "fence": 1, "log_fence": 2},
    )
    bridge(
        events.DELTA_GRAPH_SERIALIZATION,
        {"shadow_size": 100, "compression_table_size": 28},
    )
    bridge(events.INGRESS_ENTRY_SERIALIZATION, {"size": 64})
    bridge(
        events.ANALYSIS_CHECK,
        {"node": "uigc://a", "n_garbage": 5, "oracle_garbage": 5},
    )
    bridge(
        events.ANALYSIS_CHECK,
        {"node": "uigc://a", "n_garbage": 5, "oracle_garbage": 4},
    )
    assert registry.counter("uigc_link_heals_total").value() == 1
    assert registry.counter("uigc_node_draining_total").value() == 1
    assert (
        registry.counter("uigc_sbr_quarantine_total").value(checkpointed="true")
        == 1
    )
    assert (
        registry.counter("uigc_stale_windows_total").value(peer="uigc://a") == 1
    )
    assert (
        registry.counter("uigc_sanitizer_checks_total").value(divergent="false")
        == 1
    )
    assert (
        registry.counter("uigc_sanitizer_checks_total").value(divergent="true")
        == 1
    )
    snapshot = registry.snapshot()
    assert _hist_count(snapshot, "uigc_delta_graph_bytes") == 1
    assert _hist_count(snapshot, "uigc_ingress_entry_bytes") == 1


def test_decode_dcut_tolerates_malformed_frames():
    """UC105 on the port: decode_dcut (the per-link wave marker the port
    added) returns None on truncated and mistyped frames, never raises,
    and accepts trailing elements from a newer peer."""
    frame = wire.encode_dcut(7, 2, "uigc://a", 5, 3)
    assert frame[0] == "dcut"
    assert wire.decode_dcut(frame) == (7, 2, "uigc://a", 5, 3)
    assert wire.decode_dcut(frame + ("future",)) == (7, 2, "uigc://a", 5, 3)
    for bad in (("dcut",), frame[:3], frame[:5], ("dcut", "x", 2, "o", 5, 3),
                ("dcut", 7, None, "o", 5, 3), ("dcut", 7, 2, "o", [5], 3),
                ("dcut", 7, 2, "o", 5, object()), None, 5):
        assert wire.decode_dcut(bad) is None, bad


def test_tsq_tsr_codec_round_trip_and_tolerance():
    frame = wire.encode_ts_query(7, "uigc://a", {"name": "m", "window": 60})
    assert frame[0] == wire.TSQ_FRAME_KIND
    req_id, origin, query = wire.decode_ts_query(frame)
    assert (req_id, origin) == (7, "uigc://a")
    assert query == {"name": "m", "window": 60}
    # trailing elements from a newer peer are accepted
    assert wire.decode_ts_query(frame + ("future",)) is not None
    # unreadable query body degrades to {} (answer with everything)
    assert wire.decode_ts_query(("tsq", 1, "o", b"\xff{not json"))[2] == {}
    # malformed shapes -> None, never a raise
    assert wire.decode_ts_query(("tsq", 1, "o", "not-bytes")) is None
    assert wire.decode_ts_query(("tsq",)) is None
    rsp = wire.encode_ts_response(7, "uigc://b", b'{"series": []}')
    assert wire.decode_ts_response(rsp) == (7, "uigc://b", b'{"series": []}')
    assert wire.decode_ts_response(rsp + ("x",)) is not None
    assert wire.decode_ts_response(("tsr", 1, "o", None)) is None
