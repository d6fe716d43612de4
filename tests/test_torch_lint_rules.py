"""The reference's lint-rule tests that waited for the port's static
checker, with their names kept, each aimed at the port's files and run
through the port's linter (``uigc_tpu_torch/tools/uigc_lint.py``):
UL008 (``tests/test_inspect.py``), UL010 (``tests/test_schema_shm.py``),
UL011 (``tests/test_device.py``), UL012 (``tests/test_serving.py``),
UL013 (``tests/test_partition.py``) and UL014/UL015
(``tests/test_distributed.py``).  Each plants a rogue module and checks
both directions: the planted shape fires, and the port's real modules
stay clean (within the port's allowlist where the reference has a
budget).
"""

import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "uigc_tpu_torch")
ALLOWLIST = os.path.join(PKG, "tools", "uigc_lint_allow.txt")


def _load_lint():
    spec = importlib.util.spec_from_file_location(
        "uigc_lint_torch", os.path.join(PKG, "tools", "uigc_lint.py")
    )
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    return lint


lint = _load_lint()


def _lint(paths):
    return lint.lint_paths(paths, lint_asserts=False)


def _fresh(rule, paths):
    violations = [v for v in lint.lint_paths(paths) if v.rule == rule]
    _grandfathered, fresh = lint.apply_allowlist(
        violations, lint._load_allowlist(ALLOWLIST)
    )
    return fresh


# ------------------------------------------------------------------- #
# UL008 (tests/test_inspect.py)
# ------------------------------------------------------------------- #


def test_ul008_real_inspect_module_is_clean():
    target = os.path.join(PKG, "telemetry", "inspect.py")
    violations = [v for v in _lint([target]) if v.rule == "UL008"]
    assert violations == [], [v.render() for v in violations]


def test_ul008_flags_mutating_inspect_code(tmp_path):
    bad_dir = tmp_path / "telemetry"
    bad_dir.mkdir()
    bad = bad_dir / "inspect.py"
    bad.write_text(
        "from ..engines.crgc import arrays\n"
        "def poke(graph, cell):\n"
        "    graph.flags[0] = 0\n"
        "    graph.capture_parents = True\n"
        "    graph.trace(should_kill=True)\n"
        "    cell.tell(object())\n"
        "def fine(self_like):\n"
        "    out = {}\n"
        "    out['x'] = 1\n"
        "    return out\n"
    )
    violations = [v for v in _lint([str(bad)]) if v.rule == "UL008"]
    lines = {v.line for v in violations}
    assert 1 in lines  # runtime engines import
    assert 3 in lines  # graph.flags[0] = 0
    assert 4 in lines  # graph.capture_parents = ...
    assert 5 in lines  # .trace(...)
    assert 6 in lines  # .tell(...)
    assert all(v.line != 9 for v in violations)  # local dict store is fine


# ------------------------------------------------------------------- #
# UL010 (tests/test_schema_shm.py)
# ------------------------------------------------------------------- #


def test_ul010_flags_pickle_on_runtime_hot_path(tmp_path):
    runtime = tmp_path / "runtime"
    runtime.mkdir()
    bad = runtime / "hotpath.py"
    bad.write_text(
        "import pickle\n\ndef enc(x):\n    return pickle.dumps(x)\n"
    )
    violations = lint.lint_paths([str(bad)])
    assert any(v.rule == "UL010" for v in violations)
    # wire.py is sanctioned
    good = runtime / "wire.py"
    good.write_text(
        "import pickle\n\ndef enc(x):\n    return pickle.dumps(x)\n"
    )
    violations = lint.lint_paths([str(good)])
    assert not any(v.rule == "UL010" for v in violations)
    # the port is strict-clean for UL010 beyond the grandfathered set
    assert _fresh("UL010", [PKG]) == []


# ------------------------------------------------------------------- #
# UL011 (tests/test_device.py)
# ------------------------------------------------------------------- #


def test_ul011_flags_and_annotation(tmp_path):
    target = tmp_path / "engines" / "hot.py"
    target.parent.mkdir()
    target.write_text(
        "import numpy as np\n"
        "import jax\n"
        "def bad(self, x, y, z):\n"
        "    a = np.asarray(x)\n"                       # flagged
        "    b = jax.device_get(y)\n"                    # flagged
        "    c = z.item()\n"                             # flagged
        "    d = self._dev_flags.item()\n"               # flagged (attr recv)
        "    ok1 = np.asarray(x)  # readback: tested\n"  # annotated
        "    ok2 = np.asarray(x, dtype=np.int64)\n"      # dtype: host idiom
        "    return a, b, c, d, ok1, ok2\n"
    )
    violations = [
        v for v in lint.lint_paths([str(tmp_path)]) if v.rule == "UL011"
    ]
    assert len(violations) == 4
    lines = sorted(v.line for v in violations)
    assert lines == [4, 5, 6, 7]
    # outside engines/ops/parallel the rule never applies
    other = tmp_path / "models" / "cold.py"
    other.parent.mkdir()
    other.write_text("import numpy as np\nx = np.asarray([1])\n")
    assert not [
        v
        for v in lint.lint_paths([str(other)])
        if v.rule == "UL011"
    ]


def test_repo_is_ul011_strict_clean():
    assert _fresh("UL011", [PKG]) == []


# ------------------------------------------------------------------- #
# UL012 (tests/test_serving.py)
# ------------------------------------------------------------------- #


def test_ul012_flags_unbounded_queues_and_accepts_annotated(tmp_path):
    runtime_dir = tmp_path / "runtime"
    runtime_dir.mkdir()
    bad = runtime_dir / "q.py"
    bad.write_text(
        "from collections import deque\n"
        "class T:\n"
        "    def __init__(self):\n"
        "        self.outq = deque()\n"
        "        self._buffers = []\n"
        "        self.pending: list = list()\n"
        "        self.bounded = deque(maxlen=16)\n"
        "        self.okq = deque()  # unbounded: drained by a fixed pool\n"
        "        self.names = []\n"
    )
    violations = [
        v for v in lint.lint_paths([str(bad)]) if v.rule == "UL012"
    ]
    assert {v.line for v in violations} == {4, 5, 6}, [
        v.render() for v in violations
    ]
    # Outside runtime//cluster/ the rule stays silent.
    elsewhere = tmp_path / "tools_like"
    elsewhere.mkdir()
    free = elsewhere / "q.py"
    free.write_text(bad.read_text())
    assert not [
        v for v in lint.lint_paths([str(free)]) if v.rule == "UL012"
    ]
    # The port is strict-clean for UL012 under its allowlist.
    fresh = _fresh("UL012", [PKG])
    assert not fresh, [v.render() for v in fresh]


# ------------------------------------------------------------------- #
# UL013 (tests/test_partition.py)
# ------------------------------------------------------------------- #


def test_ul013_flags_fence_bypasses_and_exempts_helpers(tmp_path):
    cluster_dir = tmp_path / "cluster"
    cluster_dir.mkdir()
    bad = cluster_dir / "rogue.py"
    bad.write_text(
        "class Rogue:\n"
        "    def sneak(self, journal, blob):\n"
        "        journal.note_command('t', 1, 'k', blob)\n"
        "        journal.open_epoch('t', 1, 'k', None)\n"
        "        epoch = journal.begin_snapshot('t', 1, 'k')\n"
        "        journal.commit_snapshot('t', 1, 'k', epoch, blob)\n"
        "    def clobber(self, cluster, table):\n"
        "        cluster._table = table\n"
    )
    violations = [v for v in lint.lint_paths([str(bad)]) if v.rule == "UL013"]
    assert {v.line for v in violations} == {3, 4, 5, 6, 8}, [
        v.render() for v in violations
    ]
    # The fenced helper modules themselves are exempt, as is code
    # outside runtime//cluster/.
    sharding_like = cluster_dir / "sharding.py"
    sharding_like.write_text(bad.read_text())
    assert not [
        v for v in lint.lint_paths([str(sharding_like)]) if v.rule == "UL013"
    ]
    elsewhere = tmp_path / "tools_like"
    elsewhere.mkdir()
    free = elsewhere / "rogue.py"
    free.write_text(bad.read_text())
    assert not [v for v in lint.lint_paths([str(free)]) if v.rule == "UL013"]
    # The port is strict-clean for UL013.
    repo_violations = [
        v for v in lint.lint_paths([PKG]) if v.rule == "UL013"
    ]
    assert not repo_violations, [v.render() for v in repo_violations]


# ------------------------------------------------------------------- #
# UL014, UL015 (tests/test_distributed.py)
# ------------------------------------------------------------------- #


def test_ul014_flags_out_of_fold_slot_mutation(tmp_path):
    """Lint rule UL014, both directions: a rogue module mutating shadow
    slots outside the fold plane is flagged; the port's fold-plane
    modules stay clean."""
    rogue_dir = tmp_path / "uigc_tpu_torch" / "engines" / "crgc"
    rogue_dir.mkdir(parents=True)
    (rogue_dir / "rogue.py").write_text(
        "def f(shadow, other):\n"
        "    shadow.is_halted = True\n"
        "    shadow.recv_count += 1\n"
        "    shadow.outgoing[other] = 2\n"
    )
    hits = [v for v in lint.lint_paths([str(tmp_path)]) if v.rule == "UL014"]
    assert len(hits) == 3
    clean = [
        v
        for v in lint.lint_paths(
            [
                os.path.join(PKG, "engines", "crgc", "distributed.py"),
                os.path.join(PKG, "parallel", "partition.py"),
            ]
        )
        if v.rule == "UL014"
    ]
    assert clean == []


def test_ul015_flags_adhoc_dmark_payloads(tmp_path):
    """Lint rule UL015, both directions: ad-hoc dmark/dmack frame
    literals outside wire.py and json payload construction inside
    wire.py's dmark codecs are flagged; the port's real modules stay
    clean."""
    rogue_dir = tmp_path / "uigc_tpu_torch" / "engines" / "crgc"
    rogue_dir.mkdir(parents=True)
    (rogue_dir / "rogue_frames.py").write_text(
        "import json\n"
        "def f(keys, wave):\n"
        "    frame = ('dmark', wave, 0, 'me', json.dumps(keys).encode())\n"
        "    ack = ('dmack', wave, 'me', len(keys))\n"
        "    return frame, ack\n"
    )
    wire_dir = tmp_path / "uigc_tpu_torch" / "runtime"
    wire_dir.mkdir(parents=True)
    (wire_dir / "wire.py").write_text(
        "import json\n"
        "def encode_dmark(wave, keys):\n"
        "    return ('x', json.dumps(keys).encode())\n"
        "def decode_dmack(frame):\n"
        "    return json.loads(frame[1])\n"
        "def encode_other(x):\n"
        "    return json.dumps(x)\n"
    )
    hits = [v for v in lint.lint_paths([str(tmp_path)]) if v.rule == "UL015"]
    # two frame literals + two json calls inside dmark/dmack codecs
    # (encode_other is NOT flagged: the rule scopes to the dmark plane)
    assert len(hits) == 4
    clean = [
        v
        for v in lint.lint_paths(
            [
                os.path.join(PKG, "engines", "crgc", "distributed.py"),
                os.path.join(PKG, "runtime", "wire.py"),
                os.path.join(PKG, "runtime", "schema.py"),
            ]
        )
        if v.rule == "UL015"
    ]
    assert clean == []
