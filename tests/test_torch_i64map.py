"""The port's counterpart of ``tests/test_i64map.py``: the same tests, names and
assertions, on ``uigc_tpu_torch``.

Differential tests for the vectorized open-addressing map
(ops/i64map.py) against a Python dict, mixing scalar and batch
operations, growth, and tombstone churn."""

from __future__ import annotations

import numpy as np
import pytest

from uigc_tpu_torch.ops.i64map import I64Map, IntStack


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_i64map_matches_dict(seed):
    rng = np.random.default_rng(seed)
    m = I64Map(cap=16)
    d = {}
    key_space = 5000
    for round_ in range(30):
        op = rng.random()
        if op < 0.35:  # batch insert of new unique keys
            cand = rng.integers(0, key_space, size=rng.integers(1, 400))
            new = np.unique(cand)
            new = new[[k not in d for k in new.tolist()]]
            vals = rng.integers(0, 1 << 40, size=new.size)
            m.put_batch_new(new, vals)
            d.update(zip(new.tolist(), vals.tolist()))
        elif op < 0.55:  # batch pop (mix of present and absent)
            cand = np.unique(rng.integers(0, key_space, size=rng.integers(1, 300)))
            got = m.pop_batch(cand)
            for k, v in zip(cand.tolist(), got.tolist()):
                if k in d:
                    assert v == d.pop(k)
                else:
                    assert v == -1
        elif op < 0.75:  # batch get incl. duplicates
            cand = rng.integers(0, key_space, size=rng.integers(1, 500))
            got = m.get_batch(cand)
            for k, v in zip(cand.tolist(), got.tolist()):
                assert v == d.get(k, -1), f"round {round_} key {k}"
        elif op < 0.9:  # scalar upsert
            for _ in range(20):
                k = int(rng.integers(0, key_space))
                v = int(rng.integers(0, 1 << 40))
                m[k] = v
                d[k] = v
        else:  # scalar pop / get / contains
            for _ in range(20):
                k = int(rng.integers(0, key_space))
                assert (k in m) == (k in d)
                assert m.get(k, -1) == d.get(k, -1)
                if rng.random() < 0.5:
                    assert m.pop(k, None) == d.pop(k, None)
        assert len(m) == len(d), f"round {round_}"
    assert dict(m.items()) == d
    assert m.key_set() == set(d)


def test_i64map_build_and_grow():
    keys = np.arange(0, 100_000, dtype=np.int64) * 7 + 3
    vals = np.arange(100_000, dtype=np.int64)
    m = I64Map.build(keys, vals)
    assert len(m) == 100_000
    got = m.get_batch(keys)
    assert np.array_equal(got, vals)
    # absent keys miss
    assert np.all(m.get_batch(keys + 1) == -1)


def test_i64map_tombstone_reuse():
    """Heavy insert/delete cycling over a small key set must not grow
    unboundedly (tombstones are reclaimed on rehash)."""
    m = I64Map(cap=64)
    keys = np.arange(0, 40, dtype=np.int64)
    for i in range(200):
        m.put_batch_new(keys, keys * 2)
        assert np.array_equal(m.pop_batch(keys), keys * 2)
        assert len(m) == 0
    assert m.cap <= 1024


def test_intstack():
    s = IntStack.from_range(0, 8)
    # pop order matches list(range(7, -1, -1)).pop()
    assert s.pop() == 0 and s.pop() == 1
    s.push(99)
    assert s.pop() == 99
    s.push_batch(np.array([5, 6, 7]))
    assert len(s) == 9
    got = s.pop_batch(3)
    assert got.tolist() == [5, 6, 7]
    s.push_range(8, 16)
    assert s.pop() == 8  # lowest-first, like the list idiom
    assert bool(s)
    while s:
        s.pop()
    assert not s


# --------------------------------------------------------------------- #
# Parity: the same seeded operation sequence on both packages' maps
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_i64map_op_sequences_equal_the_reference(seed):
    """Every operation's result, the map's length and capacity after
    each round, and the final items in table order are the reference's
    (``uigc_tpu/ops/i64map.py``) on the same numpy-seeded sequence."""
    from uigc_tpu.ops.i64map import I64Map as RefI64Map
    from uigc_tpu.ops.i64map import IntStack as RefIntStack

    rng = np.random.default_rng(seed)
    maps = (RefI64Map(cap=16), I64Map(cap=16))
    present = set()
    key_space = 5000
    for round_ in range(30):
        op = rng.random()
        if op < 0.35:
            cand = np.unique(rng.integers(0, key_space, size=rng.integers(1, 400)))
            new = cand[[k not in present for k in cand.tolist()]]
            vals = rng.integers(0, 1 << 40, size=new.size)
            for m in maps:
                m.put_batch_new(new, vals)
            present.update(new.tolist())
            got = [None, None]
        elif op < 0.55:
            cand = np.unique(rng.integers(0, key_space, size=rng.integers(1, 300)))
            got = [m.pop_batch(cand).tolist() for m in maps]
            present.difference_update(cand.tolist())
        elif op < 0.75:
            cand = rng.integers(0, key_space, size=rng.integers(1, 500))
            got = [m.get_batch(cand).tolist() for m in maps]
        else:
            ks = rng.integers(0, key_space, size=20).tolist()
            vs = rng.integers(0, 1 << 40, size=20).tolist()
            got = []
            for m in maps:
                out = []
                for k, v in zip(ks, vs):
                    if v & 1:
                        m[k] = v
                    else:
                        out.append((k in m, m.get(k, -1), m.pop(k, None)))
                got.append(out)
            for k, v in zip(ks, vs):
                (present.add if v & 1 else present.discard)(k)
        assert got[0] == got[1], f"round {round_}"
        assert (len(maps[0]), maps[0].cap) == (len(maps[1]), maps[1].cap)
    assert list(maps[0].items()) == list(maps[1].items())
    assert maps[0].key_set() == maps[1].key_set() == present

    stacks = (RefIntStack.from_range(0, 8), IntStack.from_range(0, 8))
    extra = np.arange(100, 100 + int(rng.integers(1, 50)))
    popped = []
    for s in stacks:
        s.push_batch(extra)
        s.push_range(20, 30)
        out = s.pop_batch(5).tolist()
        while s:
            out.append(s.pop())
        popped.append(out)
    assert popped[0] == popped[1]
