"""The raw pair tier's kernel on the card (``csrc/propagate.cu``
``propagate_pairs_kernel``): held bit for bit against its plain twin
(``ops/propagate.py`` ``propagate_pairs_torch``) over the tier's edge
cases, and the decremental wake that launches it once a sweep held
against the CPU path's marks and sweep counts.

Every test here needs a CUDA card and skips without one.  On a machine
with a card and no JAX, run it without the repo's conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_pairs.py -q

This file imports neither jax nor uigc_tpu for that reason.
"""

import numpy as np
import pytest
import torch

from uigc_tpu_torch.ops import propagate as prop

from test_torch_propagate_pairs import (CASES, PairChurn, churned_wakes,
                                        oracle, pairs_case, tensors)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pairs kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_plain_twin(dev, name):
    """The card's words equal the twin's and the numpy oracle's bit for
    bit, what ``out`` held is kept, the operands are left unchanged, and
    one launch is counted a call."""
    case = pairs_case(name)
    want = prop.propagate_pairs(*tensors(case))
    assert np.array_equal(want.numpy(), oracle(*case))
    table, src, dst, out, n = tensors(case, dev)
    kept = [x.clone() for x in (table, src, dst)]
    before = prop.launches["pairs"]
    got = prop.propagate_pairs(table, src, dst, out, n)
    torch.cuda.synchronize()
    assert got is out
    assert prop.launches["pairs"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert all(torch.equal(a, b) for a, b in zip((table, src, dst), kept))


@pytest.mark.parametrize("mode", ("push", "auto"))
def test_decremental_wake_on_the_card_matches_the_cpu_path(dev, mode):
    """A 1<<16-actor tracer through churned wakes on the card and on the
    CPU: marks and sweeps equal wake for wake, and the pairs kernel
    launches once a closure or repair sweep of every wake whose tiers
    include the live tier, and never otherwise."""
    churn = PairChurn(1 << 16, seed=7)
    tracers = [churn.tracer(d, freeze_threshold=512, mode=mode)
               for d in (torch.device("cpu"), dev)]
    seen = {True: 0, False: 0}
    before = prop.launches["pairs"]
    for (cpu, card), (st_cpu, st), live_tier in churned_wakes(
            churn, tracers, 12):
        launched, before = prop.launches["pairs"] - before, prop.launches["pairs"]
        assert np.array_equal(card, cpu)
        assert np.array_equal(cpu, churn.oracle())
        for key in ("closure_sweeps", "n_sweeps"):
            assert int(st[key]) == int(st_cpu[key]), key
        sweeps = int(st["closure_sweeps"]) + int(st["n_sweeps"])
        assert launched == (sweeps if live_tier else 0)
        seen[live_tier] += 1
    assert seen[True] >= 6 and seen[False] >= 2
