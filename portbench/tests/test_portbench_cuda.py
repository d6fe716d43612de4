"""On the card, at a size a test run can hold: the cell's timed path
through the program's CUDA path is correct, and its control is not.
(The control at the cell's own size is run by ``python3 -m
portbench.run ... --control 1``; PERF.md keeps its readings.)"""

import pytest

from portbench.tests.rehearsal import rehearse

PASSES = dict(cell="powerlaw10m.full", sizes={"actors": 200_000})


@pytest.mark.cuda
def test_sound_on_the_card(card):
    r = rehearse(seed=21, seconds=2.0, device="cuda", **PASSES)
    assert r["correct"], r["checks"]


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    r = rehearse(seed=22, seconds=2.0, device="cuda", control=True, **PASSES)
    assert not r["correct"], r["checks"]
