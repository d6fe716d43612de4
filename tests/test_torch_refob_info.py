"""The port's counterpart of ``tests/test_refob_info.py``: the same tests, names and
assertions, on ``uigc_tpu_torch``.

Model-based test of the packed refob info word.

Analogue of the reference's ScalaCheck property suite (reference:
src/test/scala/edu/illinois/osl/uigc/engines/crgc/RefobInfoSpec.scala:8-61):
random inc/reset/deactivate executions compared against a trivial model.
"""

import random

from uigc_tpu_torch.engines.crgc import refob as refob_info


def check(model, info):
    active, count = model
    assert refob_info.is_active(info) == active
    assert refob_info.count(info) == count


def test_refob_info_model():
    rng = random.Random(12345)
    for _ in range(200):
        ops = ["inc"] * rng.randint(0, 1000) + ["reset"] * rng.randint(0, 1000)
        rng.shuffle(ops)
        ops.append("deactivate")

        model = (True, 0)
        info = refob_info.ACTIVE_REFOB
        check(model, info)
        for op in ops:
            if op == "inc":
                model = (model[0], model[1] + 1)
                info = refob_info.inc_send_count(info)
            elif op == "reset":
                model = (model[0], 0)
                info = refob_info.reset_count(info)
            else:
                model = (False, model[1])
                info = refob_info.deactivate(info)
            check(model, info)


def test_saturation_guard():
    info = refob_info.ACTIVE_REFOB
    while refob_info.can_increment(info):
        info = refob_info.inc_send_count(info)
    # Saturated: count fits in 15 bits, stays active.
    assert refob_info.count(info) == refob_info.SHORT_MAX >> 1
    assert refob_info.is_active(info)
    info = refob_info.deactivate(info)
    assert not refob_info.is_active(info)
    assert refob_info.count(info) == refob_info.SHORT_MAX >> 1
