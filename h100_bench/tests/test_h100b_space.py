"""The multi-card generator rehearsed on the CPU: four gloo processes, a
tiny whole-frame patch cut over the space axis.  The program passes its
check against the reference on whole frames; a step that leaves the
gradient reduction out, drops half the batch or leaves its state unchanged
fails it."""

import pytest

from h100_bench import harness

CELL = "convnext_ff.train_space4"
TINY = dict(patch_height=32, patch_width=24, pool=4, trace_steps=2)


def _run(variant=None, trace=False):
    r = harness.make_run(CELL, 2 ** 31 + 99, 0.5, trace, "cpu", variant=variant,
                         mix_overrides=TINY)
    return harness.generator(r.mix).run(r)


def test_the_sharded_step_passes_its_check_and_traces_every_rank():
    out = _run(trace=True)
    assert out.correct, out.checks
    assert out.count == 4 and len(out.per_rank_busy) == 4


@pytest.mark.parametrize("fault", ["fault:no_reduce", "fault:half_batch", "fault:state"])
def test_a_planted_fault_fails_the_sharded_check(fault):
    out = _run(fault)
    assert not out.correct, out.checks
