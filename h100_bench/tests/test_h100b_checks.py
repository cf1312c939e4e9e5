"""The correctness check fails what it must.  With the timed path broken
underneath (harness.Run.variant), a run past the look for a card comes out
not correct, under the cell's own limits: on the CPU at a tiny size, and
the controls on the card at the cell's size."""

import pytest

from h100_bench import harness

from conftest import tiny

FAULTS = [("convnext_ff.stream", "fault:state"), ("convnext_ff.stream", "fault:output"),
          ("convunet_ff.stream", "fault:state"), ("convunet_ff.stream", "fault:output"),
          ("convunet_ff.train", "fault:state"), ("convunet_ff.train", "fault:half_batch")]
CELLS = sorted({c for c, _ in FAULTS})


def _run(cell, variant, device="cpu", seed=11, overrides=None):
    r = harness.make_run(cell, seed, 0.2, False, device, variant=variant,
                         mix_overrides=tiny(cell) if overrides is None else overrides)
    return harness.generator(r.mix).run(r)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_its_check(cell):
    out = _run(cell, None)
    assert out.correct, out.checks


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_fails_the_check(cell, fault):
    out = _run(cell, fault)
    assert not out.correct, out.checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check_on_the_card(cell, card):
    out = _run(cell, "control", "cuda", seed=2 ** 31 + 7, overrides={})
    assert not out.correct, out.checks
