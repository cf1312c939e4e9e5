"""The port's schedules (rvdd_tpu_torch/recurrent/schedules.py, and
training/train_state.py:lr_for_epoch) against rvdd_tpu's and the
reference's golden: the unrolling weights and active unrollings of every
``--unroll_focus`` over epochs and iterations, and the learning rate of
every ``--lr_policy``, the plateau policy's literal reference schedule
included.  Exact, or within 1e-6 of the golden."""

import numpy as np
import pytest

pytest.importorskip("jax")

from rvdd_tpu.recurrent import schedules as jschedules  # noqa: E402
from rvdd_tpu.training.train_state import lr_for_epoch as jlr_for_epoch  # noqa: E402
from rvdd_tpu_torch.recurrent.schedules import active_unrollings, unroll_weights  # noqa: E402
from rvdd_tpu_torch.training.train_state import lr_for_epoch  # noqa: E402

FOCUSES = {"all": "all", "ge_1": "ge1", "gradual04_from20": "gradual04from20",
           "graduni04_from20": "graduni04from20"}
TD = 4


@pytest.mark.parametrize("focus", sorted(FOCUSES))
def test_unroll_weights_match_the_golden_and_rvdd_tpu(golden, focus):
    g = golden("unroll_schedules")
    key = FOCUSES[focus]
    for row, (epoch, it, length) in enumerate(g[f"{key}_meta"]):
        w = unroll_weights(focus, TD, int(epoch), int(it), int(length))
        padded = np.zeros(g[f"{key}_w"].shape[1], np.float32)
        padded[:len(w)] = w
        np.testing.assert_allclose(padded, g[f"{key}_w"][row], atol=1e-6)
    for epoch in range(1, 41):
        for it in (0, 17, 99):
            w = unroll_weights(focus, TD, epoch, it, 100)
            want = jschedules.unroll_weights(focus, TD, epoch, it, 100)
            assert w.dtype == want.dtype and np.array_equal(w, want), (epoch, it)
            assert len(w) == active_unrollings(focus, TD, epoch)
        assert active_unrollings(focus, TD, epoch) == jschedules.active_unrollings(
            focus, TD, epoch)


@pytest.mark.parametrize("policy", ["linear", "step", "cosine", "plateau"])
def test_lr_for_epoch_matches_rvdd_tpu(policy):
    for niter, decay, iters in ((70, 30, 50), (3, 5, 2)):
        for epoch in range(1, niter + decay + 2):
            got = lr_for_epoch(epoch, 1.6e-4, policy, niter, decay, iters)
            assert got == jlr_for_epoch(epoch, 1.6e-4, policy, niter, decay, iters), epoch
    with pytest.raises(NotImplementedError):
        lr_for_epoch(1, 1.0, "exponential", 1, 1)
