"""The fused step's bf16 carry (``state_dtype='bfloat16'``) and plain state
warp (``warp_impl='plain'``) in the port against rvdd_tpu's fused step
(Pallas kernels in interpret mode) and its generic exact step, on the CPU;
the cases and helpers are tests/test_torch_fused_options.py's (a file of
its own so that the two run side by side)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_fused_options import (  # noqa: E402
    GLUE,
    check,
    jax_exact,
    jax_fused,
    port_steps,
    setup,  # noqa: F401  (the module fixture)
)


@pytest.mark.parametrize("preset", ["fast", "mixed"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_state_dtype_and_plain_warp_match_rvdd_tpu(setup, preset, state_dtype):
    """The warped path: the carry in the glue dtype under 'bfloat16' (bf16
    under 'fast', fp32 under 'mixed', as rvdd_tpu's), rounded once after
    the emit; warp_impl='plain' against rvdd_tpu's fused step (its default
    'xla' warp of the state), and the default 'auto' (the kernel, whose
    plain version runs on CPU tensors) gives the same values."""
    _, _, net, frames, flows = setup
    jfused, jstates = jax_fused(setup, preset, state_dtype=state_dtype)
    jexact = jax_exact(setup, state_dtype=state_dtype)
    got, states = port_steps(net, frames, flows, preset, warp_impl="plain",
                             state_dtype=state_dtype)
    check(got, jfused, jexact, preset)
    sd = GLUE[preset] if state_dtype == "bfloat16" else torch.float32
    for st, jst, den in zip(states, jstates, got):
        assert st.lastden.dtype == sd
        assert str(jst.lastden.dtype) == str(sd).replace("torch.", "")
        # the output is the carried state's den block (rounded to the carry)
        np.testing.assert_array_equal(st.lastden[0, ..., :3].float().numpy(), den[0])
    auto, _ = port_steps(net, frames, flows, preset, state_dtype=state_dtype)
    for a, b in zip(got, auto):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
