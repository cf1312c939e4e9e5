"""The fused step's ``prev_noisy_frame`` option in the port against
rvdd_tpu's fused step (Pallas kernels in interpret mode) and its generic
exact step, on the CPU; the cases and helpers are
tests/test_torch_fused_options.py's (a file of its own so that the two run
side by side)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_fused_options import (  # noqa: E402
    GLUE,
    check,
    jax_exact,
    jax_fused,
    jax_state_den,
    port_steps,
    setup,  # noqa: F401  (the module fixture)
)


@pytest.mark.parametrize("preset", ["fast", "mixed"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_prev_noisy_frame_matches_rvdd_tpu(setup, preset, state_dtype):
    """prev_noisy_frame with the plain state warp (warp_impl='plain', as
    rvdd_tpu's fused step's default 'xla'): the outputs as the other
    options, and the carried state's den block is the current frame rounded
    to the glue dtype, then to the state's, bit for bit as rvdd_tpu's, at
    both steps."""
    _, _, net, frames, flows = setup
    opts = dict(prev_noisy_frame=True, state_dtype=state_dtype)
    jfused, jstates = jax_fused(setup, preset, **opts)
    jexact = jax_exact(setup, **opts)
    got, states = port_steps(net, frames, flows, preset, warp_impl="plain", **opts)
    check(got, jfused, jexact, preset)
    sd = GLUE[preset] if state_dtype == "bfloat16" else torch.float32
    want = torch.from_numpy(frames[0, 1]).to(GLUE[preset]).to(sd)
    for st, jst in zip(states, jstates):
        assert st.lastden.dtype == sd
        den = st.lastden[0, ..., :3]
        assert torch.equal(den, want)
        np.testing.assert_array_equal(den.float().numpy(), jax_state_den(jst))
        assert not st.lastden[..., 3:8].any()
