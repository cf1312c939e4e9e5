"""The fused step's options in the port (rvdd_tpu_torch/recurrent/engine.py:
_fused_step) against rvdd_tpu's fused step (Pallas kernels in interpret
mode) and its generic exact step (XLA net and warp), on the CPU:
``no_warp`` (and flows of None), ``prev_noisy_frame``, the bf16 carry
(``state_dtype='bfloat16'``) and the plain state warp (``warp_impl='plain'``,
rvdd_tpu's diagnostic ``warp_impl='xla'``, which rvdd_tpu's fused step runs
by default).  convunet+feat+future at 32x32, weights converted from flax
params, inputs from numpy seeds; each case runs two steps with the state
carried, in 'fast' and in 'mixed' (an fp32-glue preset), under each
state_dtype."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.ops.pallas.warp_rowmajor import STATE_PAD_LEFT  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import convunet_from_flax  # noqa: E402
from rvdd_tpu_torch.recurrent import engine  # noqa: E402

H = W = 32
FD = 1
IN_NC = (2 + FD) * 3
ARCH = "convunet-mode=fixedfeatures+feat"
#: normalized max error at steps 1 and 2: against the exact step, 'fast''s
#: envelope (tests/test_fast_step.py:22); against rvdd_tpu's fused step in
#: the same preset, tests/test_torch_presets.py's bounds
EXACT = (0.2, 0.3)
FUSED = {"fast": (0.2, 0.3), "mixed": (1e-3, 2e-3)}
GLUE = {"fast": torch.bfloat16, "mixed": torch.float32}


@pytest.fixture(scope="module")
def setup():
    jnet = jfactory.build_network(ARCH, IN_NC, 3, True)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(3), (1, H, W, IN_NC))
    net = build_network(ARCH, IN_NC, 3, True, device="cpu")
    net.load_state_dict(convunet_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(21)
    frames = rng.uniform(-1, 1, (1, 2 + FD, H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    fl = np.stack([1.3 + np.sin(xx / 14), -0.9 + 0.5 * np.cos(yy / 10)], -1)
    flows = np.broadcast_to(fl, (1, 1 + FD, H, W, 2)).astype(np.float32).copy()
    return jnet, params, net, frames, flows


def jax_steps(jnet, params, frames, flows, fused, **opts):
    """rvdd_tpu's step twice, state carried: (outputs, states)."""
    import jax.experimental.pallas as pl_mod

    kw = dict(model_patch_depth=2, patch_depth=2 + FD, future_patch_depth=FD,
              feature_rec=True, **opts)
    if fused is not None:
        kw.update(net_impl="fused", fused_precision=fused)
    cfg = jengine.EngineConfig(**kw)
    nil = jnet.nil_features(1, H, W)
    fr = jax.numpy.asarray(frames)
    fl = None if flows is None else jax.numpy.asarray(flows)
    def two(p, f, g):
        d1, s1 = jengine.inference_step(cfg, jnet, p, None, f, g, nil)
        d2, s2 = jengine.inference_step(cfg, jnet, p, s1, f, g, nil)
        return d1, s1, d2, s2

    orig = pl_mod.pallas_call
    pl_mod.pallas_call = lambda *a, **k: orig(*a, **dict(k, interpret=True))
    try:
        d1, s1, d2, s2 = jax.jit(two)(params, fr, fl)
    finally:
        pl_mod.pallas_call = orig
    return (np.asarray(d1), np.asarray(d2)), (s1, s2)


_EXACT = {}
_FUSED = {}


def jax_fused(setup, preset, **opts):
    """rvdd_tpu's fused steps in ``preset`` under ``opts``, computed once a
    module for each configuration rvdd_tpu tells apart: its fp32-glue
    presets carry fp32 whatever ``state_dtype`` says."""
    eff = dict(opts)
    if GLUE[preset] == torch.float32:
        eff["state_dtype"] = "float32"
    key = (preset,) + tuple(sorted(eff.items()))
    if key not in _FUSED:
        jnet, params, _, frames, flows = setup
        _FUSED[key] = jax_steps(jnet, params, frames, flows, preset, **eff)
    return _FUSED[key]


def jax_exact(setup, **opts):
    """rvdd_tpu's exact steps under ``opts``, computed once a module."""
    key = tuple(sorted(opts.items()))
    if key not in _EXACT:
        jnet, params, _, frames, flows = setup
        _EXACT[key] = jax_steps(jnet, params, frames, flows, None, **opts)[0]
    return _EXACT[key]


def port_steps(net, frames, flows, preset, **opts):
    cfg = engine.EngineConfig(model_patch_depth=2, future_patch_depth=FD, feature_rec=True,
                              net_impl="fused", fused_precision=preset, **opts)
    fr = torch.from_numpy(frames)
    fl = None if flows is None else torch.from_numpy(flows)
    d1, s1 = engine.inference_step(cfg, net, None, fr, fl)
    d2, s2 = engine.inference_step(cfg, net, s1, fr, fl)
    return (d1.float().numpy(), d2.float().numpy()), (s1, s2)


def norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


def jax_state_den(state) -> np.ndarray:
    """The den channels [H, W, 3] of rvdd_tpu's planar fused state, as fp32."""
    st = np.asarray(state.lastden[0].astype(jax.numpy.float32))
    return st.reshape(H, -1, st.shape[-1])[:, :3, STATE_PAD_LEFT:STATE_PAD_LEFT + W].transpose(
        0, 2, 1)


def check(got, jfused, jexact, preset):
    for step in range(2):
        g = got[step]
        assert g.shape == (1, H, W, 3) and np.isfinite(g).all()
        assert norm_err(g, jexact[step]) < EXACT[step], (step, norm_err(g, jexact[step]))
        assert norm_err(g, jfused[step]) < FUSED[preset][step], (step, norm_err(g, jfused[step]))


@pytest.mark.parametrize("preset", ["fast", "mixed"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_no_warp_matches_rvdd_tpu(setup, preset, state_dtype):
    """no_warp: the state's image region and the future frame go unwarped.
    flows=None gives exactly what no_warp gives."""
    _, _, net, frames, flows = setup
    opts = dict(no_warp=True, state_dtype=state_dtype)
    jfused, _ = jax_fused(setup, preset, **opts)
    jexact = jax_exact(setup, **opts)
    got, _ = port_steps(net, frames, flows, preset, **opts)
    check(got, jfused, jexact, preset)
    none, _ = port_steps(net, frames, None, preset, state_dtype=state_dtype)
    for a, b in zip(got, none):
        np.testing.assert_array_equal(a, b)


def test_warp_impl_default_is_auto():
    """The fused path's default warp is the kernel ('auto'); the module
    path's is the plain warp."""
    cfg = engine.EngineConfig()
    assert cfg.warp_impl == "auto"
    with pytest.raises(ValueError):
        engine._check_fused(engine.EngineConfig(net_impl="fused", warp_impl="shift"))
