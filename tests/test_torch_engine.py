"""The port's recurrence engine (rvdd_tpu_torch/recurrent) against
rvdd_tpu's exact engine step (net_impl='xla', warp_impl='xla') on the CPU:
two streamed steps with the state carried, weights converted from the flax
params, inputs from numpy seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import convunet_from_flax  # noqa: E402
from rvdd_tpu_torch.recurrent import engine  # noqa: E402

H = W = 32
ARCH = {True: "convunet-mode=fixedfeatures+feat", False: "convunet-mode=fixedfeatures"}


def nets(feat, seed=0):
    jnet = jfactory.build_network(ARCH[feat], 6, 3, feat)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(seed), (1, H, W, 6))
    net = build_network(ARCH[feat], 6, 3, feat, device="cpu")
    net.load_state_dict(convunet_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jnet, params, net


def clip(seed=0):
    """Two RGB frames [1, 2, H, W, 3] and a smooth flow [1, 1, H, W, 2]
    (tests/test_fast_step.py's field)."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (1, 2, H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    fl = np.stack([1.5 + np.sin(xx / 20), -0.8 + 0.5 * np.cos(yy / 9)], -1)
    flows = np.broadcast_to(fl, (1, 1, H, W, 2)).astype(np.float32).copy()
    return frames, flows


def reference_steps(feat, jnet, params, frames, flows):
    """rvdd_tpu's exact step, twice, state carried."""
    cfg = jengine.EngineConfig(model_patch_depth=2, feature_rec=feat)
    nil = jnet.nil_features(1, H, W) if feat else None
    fr, fl = jax.numpy.asarray(frames), jax.numpy.asarray(flows)
    first = jax.jit(lambda p, f, g: jengine.inference_step(cfg, jnet, p, None, f, g, nil))
    nxt = jax.jit(lambda p, s, f, g: jengine.inference_step(cfg, jnet, p, s, f, g, nil))
    d1, s = first(params, fr, fl)
    d2, _ = nxt(params, s, fr, fl)
    return np.asarray(d1), np.asarray(d2)


def port_steps(cfg, net, frames, flows):
    nil = net.nil_features(1, H, W) if cfg.feature_rec else None
    fr, fl = torch.from_numpy(frames), torch.from_numpy(flows)
    d1, s = engine.inference_step(cfg, net, None, fr, fl, nil)
    d2, _ = engine.inference_step(cfg, net, s, fr, fl, nil)
    return d1.numpy(), d2.numpy()


def norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


@pytest.mark.parametrize("feat", [True, False])
def test_module_steps_match_rvdd_tpu(feat):
    """fp32 module path with the plain warp: 1e-4 normalized (conv and
    gather summation order only)."""
    jnet, params, net = nets(feat)
    frames, flows = clip()
    want1, want2 = reference_steps(feat, jnet, params, frames, flows)
    cfg = engine.EngineConfig(model_patch_depth=2, feature_rec=feat)
    got1, got2 = port_steps(cfg, net, frames, flows)
    assert norm_err(got1, want1) < 1e-4
    assert norm_err(got2, want2) < 1e-4


@pytest.mark.parametrize("feat", [True, False])
def test_fused_steps_match_rvdd_tpu_exact(feat):
    """The fused path (the kernels' plain versions on the CPU: bf16 bands
    and weights, fp32 carry) against rvdd_tpu's exact step, within
    tests/test_fast_step.py's envelope: normalized max error < 0.2 at step
    1 and < 0.3 at step 2."""
    jnet, params, net = nets(feat, seed=1)
    frames, flows = clip(seed=1)
    want1, want2 = reference_steps(feat, jnet, params, frames, flows)
    cfg = engine.EngineConfig(model_patch_depth=2, feature_rec=feat,
                              net_impl="fused")
    got1, got2 = port_steps(cfg, net, frames, flows)
    assert got1.shape == want1.shape == (1, H, W, 3)
    assert norm_err(got1, want1) < 0.2
    assert norm_err(got2, want2) < 0.3


def test_prepare_frames_matches_rvdd_tpu():
    """Demosaic and x2 flow upsample from packed raw: 1e-5."""
    rng = np.random.default_rng(2)
    raw = rng.uniform(-1, 1, (1, 2, 8, 12, 4)).astype(np.float32)
    fl = (rng.standard_normal((1, 1, 1, 8, 12, 2)) * 2).astype(np.float32)
    jcfg = jengine.EngineConfig(model_patch_depth=2, feature_rec=True)
    want_f, want_fl = jengine.prepare_frames(jcfg, jax.numpy.asarray(raw),
                                             jax.numpy.asarray(fl))
    cfg = engine.EngineConfig(model_patch_depth=2, feature_rec=True)
    got_f, got_fl = engine.prepare_frames(cfg, torch.from_numpy(raw), torch.from_numpy(fl))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-5)
    np.testing.assert_allclose(got_fl.numpy(), np.asarray(want_fl), atol=1e-5)


def test_fused_state_layout():
    """init_state: [prev noisy frame 3 | zeros 5 | zero features 48] fp32;
    a fused step returns the next state in the same layout."""
    frames, flows = clip(seed=3)
    cfg = engine.EngineConfig(model_patch_depth=2, feature_rec=True,
                              net_impl="fused")
    st = engine.init_state(cfg, torch.from_numpy(frames))
    assert st.lastden.shape == (1, H, W, 56) and st.lastden.dtype == torch.float32
    torch.testing.assert_close(st.lastden[..., :3], torch.from_numpy(frames[:, 0]))
    assert not st.lastden[..., 3:].any()
    net = build_network(ARCH[True], 6, 3, True, device="cpu")
    den, nxt = engine.inference_step(cfg, net, st, torch.from_numpy(frames),
                                     torch.from_numpy(flows))
    torch.testing.assert_close(nxt.lastden[..., :3], den, rtol=0, atol=0)
    assert not nxt.lastden[..., 3:8].any() and nxt.lastden[..., 8:].abs().sum() > 0


def test_kernel_warp_module_path_runs_plain_on_cpu():
    """warp_impl='kernel' on CPU tensors runs the warp's plain version: the
    module path gives exactly what warp_impl='plain' gives."""
    frames, flows = clip(seed=4)
    net = build_network(ARCH[True], 6, 3, True, device="cpu")
    outs = []
    for impl in ("plain", "kernel"):
        cfg = engine.EngineConfig(model_patch_depth=2, feature_rec=True,
                                  warp_impl=impl)
        outs.append(port_steps(cfg, net, frames, flows))
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("knob", [dict(warp_raw=True), dict(no_predemosaic=True),
                                  dict(output_nc=4), dict(model_patch_depth=3)])
def test_fused_unsupported_configs_raise(knob):
    """The settings rvdd_tpu's fused step refuses too
    (rvdd_tpu/recurrent/engine.py:375-379); its other options are ported
    (tests/test_torch_fused_options.py)."""
    kw = dict(model_patch_depth=2, feature_rec=True, net_impl="fused")
    kw.update(knob)
    cfg = engine.EngineConfig(**kw)
    frames = torch.zeros(1, 3, H, W, 3)
    with pytest.raises(NotImplementedError):
        engine.init_state(cfg, frames)
