"""The port's whole-clip streaming (rvdd_tpu_torch/recurrent/engine.py:
scan_video) against rvdd_tpu's scan_video with its exact step (net_impl
'xla', XLA warp) on the CPU: a 4-frame clip of convunet+feat+future at
32x32 (weights converted from flax params, inputs from numpy seeds), zero
flows at the clip's edges as the callers give them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import convunet_from_flax  # noqa: E402
from rvdd_tpu_torch.recurrent import engine  # noqa: E402

T, H, W, FD = 4, 32, 32, 1
IN_NC = (2 + FD) * 3
ARCH = "convunet-mode=fixedfeatures+feat"


@pytest.fixture(scope="module")
def clip():
    jnet = jfactory.build_network(ARCH, IN_NC, 3, True)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(5), (1, H, W, IN_NC))
    net = build_network(ARCH, IN_NC, 3, True, device="cpu")
    net.load_state_dict(convunet_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(8)
    frames = rng.uniform(-1, 1, (T, 1, H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    fl = np.stack([1.1 + np.sin(xx / 12), -0.6 + 0.4 * np.cos(yy / 9)], -1).astype(np.float32)
    flows = np.zeros((T, 1, 1 + FD, H, W, 2), np.float32)
    flows[1:, :, 0] = fl  # the previous frame's flow; none for frame 0
    flows[:-1, :, 1] = -fl  # the future frame's; none for the last frame
    cfg = jengine.EngineConfig(model_patch_depth=2, patch_depth=2 + FD,
                               future_patch_depth=FD, feature_rec=True)
    nil = jnet.nil_features(1, H, W)
    want = jax.jit(lambda p, f, g: jengine.scan_video(cfg, jnet, p, f, g, nil))(
        params, jax.numpy.asarray(frames), jax.numpy.asarray(flows))
    return net, frames, flows, np.asarray(want)


def port_scan(net, frames, flows, **kw):
    cfg = engine.EngineConfig(model_patch_depth=2, future_patch_depth=FD, feature_rec=True, **kw)
    nil = net.nil_features(1, H, W)
    return engine.scan_video(cfg, net, torch.from_numpy(frames), torch.from_numpy(flows),
                             nil).numpy()


def norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


def test_scan_video_module_path_matches_rvdd_tpu(clip):
    """The module path, fp32: every frame within 1e-4 normalized
    (tests/test_torch_engine.py's bound)."""
    net, frames, flows, want = clip
    got = port_scan(net, frames, flows)
    assert got.shape == want.shape == (T, 1, H, W, 3)
    for t in range(T):
        assert norm_err(got[t], want[t]) < 1e-4, (t, norm_err(got[t], want[t]))


def test_scan_video_fused_path_in_fast_envelope(clip):
    """The fused path under 'fast' (the kernels' plain versions): frame 0
    within 0.2 normalized of rvdd_tpu's exact scan, every later frame
    within 0.3 (tests/test_fast_step.py's envelope)."""
    net, frames, flows, want = clip
    got = port_scan(net, frames, flows, net_impl="fused")
    assert got.shape == want.shape and np.isfinite(got).all()
    for t in range(T):
        assert norm_err(got[t], want[t]) < (0.2 if t == 0 else 0.3), (t, norm_err(got[t], want[t]))


def test_scan_video_is_inference_steps(clip):
    """scan_video is the per-frame loop: frame t's window is [t-1, t+1]
    with the edges replicated, and the recurrence starts from the
    replicated first frame (so frame 0 sees a carried state)."""
    net, frames, flows, _ = clip
    got = port_scan(net, frames, flows)
    cfg = engine.EngineConfig(model_patch_depth=2, future_patch_depth=FD, feature_rec=True)
    nil = net.nil_features(1, H, W)
    fr = torch.from_numpy(frames)
    idx = lambda t: [max(t - 1, 0), t, min(t + 1, T - 1)]  # noqa: E731
    state = engine.init_state(cfg, fr[idx(0)].transpose(0, 1), nil)
    for t in range(T):
        den, state = engine.inference_step(cfg, net, state, fr[idx(t)].transpose(0, 1),
                                           torch.from_numpy(flows[t]), nil)
        np.testing.assert_array_equal(den.numpy(), got[t])
