"""The port's ConvNeXt flagship (newunet+feat+future) against rvdd_tpu on the
CPU: the module against the reference's golden and against flax, the weight
converter, the factory, and two streamed steps of the fused flagship step
(the chain kernel's plain version on the CPU) against rvdd_tpu's generic
XLA step.  Inputs come from numpy seeds, weights are flax params converted
by models/convert.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.models.convert import convert_convnext  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu_torch.models import ConvNeXtUNet, build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import convnext_from_flax, convnext_to_flax  # noqa: E402
from rvdd_tpu_torch.models.fast_convnext import fast_forward_cnx, pack_fast_cnx  # noqa: E402
from rvdd_tpu_torch.recurrent import engine  # noqa: E402

ARCH = "newunet-mode=feat"
IN_NC = 9  # (model_patch_depth 2 + future_patch_depth 1) x RGB
GOLDEN = "tests/golden/net_convnext_random.npz"


@pytest.fixture(scope="module")
def flax_flagship():
    """(flax net, params as numpy) of newunet-mode=feat with 9 inputs; the
    params do not depend on the example's spatial size."""
    jnet = jfactory.build_network(ARCH, IN_NC, 3)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(0), (1, 32, 40, IN_NC))
    return jnet, jax.tree_util.tree_map(np.asarray, params)


def port_net(params, arch=ARCH, in_nc=IN_NC):
    net = build_network(arch, in_nc, 3, device="cpu")
    net.load_state_dict(convnext_from_flax(params))
    return net


def norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


def test_module_matches_reference_golden():
    """The reference torch net's own output (tests/golden), its state dict
    converted to flax names and on to the port: 5e-5, the tolerance of
    tests/test_networks.py."""
    g = np.load(GOLDEN)
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd/")}
    net = port_net(convert_convnext(sd), "newunet", 6)
    with torch.no_grad():
        y, feat = net(torch.from_numpy(np.moveaxis(g["x"], 1, -1).copy()))
    assert feat is None
    np.testing.assert_allclose(y.numpy(), np.moveaxis(g["y"], 1, -1), atol=5e-5)


def test_module_matches_flax(flax_flagship):
    """fp32 on both sides at 32x40 with 9 inputs and features: 1e-4
    normalized (summation order of the convs and matmuls)."""
    jnet, params = flax_flagship
    net = port_net(params)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, 32, 40, IN_NC)).astype(np.float32)
    f = np.abs(rng.standard_normal((1, 32, 40, 48))).astype(np.float32)
    want_y, want_f = jax.jit(jnet.apply)({"params": params}, x, f)
    with torch.no_grad():
        got_y, got_f = net(torch.from_numpy(x), torch.from_numpy(f))
    assert norm_err(got_y.numpy(), np.asarray(want_y)) < 1e-4
    assert norm_err(got_f.numpy(), np.asarray(want_f)) < 1e-4


def test_convert_round_trip(flax_flagship):
    _, params = flax_flagship
    back = convnext_to_flax(convnext_from_flax(params))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_build_network_seeded_kaiming():
    a = build_network(ARCH, IN_NC, 3, seed=3, device="cpu")
    b = build_network(ARCH, IN_NC, 3, seed=3, device="cpu")
    assert isinstance(a, ConvNeXtUNet) and a.feature_rec
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        if name.endswith("bias"):
            assert not pa.any(), name
    blk = a.enc_conv1.block0
    assert abs(float(blk.dw.weight.detach().std()) / np.sqrt(2 / 49) - 1) < 0.1  # fan_in 49
    assert abs(float(blk.pw1.weight.detach().std()) / np.sqrt(2 / 48) - 1) < 0.05
    assert (blk.ln.weight == 1).all() and (blk.layerscale.layerscale == 0.1).all()
    assert a.pre.block0.proj.weight.shape == (48, IN_NC, 1, 1)
    assert a.enc_conv0.block0.proj.weight.shape == (48, 96, 1, 1)
    assert not hasattr(a.enc_conv0.block1, "proj")


def test_unsupported_knobs_raise():
    """The three knobs are ported (tests/test_torch_ablations.py); values
    rvdd_tpu's net has not raise."""
    for knob in ("fusion_mode=sum", "downsampling_mode=avgpool", "upsampling_mode=nearest"):
        build_network(f"{ARCH}-{knob}", IN_NC, 3, device="cpu")
    for knob in ("fusion_mode=mul", "downsampling_mode=stridedconv", "upsampling_mode=bicubic"):
        with pytest.raises(NotImplementedError):
            build_network(f"{ARCH}-{knob}", IN_NC, 3, device="cpu")


def _clip(h, w, seed=0):
    """Three RGB frames [1, 3, H, W, 3] (previous, current, future) and the
    smooth field of tests/test_fast_step.py for both flows [1, 2, H, W, 2]."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (1, 3, h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    fl = np.stack([1.5 + np.sin(xx / 20), -0.8 + 0.5 * np.cos(yy / 9)], -1)
    return frames, np.broadcast_to(fl, (1, 2, h, w, 2)).astype(np.float32).copy()


@pytest.fixture(scope="module")
def flagship_exact(flax_flagship):
    """A 64x64 clip (the fast path's minimum) and rvdd_tpu's generic step on
    it (XLA net, XLA warp, fp32), twice with the state carried."""
    jnet, params = flax_flagship
    h = w = 64
    frames, flows = _clip(h, w)
    jcfg = jengine.EngineConfig(model_patch_depth=2, patch_depth=3, future_patch_depth=1,
                                feature_rec=True, net_impl="xla", warp_impl="xla")
    nil = jnet.nil_features(1, h, w)
    first = jax.jit(lambda p, f, g: jengine.inference_step(jcfg, jnet, p, None, f, g, nil))
    nxt = jax.jit(lambda p, s, f, g: jengine.inference_step(jcfg, jnet, p, s, f, g, nil))
    want1, st = first(params, frames, flows)
    want2, _ = nxt(params, st, frames, flows)
    return frames, flows, (np.asarray(want1), np.asarray(want2))


def port_steps(net, frames, flows, preset="fast"):
    """The port's fused flagship step twice, state carried, under ``preset``
    (the chains' plain versions on the CPU)."""
    cfg = engine.EngineConfig(model_patch_depth=2, future_patch_depth=1, feature_rec=True,
                              net_impl="fused", fused_precision=preset)
    fr, fl = torch.from_numpy(frames), torch.from_numpy(flows)
    got1, s = engine.inference_step(cfg, net, None, fr, fl)
    got2, _ = engine.inference_step(cfg, net, s, fr, fl)
    return got1.numpy(), got2.numpy()


def test_fused_flagship_steps_match_rvdd_tpu(flax_flagship, flagship_exact):
    """Two streamed steps of the fused flagship step (the kernels' plain
    versions on the CPU: bf16 bands and weights, tanh GELU, fp32 carry)
    against rvdd_tpu's generic step (XLA net, XLA warp, fp32) at 64x64, the
    fast path's minimum, within tests/test_fast_step.py's envelope:
    normalized max error < 0.2 at step 1 and < 0.3 at step 2."""
    _, params = flax_flagship
    frames, flows, (want1, want2) = flagship_exact
    got1, got2 = port_steps(port_net(params), frames, flows)
    assert got1.shape == (1, 64, 64, 3)
    assert norm_err(got1, want1) < 0.2
    assert norm_err(got2, want2) < 0.3


def test_mixed_flagship_steps_near_exact(flax_flagship, flagship_exact):
    """The fused flagship step under 'mixed' (every chain in the fp32 mode:
    fp32 bands, taps and weights, erf GELU; fp32 warps, frame inputs and
    carry) against rvdd_tpu's exact XLA step: normalized max error below
    1e-4 at both steps (seen: 3.6e-6 and 3.5e-6, fp32 sums in other orders;
    'fast' gives 0.063 and 0.067 on the same clip)."""
    _, params = flax_flagship
    frames, flows, want = flagship_exact
    got = port_steps(port_net(params), frames, flows, "mixed")
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert norm_err(g, w) < 1e-4, norm_err(g, w)


def test_accurate_is_mixed(flax_flagship, flagship_exact):
    """'accurate' computes the same function as 'mixed' (rvdd_tpu maps the
    ConvNeXt chains' 'high' to 'highest'), so the port's two steps are
    identical."""
    _, params = flax_flagship
    frames, flows, _ = flagship_exact
    net = port_net(params)
    for a, b in zip(port_steps(net, frames, flows, "accurate"),
                    port_steps(net, frames, flows, "mixed")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("preset", ["wsplit", "wf32"])
def test_fp32_core_presets_in_fast_envelope(flax_flagship, flagship_exact, preset):
    """'wsplit' and 'wf32' run fast's bf16 chains around an fp32 eighth-res
    core (the 'mid' chain in the fp32 mode, its bf16 input widened and its
    output rounded in the open): packed so, and within fast's envelope
    against the exact step (0.2 / 0.3)."""
    _, params = flax_flagship
    frames, flows, want = flagship_exact
    net = port_net(params)
    packed = pack_fast_cnx(net, True, IN_NC, preset)
    assert {c for c in packed if packed[c].band_fp32} == {"mid"}
    got = port_steps(net, frames, flows, preset)
    for g, w, lim in zip(got, want, (0.2, 0.3)):
        assert np.isfinite(g).all()
        assert norm_err(g, w) < lim, (preset, norm_err(g, w))


def test_fused_state_layout():
    """The flagship's fused state is [den 3 | zeros 5 | feat 48] fp32, and
    the step's output is exactly its first three channels."""
    frames, flows = _clip(64, 64, seed=3)
    cfg = engine.EngineConfig(model_patch_depth=2, future_patch_depth=1, feature_rec=True,
                              net_impl="fused")
    net = build_network(ARCH, IN_NC, 3, seed=1, device="cpu")
    st = engine.init_state(cfg, torch.from_numpy(frames))
    assert st.lastden.shape == (1, 64, 64, 56) and st.lastden.dtype == torch.float32
    den, nxt = engine.inference_step(cfg, net, st, torch.from_numpy(frames),
                                     torch.from_numpy(flows))
    assert nxt.lastden.dtype == torch.float32 and nxt.lastden.shape == (1, 64, 64, 56)
    torch.testing.assert_close(nxt.lastden[..., :3], den, rtol=0, atol=0)
    assert not nxt.lastden[..., 3:8].any() and nxt.lastden[..., 8:].abs().sum() > 0


@pytest.mark.parametrize("fast_act", [False, True])
def test_fast_forward_matches_module(fast_act):
    """The fused forward without the state emit (plain chains on the CPU)
    against the port's fp32 module with the exact or (``fast_act``) the
    tanh GELU of the fused path: bf16 bands and weights, so the fast-step
    envelope (normalized max error < 0.2) applies."""
    net = build_network(ARCH, IN_NC, 3, seed=2, device="cpu", fast_act=fast_act)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, IN_NC)).astype(np.float32))
    f = torch.from_numpy(np.abs(rng.standard_normal((1, 64, 64, 48))).astype(np.float32))
    with torch.no_grad():
        want, want_f = net(x, f)
        got, got_f = fast_forward_cnx(net, pack_fast_cnx(net, True, IN_NC),
                                      x.to(torch.bfloat16), f.to(torch.bfloat16))
    assert got.shape == want.shape and got_f.shape == want_f.shape
    assert norm_err(got.float().numpy(), want.numpy()) < 0.2
    assert norm_err(got_f.float().numpy(), want_f.numpy()) < 0.2

