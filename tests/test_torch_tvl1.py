"""The port's TV-L1 solver (rvdd_tpu_torch/ops/tvl1.py), its solver-mode
warp and online-flow streaming against rvdd_tpu on the CPU.

Each check feeds the same numpy inputs, made from seeds, to the JAX
function and to the port.  On the CPU the solver-mode wrapper
``warp_catmull_zero`` runs its plain version, which is held against
rvdd_tpu's gather form and against ``warp_bicubic_pallas(coeff_a=-0.5,
zero_outside=True)`` in interpret mode.  rvdd_tpu's iterations per warp
stage are read by wrapping ``jax.lax.while_loop`` with a debug callback.
Sizes stay at 1-3 pyramid scales: every JAX solver shape is an XLA:CPU
compile.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.ops import tvl1 as jtvl1  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu_torch import bench  # noqa: E402
from rvdd_tpu_torch.models.convert import convunet_from_flax  # noqa: E402
from rvdd_tpu_torch.ops import tvl1  # noqa: E402
from rvdd_tpu_torch.ops.cuda.warp_bicubic import (  # noqa: E402
    warp_catmull_zero,
    warp_catmull_zero_plain,
)
from rvdd_tpu_torch.recurrent import engine  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want, rel=1e-5):
    """Within ``rel`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


# ------------------------------------------------------------ building blocks


@pytest.mark.parametrize("c", [3, 4])
def test_to_gray_matches_rvdd_tpu(c):
    """RGB (weighted sum) and packed raw (channel mean): 1e-5 relative."""
    x = np.random.default_rng(c).uniform(-1, 1, (2, 6, 7, c)).astype(np.float32)
    _close(tvl1.to_gray(_t(x)).numpy(), jtvl1.to_gray(jnp.asarray(x)))


@pytest.mark.parametrize("sigma", [0.8, 1.039])
@pytest.mark.parametrize("shape", [(13, 17), (9, 15)])
def test_gaussian_smooth_matches_rvdd_tpu(sigma, shape):
    """Odd sizes, the presmoothing sigma and the zoom's: 1e-5 relative."""
    x = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    _close(tvl1.gaussian_smooth(_t(x), sigma).numpy(), jtvl1.gaussian_smooth(jnp.asarray(x), sigma))


@pytest.mark.parametrize("factor", [0.5, 0.7])
def test_zoom_out_matches_rvdd_tpu(factor):
    """Stride-2 subsample (0.5) and the general Catmull-Rom path: 1e-5."""
    x = np.random.default_rng(2).uniform(0, 255, (17, 31)).astype(np.float32)
    _close(tvl1._zoom_out(_t(x), factor).numpy(), jtvl1._zoom_out(jnp.asarray(x), factor))


def test_catmull_resize_matches_rvdd_tpu():
    """The flow upsample between scales on the stacked [2, H, W] flow, held
    against rvdd_tpu per plane: 1e-5 relative."""
    x = np.random.default_rng(3).standard_normal((2, 9, 15)).astype(np.float32)
    got = tvl1._catmull_resize(_t(x), 17, 30).numpy()
    want = np.stack([np.asarray(jtvl1._catmull_resize(jnp.asarray(p), 17, 30)) for p in x])
    _close(got, want)


def test_stencils_match_rvdd_tpu():
    """Centered and forward gradients and the divergence, mask.c borders."""
    rng = np.random.default_rng(4)
    f, v1, v2 = (rng.standard_normal((11, 13)).astype(np.float32) for _ in range(3))
    for g, w in zip(tvl1._centered_gradient(_t(f)), jtvl1._centered_gradient(jnp.asarray(f))):
        _close(g.numpy(), w)
    for g, w in zip(tvl1._forward_gradient(_t(f)), jtvl1._forward_gradient(jnp.asarray(f))):
        _close(g.numpy(), w)
    _close(tvl1._divergence(_t(v1), _t(v2)).numpy(),
           jtvl1._divergence(jnp.asarray(v1), jnp.asarray(v2)))


def test_num_scales_matches_rvdd_tpu():
    for p in (tvl1.TVL1Params(), tvl1.TVL1Params(nscales=3), tvl1.TVL1Params(zfactor=0.7)):
        jp = jtvl1.TVL1Params(**p._asdict())
        for nx in (8, 16, 24, 33, 64, 100, 511, 960, 1920):
            for ny in (8, 16, 23, 48, 540, 1080):
                assert tvl1._num_scales(nx, ny, p) == jtvl1._num_scales(nx, ny, jp)


def test_flow_presets():
    """The fast preset is rvdd_tpu's bench.py --fast_flow one."""
    assert tvl1.resolve_params(None) == tvl1.TVL1Params() == tvl1.FLOW_PRESETS["default"]
    assert tvl1.resolve_params("fast") == tvl1.TVL1Params(nwarps=2, max_iterations=75)
    assert tuple(tvl1.TVL1Params()) == tuple(jtvl1.TVL1Params())
    with pytest.raises(ValueError):
        tvl1.resolve_params("fastest")


# ------------------------------------------------------------ solver warp


def _warp_case(h, w, c, kind, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, h, w, c)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "smooth":
        fl = np.stack([0.7 + 1.3 * np.sin(xx / 9), -0.4 + np.cos(yy / 5)], -1)
    else:  # many taps outside the frame
        fl = np.stack([9.0 * np.sin(xx / 7 + yy / 5), -6.0 * np.cos(yy / 3)], -1)
    return x, fl.astype(np.float32)[None]


@pytest.mark.parametrize("kind", ["smooth", "outside"])
@pytest.mark.parametrize("c", [1, 4])
def test_warp_catmull_zero_plain_matches_gather_form(c, kind):
    """The plain solver-mode warp against rvdd_tpu's gather form (its CPU
    path of _warp_catmull_zero), one plane at a time: 1e-5.  The gather
    form clips the coordinate before floor, the port clamps each tap; the
    zeroing removes every pixel where they could differ."""
    x, fl = _warp_case(19, 27, c, kind)
    got = warp_catmull_zero_plain(_t(x), _t(fl)).numpy()
    u, v = jnp.asarray(fl[0, ..., 0]), jnp.asarray(fl[0, ..., 1])
    want = np.stack([np.asarray(jtvl1._warp_catmull_zero(jnp.asarray(x[0, ..., k]), u, v))
                     for k in range(c)], -1)[None]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got == 0).mean() > (0.25 if kind == "outside" else 0.05)  # the zeroing acts


@pytest.mark.parametrize("kind", ["smooth", "outside"])
@pytest.mark.parametrize("c", [1, 4])
def test_warp_catmull_zero_plain_matches_warp_bicubic_pallas(pallas_interpret, c, kind):
    """Against rvdd_tpu's Pallas kernel in the solver's mode (coeff_a=-0.5,
    zero_outside=True) in interpret mode, with max_disp above every flow so
    its clamp never acts: 1e-5 (order of the 16 fp32 products)."""
    from rvdd_tpu.ops.pallas.warp_pallas import warp_bicubic_pallas

    x, fl = _warp_case(24, 100, c, kind, seed=1)
    got = warp_catmull_zero_plain(_t(x), _t(fl)).numpy()
    want, _ = warp_bicubic_pallas(jnp.asarray(x), jnp.asarray(fl), max_disp=16, tile_h=8,
                                  tile_w=128, group=c, coeff_a=-0.5, zero_outside=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_warp_catmull_zero_wrapper_runs_plain_on_cpu():
    x, fl = _warp_case(9, 13, 4, "smooth", seed=2)
    before = warp_catmull_zero.launches
    got = warp_catmull_zero(_t(x), _t(fl))
    assert warp_catmull_zero.launches == before
    torch.testing.assert_close(got, warp_catmull_zero_plain(_t(x), _t(fl)), rtol=0, atol=0)


# ------------------------------------------------------------ the solver


def rvdd_tpu_flow(monkeypatch, i0, i1, params):
    """rvdd_tpu's tvl1_flow and its iterations per warp stage: a fresh jit
    of the solver with lax.while_loop wrapped so the final count reaches
    the host through an ordered debug callback."""
    counts = []
    orig = jax.lax.while_loop

    def while_loop(cond, body, init):
        out = orig(cond, body, init)
        jax.debug.callback(lambda n: counts.append(int(n)), out[-1], ordered=True)
        return out

    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    fn = jax.jit(jtvl1.tvl1_flow.__wrapped__, static_argnames=("params",))
    flow = np.asarray(fn(jnp.asarray(i0), jnp.asarray(i1), params))
    jax.effects_barrier()
    return flow, counts


def textured_pair(h, w, seed=5):
    """A smooth texture and its copy moved by (-1.6, +0.7) px, with noise."""
    from scipy.ndimage import gaussian_filter, shift

    rng = np.random.default_rng(seed)
    tex = gaussian_filter(rng.standard_normal((h, w)), 2) * 40 + 100
    moved = shift(tex, (0.7, -1.6), order=3, mode="mirror")
    noise = rng.standard_normal((2, h, w)) * 0.5
    return (tex + noise[0]).astype(np.float32), (moved + noise[1]).astype(np.float32)


def test_tvl1_flow_matches_c_golden(golden):
    """The C library's flow on the tiny case, within tests/test_tvl1.py's
    limits."""
    g = golden("tvl1")
    out = tvl1.tvl1_flow(_t(g["tiny_i0"]), _t(g["tiny_i1"])).numpy()
    err = np.abs(out - g["tiny_flow"])
    assert np.median(err) < 0.02
    assert np.mean(err) < 0.05
    assert np.quantile(err, 0.95) < 0.12


@pytest.mark.parametrize("case", ["golden_tiny", "textured"])
def test_tvl1_flow_matches_rvdd_tpu(golden, monkeypatch, case):
    """Same inputs through both solvers.  The iterations per warp stage
    must be equal, up to a flip at the threshold from summation order (at
    most one stage off by one); the flows agree within 1e-3 px (measured:
    below 2e-5 px on both cases), far inside test_tvl1.py's limits against
    the C library."""
    if case == "golden_tiny":
        g = golden("tvl1")
        i0, i1, params = g["tiny_i0"], g["tiny_i1"], jtvl1.TVL1Params()
    else:
        i0, i1 = textured_pair(40, 56)
        params = jtvl1.TVL1Params(nwarps=2, max_iterations=75)
    want, want_its = rvdd_tpu_flow(monkeypatch, i0, i1, params)
    its = []
    got = tvl1.tvl1_flow(_t(i0), _t(i1), tvl1.TVL1Params(*params), iterations=its).numpy()
    assert len(its) == len(want_its) == params.nwarps * tvl1._num_scales(i0.shape[1], i0.shape[0],
                                                                         params)
    diff = [abs(a - b) for a, b in zip(its, want_its)]
    assert sum(d > 0 for d in diff) <= 1 and max(diff) <= 1, (its, want_its)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    if case == "textured":  # and it finds the motion
        assert np.abs(np.median(got[8:-8, 8:-8], axis=(0, 1)) - (-1.6, 0.7)).max() < 0.05


def test_tvl1_flow_pair_matches_rvdd_tpu(golden):
    """The src -> ref convention on RGB frames (the golden tiny pair as
    gray, tinted): within 1e-3 px of rvdd_tpu's tvl1_flow_pair."""
    g = golden("tvl1")
    tint = np.array([0.9, 1.0, 1.1], np.float32)
    ref, src = g["tiny_i0"][..., None] * tint, g["tiny_i1"][..., None] * tint
    want = np.asarray(jtvl1.tvl1_flow_pair(jnp.asarray(src), jnp.asarray(ref)))
    got = tvl1.tvl1_flow_pair(_t(src), _t(ref)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_compute_window_flows_matches_rvdd_tpu():
    """A flagship window [1, 3, 16, 24, 4] (previous, current, future):
    flows [1, 2, 16, 24, 2] to the current frame, previous first, within
    1e-3 px."""
    raw, _ = bench.make_inputs(16, 24, seed=3, device="cpu", model="convnext+feat+future",
                               with_flow=True)
    jcfg = jengine.EngineConfig(model_patch_depth=2, future_patch_depth=1)
    want = np.asarray(jengine.compute_window_flows(jcfg, jnp.asarray(raw.numpy())))
    cfg = engine.EngineConfig(model_patch_depth=2, future_patch_depth=1)
    its = []
    got = engine.compute_window_flows(cfg, raw, None, its).numpy()
    assert got.shape == want.shape == (1, 2, 16, 24, 2)
    assert len(its) == 2 * 5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("cfg_kw", [{}, {"net_impl": "fused", "warp_impl": "kernel"}])
def test_compute_window_flows_always_uses_the_solver_warp_wrapper(monkeypatch, cfg_kw):
    """The solver warps through ``warp_catmull_zero`` (the kernel on CUDA
    tensors) whatever the config picks for the state warp, EngineConfig's
    defaults included: one call per warp stage."""
    calls = []

    def counting(x, flow):
        calls.append(tuple(x.shape))
        return warp_catmull_zero(x, flow)

    monkeypatch.setattr(tvl1, "warp_catmull_zero", counting)
    raw, _ = bench.make_inputs(16, 24, seed=3, device="cpu", with_flow=True)
    its = []
    flows = engine.compute_window_flows(engine.EngineConfig(**cfg_kw), raw, "fast", its)
    assert flows.shape == (1, 1, 16, 24, 2)
    assert len(calls) == len(its) == tvl1.FLOW_PRESETS["fast"].nwarps
    assert all(s[-1] == 4 for s in calls)


# ------------------------------------------------------ online streaming


def _norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


@pytest.fixture(scope="module")
def online_reference():
    """rvdd_tpu's online-flow step as bench.py:262-267 runs it (flows from
    the whole raw window, net_impl='xla', warp_impl='xla'), twice with the
    state carried, on a convunet+feat window at raw 16x16; and the port's
    net with the same weights."""
    arch = "convunet-mode=fixedfeatures+feat"
    raw, _ = bench.make_inputs(16, 16, seed=4, device="cpu", with_flow=True)
    jcfg = jengine.EngineConfig(model_patch_depth=2, feature_rec=True)
    jnet = jfactory.build_network(arch, 6, 3, True)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(7), (1, 32, 32, 6))
    nil = jnet.nil_features(1, 32, 32)

    def step_fn(params, state, raw_window):
        flows = jengine.compute_window_flows(jcfg, raw_window)[:, None]
        frames, flows2 = jengine.prepare_frames(jcfg, raw_window, flows)
        return jengine.inference_step(jcfg, jnet, params, state, frames, flows2[:, 0], nil)

    rw = jnp.asarray(raw.numpy())
    d1, st = jax.jit(lambda p, r: step_fn(p, None, r))(params, rw)
    d2, _ = jax.jit(step_fn)(params, st, rw)
    from rvdd_tpu_torch.models import build_network

    net = build_network(arch, 6, 3, True, device="cpu")
    net.load_state_dict(convunet_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return raw, net, (np.asarray(d1), np.asarray(d2))


def _port_online_steps(cfg, net, raw):
    packed = engine.fused_pack(cfg, net) if cfg.net_impl == "fused" else None
    d1, st = bench.step_fn(cfg, net, packed, None, raw, None, "default")
    d2, _ = bench.step_fn(cfg, net, packed, st, raw, None, "default")
    return d1.numpy(), d2.numpy()


def test_online_module_steps_match_rvdd_tpu(online_reference):
    """The module path with online flows (on the CPU the solver warp is its
    plain version): 1e-3 normalized, the flows' and the convs' summation
    order."""
    raw, net, (want1, want2) = online_reference
    cfg = engine.EngineConfig(model_patch_depth=2, feature_rec=True)
    got1, got2 = _port_online_steps(cfg, net, raw)
    assert got1.shape == want1.shape == (1, 32, 32, 3)
    assert _norm_err(got1, want1) < 1e-3
    assert _norm_err(got2, want2) < 1e-3


def test_online_fused_steps_match_rvdd_tpu(online_reference):
    """The fused path with online flows (every kernel's plain version on
    the CPU) within tests/test_fast_step.py's envelope: 0.2 and 0.3."""
    raw, net, (want1, want2) = online_reference
    cfg = engine.EngineConfig(model_patch_depth=2, feature_rec=True, net_impl="fused",
                              warp_impl="kernel")
    got1, got2 = _port_online_steps(cfg, net, raw)
    assert np.isfinite(got1).all() and np.isfinite(got2).all()
    assert _norm_err(got1, want1) < 0.2
    assert _norm_err(got2, want2) < 0.3
