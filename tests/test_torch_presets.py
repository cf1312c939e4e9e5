"""The port's fused-path presets (rvdd_tpu_torch/models/fast_unet.py) against
rvdd_tpu's on the CPU: the preset table and its hybrids, 'auto', and the
fused engine step of convunet+feat+future (future depth 1, 32x32) in each
ported preset.  The port's chains run their plain versions here; rvdd_tpu's
fused step runs its Pallas kernels in interpret mode (as the pallas_interpret
fixture of tests/conftest.py routes them), its exact step in XLA.  Weights are flax params converted with
models/convert.py; inputs come from numpy seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.models import fast_unet as jfu  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models import fast_unet as fu  # noqa: E402
from rvdd_tpu_torch.models.convert import convunet_from_flax  # noqa: E402
from rvdd_tpu_torch.models import fast_convnext as fcx  # noqa: E402
from rvdd_tpu_torch.recurrent import engine  # noqa: E402

H = W = 32
FD = 1
IN_NC = (2 + FD) * 3
ARCH = "convunet-mode=fixedfeatures+feat"
FAST_DEC2 = (False, False, False, True, True)


# ------------------------------------------------------------ the table


def _jax_parts(prec):
    """(fp32 parts, dec2's weight split or None, fp32 weights, the fp32
    chains' MXU precision) of a resolved rvdd_tpu preset, in the port's
    terms."""
    bd, wd, mp = prec["band_dtype"], prec.get("weight_dtype"), prec["mxu_precision"]
    if isinstance(bd, dict):
        fp32 = {c for c, d in bd.items() if d == jax.numpy.float32}
    else:
        fp32 = set(fu.HYBRID_CHAINS) if bd == jax.numpy.float32 else set()
    if isinstance(mp, dict):  # a hybrid: 'high' for every named chain
        assert set(mp.values()) == {"high"}
        mp = "high"
    w32 = not isinstance(wd, (dict, str)) and wd is not None and wd == jax.numpy.float32
    if isinstance(wd, dict):
        wd = tuple(v == "split" for v in wd["dec2"])
    return fp32, None if w32 else wd, w32, mp


@pytest.mark.parametrize("name", ["fast", "mixed", "accurate", "wsplit", "wf32",
                                  "hybrid:A+dec2", "hybrid:B+C", "hybrid:glue+A+dec2",
                                  "hybrid:middle+dec0+dec1"])
def test_presets_match_rvdd_tpu(name):
    """Each ported preset names the same fp32 parts as rvdd_tpu's, the same
    MXU precision and weight dtype, and the same weight split: fast's
    (post0, head) split of dec2 stays in a hybrid that does not name dec2
    and goes where it does (the 3-pass products split every layer); wsplit
    splits every layer of every chain; accurate and wf32 split none (fp32
    weights)."""
    got, want = fu.get_fused_precision(name), jfu.get_fused_precision(name)
    fp32, wd, w32, mp = _jax_parts(want)
    assert set(got["fp32"]) == fp32
    assert got["weight_fp32"] == w32 and got["mxu_precision"] == mp
    if wd == "split":
        assert got["weight_split"] is True
    elif wd is None:
        assert got["weight_split"] == {}
    else:
        assert got["weight_split"] == {"dec2": wd}
    assert fu.glue_dtype(got) == (torch.float32 if "glue" in fp32 else torch.bfloat16)
    assert (fu.glue_dtype(got) == torch.float32) == (jfu.glue_dtype(want) == jax.numpy.float32)


def test_get_fused_precision_hybrid_parsing():
    """tests/test_hybrid_precision.py's parsing cases in the port's terms."""
    p = fu.get_fused_precision("hybrid:A+dec2")
    assert p["fp32"] == {"A", "dec2"} and p["weight_split"] == {}
    assert fu.get_fused_precision("hybrid:B+C")["weight_split"] == {"dec2": FAST_DEC2}
    with pytest.raises(ValueError):
        fu.get_fused_precision("hybrid:nochain")
    with pytest.raises(ValueError):
        fu.get_fused_precision("nopreset")


@pytest.mark.parametrize("arch,feat,future", [
    ("convunet", True, True), ("convunet", True, False), ("convunet", False, True),
    ("convunet-mode=fixedfeatures+feat", True, True), ("newunet", True, True),
])
def test_auto_resolves_as_rvdd_tpu(arch, feat, future):
    kw = dict(arch=arch, feature_rec=feat, future=future)
    got = fu.resolve_fused_precision("auto", **kw)
    assert got == jfu.resolve_fused_precision("auto", **kw)
    assert got == ("hybrid:glue+A+dec2" if arch.startswith("convunet") and feat and future
                   else "fast")
    assert fu.resolve_fused_precision("mixed", **kw) == "mixed"


def test_convnext_fused_path_takes_fast_only():
    """The ConvNeXt fused path takes its own five presets, no longer 'fast'
    alone: fast, mixed, accurate, wsplit and wf32 resolve; a hybrid names
    ConvUNet chains and raises ValueError (as rvdd_tpu's
    fast_forward_planar_cnx does), and so does an unknown name, at every
    entry (the preset table, the packing, the engine)."""
    assert set(fcx.CNX_PRECISIONS) == {"fast", "mixed", "accurate", "wsplit", "wf32"}
    for name in fcx.CNX_PRECISIONS:
        fcx.cnx_precision(name)
    net = build_network("newunet-mode=feat", IN_NC, 3, device="cpu")
    for bad in ("hybrid:glue+A+dec2", "nopreset"):
        with pytest.raises(ValueError):
            fcx.cnx_precision(bad)
        with pytest.raises(ValueError):
            fcx.pack_fast_cnx(net, True, IN_NC, bad)
        cfg = engine.EngineConfig(feature_rec=True, future_patch_depth=FD, net_impl="fused",
                                  fused_precision=bad)
        with pytest.raises(ValueError):
            engine.init_state(cfg, torch.zeros(1, 3, 64, 64, 3), net=net)


@pytest.mark.parametrize("name", ["fast", "mixed", "accurate", "wsplit", "wf32"])
def test_convnext_presets_match_rvdd_tpu(name):
    """Each ConvNeXt preset runs the chains that rvdd_tpu's code paths run
    in fp32, with its glue dtype: the six row-tiled chains follow the
    preset's band dtype (fast_forward_planar_cnx, with 'high' mapped to
    'highest' and the erf GELU where the bands are fp32); the eighth-res
    core ('mid') is fp32 for every preset but 'fast' (_middle8_cnx_body);
    the glue is glue_dtype's.  The engine's glue dtype for the ConvNeXt
    net is the preset's."""
    prec = jfu.get_fused_precision(name)
    chains_fp32 = prec["band_dtype"] == jax.numpy.float32
    assert prec["gelu_exact"] == chains_fp32
    if chains_fp32:
        assert prec["mxu_precision"] in ("high", "highest")  # both run 'highest' in _chain
    want = {c for c in fcx.CNX_CHAINS if c != "mid" and chains_fp32}
    if name != "fast":
        want.add("mid")
    got = fcx.cnx_precision(name)
    assert set(got["fp32"]) == want
    jglue = jfu.glue_dtype(prec) == jax.numpy.float32
    assert (got["glue"] == torch.float32) == jglue
    net = build_network("newunet-mode=feat", IN_NC, 3, device="cpu")
    cfg = engine.EngineConfig(feature_rec=True, future_patch_depth=FD, net_impl="fused",
                              fused_precision=name)
    assert engine._fused_glue_dtype(cfg, net) == got["glue"]
    packed = fcx.pack_fast_cnx(net, True, IN_NC, name)
    assert {c for c in fcx.CNX_CHAINS if packed[c].band_fp32} == want


def test_pack_marks_each_chain():
    """pack_fast_params packs each chain in its preset's mode: the hybrid's
    named chains and every chain of 'mixed' in the 'high' mode; every chain
    of 'accurate' in the 'highest' mode and of 'wf32' in the 'w32' mode,
    each layer's weights as three planes, with an fp32 eighth-res core."""
    net = build_network(ARCH, IN_NC, 3, True, device="cpu")
    packed = fu.pack_fast_params(net, True, IN_NC, "hybrid:glue+A+dec2")
    assert [packed[c].mode for c in fu.CHAINS] == ["high", "bf16", "bf16", "bf16", "bf16", "high"]
    assert [packed[c].band_fp32 for c in fu.CHAINS] == [True, False, False, False, False, True]
    assert all(layer.split for c in ("A", "dec2") for layer in packed[c].layers)
    assert not any(layer.split for c in ("B", "C", "dec0", "dec1") for layer in packed[c].layers)
    assert not packed["middle_fp32"] and packed["middle_dtype"] == torch.float32
    assert fu.pack_fast_params(net, True, IN_NC, "hybrid:A+dec2")["middle_dtype"] == torch.bfloat16
    mixed = fu.pack_fast_params(net, True, IN_NC, "mixed")
    assert all(mixed[c].mode == "high" for c in fu.CHAINS) and mixed["middle_fp32"]
    ws = fu.pack_fast_params(net, True, IN_NC, "wsplit")
    assert all(layer.split and not ws[c].band_fp32 for c in fu.CHAINS for layer in ws[c].layers)
    for name, mode, band in (("accurate", "highest", torch.float32), ("wf32", "w32", torch.bfloat16)):
        p = fu.pack_fast_params(net, True, IN_NC, name)
        assert all(p[c].mode == mode and p[c].dtype == band for c in fu.CHAINS), name
        assert all(len(layer.planes) == 3 and not layer.split
                   for c in fu.CHAINS for layer in p[c].layers), name
        assert p["middle_fp32"] and p["middle_dtype"] == torch.float32, name
        assert fu.glue_dtype(fu.get_fused_precision(name)) == band, name


# ------------------------------------------------------- the fused step


@pytest.fixture(scope="module")
def stream():
    """convunet+feat+future in both packages (converted flax weights), two
    frames of input with a future frame and a smooth flow, and rvdd_tpu's
    exact step (XLA net and warp) twice with the state carried."""
    jnet = jfactory.build_network(ARCH, IN_NC, 3, True)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(0), (1, H, W, IN_NC))
    net = build_network(ARCH, IN_NC, 3, True, device="cpu")
    net.load_state_dict(convunet_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(11)
    frames = rng.uniform(-1, 1, (1, 2 + FD, H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    fl = np.stack([1.2 + np.sin(xx / 15), -0.7 + 0.5 * np.cos(yy / 8)], -1)
    flows = np.broadcast_to(fl, (1, 1 + FD, H, W, 2)).astype(np.float32).copy()
    exact = jax_steps(jnet, params, frames, flows, None)
    return jnet, params, net, frames, flows, exact


def jax_steps(jnet, params, frames, flows, preset):
    """rvdd_tpu's step twice, state carried: exact (preset None) or fused."""
    kw = dict(model_patch_depth=2, patch_depth=2 + FD, future_patch_depth=FD, feature_rec=True)
    if preset is not None:
        kw.update(net_impl="fused", fused_precision=preset)
    cfg = jengine.EngineConfig(**kw)
    nil = jnet.nil_features(1, H, W)
    fr, fl = jax.numpy.asarray(frames), jax.numpy.asarray(flows)
    first = jax.jit(lambda p, f, g: jengine.inference_step(cfg, jnet, p, None, f, g, nil))
    nxt = jax.jit(lambda p, s, f, g: jengine.inference_step(cfg, jnet, p, s, f, g, nil))
    d1, s = first(params, fr, fl)
    d2, _ = nxt(params, s, fr, fl)
    return np.asarray(d1), np.asarray(d2)


def port_steps(net, frames, flows, preset):
    cfg = engine.EngineConfig(model_patch_depth=2, future_patch_depth=FD, feature_rec=True,
                              net_impl="fused", fused_precision=preset)
    fr, fl = torch.from_numpy(frames), torch.from_numpy(flows)
    d1, s = engine.inference_step(cfg, net, None, fr, fl)
    d2, _ = engine.inference_step(cfg, net, s, fr, fl)
    return d1.numpy(), d2.numpy()


def norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


def test_mixed_step_near_exact(stream):
    """tests/test_fast_step.py:61 for the port: the fused step under
    'mixed' (fp32 bands and bf16_3x products in every chain, fp32 middle,
    fp32 warps and carry) against rvdd_tpu's exact XLA step, normalized max
    error below 2e-3 at step 1 and 3e-3 at step 2."""
    _, _, net, frames, flows, (want1, want2) = stream
    got1, got2 = port_steps(net, frames, flows, "mixed")
    assert got1.shape == want1.shape == (1, H, W, 3)
    assert norm_err(got1, want1) < 2e-3, norm_err(got1, want1)
    assert norm_err(got2, want2) < 3e-3, norm_err(got2, want2)


def test_accurate_step_near_exact(stream):
    """The fused step under 'accurate' (every chain in the 'highest' mode,
    fp32 bands and weights; the fp32 middle, warps and carry) against
    rvdd_tpu's exact XLA step: normalized max error below 2e-4 at step 1
    and 3e-4 at step 2, a tenth of 'mixed''s limits (seen: 8.0e-6 and
    1.1e-5; rvdd_tpu's own 'accurate' in interpret mode 6.6e-6 and
    8.7e-6)."""
    _, _, net, frames, flows, (want1, want2) = stream
    got1, got2 = port_steps(net, frames, flows, "accurate")
    assert got1.shape == want1.shape == (1, H, W, 3)
    assert norm_err(got1, want1) < 2e-4, norm_err(got1, want1)
    assert norm_err(got2, want2) < 3e-4, norm_err(got2, want2)


@pytest.fixture(scope="module")
def jax_fused(stream):
    """rvdd_tpu's fused steps by preset (Pallas in interpret mode), each
    computed once for the module."""
    import jax.experimental.pallas as pl_mod

    jnet, params, _, frames, flows, _ = stream
    done = {}

    def run(preset):
        if preset not in done:
            orig = pl_mod.pallas_call
            pl_mod.pallas_call = lambda *a, **k: orig(*a, **dict(k, interpret=True))
            try:
                done[preset] = jax_steps(jnet, params, frames, flows, preset)
            finally:
                pl_mod.pallas_call = orig
        return done[preset]

    return run


def test_auto_step_between_fast_and_exact(stream, jax_fused):
    """tests/test_hybrid_precision.py's ordering for the port: 'auto'
    (hybrid:glue+A+dec2) is closer to the exact step than the port's
    'fast' on the same inputs, at both steps; and it is as close as
    rvdd_tpu's own 'auto': max error within 1.5x of rvdd_tpu's (the max of
    bf16 noise moves with each rounding choice), mean error within 1.1x.
    Seen at these inputs: port max 0.050 / 0.055, mean 0.0074 / 0.0092;
    rvdd_tpu 0.062 / 0.058, 0.0076 / 0.0092; the port's 'fast' max 0.078 /
    0.083.  (test_hybrid_precision.py's 0.05 holds for rvdd_tpu on its own
    inputs at step 1 only: 0.041 there, 0.054 at step 2.)"""
    _, _, net, frames, flows, want = stream
    auto = fu.resolve_fused_precision("auto", arch=ARCH, feature_rec=True, future=True)

    def errs(outs):
        return [(norm_err(g, w), float(np.mean(np.abs(g - w)) / np.std(w)))
                for g, w in zip(outs, want)]

    ref = errs(jax_fused(auto))
    got = {p: errs(port_steps(net, frames, flows, p)) for p in (auto, "fast")}
    for step in range(2):
        assert got[auto][step][0] < got["fast"][step][0], got
        assert got[auto][step][0] < 1.5 * ref[step][0], (got, ref)
        assert got[auto][step][1] < 1.1 * ref[step][1], (got, ref)


def test_wf32_step_keeps_fp32_weights(stream, jax_fused, monkeypatch):
    """'wf32' rounds the bands to bf16 but not the chains' weights, so its
    mean error against the exact step is rvdd_tpu's 'wf32''s: within 1.2x
    of it at both steps (seen 0.87x and 0.91x).  The control, the same step
    with every chain's weights rounded to bf16 (split3 giving the bf16
    weights as the hi plane and zero mid and lo planes, which is what a
    kernel that dropped them would compute), reads 1.42x and 1.34x and must
    fail that bound: test_fused_step_matches_rvdd_tpu_fused's 1.5x cannot
    tell the two apart."""
    from rvdd_tpu_torch.ops.cuda import conv_chain as cc

    _, _, net, frames, flows, exact = stream
    ref = jax_fused("wf32")

    def ratios(outs):
        return [float(np.mean(np.abs(g - e)) / np.mean(np.abs(w - e)))
                for g, w, e in zip(outs, ref, exact)]

    got = ratios(port_steps(net, frames, flows, "wf32"))

    def bf16_weights(w):
        b = w.float().to(torch.bfloat16)
        return b, torch.zeros_like(b), torch.zeros_like(b)

    monkeypatch.setattr(cc, "split3", bf16_weights)
    control = ratios(port_steps(net, frames, flows, "wf32"))
    assert all(r < 1.2 for r in got), got
    assert all(r >= 1.2 for r in control), control


@pytest.mark.parametrize("preset,lims,mutual", [
    ("hybrid:glue+A+dec2", (0.1, 0.15), "max"), ("wsplit", (0.2, 0.3), "max"),
    ("mixed", (1e-3, 2e-3), "max"), ("accurate", (1e-4, 1.5e-4), "max"),
    ("wf32", (0.2, 0.3), "mean")])
def test_fused_step_matches_rvdd_tpu_fused(stream, jax_fused, preset, lims, mutual):
    """The port's fused step against rvdd_tpu's fused step in the same
    preset (Pallas kernels in interpret mode), two steps with the state
    carried.  Chain by chain the two agree to fp32 summation order
    (tests/test_torch_kernels.py); over the net, a bf16 band that rounds
    the other way after sums taken in another order feeds every later
    bf16 layer, so two bf16 runs differ by about as much as either differs
    from fp32 (seen: hybrid 0.039 / 0.049, wsplit 0.052 / 0.079; under
    'mixed', every part fp32, the same comparison gives 1.3e-4 / 2.4e-4).  The
    bounds are the bf16 presets' envelope against the exact step (0.2 /
    0.3, tests/test_fast_step.py), halved for the hybrid, whose full-res
    cycle is fp32, and for 'mixed' half its own bound against the exact
    step (test_mixed_step_near_exact), and for 'accurate' half of its own
    (test_accurate_step_near_exact; seen 7.9e-6 / 1.1e-5, and 0.057 / 0.081
    for 'wf32').  Each side's error against the exact step must be within
    1.5x of the other's: the max error, or for 'wf32' the mean, where the
    port's max error must in addition stay within 1.5x of rvdd_tpu's.  (Its
    max errors are 0.032 / 0.070 against rvdd_tpu's 0.073 / 0.064, its
    means 0.0073 / 0.0100 against 0.0084 / 0.0109: the max of bf16 noise
    moves with each rounding choice, so the port's lower max at step 1
    says no more than the means, which agree within 15%.)"""
    _, _, net, frames, flows, exact = stream
    want = jax_fused(preset)
    got = port_steps(net, frames, flows, preset)

    def mean_err(a, b):
        return float(np.mean(np.abs(a - b)) / np.std(b))

    stat = norm_err if mutual == "max" else mean_err
    for step, (g, w, e, lim) in enumerate(zip(got, want, exact, lims)):
        assert np.isfinite(g).all()
        assert norm_err(g, w) < lim, (preset, step, norm_err(g, w))
        assert norm_err(g, e) < 1.5 * norm_err(w, e), (preset, step)
        assert stat(g, e) < 1.5 * stat(w, e), (preset, step)
        assert stat(w, e) < 1.5 * stat(g, e), (preset, step)
