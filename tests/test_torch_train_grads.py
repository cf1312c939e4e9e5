"""The port's training forward and gradients (rvdd_tpu_torch/recurrent/
engine.py:unrolled_forward, compute_losses; training/train_state.py:
make_train_step) against the reference and against rvdd_tpu.

* The goldens tests/golden/grads_convunet_{feat,future}.npz hold the
  reference's own training forward and backward (tools/make_goldens.py):
  its torch state dict (``sd/``, loaded through the port's ``.pth``
  converter), inputs, outputs, loss and every gradient (``gd/``).  The
  port's outputs agree within 2e-4 absolute, its loss within 2e-5
  relative, each gradient leaf within 2e-3 x the largest reference
  gradient, and the gradients' cosine exceeds 1 - 1e-6
  (tests/test_gradients.py's limits).
* rvdd_tpu's ``jax.value_and_grad`` of the same loss on the same numpy
  inputs and converted weights (its XLA net and warp, matmuls at highest):
  a tiny convunet+feat with a raw ground truth, and a tiny
  ``newunet-mode=feat`` with a future frame; the same limits.
* ``remat`` (torch.utils.checkpoint around each unrolling) gives the same
  gradients within 1e-6 x the largest.

The gradients are read off the port's train step itself: one step of SGD
without momentum at lr = 1 moves every weight by minus its gradient.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.ops.warp_shift import clamp_fraction as jclamp_fraction  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import (  # noqa: E402
    convert_torch_state_dict,
    convnext_from_flax,
    convnext_to_flax,
    convunet_from_flax,
    convunet_to_flax,
)
from rvdd_tpu_torch.ops.warp_shift import clamp_fraction  # noqa: E402
from rvdd_tpu_torch.recurrent.engine import (  # noqa: E402
    EngineConfig,
    prepare_frames,
    unrolled_forward,
)
from rvdd_tpu_torch.training.train_state import create_train_state, make_train_step  # noqa: E402


def port_step(cfg, net, raw, flows, gt, weights, precision="highest"):
    """(losses, grads by state-dict key, outputs) of one train step of the
    port on ``net`` (left unchanged), at ``precision`` (the outputs are
    the fp32 forward's)."""
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    state = create_train_state(net, "sgd", beta1=0.0)
    for g in state.optimizer.param_groups:
        g["lr"] = 1.0
    t = [None if a is None else torch.from_numpy(np.asarray(a)) for a in (raw, flows, gt)]
    _, losses = make_train_step(cfg, precision)(state, t[0], t[1], t[2],
                                                torch.from_numpy(weights))
    grads = {k: before[k] - p.detach() for k, p in net.named_parameters()}
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(before[k])
        frames, fl = prepare_frames(cfg, t[0], t[1])
        nil = (net.nil_features(frames.shape[0], frames.shape[2], frames.shape[3])
               if cfg.feature_rec else None)
        outs = unrolled_forward(cfg, net, frames, fl, len(weights), nil)
    return {k: float(v) for k, v in losses.items()}, grads, outs.numpy()


def check_grads(got: dict, want: dict, bound: float = 2e-3, cosine: bool = True,
                min_cosine: float = 1 - 1e-6):
    """Leaf by leaf within ``bound`` x the largest reference gradient, and
    the cosine of the two gradient vectors above ``min_cosine``."""
    assert got.keys() == want.keys()
    gscale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        err = float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
        assert err <= bound * gscale, f"{k}: max|d| {err:.3e} against scale {gscale:.3e}"
    if cosine:
        a = np.concatenate([np.asarray(got[k]).ravel() for k in sorted(want)])
        b = np.concatenate([np.asarray(want[k]).ravel() for k in sorted(want)])
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos > min_cosine, cos


@pytest.mark.parametrize("name,arch,feat,fd", [
    ("grads_convunet_feat", "convunet-mode=fixedfeatures+feat-filters=12", True, 0),
    ("grads_convunet_future", "convunet-mode=fixedfeatures-filters=12", False, 1),
], ids=["feat", "future"])
def test_grads_match_reference_golden(golden, name, arch, feat, fd):
    g = golden(name)
    cfg = EngineConfig(model_patch_depth=2, patch_depth=4, future_patch_depth=fd,
                       feature_rec=feat, warp_impl="plain")
    net = build_network(arch, cfg.network_input_nc, 3, feat, device="cpu")
    net.load_state_dict(convert_torch_state_dict(
        {k[3:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("sd/")}))
    # golden flows [TD, D+fD, 2, h, w] -> [B, TD, D+fD, h, w, 2]
    flows = np.transpose(g["flow"], (0, 1, 3, 4, 2))[None]
    losses, grads, outs = port_step(cfg, net, g["raw"], flows, g["gt"],
                                    g["weights"].astype(np.float32))
    np.testing.assert_allclose(outs, g["denoised"].transpose(0, 1, 3, 4, 2), atol=2e-4)
    np.testing.assert_allclose(losses["Denoiser"], float(g["loss"]), rtol=2e-5)
    want = convert_torch_state_dict(
        {k[3:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("gd/")})
    check_grads(grads, want)


def _inputs(cfg, h, w, seed):
    """Seeded raw frames, smooth flows of a few pixels, ground truth and
    unrolling weights, numpy float32."""
    rng = np.random.default_rng(seed)
    t = cfg.patch_depth + cfg.future_patch_depth
    raw = rng.uniform(-0.9, 0.9, (1, t, h, w, 4)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    td, nf = cfg.train_unrollings, cfg.d + cfg.future_patch_depth
    flows = np.zeros((1, td, nf, h, w, 2), np.float32)
    for a in range(td):
        for k in range(nf):
            s = 1.0 if k < cfg.d else -1.0
            flows[0, a, k, ..., 0] = s * (1.3 + 0.8 * np.sin(xx / 5 + a))
            flows[0, a, k, ..., 1] = s * (-0.7 + 0.6 * np.cos(yy / 4 - k))
    gh, gw, gc = (h, w, 4) if cfg.raw_gt else (2 * h, 2 * w, 3)
    gt = rng.uniform(-0.9, 0.9, (1, t, gh, gw, gc)).astype(np.float32)
    weights = rng.uniform(0.2, 1.0, td).astype(np.float32)
    return raw, flows, gt, weights / weights.sum()


CASES = {
    "convunet_feat_raw_gt": ("convunet-mode=fixedfeatures+feat-filters=8", True, 0, True),
    "newunet_feat_future": ("newunet-mode=feat-filters=8-depth=2", True, 1, False),
}
#: the value_and_grad cases: CASES at patch_depth 4 with the warp and
#: highest precision, and the configurations of the training scripts that
#: CASES leaves out: the non-recurrent scripts (patch_depth 2, one
#: unrolling, scripts/train-non_recurrent-convunet{,-no_warp}.sh) with and
#: without the warp, and --train_matmul_precision default.  (arch, feat,
#: fD, raw_gt, patch_depth, no_warp, precision)
GRAD_CASES = {
    **{k: v + (4, False, "highest") for k, v in CASES.items()},
    "nonrecurrent_no_warp": ("convunet-mode=fixedfeatures-filters=8", False, 0, False, 2, True,
                             "highest"),
    "nonrecurrent_warp": ("convunet-mode=fixedfeatures-filters=8", False, 0, False, 2, False,
                          "highest"),
    "convunet_feat_default_precision": ("convunet-mode=fixedfeatures+feat-filters=8", True, 0,
                                        False, 4, False, "default"),
}
#: 'default' precision: the port's forward runs under bf16 autocast (8
#: bits of mantissa), while XLA:CPU runs rvdd_tpu's 'default' dots in fp32,
#: so the two differ by bf16 rounding.  Measured on this case's inputs with
#: seeds 3, 4 and 5 (x86, torch 2.13): the loss 6.3e-5, 9.3e-5 and 1.4e-4
#: relative, the gradients 0.050, 0.108 and 0.060 x the largest with
#: cosines 1 - 0.0056, 1 - 0.0099 and 1 - 0.0105.  The limits are about
#: twice the worst of those; a wrong gradient gives a cosine near 0.  The
#: case also holds the port's own fp32 step to rvdd_tpu at the fp32
#: limits, so bf16 is the whole difference.
BF16_LIMITS = dict(loss=5e-4, grads=0.2, cosine=0.97)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grads_match_rvdd_tpu_value_and_grad(case):
    arch, feat, fd, raw_gt, pd, no_warp, precision = GRAD_CASES[case]
    jcfg = jengine.EngineConfig(model_patch_depth=2, patch_depth=pd, future_patch_depth=fd,
                                feature_rec=feat, raw_gt=raw_gt, no_warp=no_warp,
                                warp_impl="xla", net_impl="xla")
    cfg = EngineConfig(model_patch_depth=2, patch_depth=pd, future_patch_depth=fd,
                       feature_rec=feat, raw_gt=raw_gt, no_warp=no_warp, warp_impl="plain")
    h, w = 12, 16
    raw, flows, gt, weights = _inputs(cfg, h, w, seed=3)
    if no_warp:
        flows = None
    jnet = jfactory.build_network(arch, cfg.network_input_nc, 3, feat)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(1),
                                   (1, 2 * h, 2 * w, cfg.network_input_nc))
    cnx = arch.startswith("newunet")
    from_flax, to_flax = (convnext_from_flax, convnext_to_flax) if cnx else (
        convunet_from_flax, convunet_to_flax)

    def loss_fn(p):
        frames, fl = jengine.prepare_frames(jcfg, jnp.asarray(raw),
                                            None if flows is None else jnp.asarray(flows))
        nil = jnet.nil_features(1, 2 * h, 2 * w, frames.dtype) if feat else None
        outs = jengine.unrolled_forward(jcfg, jnet, p, frames, fl, len(weights), nil)
        return jengine.compute_losses(jcfg, outs, jnp.asarray(gt),
                                      jnp.asarray(weights))["Denoiser"], outs

    with jax.default_matmul_precision(precision):
        (jloss, jouts), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    net = build_network(arch, cfg.network_input_nc, 3, feat, device="cpu")
    net.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params)))
    losses, grads, outs = port_step(cfg, net, raw, flows, gt, weights, precision)
    want = from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert to_flax(grads).keys() == jgrads.keys()
    # the fp32 forward in every case (XLA:CPU's 'default' is fp32 too)
    np.testing.assert_allclose(outs, np.asarray(jouts), atol=2e-4)
    if precision == "default":
        np.testing.assert_allclose(losses["Denoiser"], float(jloss), rtol=BF16_LIMITS["loss"])
        check_grads(grads, want, bound=BF16_LIMITS["grads"], min_cosine=BF16_LIMITS["cosine"])
        bf16_grads = grads
        losses, grads, _ = port_step(cfg, net, raw, flows, gt, weights, "highest")
        assert any(not torch.equal(grads[k], g) for k, g in bf16_grads.items())
    np.testing.assert_allclose(losses["Denoiser"], float(jloss), rtol=2e-5)
    check_grads(grads, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_gives_the_same_gradients(case):
    arch, feat, fd, raw_gt = CASES[case]
    cfg = EngineConfig(model_patch_depth=2, patch_depth=4, future_patch_depth=fd,
                       feature_rec=feat, raw_gt=raw_gt, warp_impl="plain")
    raw, flows, gt, weights = _inputs(cfg, 12, 16, seed=4)
    net = build_network(arch, cfg.network_input_nc, 3, feat, seed=2, device="cpu")
    l0, g0, _ = port_step(cfg, net, raw, flows, gt, weights)
    l1, g1, _ = port_step(dataclasses.replace(cfg, remat=True), net, raw, flows, gt, weights)
    assert l1["Denoiser"] == pytest.approx(l0["Denoiser"], rel=1e-6)
    check_grads(g1, g0, bound=1e-6, cosine=False)


def test_training_refuses_the_fused_chains():
    cfg = EngineConfig(feature_rec=True, net_impl="fused")
    net = build_network("convunet-mode=fixedfeatures+feat-filters=8", 6, 3, True, device="cpu")
    frames = torch.zeros(1, 5, 16, 16, 3)
    with pytest.raises(ValueError, match="forward-only"):
        unrolled_forward(cfg, net, frames, None, 4, net.nil_features(1, 16, 16))


@pytest.mark.parametrize("radius", [2, 8])
def test_clamp_fraction_matches_rvdd_tpu(radius):
    """The warp_clamp telemetry against rvdd_tpu's on flows with
    displacements beyond the sweep (smooth, banded and noisy parts), and
    zero on TV-L1-like small flows; the counts are exact."""
    rng = np.random.default_rng(radius)
    yy, xx = np.mgrid[0:40, 0:56].astype(np.float32)
    big = np.stack([9 * np.sin(xx / 6) + rng.normal(0, 3, xx.shape),
                    -7 * np.cos(yy / 5) + 4 * (yy > 20)], -1).astype(np.float32)
    small = (0.4 * rng.standard_normal((40, 56, 2))).astype(np.float32)
    fl = np.stack([big, small, big[::-1].copy()])[None]  # [1, 3, H, W, 2]
    for f in (fl, fl[:, 1:2]):
        want = float(jclamp_fraction(jnp.asarray(f), radius_v=radius, radius_h=radius))
        got = float(clamp_fraction(torch.from_numpy(f), radius_v=radius, radius_h=radius))
        assert got == pytest.approx(want, abs=1e-7)
    assert float(clamp_fraction(torch.from_numpy(fl[:, 1:2]), 8, 8)) == 0.0


def test_shift_step_logs_the_clamp_and_matches_the_plain_step():
    """warp_impl='shift' trains with the exact plain warp (the same loss and
    gradients as 'plain') and adds 'warp_clamp' to the losses, computed on
    the prepared (x2) flows; 'default' precision runs the forward in bf16
    autocast, close to fp32."""
    cfg = EngineConfig(model_patch_depth=2, patch_depth=4, feature_rec=True, warp_impl="plain")
    raw, flows, gt, weights = _inputs(cfg, 12, 16, seed=5)
    flows[..., 0] *= 6.0
    net = build_network("convunet-mode=fixedfeatures+feat-filters=8", 6, 3, True, seed=1,
                        device="cpu")
    l0, g0, _ = port_step(cfg, net, raw, flows, gt, weights)
    scfg = dataclasses.replace(cfg, warp_impl="shift", shift_warp_radius=2)
    l1, g1, _ = port_step(scfg, net, raw, flows, gt, weights)
    assert "warp_clamp" not in l0 and l1["Denoiser"] == l0["Denoiser"]
    check_grads(g1, g0, bound=0.0, cosine=False)
    _, fl2 = prepare_frames(cfg, torch.from_numpy(raw), torch.from_numpy(flows))
    assert l1["warp_clamp"] == float(clamp_fraction(fl2, 2, 2)) > 0.0

    state = create_train_state(net, "adamw")
    t = [torch.from_numpy(a) for a in (raw, flows, gt, weights)]
    _, lb = make_train_step(cfg, "default")(state, *t)
    assert float(lb["Denoiser"]) == pytest.approx(l0["Denoiser"], rel=0.05)
