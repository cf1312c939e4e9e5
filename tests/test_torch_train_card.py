"""The train step on the card (tests marked ``gpu``; they skip without a
card).  This file imports no JAX, so it runs on the card's machine with
``-m gpu --noconftest`` (see README).

* One train step's loss and gradients on the card against the CPU, on the
  same seeded inputs and weights, TF32 off (cuBLAS and cuDNN): the loss
  within 1e-5 relative, each gradient leaf within 2e-3 x the largest CPU
  gradient (tests/test_gradients.py's bound) and the cosine above
  1 - 1e-6.  The warp's backward scatters with atomics on the card, so the
  gradients are not bit-repeatable there.
* ``remat`` on the card: the same gradients within 1e-5 x the largest.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.precision import exact_precision  # noqa: E402
from rvdd_tpu_torch.recurrent.engine import EngineConfig  # noqa: E402
from rvdd_tpu_torch.training.train_state import loss_and_grads  # noqa: E402

CASES = {
    "convunet_feat": ("convunet-mode=fixedfeatures+feat-filters=12", 0),
    "newunet_feat_future": ("newunet-mode=feat-filters=12-depth=3", 1),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: see README)")
    return torch.device("cuda")


def _inputs(cfg, b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    t = cfg.patch_depth + cfg.future_patch_depth
    raw = rng.uniform(-0.9, 0.9, (b, t, h, w, 4)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    nf = cfg.d + cfg.future_patch_depth
    flows = np.zeros((b, cfg.train_unrollings, nf, h, w, 2), np.float32)
    for a in range(cfg.train_unrollings):
        flows[:, a, ..., 0] = 2.5 * np.sin(xx / 9 + a) + 1.0
        flows[:, a, ..., 1] = 1.5 * np.cos(yy / 7 - a) - 0.5
    gt = rng.uniform(-0.9, 0.9, (b, t, 2 * h, 2 * w, 3)).astype(np.float32)
    weights = np.full(cfg.train_unrollings, 1.0 / cfg.train_unrollings, np.float32)
    return [torch.from_numpy(a) for a in (raw, flows, gt, weights)]


def _step(cfg, arch, dev, inputs, seed=0):
    net = build_network(arch, cfg.network_input_nc, 3, True, seed=seed, device=dev)
    with exact_precision():
        losses, grads = loss_and_grads(cfg, net, *[x.to(dev) for x in inputs])
    return float(losses["Denoiser"]), {k: g.cpu().double() for k, g in grads.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_on_the_card_matches_the_cpu(cuda, case):
    arch, fd = CASES[case]
    cfg = EngineConfig(patch_depth=4, future_patch_depth=fd, feature_rec=True, warp_impl="plain")
    inputs = _inputs(cfg, 2, 32, 48)
    l_cpu, g_cpu = _step(cfg, arch, "cpu", inputs)
    l_card, g_card = _step(cfg, arch, cuda, inputs)
    assert l_card == pytest.approx(l_cpu, rel=1e-5)
    gscale = max(float(g.abs().max()) for g in g_cpu.values())
    for k in g_cpu:
        assert float((g_card[k] - g_cpu[k]).abs().max()) <= 2e-3 * gscale, k
    a = torch.cat([g_card[k].ravel() for k in sorted(g_cpu)])
    b = torch.cat([g_cpu[k].ravel() for k in sorted(g_cpu)])
    assert float(a @ b / (a.norm() * b.norm())) > 1 - 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_on_the_card(cuda, case):
    arch, fd = CASES[case]
    cfg = EngineConfig(patch_depth=5, future_patch_depth=fd, feature_rec=True, warp_impl="plain")
    inputs = _inputs(cfg, 2, 48, 64, seed=1)
    l0, g0 = _step(cfg, arch, cuda, inputs)
    l1, g1 = _step(dataclasses.replace(cfg, remat=True), arch, cuda, inputs)
    assert l1 == pytest.approx(l0, rel=1e-6)
    gscale = max(float(g.abs().max()) for g in g0.values())
    for k in g0:
        assert float((g1[k] - g0[k]).abs().max()) <= 1e-5 * gscale, k
