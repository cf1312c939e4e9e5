"""The data-parallel train step on the card (marked ``gpu``; skips without
a card).  This file imports no JAX, so it runs on the card's machine with
``-m gpu --noconftest`` (see README).

At world size 1 on NCCL (torchrun's environment of a one-process job, a
free port), the step of make_train_step(mesh=...) against the plain step
(loss_and_grads) on the same weights and inputs, TF32 off: the loss within
1e-5 relative and each averaged gradient within 2e-3 x the largest plain
gradient, cosine above 1 - 1e-6 (chip_smoke.py's card_against_cpu
limits; the warp's backward scatters with atomics, so two steps on the
card are not bit-equal).  NCCL's average runs its one-rank reduction
kernel at world size 1, so the gradients do go through the collective.
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.parallel.mesh import TORCHRUN_ENV, init_distributed, make_mesh  # noqa: E402
from rvdd_tpu_torch.precision import exact_precision  # noqa: E402
from rvdd_tpu_torch.recurrent.engine import EngineConfig  # noqa: E402
from rvdd_tpu_torch.training.train_state import (  # noqa: E402
    create_train_state,
    loss_and_grads,
    make_train_step,
)

ARCH = "convunet-mode=fixedfeatures+feat-filters=12"


@pytest.fixture
def nccl(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: see README)")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in zip(TORCHRUN_ENV, ("0", "1", "0", "127.0.0.1", str(port))):
        monkeypatch.setenv(k, v)
    dev = init_distributed("cuda")
    yield dev
    torch.distributed.destroy_process_group()


def _inputs(cfg, b, h, w, dev):
    rng = np.random.default_rng(0)
    t = cfg.patch_depth
    raw = rng.uniform(-0.9, 0.9, (b, t, h, w, 4)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    flows = np.zeros((b, cfg.train_unrollings, 1, h, w, 2), np.float32)
    flows[..., 0] = 2.5 * np.sin(xx / 9) + 1.0
    flows[..., 1] = 1.5 * np.cos(yy / 7) - 0.5
    gt = rng.uniform(-0.9, 0.9, (b, t, 2 * h, 2 * w, 3)).astype(np.float32)
    weights = np.full(cfg.train_unrollings, 1.0 / cfg.train_unrollings, np.float32)
    return [torch.from_numpy(a).to(dev) for a in (raw, flows, gt)] + [torch.from_numpy(weights)]


@pytest.mark.gpu
def test_dp_step_on_nccl_matches_the_plain_step(nccl):
    assert torch.distributed.get_backend() == "nccl" and nccl.type == "cuda"
    cfg = EngineConfig(patch_depth=4, feature_rec=True, warp_impl="plain")
    inputs = _inputs(cfg, 2, 48, 64, nccl)
    net = build_network(ARCH, 6, 3, True, seed=0, device=nccl)
    mesh = make_mesh("data", batch_size=2)
    assert (mesh.data, mesh.world_size, mesh.rank) == (1, 1, 0)
    with exact_precision():
        plain, want = loss_and_grads(cfg, net, *inputs)
        state = create_train_state(net, "sgd", beta1=0.0)  # lr 0: the weights stay
        _, losses = make_train_step(cfg, "highest", mesh)(state, *inputs)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert float(losses["Denoiser"]) == pytest.approx(float(plain["Denoiser"]), rel=1e-5)
    assert float(losses["PSNR"]) == pytest.approx(float(plain["PSNR"]), rel=1e-5)
    gscale = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        assert float((got[k] - g).abs().max()) <= 2e-3 * gscale, k
    a = torch.cat([got[k].double().ravel() for k in sorted(want)])
    b = torch.cat([want[k].double().ravel() for k in sorted(want)])
    assert float(a @ b / (a.norm() * b.norm())) > 1 - 1e-6
