"""The nets' ablation knobs on the card (tests marked ``gpu``; they skip
without a card).  This file imports no JAX, so it runs on the card's
machine with ``-m gpu --noconftest`` (see README).

Each knob's forward and backward on the card against the CPU, on the same
seeded weights and inputs, TF32 off (cuBLAS and cuDNN): the output and the
recurrent features within 1e-4 x their largest CPU value, and every
parameter's gradient within 1e-4 x the largest CPU gradient (a leaf's own
largest can be noise: a conv bias before instance norm has none) (cuDNN
and the CPU sum in other orders; no TF32 rounding is left)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.precision import exact_precision  # noqa: E402

TOL = 1e-4
SMALL = "convunet-mode=fixedfeatures-filters=8-depth=3"
CNX = "newunet-filters=8-depth=3-n_blocks_encoder=1-n_blocks_decoder=1"
KNOBS = [
    f"{SMALL}-downsampling_mode=convavg",
    f"{SMALL}-downsampling_mode=maxpool",
    f"{SMALL}-downsampling_mode=stridedconv",
    f"{SMALL}-upsampling_mode=nearest",
    f"{SMALL}-upsampling_mode=transposedconv2",
    f"{SMALL}-upsampling_mode=transposedconv3",
    f"{SMALL}-upsampling_mode=transposedconv4",
    f"{SMALL}-activation=silu",
    f"{SMALL}-normalization=instance",
    f"{SMALL}-normalization=batch",
    f"{SMALL}-bottleneck_dilation=true",
    f"{SMALL}-use_bias=false",
    f"{SMALL}-residual=true",
    "convunet-mode=fixedfeatures+feat-filters=8-depth=3-normalization=batch",
    f"{CNX}-downsampling_mode=avgpool",
    f"{CNX}-upsampling_mode=nearest",
    f"{CNX}-fusion_mode=sum",
]


def _feat(arch):
    return "+feat" in arch or "mode=feat" in arch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: see README)")
    return torch.device("cuda")


def _run(arch, dev, x, feat):
    """(outputs, gradients) of sum(y^2) + sum(feat'^2) on ``dev``; the
    biases and batch norm's affine off their initial values, TF32 off."""
    in_nc = x.shape[-1]
    net = build_network(arch, in_nc, 3, _feat(arch), seed=3, device="cpu").train()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    net.to(dev)
    with exact_precision():
        y, f = net(x.to(dev), None if feat is None else feat.to(dev))
        loss = (y ** 2).sum() + (0 if f is None else (f ** 2).sum())
        loss.backward()
    outs = [y.detach().cpu().double()] + ([] if f is None else [f.detach().cpu().double()])
    grads = {n: p.grad.detach().cpu().double() for n, p in net.named_parameters()}
    return outs, grads


@pytest.mark.gpu
@pytest.mark.parametrize("arch", KNOBS)
def test_knob_forward_and_backward_on_the_card(cuda, arch):
    rng = np.random.default_rng(0)
    in_nc = 7 if "residual" in arch else 6
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 40, in_nc)).astype(np.float32))
    feat = (torch.from_numpy(np.abs(rng.standard_normal((2, 32, 40, 8))).astype(np.float32))
            if _feat(arch) else None)
    want, gwant = _run(arch, "cpu", x, feat)
    got, ggot = _run(arch, cuda, x, feat)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= TOL * float(w.abs().max()), arch
    assert gwant.keys() == ggot.keys()
    gscale = max(float(w.abs().max()) for w in gwant.values())
    for k, w in gwant.items():
        assert float((ggot[k] - w).abs().max()) <= TOL * gscale, (arch, k)
