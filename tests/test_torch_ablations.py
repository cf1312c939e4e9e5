"""The ablation knobs of the port's nets (rvdd_tpu_torch/models/unet.py and
convnext_unet.py) and ``--init_type`` (models/factory.py) against
rvdd_tpu's, on the CPU in fp32.

Each knob's forward is held against rvdd_tpu's ``net.apply`` on the same
parameters, carried across by models/convert.py, within 1e-5 x max|out|
(both sides fp32; what is left is the order of the sums).  Small nets:
filters 8, depth 2, 16x20 pixels, a batch of 2 (batch norm's statistics
span it)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.models.fast_convnext import supports_fast_path_cnx as j_supports_cnx  # noqa: E402
from rvdd_tpu.models.fast_unet import supports_fast_path as j_supports  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import (  # noqa: E402
    check_state_dict,
    convnext_from_flax,
    convnext_to_flax,
    convunet_from_flax,
    convunet_to_flax,
)
from rvdd_tpu_torch.models.factory import INIT_GAIN, INIT_TYPES  # noqa: E402
from rvdd_tpu_torch.models.fast_convnext import supports_fast_path_cnx  # noqa: E402
from rvdd_tpu_torch.models.fast_unet import supports_fast_path  # noqa: E402
from rvdd_tpu_torch.models.unet import _normalize  # noqa: E402
from rvdd_tpu_torch.recurrent.engine import EngineConfig, inference_step  # noqa: E402

TOL = 1e-5  # x max|out|
B, H, W = 2, 16, 20
SMALL = "convunet-mode=fixedfeatures-filters=8-depth=2"
UNET_KNOBS = [
    f"{SMALL}-downsampling_mode=convavg",
    f"{SMALL}-downsampling_mode=maxpool",
    f"{SMALL}-downsampling_mode=stridedconv",
    f"{SMALL}-upsampling_mode=nearest",
    f"{SMALL}-upsampling_mode=transposedconv",
    f"{SMALL}-upsampling_mode=transposedconv3",
    f"{SMALL}-upsampling_mode=transposedconv4",
    f"{SMALL}-activation=silu",
    f"{SMALL}-normalization=instance",
    f"{SMALL}-normalization=batch",
    f"{SMALL}-bottleneck_dilation=true",
    f"{SMALL}-use_bias=false",
    f"{SMALL}-residual=true",
    # channel-doubling mode: each transposed conv at its own width
    "convunet-filters=8-depth=3-upsampling_mode=transposedconv2-normalization=batch",
    "convunet-mode=fixedfeatures+feat-filters=8-depth=2-normalization=batch-use_bias=false",
]
CNX = "newunet-filters=8-depth=2-n_blocks_encoder=1-n_blocks_decoder=1-n_blocks_bottleneck=1-" \
      "n_blocks_postprocessing=1"
CNX_KNOBS = [f"{CNX}-downsampling_mode=avgpool", f"{CNX}-upsampling_mode=nearest",
             f"{CNX}-fusion_mode=sum", "newunet-mode=feat-filters=8-depth=2-fusion_mode=sum-"
             "downsampling_mode=avgpool-upsampling_mode=nearest"]


def _feat(arch):
    return "+feat" in arch or "mode=feat" in arch


def _in_nc(arch):
    return 7 if "residual" in arch else 6  # the residual takes x[..., 4:] (3 channels)


def _flat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(arch, seed=0):
    """(flax net, params, the port's net): the port's seeded net with every
    1-D leaf moved off its initial value (biases, batch norm's affine,
    LayerNorm, LayerScale), carried to flax by models/convert.py; the tree
    is checked leaf for leaf against the one rvdd_tpu's init makes
    (jax.eval_shape: names and shapes, without compiling it)."""
    in_nc, feat = _in_nc(arch), _feat(arch)
    cnx = arch.startswith("newunet")
    jnet = jfactory.build_network(arch, in_nc, 3, feat)
    net = build_network(arch, in_nc, 3, feat, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    params = (convnext_to_flax if cnx else convunet_to_flax)(net.state_dict())
    x = jax.ShapeDtypeStruct((1, H, W, in_nc), np.float32)
    f = jax.ShapeDtypeStruct((1, H, W, 8), np.float32) if feat else None
    want = _flat(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, f)["params"])
    got = _flat(params)
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    return jnet, params, net


def _inputs(arch, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, H, W, _in_nc(arch))).astype(np.float32)
    feat = np.abs(rng.standard_normal((B, H, W, 8))).astype(np.float32)
    return x, (feat if _feat(arch) else None)


@pytest.mark.parametrize("arch", UNET_KNOBS + CNX_KNOBS)
def test_knob_matches_rvdd_tpu(arch):
    jnet, params, net = _pair(arch)
    x, feat = _inputs(arch)
    want_y, want_f = jnet.apply({"params": params}, x, feat)
    with torch.no_grad():
        got_y, got_f = net(torch.from_numpy(x), None if feat is None else torch.from_numpy(feat))
    want_y = np.asarray(want_y)
    assert got_y.shape == want_y.shape == (B, H, W, 3)
    assert np.abs(got_y.numpy() - want_y).max() <= TOL * np.abs(want_y).max()
    if feat is not None:
        want_f = np.asarray(want_f)
        assert np.abs(got_f.numpy() - want_f).max() <= TOL * np.abs(want_f).max()


@pytest.mark.parametrize("arch", [
    "convunet-filters=8-depth=3-upsampling_mode=transposedconv3-normalization=batch",
    f"{CNX}-fusion_mode=sum",
])
def test_converter_round_trip_is_exact(arch):
    """rvdd_tpu's initialized params -> state_dict -> flax, and the port's
    state_dict -> flax -> state_dict, give back every leaf bit for bit, the
    ablation leaves (batch norm's affine, the transposed convs' HWIO
    kernels and biases, fuse_scale) included."""
    cnx = arch.startswith("newunet")
    jnet = jfactory.build_network(arch, 6, 3, False)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(0), (1, H, W, 6))
    a = {k: np.asarray(v) for k, v in _flat(params).items()}
    to_flax, from_flax = ((convnext_to_flax, convnext_from_flax) if cnx
                          else (convunet_to_flax, convunet_from_flax))
    net = build_network(arch, 6, 3, device="cpu")
    sd = from_flax(params)
    check_state_dict(sd, net)
    b = _flat(to_flax(sd))
    own = [k for k in a if k.endswith(("_bn_scale", "_bn_offset", "_kernel", "_bias"))
           or k.startswith("fuse_scale")]
    assert len(own) >= (1 if cnx else 6), "ablation leaves missing"
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    back = from_flax(to_flax(net.state_dict()))
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("k", [2, 3, 4])
def test_transposed_conv_is_conv_transpose2d(k):
    """The upsample of ``transposedconv<k>`` is nn.ConvTranspose2d(ch, ch,
    k, stride=2, padding=(k-1)//2) with the weight kernel.permute(2, 3, 0,
    1), as tests/test_unet_ablations.py holds rvdd_tpu's (1e-6 x max)."""
    net = build_network(f"{SMALL}-upsampling_mode=transposedconv{k}", 6, 3, device="cpu")
    kernel, bias = net.up_transposed0_kernel, net.up_transposed0_bias
    assert kernel.shape == (k, k, 8, 8)
    with torch.no_grad():
        bias.copy_(torch.randn(8))
        tconv = torch.nn.ConvTranspose2d(8, 8, k, stride=2, padding=(k - 1) // 2)
        tconv.weight.copy_(kernel.permute(2, 3, 0, 1))
        tconv.bias.copy_(bias)
        d = torch.randn(2, 8, 5, 6)
        want = tconv(d)
        got = net._upsample(d, 0)
    p = (k - 1) // 2
    assert got.shape == want.shape == (2, 8, 2 * 4 + k - 2 * p, 2 * 5 + k - 2 * p)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_instance_and_batch_norm_match_torch_modules():
    """``instance`` is nn.InstanceNorm2d (no affine, eps 1e-5); ``batch``
    is nn.BatchNorm2d in training mode with the affine from the calling
    module (5e-6 x max)."""
    x = torch.randn(3, 8, 6, 7) * 2 + 0.5
    net = build_network(f"{SMALL}-normalization=batch", 6, 3, device="cpu")
    with torch.no_grad():
        net.dec_up0_bn_scale.copy_(torch.rand(8) + 0.5)
        net.dec_up0_bn_offset.copy_(torch.randn(8))
        want = torch.nn.InstanceNorm2d(8, eps=1e-5)(x)
        got = _normalize(x, "instance", None, "")
        assert (got - want).abs().max() <= 5e-6 * want.abs().max()
        bn = torch.nn.BatchNorm2d(8, eps=1e-5, track_running_stats=False).train()
        bn.weight.copy_(net.dec_up0_bn_scale)
        bn.bias.copy_(net.dec_up0_bn_offset)
        want = bn(x)
        got = _normalize(x, "batch", net, "dec_up0")
        assert (got - want).abs().max() <= 5e-6 * want.abs().max()
    net.eval()  # batch statistics in eval too, as rvdd_tpu
    with torch.no_grad():
        assert torch.equal(_normalize(x, "batch", net, "dec_up0"), got)


def test_batch_norm_gradients_are_nonzero():
    net = build_network(f"{SMALL}-normalization=batch", 6, 3, device="cpu").train()
    x, _ = _inputs(SMALL)
    y, _ = net(torch.from_numpy(x))
    (y ** 2).mean().backward()
    names = [n for n, _ in net.named_parameters() if n.endswith(("_bn_scale", "_bn_offset"))]
    assert len(names) == 2 * (3 * 2 + 1 + 1)  # enc/dec blocks' convs, dec_up0, post0
    for n, p in net.named_parameters():
        if n in names:
            assert p.grad is not None and p.grad.abs().max() > 0, n


@pytest.mark.parametrize("arch", UNET_KNOBS[:13] + CNX_KNOBS[:3])
def test_fused_path_refuses_what_rvdd_tpu_refuses(arch):
    """Each knob at full width is outside the fused path's limits in both
    packages (supports_fast_path), and the fused step raises on it; the
    module path runs it."""
    full = arch.replace("-filters=8-depth=2", "").replace(
        "-n_blocks_encoder=1-n_blocks_decoder=1-n_blocks_bottleneck=1-n_blocks_postprocessing=1",
        "")
    cnx = full.startswith("newunet")
    in_nc = 9 if cnx else _in_nc(full)
    net = build_network(full, in_nc, 3, True, device="cpu")
    jnet = jfactory.build_network(full, in_nc, 3, True)
    h = 64
    assert not (supports_fast_path_cnx if cnx else supports_fast_path)(net, h, h)
    assert not (j_supports_cnx if cnx else j_supports)(jnet, h, h)
    if cnx or "residual" in full:
        return
    cfg = EngineConfig(feature_rec=True, net_impl="fused")
    frames = torch.zeros(1, 2, h, h, 3)
    flows = torch.zeros(1, 1, h, h, 2)
    with pytest.raises(ValueError, match="no fast path"):
        inference_step(cfg, net, None, frames, flows, net.nil_features(1, h, h))
    den, _ = inference_step(EngineConfig(feature_rec=True), net, None, frames, flows,
                            net.nil_features(1, h, h))
    assert den.shape == (1, h, h, 3)


# ------------------------------------------------------------ --init_type


def _hwio(p: torch.Tensor) -> np.ndarray:
    return p.detach().permute(2, 3, 1, 0).numpy()


def _target_std(init_type, fan_in, fan_out):
    return {"kaiming": np.sqrt(2 / fan_in), "normal": INIT_GAIN,
            "xavier": INIT_GAIN * np.sqrt(2 / (fan_in + fan_out)),
            "orthogonal": INIT_GAIN / np.sqrt(fan_in), "flax": np.sqrt(1 / fan_in)}[init_type]


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_init_type_statistics(init_type):
    """On 48x48x3x3 kernels (fan_in = fan_out = 432): the std within 5% of
    the policy's; ``orthogonal``'s (432, 48) matrix has orthonormal columns
    times 0.02 (to 1e-5); ``flax`` is truncated at 2 standard deviations;
    every bias 0; the transposed conv's HWIO kernel follows the policy too;
    seeded draws repeat."""
    arch = "convunet-mode=fixedfeatures-depth=2-upsampling_mode=transposedconv3"
    net = build_network(arch, 6, 3, seed=4, device="cpu", init_type=init_type)
    again = build_network(arch, 6, 3, seed=4, device="cpu", init_type=init_type)
    for (n, p), (_, q) in zip(net.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), n
        if n.endswith("bias"):
            assert not p.any(), n
    for w in (_hwio(net.enc_conv1.conv0.weight), net.up_transposed0_kernel.detach().numpy()):
        assert w.shape == (3, 3, 48, 48)
        target = _target_std(init_type, 432, 432)
        assert abs(w.std() / target - 1) < 0.05, (w.std(), target)
        if init_type == "orthogonal":
            m = w.reshape(432, 48).astype(np.float64) / INIT_GAIN
            assert np.abs(m.T @ m - np.eye(48)).max() < 1e-5
        if init_type == "flax":
            assert np.abs(w).max() <= 2 * target / 0.87962566103423978 + 1e-7
    # fan_in of a thin kernel: the first conv, 3x3x6 -> 48 (kaiming's and flax's)
    if init_type in ("kaiming", "flax"):
        w = _hwio(net.enc_conv0.conv0.weight)
        assert abs(w.std() / _target_std(init_type, 54, 432) - 1) < 0.1


@pytest.mark.parametrize("init_type", ["normal", "flax"])
def test_init_type_keeps_flax_leaves(init_type):
    """ConvNeXt's LayerNorm, LayerScale (fuse_scale included) and batch
    norm keep flax's initial values under every policy, as rvdd_tpu's
    reinit_convs leaves them; a depthwise 7x7 has fan_in 49."""
    net = build_network(f"{CNX}-fusion_mode=sum", 6, 3, device="cpu", init_type=init_type)
    for n, p in net.named_parameters():
        if n.endswith("bias"):
            assert not p.any(), n
        elif n.endswith("layerscale"):
            assert (p == 0.1).all(), n
        elif p.dim() == 1:
            assert (p == 1).all(), n
    dw = _hwio(net.enc_conv0.block0.dw.weight)
    assert dw.shape == (7, 7, 1, 8)
    if init_type == "flax":
        assert np.abs(dw).max() <= 2 / np.sqrt(49) / 0.87962566103423978 + 1e-7
    bn = build_network(f"{SMALL}-normalization=batch", 6, 3, device="cpu", init_type=init_type)
    assert (bn.enc_conv0.conv0_bn_scale == 1).all() and not bn.post0_bn_offset.any()


def test_unknown_init_type_raises():
    with pytest.raises(NotImplementedError):
        build_network(SMALL, 6, 3, device="cpu", init_type="uniform")
