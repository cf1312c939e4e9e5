"""The port's ConvUNet (rvdd_tpu_torch/models) against rvdd_tpu's flax
ConvUNet on the CPU, with weights carried across by models/convert.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import convunet_from_flax, convunet_to_flax  # noqa: E402
from rvdd_tpu_torch.models.factory import parse_arch  # noqa: E402
from rvdd_tpu_torch.models.fast_unet import (  # noqa: E402
    fast_forward,
    pack_fast_params,
    resolve_fused_precision,
)

TRAINED = "trained-nets/recurrent-convunet+feat-tinyconv-iso3200.msgpack"
ARCHS = {
    "convunet": ("convunet-mode=fixedfeatures", False),
    "convunet+feat": ("convunet-mode=fixedfeatures+feat", True),
}


def flax_net(arch, in_nc, feat, h, w, seed=0):
    net = jfactory.build_network(arch, in_nc, 3, feat)
    params = jfactory.init_network(net, jax.random.PRNGKey(seed), (1, h, w, in_nc))
    return net, jax.tree_util.tree_map(np.asarray, params)


def port_net(arch, in_nc, feat, params):
    net = build_network(arch, in_nc, 3, feat, device="cpu")
    net.load_state_dict(convunet_from_flax(params))
    return net


def inputs(h, w, in_nc, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, h, w, in_nc)).astype(np.float32)
    feat = np.abs(rng.standard_normal((1, h, w, 48))).astype(np.float32)
    return x, feat


def compare(jnet, params, net, x, feat, use_feat, tol):
    want_y, want_f = jnet.apply({"params": params}, jax.numpy.asarray(x),
                                jax.numpy.asarray(feat) if use_feat else None)
    with torch.no_grad():
        got_y, got_f = net(torch.from_numpy(x), torch.from_numpy(feat) if use_feat else None)
    want_y = np.asarray(want_y)
    err = np.max(np.abs(got_y.numpy() - want_y)) / (np.std(want_y) + 1e-6)
    assert err < tol, err
    if use_feat:
        want_f = np.asarray(want_f)
        errf = np.max(np.abs(got_f.numpy() - want_f)) / (np.std(want_f) + 1e-6)
        assert errf < tol, errf


@pytest.mark.parametrize("name", list(ARCHS))
def test_convunet_matches_flax(name):
    """fp32 on both sides at 32x40; 1e-4 normalized for conv summation
    order (flax's XLA conv at 'highest' vs torch's CPU conv)."""
    arch, feat = ARCHS[name]
    jnet, params = flax_net(arch, 6, feat, 32, 40)
    net = port_net(arch, 6, feat, params)
    x, f = inputs(32, 40, 6)
    compare(jnet, params, net, x, f, feat, 1e-4)


def test_convunet_doubling_features_matches_flax():
    """The channel-doubling mode (no mode= argument), same tolerance."""
    jnet, params = flax_net("convunet-filters=8", 6, False, 32, 40)
    net = port_net("convunet-filters=8", 6, False, params)
    x, f = inputs(32, 40, 6, seed=5)
    compare(jnet, params, net, x, f, False, 1e-4)


def test_convert_round_trip():
    _, params = flax_net("convunet-mode=fixedfeatures+feat", 6, True, 32, 32)
    back = convunet_to_flax(convunet_from_flax(params))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_trained_weights_match_flax():
    """The trained full-width convunet+feat weights through both packages
    (flax reads the msgpack here, in the test only); 1e-4 normalized."""
    from flax import serialization

    with open(TRAINED, "rb") as fh:
        params = serialization.msgpack_restore(fh.read())
    params = jax.tree_util.tree_map(np.asarray, params)
    jnet = jfactory.build_network("convunet-mode=fixedfeatures+feat", 6, 3, True)
    net = port_net("convunet-mode=fixedfeatures+feat", 6, True, params)
    x, f = inputs(32, 48, 6, seed=4)
    compare(jnet, params, net, x, f, True, 1e-4)


def test_build_network_seeded_kaiming():
    a = build_network("convunet-mode=fixedfeatures+feat", 6, 3, seed=3, device="cpu")
    b = build_network("convunet-mode=fixedfeatures+feat", 6, 3, seed=3, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        if na.endswith("bias"):
            assert not pa.any()
    w = a.enc_conv1.conv0.weight.detach()  # fan_in 3*3*48: std sqrt(2/432)
    assert abs(float(w.std()) / np.sqrt(2 / 432) - 1) < 0.05
    assert a.feature_rec and a.pre.weight.shape == (48, 6, 3, 3)


def test_unsupported_knobs_raise():
    assert parse_arch("convunet-mode=fixedfeatures-depth=3") == (
        "convunet", {"mode": "fixedfeatures", "depth": 3})
    # the ablation knobs are ported (tests/test_torch_ablations.py); a value
    # neither package has raises, as rvdd_tpu's nets raise when applied
    assert build_network("convunet-mode=fixedfeatures-residual=true", 7, 3, device="cpu").residual
    assert build_network("newunet-mode=feat-fusion_mode=sum", 6, 3,
                         device="cpu").fusion_mode == "sum"
    with pytest.raises(NotImplementedError):
        build_network("convunet-mode=fixedfeatures-downsampling_mode=blur", 6, 3, device="cpu")
    with pytest.raises(NotImplementedError):
        build_network("newunet-mode=feat-fusion_mode=mul", 6, 3, device="cpu")
    assert resolve_fused_precision("mixed", arch="convunet", feature_rec=True,
                                   future=False) == "mixed"
    assert resolve_fused_precision("auto", arch="convunet", feature_rec=True,
                                   future=True) == "hybrid:glue+A+dec2"
    for name in ("accurate", "wf32"):  # ported: they resolve to themselves
        assert resolve_fused_precision(name, arch="convunet", feature_rec=True,
                                       future=True) == name
    with pytest.raises(ValueError):
        resolve_fused_precision("nopreset", arch="convunet", feature_rec=True, future=True)
    assert resolve_fused_precision("auto", arch="convunet", feature_rec=True,
                                   future=False) == "fast"


@pytest.mark.parametrize("name", list(ARCHS))
def test_fast_forward_matches_module(name):
    """The fused forward (plain chains on the CPU) against the port's fp32
    module: bf16 bands and weights, so the fast_step envelope (normalized
    max error < 0.2) applies."""
    arch, feat = ARCHS[name]
    net = build_network(arch, 6, 3, feat, seed=1, device="cpu")
    x, f = inputs(32, 32, 6, seed=2)
    xt, ft = torch.from_numpy(x), torch.from_numpy(f)
    with torch.no_grad():
        want, want_f = net(xt, ft if feat else None)
        packed = pack_fast_params(net, feat, 6)
        got, got_f = fast_forward(net, packed, xt.to(torch.bfloat16),
                                  ft.to(torch.bfloat16) if feat else None)
    err = float((got.float() - want).abs().max() / want.std())
    assert got.shape == want.shape and err < 0.2, err
    if feat:
        errf = float((got_f.float() - want_f).abs().max() / want_f.std())
        assert errf < 0.2, errf
