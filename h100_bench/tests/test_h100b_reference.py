"""The frozen reference against the program's module path, at a tiny size
on the CPU: the nets, the frame operations, a streamed step and a train
step's loss."""

import pytest
import torch

from h100_bench import compare, harness, weights
from h100_bench.reference import nets, ops
from h100_bench.reference.recurrent import frame_step, train_loss

CONFIGS = ["convunet_ff", "convnext_ff"]


def _pair(name, seed=3, device="cpu"):
    from h100_bench import program

    cfg = harness.load_json("configs", name)
    params = weights.make(cfg, torch.Generator().manual_seed(seed), device)
    ref = nets.build(cfg)
    ref.load_state_dict(params)
    return cfg, params, ref, program.build_net(cfg, params, device)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_frame_operations_match_the_program():
    from rvdd_tpu_torch.ops.demosaic import hamilton_adams
    from rvdd_tpu_torch.ops.warp import flow_upsample_2x, warp

    g = torch.Generator().manual_seed(0)
    raw = torch.randn(2, 3, 12, 20, 4, generator=g)
    assert torch.equal(ops.demosaic(raw), hamilton_adams(raw))
    fl = torch.randn(2, 12, 20, 2, generator=g) * 4
    assert torch.equal(ops.flow_upsample(fl), flow_upsample_2x(fl))
    x = torch.randn(2, 24, 40, 51, generator=g)
    f2 = torch.randn(2, 24, 40, 2, generator=g) * 9
    assert torch.allclose(ops.warp(x, f2), warp(x, f2, "bicubic")[0], atol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_net_matches_the_program(name):
    cfg, params, ref, net = _pair(name)
    assert {k for k, _ in ref.named_parameters()} == set(params)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 64, 96, cfg["net"]["in_channels"], generator=g)
    feat = torch.randn(1, 64, 96, 48, generator=g)
    with torch.no_grad():
        (a, af), (b, bf) = net(x, feat), ref(x, feat)
    assert _rel(a, b) < 1e-5 and _rel(af, bf) < 1e-5


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_stream_step_matches_the_module_path(name):
    from h100_bench import program
    from rvdd_tpu_torch.recurrent.engine import inference_step, prepare_frames, step

    cfg, _, ref, net = _pair(name)
    ecfg = program.engine_config(cfg, warp_impl="plain", net_impl="module")
    g = torch.Generator().manual_seed(2)
    raw = torch.randn(1, 3, 32, 48, 4, generator=g) * 0.3
    fl = torch.randn(1, 2, 32, 48, 2, generator=g) * 3
    with torch.no_grad():
        frames, fl2 = prepare_frames(ecfg, raw, fl[:, None])
        nil = net.nil_features(1, 64, 96)
        den, st = inference_step(ecfg, net, None, frames, fl2[:, 0], nil)
        ref_den, ref_st = frame_step(ref, raw, fl, None)
        assert _rel(den, ref_den) < 1e-5
        frames2, fl3 = prepare_frames(ecfg, raw[:, 1:], fl[:, None])
        den2, _ = step(ecfg, net, st, frames2[:, 0], frames2[:, 1:], fl3[:, 0])
        ref_den2, _ = frame_step(ref, raw, fl, ref_st)
    assert _rel(den2, ref_den2) < 1e-5


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_train_loss_matches_the_train_step(name):
    from h100_bench import program
    from rvdd_tpu_torch.training.train_state import loss_and_grads

    cfg, _, ref, net = _pair(name)
    ecfg = program.engine_config(cfg, patch_depth=3, warp_impl="plain", net_impl="module")
    g = torch.Generator().manual_seed(4)
    frames = torch.rand(2, 4, 16, 16, 4, generator=g) * 2 - 1
    flows = torch.rand(2, 2, 2, 16, 16, 2, generator=g) * 2 - 1
    gt = torch.rand(2, 4, 32, 32, 3, generator=g) * 2 - 1
    wts = torch.full((2,), 0.5)
    losses, grads = loss_and_grads(ecfg, net, frames, flows, gt, wts)
    for ckpt in (False, True):
        loss = train_loss(ref, frames, flows, gt, wts, checkpoint_steps=ckpt)
        ref_grads = dict(zip([k for k, _ in ref.named_parameters()],
                             torch.autograd.grad(loss, list(ref.parameters()))))
        assert abs(float(loss) - float(losses["Denoiser"])) < 1e-5 * float(loss)
        # by the benchmark's measure: ReLU's kinks and the pools' ties turn
        # rounding into gradient gaps of 1e-4 at this size (ConvNeXt: 1e-7)
        assert compare.norm_gap(grads, ref_grads, sorted(ref_grads)) < 1e-3
