"""The work counts against hand-counted multiply-adds and bytes, and their
independence from the program's chain modes."""

import pytest

from h100_bench import harness, peaks
from h100_bench.reference import nets
from h100_bench.work import conv_chain, convnext_chain, model, warp_bicubic

TINY_NET = dict(in_channels=9, out_channels=3, filters=4, depth=2, feature_rec=True)


def _cfg(family, **extra):
    cfg = harness.load_json("configs", "convunet_ff" if family == "convunet" else "convnext_ff")
    cfg["net"] = dict(TINY_NET, family=family, **extra)
    return cfg


def _params(cfg):
    return sum(p.numel() for p in nets.build(cfg, "meta").parameters())


MIX = {"raw_height": 4, "raw_width": 4}  # 8 x 8 RGB


def test_convunet_macs_by_hand():
    px, lo = 64, 16  # full and half resolution pixels
    c3 = lambda n, cin, cout: n * cin * cout * 9  # noqa: E731
    core = c3(lo, 4, 4) * 4  # enc_conv1 (2 convs) and bottleneck0, bottleneck1
    macs = (c3(px, 9, 4)  # pre
            + c3(px, 8, 4) + c3(px, 4, 4)  # enc_conv0
            + c3(px, 4, 4)  # enc_down0
            + core
            + c3(px, 4, 4)  # dec_up0 after the upsample
            + c3(px, 8, 4) + c3(px, 4, 4)  # dec_conv0
            + c3(px, 4, 4)  # post0
            + px * 4 * 3)  # post_final
    cfg = _cfg("convunet", bottleneck_depth=2, post_depth=2, n_blocks=2)
    assert model.forward_flops(cfg, 1, 8, 8) == 2 * macs == 227328
    flops, nbytes = conv_chain.per_frame(cfg, MIX)
    assert flops == 2 * (macs - core)
    core_params = 4 * (4 * 4 * 9 + 4)
    # glue fp32 in (9 + 4 channels), fp32 out (3 + 4), weights fp32
    assert nbytes == px * (13 * 4 + 7 * 4) + (_params(cfg) - core_params) * 4


def test_convnext_macs_by_hand():
    def block(n, cin, f):
        return (n * cin * f if cin != f else 0) + n * f * 49 + 8 * n * f * f

    px, lo = 64, 16
    macs = (block(px, 9, 4)  # pre
            + block(px, 8, 4)  # enc_conv0
            + block(lo, 4, 4) * 3  # enc_down0, enc_conv1, bottleneck
            + block(px, 4, 4)  # dec_up0
            + block(px, 8, 4)  # dec_conv0
            + block(px, 4, 4)  # post
            + px * 4 * 3)  # post_final
    cfg = _cfg("convnext", n_blocks=1)
    assert model.forward_flops(cfg, 1, 8, 8) == 2 * macs == 252800
    flops, nbytes = convnext_chain.per_frame(cfg, MIX)
    assert flops == 2 * macs
    assert nbytes == px * (13 * 4 + 7 * 4) + _params(cfg) * 4


def test_warp_bytes_by_hand():
    cfg = _cfg("convnext", n_blocks=1)
    # the state (3 + 4 channels) fp32 in and out, the future frame (3
    # channels) in and out, and each warp's flow (2 x fp32)
    assert warp_bicubic.per_frame(cfg, MIX) == (0, 64 * (7 * 8 + 8 + 3 * 8 + 8))


@pytest.mark.parametrize("work", [conv_chain, convnext_chain, warp_bicubic])
def test_counts_do_not_depend_on_the_chain_mode(work):
    mix = harness.load_json("traffic", "stream")
    for name in ("convunet_ff", "convnext_ff"):
        cfg = harness.load_json("configs", name)
        counts = {work.per_frame(dict(cfg, preset=p), mix)
                  for p in ("fast", "mixed", "accurate", "hybrid:glue+A+dec2")}
        assert len(counts) == 1


def test_bound_is_the_larger_time():
    assert peaks.bound_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_seconds(989e12, 6.7e12) == pytest.approx(2.0)
