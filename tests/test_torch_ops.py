"""The port's plain ops (rvdd_tpu_torch/ops) against rvdd_tpu's and the
golden fixtures, on the CPU.  Inputs come from numpy seeds and go to both
packages; goldens are NCHW and are transposed to NHWC."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from rvdd_tpu.ops import bayer as jbayer  # noqa: E402
from rvdd_tpu.ops import demosaic as jdemosaic  # noqa: E402
from rvdd_tpu.ops import metrics as jmetrics  # noqa: E402
from rvdd_tpu.ops import resize as jresize  # noqa: E402
from rvdd_tpu_torch.ops import bayer, demosaic, metrics, resize, warp  # noqa: E402

# rvdd_tpu.ops re-exports the function `warp`, which shadows the module
jwarp = importlib.import_module("rvdd_tpu.ops.warp")


def nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


# ------------------------------------------------------------------ bayer


def test_bayer_pack_unpack_remosaic_match_rvdd_tpu():
    rng = np.random.default_rng(0)
    raw = rng.uniform(-1, 1, (2, 5, 7, 4)).astype(np.float32)
    cfa = bayer.pack_cfa(t(raw)).numpy()
    np.testing.assert_array_equal(cfa, np.asarray(jbayer.pack_cfa(j(raw))))
    np.testing.assert_array_equal(bayer.unpack_cfa(t(cfa)).numpy(), raw)
    rgb = rng.uniform(-1, 1, (2, 10, 14, 3)).astype(np.float32)
    np.testing.assert_array_equal(bayer.remosaic(t(rgb)).numpy(),
                                  np.asarray(jbayer.remosaic(j(rgb))))


def test_bayer_masks_match_rvdd_tpu():
    for got, want in zip(bayer.bayer_masks(6, 8) + bayer.green_row_masks(6, 8),
                         jbayer.bayer_masks(6, 8) + jbayer.green_row_masks(6, 8)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------- demosaic


def test_hamilton_adams_golden(golden):
    """2e-5: the golden's own tolerance in tests/test_ops_core.py."""
    g = golden("hamilton_adams")
    out = demosaic.hamilton_adams(t(nhwc(g["raw"]))).numpy()
    np.testing.assert_allclose(out, nhwc(g["rgb"]), atol=2e-5)


def test_hamilton_adams_matches_rvdd_tpu():
    """1e-5: the same fp32 stencil arithmetic in both packages."""
    rng = np.random.default_rng(1)
    raw = rng.uniform(-1, 1, (2, 12, 18, 4)).astype(np.float32)
    np.testing.assert_allclose(demosaic.hamilton_adams(t(raw)).numpy(),
                               np.asarray(jdemosaic.hamilton_adams(j(raw))), atol=1e-5)


# ------------------------------------------------------------------- warp


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "nearest"])
def test_warp_matches_rvdd_tpu(mode):
    """(warped, mask) at 1e-5: the same fp32 taps and weights, summed in the
    same order; flows reach past every border."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 13, 17, 5)).astype(np.float32)
    fl = (rng.standard_normal((2, 13, 17, 2)) * 6).astype(np.float32)
    got, gmask = warp.warp(t(x), t(fl), mode)
    want, wmask = jwarp.warp(j(x), j(fl), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "nearest"])
def test_warp_golden(golden, mode):
    """3e-5: the golden's own tolerance in tests/test_ops_core.py."""
    g = golden("warp")
    out, mask = warp.warp(t(nhwc(g["x"])), t(nhwc(g["flow"])), mode)
    np.testing.assert_allclose(out.numpy(), nhwc(g[f"warped_{mode}"]), atol=3e-5)
    np.testing.assert_allclose(mask.numpy(), nhwc(g[f"mask_{mode}"]), atol=0)


def test_cubic_kernel_matches_rvdd_tpu():
    tt = np.linspace(0, 0.999, 37).astype(np.float32)
    for got, want in zip(warp.cubic_kernel(t(tt)), jwarp.cubic_kernel(j(tt))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


def test_flow_upsample_matches_rvdd_tpu_and_golden(golden):
    """1e-4: the golden's tolerance (rvdd_tpu evaluates the lerp in another
    order); against rvdd_tpu on a random flow, 1e-5."""
    g = golden("warp")
    up = warp.flow_upsample_2x(t(nhwc(g["flow"]))).numpy()
    np.testing.assert_allclose(up, nhwc(g["flow_up2"]), atol=1e-4)
    rng = np.random.default_rng(3)
    fl = (rng.standard_normal((3, 9, 14, 2)) * 4).astype(np.float32)
    np.testing.assert_allclose(warp.flow_upsample_2x(t(fl)).numpy(),
                               np.asarray(jwarp.flow_upsample_2x(j(fl))), atol=1e-5)


# ----------------------------------------------------------------- resize


@pytest.mark.parametrize("align_corners", [False, True])
def test_upsample2x_bilinear_matches_rvdd_tpu_and_golden(golden, align_corners):
    """1e-5 (golden's tolerance); the same lerps in both packages."""
    g = golden("resize")
    x = nhwc(g["x"])
    got = resize.upsample2x_bilinear(t(x), align_corners=align_corners).numpy()
    key = "up_ac" if align_corners else "up_nac"
    np.testing.assert_allclose(got, nhwc(g[key]), atol=1e-5)
    want = jresize.upsample2x_bilinear(j(x), align_corners=align_corners)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_resize_bilinear_matches_rvdd_tpu():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 7, 11, 3)).astype(np.float32)
    for ac in (False, True):
        np.testing.assert_allclose(
            resize.resize_bilinear(t(x), 12, 5, ac).numpy(),
            np.asarray(jresize.resize_bilinear(j(x), 12, 5, ac)), atol=1e-5)


def test_maxpool2x2_matches_rvdd_tpu_and_golden(golden):
    g = golden("resize")
    x = nhwc(g["x"])  # odd sizes: floor semantics
    got = resize.maxpool2x2(t(x)).numpy()
    np.testing.assert_array_equal(got, nhwc(g["maxpool"]))
    np.testing.assert_array_equal(got, np.asarray(jresize.maxpool2x2(j(x))))


# ---------------------------------------------------------------- metrics


def test_psnr_matches_rvdd_tpu():
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.05, a.shape).astype(np.float32)
    np.testing.assert_allclose(float(metrics.psnr(t(a), t(b))),
                               float(jmetrics.psnr(j(a), j(b))), rtol=1e-5)
