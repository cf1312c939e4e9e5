"""The port's camera pipeline, transforms and sRGB metrics
(rvdd_tpu_torch/ops/{pipeline,transforms,metrics}.py) against rvdd_tpu's on
the CPU, with inputs from numpy seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from rvdd_tpu.ops import metrics as jmetrics  # noqa: E402
from rvdd_tpu.ops import pipeline as jpipe  # noqa: E402
from rvdd_tpu.ops import transforms as jtransforms  # noqa: E402
from rvdd_tpu_torch.ops import metrics, pipeline, transforms  # noqa: E402


def test_forward_pipeline_golden_and_rvdd_tpu(golden):
    """tests/test_pipeline.py's golden at atol 0.02, and rvdd_tpu's
    forward_pipeline to 1e-5 relative."""
    g = golden("fwd_ppipe")
    n, red, blue = (float(x) for x in g["gains"])
    gains = pipeline.Gains(1.0 / n, red, blue)
    jgains = jpipe.Gains(jnp.float32(1.0 / n), jnp.float32(red), jnp.float32(blue))
    for iso, key in [(3200, "srgb3200"), (12800, "srgb12800")]:
        got = pipeline.forward_pipeline(torch.from_numpy(g["im"]), gains, iso).numpy()
        np.testing.assert_allclose(got, g[key], atol=0.02)
        want = np.asarray(jpipe.forward_pipeline(jnp.asarray(g["im"]), jgains, iso))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_gains_tables_match_rvdd_tpu(tmp_path):
    for seq, iso in ((0, 3200), (7, 12800), (29, 3200)):
        assert pipeline.find_gains(seq, iso) == tuple(
            float(v) for v in jpipe.find_gains(seq, iso))
    for split, iso in (("train", 3200), ("train", 12800), ("val", 3200)):
        np.testing.assert_array_equal(pipeline.load_wb_table(split, iso),
                                      jpipe.load_wb_table(split, iso))
    t = pipeline.load_wb_table("train", 3200)
    assert pipeline.gains_from_table(t, 5) == tuple(
        float(v) for v in jpipe.gains_from_table(t, 5))
    p = tmp_path / "white_balance_coeffs_val_iso3200.txt"
    p.write_text("Seq = 000, n = tensor([0.8163]), red_gain = tensor([2.3223]), "
                 "blue_gain = tensor([3.6655])\nnoise line\n")
    np.testing.assert_array_equal(pipeline.parse_wb_table(str(p)), jpipe.parse_wb_table(str(p)))


def test_synthesize_raw_deterministic_outputs_match_rvdd_tpu():
    """gt_raw and gt_linear of rvdd_tpu's synthesize_raw from its key, and
    the port's unprocess of the same sRGB plus rvdd_tpu's dither of that
    key: 1e-5 relative.  The port's synthesize_raw draws the dither first,
    then the noise, from its generator."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (12, 16, 3)).astype(np.float32)
    gains = pipeline.find_gains(3, 3200)
    jgains = jpipe.find_gains(3, 3200)
    key = jax.random.PRNGKey(9)
    jgt_raw, jgt_lin, _ = jpipe.synthesize_raw(jnp.asarray(img), jgains, 3200, key)
    k_dither, _ = jax.random.split(key)
    dither = np.asarray(jax.random.uniform(k_dither, img.shape, jnp.float32, -0.5, 0.5))
    lin, raw = pipeline.unprocess(torch.from_numpy(img + dither), gains)
    for got, want in ((pipeline.to_stored_range(raw, 3200), jgt_raw),
                      (pipeline.to_stored_range(lin, 3200), jgt_lin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    gen = torch.Generator().manual_seed(3)
    gt_raw, gt_lin, noisy = pipeline.synthesize_raw(torch.from_numpy(img), gains, 3200, gen)
    assert gt_raw.shape == (6, 8, 4) and gt_lin.shape == (12, 16, 3)
    replay = torch.Generator().manual_seed(3)
    d = torch.rand(img.shape, generator=replay) - 0.5
    lin2, raw2 = pipeline.unprocess(torch.from_numpy(img) + d, gains)
    assert torch.equal(pipeline.to_stored_range(raw2, 3200), gt_raw)
    z = torch.randn(gt_raw.shape, generator=replay)
    a, b = pipeline.NOISE_PARAMS[3200]
    torch.testing.assert_close(noisy, gt_raw + torch.sqrt((a * gt_raw + b).clamp(min=0)) * z)


@pytest.mark.parametrize("iso,level", [(3200, 600.0), (3200, 2500.0), (12800, 1500.0)])
def test_noise_moments_match_rvdd_tpu(iso, level):
    """add_noise on a constant image: the noise's mean and variance within
    3 standard errors of rvdd_tpu's."""
    n = 200_000
    raw = np.full((n // 4, 4), level, np.float32)
    got = (pipeline.add_noise(torch.from_numpy(raw), iso, torch.Generator().manual_seed(0))
           .numpy() - raw).ravel().astype(np.float64)
    want = (np.asarray(jpipe.add_noise(jnp.asarray(raw), iso, jax.random.PRNGKey(0)))
            - raw).ravel().astype(np.float64)
    var = want.var()
    se_mean = np.sqrt(var / n + got.var() / n)
    se_var = np.sqrt(2 * var**2 / (n - 1) * 2)  # both estimates' errors, gaussian noise
    assert abs(got.mean() - want.mean()) < 3 * se_mean
    assert abs(got.var() - var) < 3 * se_var
    a, b = pipeline.NOISE_PARAMS[iso]
    assert abs(var / (a * level + b) - 1) < 0.02  # the model's variance


def test_srgb_metrics_match_rvdd_tpu():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (40, 52, 3)).astype(np.uint8)
    y = np.clip(x.astype(np.int64) + rng.integers(-9, 10, x.shape), 0, 255).astype(np.uint8)
    assert abs(metrics.psnr_srgb(x, y) - jmetrics.psnr_srgb(x, y)) < 1e-9
    assert abs(metrics.ssim_srgb(x, y) - jmetrics.ssim_srgb(x, y)) < 1e-9
    assert abs(metrics.ssim_srgb(x[..., 0], y[..., 0]) - jmetrics.ssim_srgb(x[..., 0], y[..., 0])) < 1e-9


def test_transforms_match_rvdd_tpu():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 4096, (5, 7, 4)).astype(np.uint16)
    got = transforms.normalize_bitdepth(torch.from_numpy(img.astype(np.int32)), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtransforms.normalize_bitdepth(img, 12)))
    x = torch.from_numpy(rng.uniform(0, 1, (6, 3)).astype(np.float32))
    np.testing.assert_array_equal(transforms.to_net(x).numpy(),
                                  np.asarray(jtransforms.to_net(jnp.asarray(x.numpy()))))
    np.testing.assert_allclose(transforms.from_net(transforms.to_net(x)).numpy(), x.numpy(),
                               atol=1e-7)
