"""Quality metrics (port of rvdd_tpu/ops/metrics.py): PSNR in the network
domain, and the sRGB-domain PSNR and SSIM of the scoring harness (numpy,
float64)."""

from __future__ import annotations

import numpy as np
import torch


def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 2.0) -> torch.Tensor:
    """10*log10(max_val^2 / MSE) over all elements; max_val defaults to 2.0
    because the network domain is [-1, 1]."""
    mse = torch.mean((x.float() - y.float()) ** 2)
    return 10.0 * torch.log10(max_val * max_val / mse)


def psnr_srgb(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR between two 8-bit sRGB images, each normalized by 255 first."""
    x = (np.asarray(img1, np.float64) / 255.0 - np.asarray(img2, np.float64) / 255.0).ravel()
    return float(10.0 * np.log10(1.0 / np.mean(x**2)))


def ssim_srgb(img1: np.ndarray, img2: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM of two images, channels averaged: Wang et al. with a 7x7
    uniform window, K1 = 0.01, K2 = 0.03, the unbiased covariance and the
    valid region only (scikit-image's defaults, as the scoring harness
    calls it)."""
    from scipy.ndimage import uniform_filter

    x = np.asarray(img1, np.float64)
    y = np.asarray(img2, np.float64)
    if x.ndim == 2:
        x, y = x[..., None], y[..., None]
    win = 7
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def filt(a):
        return uniform_filter(a, size=(win, win, 1))

    mu_x, mu_y = filt(x), filt(y)
    cov_norm = win * win / (win * win - 1.0)
    vx = cov_norm * (filt(x * x) - mu_x * mu_x)
    vy = cov_norm * (filt(y * y) - mu_y * mu_y)
    vxy = cov_norm * (filt(x * y) - mu_x * mu_y)
    s = ((2 * mu_x * mu_y + c1) * (2 * vxy + c2)) / (
        (mu_x**2 + mu_y**2 + c1) * (vx + vy + c2))
    pad = (win - 1) // 2
    return float(s[pad:-pad, pad:-pad, :].mean())
