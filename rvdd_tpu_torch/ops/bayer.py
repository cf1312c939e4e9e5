"""Bayer CFA layout utilities, GBRG packing (port of rvdd_tpu/ops/bayer.py).

A GBRG mosaic of a 2H x 2W sensor frame is stored as a half-resolution
4-channel image with channel order

    ch0 = G  (rows 0::2, cols 0::2)
    ch1 = B  (rows 0::2, cols 1::2)
    ch2 = R  (rows 1::2, cols 0::2)
    ch3 = G2 (rows 1::2, cols 1::2)

All tensors are NHWC.
"""

from __future__ import annotations

import torch

PATTERN = "gbrg"


def pack_cfa(raw4: torch.Tensor) -> torch.Tensor:
    """Scatter a packed [..., H, W, 4] raw image into a [..., 2H, 2W] CFA."""
    *lead, h, w, c = raw4.shape
    if c != 4:
        raise ValueError(f"packed raw must have 4 channels, got {c}")
    x = raw4.reshape(*lead, h, w, 2, 2).transpose(-3, -2)  # [..., h, 2, w, 2]
    return x.reshape(*lead, 2 * h, 2 * w)


def unpack_cfa(cfa: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_cfa`: [..., 2H, 2W] -> [..., H, W, 4]."""
    *lead, hh, ww = cfa.shape
    h, w = hh // 2, ww // 2
    x = cfa.reshape(*lead, h, 2, w, 2).transpose(-3, -2)  # [..., h, w, 2, 2]
    return x.reshape(*lead, h, w, 4)


def remosaic(rgb: torch.Tensor) -> torch.Tensor:
    """Subsample a full-res [..., 2H, 2W, 3] RGB image back to packed raw."""
    g = rgb[..., 0::2, 0::2, 1]
    b = rgb[..., 0::2, 1::2, 2]
    r = rgb[..., 1::2, 0::2, 0]
    g2 = rgb[..., 1::2, 1::2, 1]
    return torch.stack([g, b, r, g2], dim=-1)


def _parities(hh: int, ww: int, dtype, device):
    odd_r = (torch.arange(hh, device=device)[:, None] % 2).to(dtype)
    odd_c = (torch.arange(ww, device=device)[None, :] % 2).to(dtype)
    return odd_r, odd_c


def bayer_masks(hh: int, ww: int, dtype=torch.float32, device=None):
    """Per-color site masks (mask_r, mask_g, mask_b), each [hh, ww]."""
    odd_r, odd_c = _parities(hh, ww, dtype, device)
    even_r, even_c = 1.0 - odd_r, 1.0 - odd_c
    mask_g = even_r * even_c + odd_r * odd_c
    mask_b = even_r * odd_c
    mask_r = odd_r * even_c
    return mask_r, mask_g, mask_b


def green_row_masks(hh: int, ww: int, dtype=torch.float32, device=None):
    """(mask_gr, mask_gb): greens on red rows (odd/odd) and on blue rows
    (even/even)."""
    odd_r, odd_c = _parities(hh, ww, dtype, device)
    mask_gb = (1.0 - odd_r) * (1.0 - odd_c)
    mask_gr = odd_r * odd_c
    return mask_gr, mask_gb
