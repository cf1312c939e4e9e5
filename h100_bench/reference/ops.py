"""Plain fp32 PyTorch of the frame operations the benchmark checks:
Hamilton-Adams demosaicing of packed GBRG raw, the x2 flow upsample, the
bilinear resizes and the max pool of the nets, and the bicubic flow warp.

A frozen copy of the program's semantics (the RVDD reference's
util/Hamilton_Adam_demo.py and torch's ``grid_sample``/``interpolate``
conventions), written for whole frames on one device.  It imports nothing of
the program, so a later change to the program cannot move it.  NHWC
throughout.
"""

from __future__ import annotations

import torch


# ------------------------------------------------------------------ demosaic


def pack_cfa(raw4: torch.Tensor) -> torch.Tensor:
    """Packed GBRG [..., h, w, 4] (G, B, R, G2) -> the mosaic [..., 2h, 2w]."""
    *lead, h, w, _ = raw4.shape
    x = raw4.reshape(*lead, h, w, 2, 2).transpose(-3, -2)
    return x.reshape(*lead, 2 * h, 2 * w)


def _masks(hh: int, ww: int, dtype, device):
    odd_r = (torch.arange(hh, device=device)[:, None] % 2).to(dtype)
    odd_c = (torch.arange(ww, device=device)[None, :] % 2).to(dtype)
    even_r, even_c = 1.0 - odd_r, 1.0 - odd_c
    mask_g = even_r * even_c + odd_r * odd_c
    mask_b = even_r * odd_c
    mask_r = odd_r * even_c
    # greens on red rows (odd/odd) and on blue rows (even/even)
    return mask_r, mask_g, mask_b, odd_r * odd_c, even_r * even_c


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x at (y + dy, x + dx) over the last two axes, edges replicated."""
    h, w = x.shape[-2], x.shape[-1]
    if dy:
        x = x.index_select(-2, (torch.arange(h, device=x.device) + dy).clamp(0, h - 1))
    if dx:
        x = x.index_select(-1, (torch.arange(w, device=x.device) + dx).clamp(0, w - 1))
    return x


def _green(cfa, mask_g):
    kh = 0.5 * (_shift(cfa, 0, -1) + _shift(cfa, 0, 1))
    kv = 0.5 * (_shift(cfa, -1, 0) + _shift(cfa, 1, 0))
    dh = _shift(cfa, 0, -2) - 2.0 * cfa + _shift(cfa, 0, 2)
    dv = _shift(cfa, -2, 0) - 2.0 * cfa + _shift(cfa, 2, 0)
    clh = (_shift(cfa, 0, -1) - _shift(cfa, 0, 1)).abs() + dh.abs()
    clv = (_shift(cfa, -1, 0) - _shift(cfa, 1, 0)).abs() + dv.abs()
    # the smaller gradient wins; a tie averages the two
    s = torch.sign(clh - clv)
    green = (1.0 + s) * (kv - dv / 4.0) / 2.0 + (1.0 - s) * (kh - dh / 4.0) / 2.0
    return green * (1.0 - mask_g) + cfa * mask_g


def _chroma(green, chan, mask_other, mask_row, mask_col):
    kh = 0.5 * (_shift(chan, 0, -1) + _shift(chan, 0, 1))
    kv = 0.5 * (_shift(chan, -1, 0) + _shift(chan, 1, 0))
    kp = 0.5 * (_shift(chan, -1, -1) + _shift(chan, 1, 1))
    kn = 0.5 * (_shift(chan, -1, 1) + _shift(chan, 1, -1))
    diffp = _shift(chan, 1, 1) - _shift(chan, -1, -1)
    diffn = _shift(chan, 1, -1) - _shift(chan, -1, 1)
    dh_g = 0.25 * _shift(green, 0, -1) - 0.5 * green + 0.25 * _shift(green, 0, 1)
    dv_g = 0.25 * _shift(green, -1, 0) - 0.5 * green + 0.25 * _shift(green, 1, 0)
    dp_g = _shift(green, -1, -1) - 2.0 * green + _shift(green, 1, 1)
    dn_g = _shift(green, -1, 1) - 2.0 * green + _shift(green, 1, -1)
    cp = mask_other * (kp - dp_g / 4.0)
    cn = mask_other * (kn - dn_g / 4.0)
    clp = mask_other * (diffp.abs() + dp_g.abs())
    cln = mask_other * (diffn.abs() + dn_g.abs())
    s = torch.sign(clp - cln)
    diag = (1.0 + s) * cn / 2.0 + (1.0 - s) * cp / 2.0
    return diag + mask_row * (kh - dh_g) + mask_col * (kv - dv_g) + chan


def demosaic(raw4: torch.Tensor) -> torch.Tensor:
    """Hamilton-Adams: packed GBRG [..., h, w, 4] -> RGB [..., 2h, 2w, 3]."""
    cfa = pack_cfa(raw4.float())
    mask_r, mask_g, mask_b, mask_gr, mask_gb = _masks(cfa.shape[-2], cfa.shape[-1],
                                                      cfa.dtype, cfa.device)
    green = _green(cfa, mask_g)
    red = _chroma(green, cfa * mask_r, mask_b, mask_gr, mask_gb)
    blue = _chroma(green, cfa * mask_b, mask_r, mask_gb, mask_gr)
    return torch.stack([red, green, blue], dim=-1)


# ------------------------------------------------------------------ resizing


def upsample2x(x: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """x2 bilinear upsample of [..., H, W, C] with torch's conventions."""
    for dim in (x.ndim - 3, x.ndim - 2):
        n = x.shape[dim]
        if align_corners:
            src = torch.arange(2 * n, dtype=torch.float64) * (n - 1) / max(2 * n - 1, 1)
        else:
            src = ((torch.arange(2 * n, dtype=torch.float64) + 0.5) / 2 - 0.5).clamp(min=0.0)
        i0 = src.floor().long().clamp(max=n - 1)
        i1 = (i0 + 1).clamp(max=n - 1)
        shape = [1] * x.ndim
        shape[dim] = 2 * n
        t = (src - i0).to(x.dtype).reshape(shape).to(x.device)
        x = (x.index_select(dim, i0.to(x.device)) * (1.0 - t)
             + x.index_select(dim, i1.to(x.device)) * t)
    return x


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of [..., H, W, C], floor semantics."""
    *lead, h, w, c = x.shape
    x = x[..., : h // 2 * 2, : w // 2 * 2, :].reshape(*lead, h // 2, 2, w // 2, 2, c)
    return x.amax(dim=(-4, -2))


def flow_upsample(flow: torch.Tensor) -> torch.Tensor:
    """Raw-resolution flow [..., h, w, 2] -> RGB resolution: x2 bilinear
    (align_corners=True) and the vectors doubled."""
    return upsample2x(flow.float(), align_corners=True) * 2.0


# ---------------------------------------------------------------------- warp


def _cubic(t: torch.Tensor, a: float = -0.75):
    """Keys' cubic weights of the taps at -1, 0, 1, 2 for fraction t."""
    def near(d):
        return ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0

    def far(d):
        return ((a * d - 5.0 * a) * d + 8.0 * a) * d - 4.0 * a

    return far(t + 1.0), near(t), near(1.0 - t), far(2.0 - t)


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bicubic warp (a = -0.75, each tap clamped to the border, as torch's
    ``grid_sample(mode='bicubic', padding_mode='border')``): x [B, H, W, C]
    sampled at (col + u, row + v) for flow [B, H, W, 2] = (u, v); fp32."""
    b, h, w, c = x.shape
    x = x.float()
    dev = x.device
    gx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :] + flow[..., 0].float()
    gy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] + flow[..., 1].float()
    fx, fy = gx.floor(), gy.floor()
    wx, wy = _cubic(gx - fx), _cubic(gy - fy)
    # far outside, every tap lands on the same edge pixel: clamping the
    # base there changes nothing and keeps the indices in range
    ix = fx.clamp(-3.0, w + 1.0).long()
    iy = fy.clamp(-3.0, h + 1.0).long()
    flat = x.reshape(b, h * w, c)
    bidx = torch.arange(b, device=dev)[:, None]
    out = torch.zeros_like(x)
    for j in range(4):
        row = (iy - 1 + j).clamp(0, h - 1) * w
        for i in range(4):
            idx = (row + (ix - 1 + i).clamp(0, w - 1)).reshape(b, -1)
            out += flat[bidx, idx].reshape(b, h, w, c) * (wy[j] * wx[i])[..., None]
    return out
