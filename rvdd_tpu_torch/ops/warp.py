"""Flow warping with torch ``grid_sample`` semantics, in plain PyTorch (port
of rvdd_tpu/ops/warp.py).

* bicubic = Keys cubic convolution with A = -0.75; the fractional position
  comes from the *unclipped* source coordinate while each of the 4x4 taps
  is clamped to the border individually (torch's bicubic border padding);
* bilinear and nearest clip the source coordinate first.

``flow[..., 0]`` is the horizontal displacement u, ``flow[..., 1]`` the
vertical v; ``warp(x, flow)`` samples x at ``(col + u, row + v)``.

The bicubic ``warp`` is also the plain version of the CUDA warp kernel
(ops/cuda/warp_bicubic.py), in both its modes.

On a shard of the mesh's space axis (``rows``, parallel/space.py) a
flow's reach is unbounded, so ``warp`` gathers the whole sample of ``x``
and samples it at this shard's rows, counted from the shard's offset; the
border clamp and the mask use the sample's height.
"""

from __future__ import annotations

from typing import Optional

import torch

from rvdd_tpu_torch.ops.resize import resize_bilinear
from rvdd_tpu_torch.parallel import space
from rvdd_tpu_torch.parallel.space import Rows


def cubic_kernel(t, a: float = -0.75):
    """Keys cubic convolution weights for taps at offsets (-1, 0, 1, 2);
    ``t`` is the fractional position in [0, 1)."""
    d0 = t + 1.0
    d3 = 2.0 - t
    w0 = ((a * d0 - 5.0 * a) * d0 + 8.0 * a) * d0 - 4.0 * a
    w1 = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    u = 1.0 - t
    w2 = ((a + 2.0) * u - (a + 3.0)) * u * u + 1.0
    w3 = ((a * d3 - 5.0 * a) * d3 + 8.0 * a) * d3 - 4.0 * a
    return w0, w1, w2, w3


def _gather2d(xf: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, w: int):
    """xf [B, H*W, C] at integer (iy, ix) [B, H', W'] -> [B, H', W', C]."""
    b = xf.shape[0]
    idx = (iy * w + ix).reshape(b, -1)
    bidx = torch.arange(b, device=xf.device)[:, None]
    return xf[bidx, idx].reshape(b, iy.shape[1], iy.shape[2], xf.shape[-1])


def warp(x: torch.Tensor, flow: torch.Tensor, interp: str = "bicubic", a: float = -0.75,
         rows: Optional[Rows] = None):
    """Warp ``x`` [B, H, W, C] by ``flow`` [B, H, W, 2].

    Returns ``(warped, mask)``; ``mask`` [B, H, W, 1] is 1.0 where the
    source position fell inside the image.  Computes in float32.  ``a`` is
    the bicubic coefficient: -0.75 (torch's) for the model, -0.5
    (Catmull-Rom) for the TV-L1 solver's warp.  On a shard, ``x`` and
    ``flow`` hold this shard's ``rows`` and so does the result.
    """
    row0 = 0
    if rows is not None:
        x = space.gather_rows(x, rows)
        row0 = rows.start
    b, h, wd, c = x.shape
    x = x.float()
    flow = flow.float()
    dev = x.device
    gx = torch.arange(wd, device=dev, dtype=torch.float32)[None, None, :] + flow[..., 0]
    gy = (torch.arange(row0, row0 + flow.shape[1], device=dev, dtype=torch.float32)
          [None, :, None] + flow[..., 1])
    mask = ((gx >= 0.0) & (gx <= wd - 1.0) & (gy >= 0.0) & (gy <= h - 1.0))
    mask = mask.to(x.dtype)[..., None]
    xf = x.reshape(b, h * wd, c)

    if interp == "bicubic":
        fx = torch.floor(gx)
        fy = torch.floor(gy)
        wx = cubic_kernel(gx - fx, a)
        wy = cubic_kernel(gy - fy, a)
        # every tap of a position beyond [-3, size+1] clamps to the same
        # edge pixel, so clamping the base index there changes nothing and
        # keeps the integer conversion in range
        ix = fx.clamp(-3.0, wd + 1.0).long()
        iy = fy.clamp(-3.0, h + 1.0).long()
        out = x.new_zeros((b,) + tuple(gy.shape[1:]) + (c,))
        for j in range(4):
            iyj = (iy - 1 + j).clamp(0, h - 1)
            for i in range(4):
                ixi = (ix - 1 + i).clamp(0, wd - 1)
                v = _gather2d(xf, iyj, ixi, wd)
                out = out + v * (wy[j] * wx[i])[..., None]
        return out, mask

    if interp == "bilinear":
        cgx = gx.clamp(0.0, wd - 1.0)
        cgy = gy.clamp(0.0, h - 1.0)
        ix0 = torch.floor(cgx).long()
        iy0 = torch.floor(cgy).long()
        tx = (cgx - ix0)[..., None]
        ty = (cgy - iy0)[..., None]
        ix1 = (ix0 + 1).clamp(max=wd - 1)
        iy1 = (iy0 + 1).clamp(max=h - 1)
        v00 = _gather2d(xf, iy0, ix0, wd)
        v01 = _gather2d(xf, iy0, ix1, wd)
        v10 = _gather2d(xf, iy1, ix0, wd)
        v11 = _gather2d(xf, iy1, ix1, wd)
        top = v00 * (1.0 - tx) + v01 * tx
        bot = v10 * (1.0 - tx) + v11 * tx
        return top * (1.0 - ty) + bot * ty, mask

    if interp == "nearest":
        # round half to even, as jnp.round does
        ix0 = torch.round(gx).clamp(0, wd - 1).long()
        iy0 = torch.round(gy).clamp(0, h - 1).long()
        return _gather2d(xf, iy0, ix0, wd), mask

    raise ValueError(f"unknown interpolation '{interp}'")


def flow_upsample_2x(flow: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
    """Upsample a flow field [..., H, W, 2] x2 spatially and scale the vectors
    by 2 (bilinear, align_corners=True, as torch F.interpolate); on a shard
    the sample's sizes give the taps (``rows``: the flow's)."""
    h, w = flow.shape[-3], flow.shape[-2]
    if rows is not None:
        out = rows.scale(2)
        return resize_bilinear(flow.float(), out.height, 2 * w, True, rows, out) * 2.0
    return resize_bilinear(flow.float(), 2 * h, 2 * w, align_corners=True) * 2.0
