"""Spatial resampling with torch-parity semantics, NHWC (port of
rvdd_tpu/ops/resize.py): bilinear resize with align_corners True or False,
the 2x align_corners=False upsample of the convunet decoder, the 2x nearest
upsample, and the 2x2 max and average pools with floor semantics.

On a shard of the mesh's space axis (``rows``, parallel/space.py) the
bilinear resizes read the rows their taps reach across the cut: the
sample's sizes give the taps, and the rows beyond the sample are its
replicated edge, as the single-process clamp.  The nearest upsample and the
pools are local (the row cut keeps every pool inside a shard).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rvdd_tpu_torch.parallel import space
from rvdd_tpu_torch.parallel.space import Rows


def _axis_indices(in_size: int, out_size: int, align_corners: bool):
    """Source taps (i0, i1) and lerp weight t for one axis (numpy, static)."""
    if out_size == 1:
        src = np.zeros((1,), np.float64)
    elif align_corners:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
        src = np.maximum(src, 0.0)  # torch clamps negative source indices
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    t = (src - i0).astype(np.float32)
    return i0, i1, t


def _up2x_nac_axis(x: torch.Tensor, dim: int, rows: Optional[Rows] = None) -> torch.Tensor:
    """x2 bilinear upsample along one axis, align_corners=False:
    out[2k] = 0.25 x[k-1] + 0.75 x[k], out[2k+1] = 0.75 x[k] + 0.25 x[k+1],
    edges clamped; on a shard, x[k-1] and x[k+1] across the cut."""
    if rows is not None:
        xe = space.halo(x, rows, 1, 1, "edge", dim).movedim(dim, 0)
        x, prev, nxt = xe[1:-1], xe[:-2], xe[2:]
    else:
        x = x.movedim(dim, 0)
        prev = torch.cat([x[:1], x[:-1]], dim=0)
        nxt = torch.cat([x[1:], x[-1:]], dim=0)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    out = torch.stack([even, odd], dim=1).reshape((2 * x.shape[0],) + x.shape[1:])
    return out.movedim(0, dim)


def _lerp(a: torch.Tensor, dim: int, in_size: int, out_size: int, align_corners: bool):
    i0, i1, t = _axis_indices(in_size, out_size, align_corners)
    i0 = torch.as_tensor(i0, device=a.device)
    i1 = torch.as_tensor(i1, device=a.device)
    shape = [1] * a.ndim
    shape[dim] = out_size
    tt = torch.as_tensor(t, device=a.device, dtype=a.dtype).reshape(shape)
    return a.index_select(dim, i0) * (1.0 - tt) + a.index_select(dim, i1) * tt


def _lerp_rows(x: torch.Tensor, rows: Rows, out_rows: Rows, align_corners: bool):
    """The H axis of a bilinear resize on a shard: the sample's taps for
    this shard's output rows ``out_rows``, read from the rows they reach."""
    dim = x.ndim - 3
    i0, i1, t = _axis_indices(rows.height, out_rows.height, align_corners)
    want = [(int(i0[a:b].min()), int(i1[a:b].max()) + 1) for a, b in out_rows.bounds]
    lo = want[out_rows.index][0]
    xw = space.window(x, rows, want, "edge", dim)
    sl = slice(out_rows.start, out_rows.stop)
    shape = [1] * x.ndim
    shape[dim] = out_rows.n
    tt = torch.as_tensor(t[sl], device=x.device, dtype=x.dtype).reshape(shape)
    i0 = torch.as_tensor(i0[sl] - lo, device=x.device)
    i1 = torch.as_tensor(i1[sl] - lo, device=x.device)
    return xw.index_select(dim, i0) * (1.0 - tt) + xw.index_select(dim, i1) * tt


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False, rows: Optional[Rows] = None,
                    out_rows: Optional[Rows] = None) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] to [..., out_h, out_w, C].  On a
    shard, ``rows`` are x's and ``out_rows`` the output's (``out_h`` is
    then the sample's, ``out_rows.height``)."""
    w = x.shape[-2]
    if rows is not None:
        if out_rows.height != out_h:
            raise ValueError(f"out_h {out_h}, the output rows' height {out_rows.height}")
        if not align_corners and out_h == 2 * rows.height and out_w == 2 * w:
            return _up2x_nac_axis(_up2x_nac_axis(x, x.ndim - 3, rows), x.ndim - 2)
        x = _lerp_rows(x, rows, out_rows, align_corners)
        return _lerp(x, x.ndim - 2, w, out_w, align_corners) if out_w != w else x
    h = x.shape[-3]
    if (h, w) == (out_h, out_w):
        return x
    if not align_corners and out_h == 2 * h and out_w == 2 * w:
        return _up2x_nac_axis(_up2x_nac_axis(x, x.ndim - 3), x.ndim - 2)
    x = _lerp(x, x.ndim - 3, h, out_h, align_corners)
    return _lerp(x, x.ndim - 2, w, out_w, align_corners)


def upsample2x_bilinear(x: torch.Tensor, align_corners: bool = False,
                        rows: Optional[Rows] = None) -> torch.Tensor:
    """x2 bilinear upsample; on a shard (``rows``), the output's rows are
    ``rows.scale(2)``."""
    h, w = x.shape[-3], x.shape[-2]
    if rows is not None:
        out = rows.scale(2)
        return resize_bilinear(x, out.height, 2 * w, align_corners, rows, out)
    return resize_bilinear(x, 2 * h, 2 * w, align_corners)


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool with floor semantics (torch nn.MaxPool2d(2))."""
    *lead, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[..., : 2 * h2, : 2 * w2, :].reshape(*lead, h2, 2, w2, 2, c)
    return x.amax(dim=(-4, -2))


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample of [..., H, W, C] (torch nn.Upsample(mode='nearest'))."""
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)


def avgpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pool with floor semantics: the mean over W of
    each pair, then over H, as rvdd_tpu sums them."""
    *lead, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[..., : 2 * h2, : 2 * w2, :].reshape(*lead, h2, 2, w2, 2, c)
    return x.mean(dim=-2).mean(dim=-3)
