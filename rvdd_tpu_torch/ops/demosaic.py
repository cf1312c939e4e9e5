"""Hamilton-Adams demosaicing of packed GBRG raw, in plain PyTorch (port of
rvdd_tpu/ops/demosaic.py:hamilton_adams).

Each stencil tap is an edge-replicated shift of the full-res mosaic, with
the same formulas and tie rules as the reference fixed-weight convolutions
(reference: util/Hamilton_Adam_demo.py).  rvdd_tpu also has a planar,
phase-resolved variant; that is a TPU layout and is not ported.

On a shard of the mesh's space axis (``rows``, parallel/space.py) the
shard demosaics its rows with up to two packed rows of its neighbours
above and below (the stencils reach three mosaic rows; the sample's edge
replicates as before) and keeps its own.

CUDA raw for which no gradient is wanted goes to the hand-written kernel
(ops/cuda/demosaic.py), which computes the same function, bitwise, in one
launch, and takes float32 alone (other dtypes raise TypeError there).  The
CPU, and CUDA raw that requires grad under autograd (the kernel has no
backward), run the plain version here.
"""

from __future__ import annotations

from typing import Optional

import torch

from rvdd_tpu_torch.ops.bayer import bayer_masks, green_row_masks, pack_cfa
from rvdd_tpu_torch.ops.cuda.demosaic import hamilton_adams_cuda
from rvdd_tpu_torch.parallel import space
from rvdd_tpu_torch.parallel.space import Rows

#: packed raw rows a shard reads beyond its own on each side (4 mosaic
#: rows; the green stencil reaches 2, the chroma one 1 more)
HALO = 2


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x sampled at (y+dy, x+dx) over the last two axes, edge replication."""
    if dy == 0 and dx == 0:
        return x
    h, w = x.shape[-2], x.shape[-1]
    if dy:
        iy = (torch.arange(h, device=x.device) + dy).clamp(0, h - 1)
        x = x.index_select(-2, iy)
    if dx:
        ix = (torch.arange(w, device=x.device) + dx).clamp(0, w - 1)
        x = x.index_select(-1, ix)
    return x


def _interp_green(cfa: torch.Tensor, mask_g: torch.Tensor) -> torch.Tensor:
    """Gradient-adaptive green interpolation (HA 'algorithm 1')."""
    kh = 0.5 * (_shift(cfa, 0, -1) + _shift(cfa, 0, 1))
    kv = 0.5 * (_shift(cfa, -1, 0) + _shift(cfa, 1, 0))
    dh = _shift(cfa, 0, -2) - 2.0 * cfa + _shift(cfa, 0, 2)
    dv = _shift(cfa, -2, 0) - 2.0 * cfa + _shift(cfa, 2, 0)
    diffh = _shift(cfa, 0, -1) - _shift(cfa, 0, 1)
    diffv = _shift(cfa, -1, 0) - _shift(cfa, 1, 0)

    rawh = kh - dh / 4.0
    rawv = kv - dv / 4.0
    clh = diffh.abs() + dh.abs()
    clv = diffv.abs() + dv.abs()
    # CLh > CLv -> vertical, CLh < CLv -> horizontal, tie -> average
    s = torch.sign(clh - clv)
    green = (1.0 + s) * rawv / 2.0 + (1.0 - s) * rawh / 2.0
    return green * (1.0 - mask_g) + cfa * mask_g


def _interp_chroma(green, chan, mask_ochan, mask_row, mask_col):
    """R or B channel interpolation (HA 'algorithm 2')."""
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

    ch = mask_row * (kh - dh_g)
    cv = mask_col * (kv - dv_g)
    cp = mask_ochan * (kp - dp_g / 4.0)
    cn = mask_ochan * (kn - dn_g / 4.0)
    clp = mask_ochan * (diffp.abs() + dp_g.abs())
    cln = mask_ochan * (diffn.abs() + dn_g.abs())

    s = torch.sign(clp - cln)
    diag = (1.0 + s) * cn / 2.0 + (1.0 - s) * cp / 2.0
    return diag + ch + cv + chan


def hamilton_adams(raw4: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
    """Demosaic packed GBRG raw [..., H, W, 4] -> linear RGB [..., 2H, 2W, 3];
    on a shard, ``rows`` are raw4's.  CUDA inputs that take the plain
    version (those that require grad) are counted in
    ``hamilton_adams.plain_cuda_calls``."""
    if rows is not None:
        h = rows.height
        want = [(max(a - HALO, 0), min(b + HALO, h)) for a, b in rows.bounds]
        lo = rows.start - want[rows.index][0]
        rgb = hamilton_adams(space.window(raw4, rows, want, "zero", raw4.ndim - 3))
        return rgb[..., 2 * lo:2 * (lo + rows.n), :, :]
    if kernel_takes(raw4):
        return hamilton_adams_cuda(raw4)
    if raw4.is_cuda:
        hamilton_adams.plain_cuda_calls += 1
    return hamilton_adams_plain(raw4)


def kernel_takes(raw4: torch.Tensor) -> bool:
    """Whether :func:`hamilton_adams` sends raw4 to the CUDA kernel: on a
    CUDA device, and no gradient wanted."""
    return raw4.is_cuda and not (torch.is_grad_enabled() and raw4.requires_grad)


def hamilton_adams_plain(raw4: torch.Tensor) -> torch.Tensor:
    """The plain version: [..., H, W, 4] -> [..., 2H, 2W, 3] on any device
    and dtype, differentiable."""
    cfa = pack_cfa(raw4)
    hh, ww = cfa.shape[-2], cfa.shape[-1]
    mask_r, mask_g, mask_b = bayer_masks(hh, ww, cfa.dtype, cfa.device)
    mask_gr, mask_gb = green_row_masks(hh, ww, cfa.dtype, cfa.device)

    green = _interp_green(cfa, mask_g)
    red = _interp_chroma(green, cfa * mask_r, mask_b, mask_gr, mask_gb)
    blue = _interp_chroma(green, cfa * mask_b, mask_r, mask_gb, mask_gr)
    return torch.stack([red, green, blue], dim=-1)


hamilton_adams.plain_cuda_calls = 0
