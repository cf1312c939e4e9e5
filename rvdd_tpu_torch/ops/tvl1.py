"""On-device TV-L1 optical flow, Zach-Pock-Bischof duality scheme (port of
rvdd_tpu/ops/tvl1.py).

It replaces the reference's offline CPU flow precompute, which "can take
minutes to hours", so a video can be denoised without flows computed
beforehand.  Numerics follow rvdd_tpu (and through it the C library
tvl1flow_lib.c): the same joint [0, 255] normalization, Gaussian
presmoothing, Catmull-Rom pyramid, stencils with the ``mask.c`` boundary
rules and duality iteration, float32 throughout.

Everything is plain PyTorch except the solver's warp, which on CUDA tensors
is the hand-written kernel ``ops/cuda/warp_bicubic.py:warp_catmull_zero``
(replacing rvdd_tpu's Pallas ``warp_bicubic_pallas(coeff_a=-0.5,
zero_outside=True)``).  Per warp stage it warps ``[i1 | i1x | i1y | 0]`` in
one launch; the flow components are kept stacked (``[2, H, W]``, duals
``[2, 2, H, W]``) so each elementwise op of the iteration is one launch for
both.  rvdd_tpu's ``lax.while_loop`` is a host loop here that reads the
convergence measure once an iteration: the iterations per stage are
rvdd_tpu's, up to a flip at the threshold from summation order, and
:func:`tvl1_flow` can record them.

    flow = tvl1_flow(i0, i1, FLOW_PRESETS["fast"])   # i1(x + flow) ~= i0(x)
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from rvdd_tpu_torch.ops.cuda.warp_bicubic import warp_catmull_zero


class TVL1Params(NamedTuple):
    """Solver parameters; defaults match libBridge.cpp:27-36."""

    tau: float = 0.25
    lambda_: float = 0.15
    theta: float = 0.3
    nscales: int = 100
    fscale: int = 0
    zfactor: float = 0.5
    nwarps: int = 5
    epsilon: float = 0.01
    max_iterations: int = 300


#: the solver presets: the C library's parameters, and the fast one of
#: rvdd_tpu's ``bench.py --fast_flow`` / ``flow_preset='fast'``
FLOW_PRESETS = {
    "default": TVL1Params(),
    "fast": TVL1Params(nwarps=2, max_iterations=75),
}


def resolve_params(params: Union[None, str, TVL1Params]) -> TVL1Params:
    """A preset name from FLOW_PRESETS, TVL1Params as is, None -> default."""
    if params is None:
        return FLOW_PRESETS["default"]
    if isinstance(params, str):
        if params not in FLOW_PRESETS:
            raise ValueError(f"unknown flow preset {params!r} (have {sorted(FLOW_PRESETS)})")
        return FLOW_PRESETS[params]
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., H, W] grayscale with the bridge's conventions.

    RGB uses the ITU-R 709 luma of skimage.rgb2gray (a weighted sum, not a
    matmul, which could run in TF32 on the card); packed raw uses the
    channel mean (reference: library.py:162-170).  A 2-D input is returned
    as is.
    """
    if img.dim() == 2:
        return img
    c = img.shape[-1]
    if c == 1:
        return img[..., 0]
    if c == 3:
        return img[..., 0] * 0.2125 + img[..., 1] * 0.7154 + img[..., 2] * 0.0721
    return img.mean(dim=-1)


def _gaussian_kernel(sigma: float) -> np.ndarray:
    """1-D half-kernel B[0..size-1], normalized like mask.c:234-246."""
    size = int(5.0 * sigma) + 1
    j = np.arange(size, dtype=np.float64)
    b = np.exp(-j * j / (2.0 * sigma * sigma)) / (sigma * math.sqrt(2.0 * math.pi))
    b /= 2.0 * b.sum() - b[0]
    return b


def _smooth_axis(x: torch.Tensor, b: np.ndarray, dim: int) -> torch.Tensor:
    """Separable Gaussian pass along one axis with the C boundary rule:
    'reflect' on the low side, 'symmetric' on the high side
    (mask.c:264-268).  The padding is rvdd_tpu's ``x[size-1:0:-1]`` and
    ``x[-1:-size:-1]``, written with flips (torch has no negative steps)."""
    size = len(b)
    x = x.movedim(dim, 0)
    n = x.shape[0]
    left = x[1:size].flip(0)
    right = x[max(n - size + 1, 0):].flip(0)
    xp = torch.cat([left, x, right], dim=0)
    out = float(b[0]) * x
    for j in range(1, size):
        lo = xp[size - 1 - j: size - 1 - j + n]
        hi = xp[size - 1 + j: size - 1 + j + n]
        out = out + float(b[j]) * (lo + hi)
    return out.movedim(0, dim)


def gaussian_smooth(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """2-D Gaussian smoothing of [..., H, W] (rows then columns), with
    shifted adds (a cuDNN convolution would run in TF32 on the card)."""
    b = _gaussian_kernel(sigma)
    img = _smooth_axis(img, b, -1)
    return _smooth_axis(img, b, -2)


def _catmull_taps(src: np.ndarray, in_size: int):
    """Catmull-Rom (A=-0.5) taps [4, n] (Neumann-clamped) and fp32 weights
    [4, n] at non-negative source coords (bicubic_interpolation.c:100-128,
    zoom.c:85-109)."""
    x = np.floor(src).astype(np.int64)
    t = src - x
    taps = np.stack([x - 1, x, x + 1, x + 2], 0).clip(0, in_size - 1)
    w0 = 0.5 * (-t + 2.0 * t**2 - t**3)
    w1 = 1.0 + 0.5 * (-5.0 * t**2 + 3.0 * t**3)
    w2 = 0.5 * (t + 4.0 * t**2 - 3.0 * t**3)
    w3 = 0.5 * (-(t**2) + t**3)
    return taps, np.stack([w0, w1, w2, w3], 0).astype(np.float32)


@functools.lru_cache(maxsize=128)
def _resize_table(in_size: int, out_size: int, device: torch.device):
    """Taps and weights of one axis at source coords i / (out / in), as
    rvdd_tpu's _catmull_axis_weights; built once per (in, out, device), so
    no frame pays a host-to-device copy."""
    src = np.arange(out_size, dtype=np.float64) / (out_size / in_size)
    taps, w = _catmull_taps(src, in_size)
    return torch.from_numpy(taps).to(device), torch.from_numpy(w).to(device)


@functools.lru_cache(maxsize=128)
def _zoom_table(in_size: int, out_size: int, step: float, device: torch.device):
    """As _resize_table at source coords i * step (_catmull_axis_weights_src)."""
    src = np.arange(out_size, dtype=np.float64) * step
    taps, w = _catmull_taps(src, in_size)
    return torch.from_numpy(taps).to(device), torch.from_numpy(w).to(device)


def _resample_axis(img: torch.Tensor, taps: torch.Tensor, wts: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """sum_k wts[k] * img[taps[k]] along ``dim`` (-2 or -1), summed in
    rvdd_tpu's order."""
    n = taps.shape[1]
    g = img.index_select(dim, taps.reshape(-1))
    shape = [1] * img.dim()
    shape[dim] = n
    out = None
    for k in range(4):
        term = wts[k].reshape(shape) * g.narrow(dim, k * n, n)
        out = term if out is None else out + term
    return out


def _catmull_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Separable Catmull-Rom resize of [..., H, W] (flow upsampling between
    pyramid levels)."""
    h, w = img.shape[-2], img.shape[-1]
    rows = _resample_axis(img, *_resize_table(h, out_h, img.device), dim=-2)
    return _resample_axis(rows, *_resize_table(w, out_w, img.device), dim=-1)


def _zoom_size(n: int, factor: float) -> int:
    return int(n * factor + 0.5)  # zoom.c:22-34


def _zoom_out(img: torch.Tensor, factor: float) -> torch.Tensor:
    """Gaussian presmooth + Catmull-Rom subsample of [..., H, W]
    (zoom.c:41-77)."""
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = _zoom_size(h, factor), _zoom_size(w, factor)
    sigma = 0.6 * math.sqrt(1.0 / (factor * factor) - 1.0)
    sm = gaussian_smooth(img, sigma)
    if abs(factor - 0.5) < 1e-12:
        # source coords are exactly 2*i -> plain stride-2 subsampling
        return sm[..., 0: 2 * oh: 2, 0: 2 * ow: 2]
    rows = _resample_axis(sm, *_zoom_table(h, oh, 1.0 / factor, img.device), dim=-2)
    return _resample_axis(rows, *_zoom_table(w, ow, 1.0 / factor, img.device), dim=-1)


# --- stencils with the exact boundary rules of mask.c, over [..., H, W] ----


def _centered_gradient(f: torch.Tensor):
    """mask.c:149-206: central differences, one-sided*0.5 at borders."""
    fp = F.pad(f[None], (1, 1, 1, 1), mode="replicate")[0]
    dx = 0.5 * (fp[..., 1:-1, 2:] - fp[..., 1:-1, :-2])
    dy = 0.5 * (fp[..., 2:, 1:-1] - fp[..., :-2, 1:-1])
    return dx, dy


def _forward_gradient(f: torch.Tensor):
    """mask.c:98-141: forward differences, zero at the last row/column."""
    fx = F.pad(f[..., :, 1:] - f[..., :, :-1], (0, 1))
    fy = F.pad(f[..., 1:, :] - f[..., :-1, :], (0, 0, 0, 1))
    return fx, fy


def _divergence(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """mask.c:40-89: adjoint of the forward gradient (backward differences
    with v at the first row/column and -v at the last).  Written as the
    difference of ``[0, v[0..n-2], 0]``, which gives rvdd_tpu's values
    exactly for every size >= 2."""
    q1 = F.pad(v1[..., :, :-1], (1, 1))
    q2 = F.pad(v2[..., :-1, :], (0, 0, 1, 1))
    return (q1[..., :, 1:] - q1[..., :, :-1]) + (q2[..., 1:, :] - q2[..., :-1, :])


# ---------------------------------------------------------------------------
# single-scale solver
# ---------------------------------------------------------------------------


def _tvl1_single_scale(i0: torch.Tensor, i1: torch.Tensor, u: torch.Tensor,
                       p: TVL1Params, warp: Callable,
                       iterations: Optional[list]) -> torch.Tensor:
    """One scale of the duality iteration (tvl1flow_lib.c:91-273).  u is
    [2, H, W] (u1, u2); returns the new u.  The duals carry across the
    ``nwarps`` warp stages of the scale and start at zero per scale.

    ``warp`` is bicubic_interpolation_warp(..., border_out=true): Catmull-Rom
    weights, 0 wherever a 4x4 tap would need clamping.  rvdd_tpu's gather
    form clips the coordinate before ``floor``, the kernel takes the
    unclipped fraction and clamps each tap: the two agree on every pixel
    that is kept, since each such pixel has all its taps inside."""
    l_t = p.lambda_ * p.theta
    taut = p.tau / p.theta
    grad_is_zero = 1e-10
    # rvdd_tpu compares its fp32 error with the fp32 rounding of eps^2
    thr = float(np.float32(p.epsilon * p.epsilon))
    size = np.float32(i0.numel())
    i1x, i1y = _centered_gradient(i1)
    stack = torch.stack([i1, i1x, i1y, torch.zeros_like(i1)], dim=-1)[None].contiguous()
    duals = torch.zeros((2, 2) + tuple(i0.shape), device=i0.device)  # [comp, (x, y)]
    # forward-gradient buffer: the last column of [:, 0] and the last row of
    # [:, 1] stay 0 (mask.c), the rest is rewritten every iteration
    fgrad = torch.zeros_like(duals)
    for _ in range(p.nwarps):
        warped = warp(stack, u.permute(1, 2, 0)[None].contiguous())[0]
        i1w, i1wx, i1wy = warped[..., 0], warped[..., 1], warped[..., 2]
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u[0] - i1wy * u[1] - i0
        gw = torch.stack([i1wx, i1wy])
        ltg = l_t * grad
        nltg = -ltg
        flat = grad < grad_is_zero
        ngmax = -torch.clamp_min(grad, grad_is_zero)

        n, err = 0, math.inf
        while err > thr and n < p.max_iterations:
            rho = torch.addcmul(rho_c, i1wx, u[0])
            rho.addcmul_(i1wy, u[1])
            # coefficient of (i1wx, i1wy) in the step: l_t, -l_t or -rho/grad
            c = torch.div(rho, ngmax).masked_fill_(flat, 0.0)
            c = torch.where(rho > ltg, -l_t, c)
            c = torch.where(rho < nltg, l_t, c)
            v = torch.addcmul(u, c, gw)
            un = torch.add(v, _divergence(duals[:, 0], duals[:, 1]), alpha=p.theta)
            du = un - u
            err = float(np.float32((du * du).sum().item()) / size)
            torch.sub(un[..., :, 1:], un[..., :, :-1], out=fgrad[:, 0, :, :-1])
            torch.sub(un[..., 1:, :], un[..., :-1, :], out=fgrad[:, 1, :-1, :])
            ng = torch.hypot(fgrad[:, 0], fgrad[:, 1]).mul_(taut).add_(1.0)
            duals = torch.add(duals, fgrad, alpha=taut).div_(ng[:, None])
            u = un
            n += 1
        if iterations is not None:
            iterations.append(n)
    return u


# ---------------------------------------------------------------------------
# multiscale solver
# ---------------------------------------------------------------------------


def _num_scales(nx: int, ny: int, p: TVL1Params) -> int:
    """Scale count so the coarsest level is >= 16px (libBridge.cpp:131-138)."""
    n = int(1 + math.log(math.hypot(nx, ny) / 16.0) / math.log(1.0 / p.zfactor))
    return max(1, min(p.nscales, n))


def tvl1_flow(i0: torch.Tensor, i1: torch.Tensor,
              params: Union[None, str, TVL1Params] = None, *,
              iterations: Optional[list] = None,
              _warp: Optional[Callable] = None) -> torch.Tensor:
    """Multiscale TV-L1 flow: finds u with i1(x + u) ~= i0(x).

    i0, i1: [H, W] grayscale on one device (any range; jointly normalized to
    [0, 255] like tvl1flow_lib.c:301-335, in device scalars).  params: a
    TVL1Params or a FLOW_PRESETS name (None: default).  If ``iterations`` is
    a list, the duality iterations of every warp stage are appended to it,
    coarsest scale first.  Returns flow [H, W, 2] with (u, v).

    The solver's warp is ``warp_catmull_zero``: the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors.  ``_warp`` replaces it, for
    the comparison of the kernel with its plain version only.
    """
    warp = warp_catmull_zero if _warp is None else _warp
    p = resolve_params(params)
    i0 = i0.float()
    i1 = i1.float()
    ny, nx = i0.shape
    nscales = _num_scales(nx, ny, p)

    # joint [0,255] normalization
    mx = torch.maximum(i0.max(), i1.max())
    mn = torch.minimum(i0.min(), i1.min())
    den = mx - mn
    scale = torch.where(den > 0, 255.0 / den, 1.0)
    off = torch.where(den > 0, mn, 0.0)
    i0 = (i0 - off) * scale
    i1 = (i1 - off) * scale

    i0 = gaussian_smooth(i0, 0.8)  # PRESMOOTHING_SIGMA
    i1 = gaussian_smooth(i1, 0.8)

    pyr0, pyr1 = [i0], [i1]
    for _ in range(1, nscales):
        pyr0.append(_zoom_out(pyr0[-1], p.zfactor))
        pyr1.append(_zoom_out(pyr1[-1], p.zfactor))

    u = torch.zeros((2,) + tuple(pyr0[-1].shape), device=i0.device)
    for s in range(nscales - 1, -1, -1):
        if s >= p.fscale:
            u = _tvl1_single_scale(pyr0[s], pyr1[s], u, p, warp, iterations)
        if s == 0:
            break
        oh, ow = pyr0[s - 1].shape
        u = _catmull_resize(u, oh, ow) * (1.0 / p.zfactor)
    return u.permute(1, 2, 0).contiguous()


def tvl1_flow_pair(src: torch.Tensor, ref: torch.Tensor,
                   params: Union[None, str, TVL1Params] = None, **kw) -> torch.Tensor:
    """Flow that warps ``src`` onto ``ref`` (both [H, W, C] or [H, W]).

    Mirrors compute_flow(img1, img2) in the reference
    (util/flow_utils.py:126-134): the returned flow, applied to ``src`` with
    :func:`rvdd_tpu_torch.ops.warp.warp`, aligns it with ``ref``.
    """
    return tvl1_flow(to_gray(ref), to_gray(src), params, **kw)
