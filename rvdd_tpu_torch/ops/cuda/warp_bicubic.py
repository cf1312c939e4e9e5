"""Bicubic flow warps: wrappers of csrc/warp_bicubic.cu, in two modes.

* :func:`warp_bicubic` replaces rvdd_tpu/ops/pallas/warp_rowmajor.py:
  warp_planar_pallas, the warp of the recurrence state (and of the future
  frame): exact semantics of ops/warp.py:warp(..., "bicubic"), a = -0.75,
  border-clamped taps.
* :func:`warp_catmull_zero` replaces rvdd_tpu/ops/pallas/warp_pallas.py:
  warp_bicubic_pallas as the TV-L1 solver calls it (coeff_a=-0.5,
  zero_outside=True): Catmull-Rom, and 0 wherever a 4x4 tap leaves the
  image (``gx < 1 or gx >= W-2 or gy < 1 or gy >= H-2``), fp32 in and out.
  rvdd_tpu's mask output is computed outside its Pallas kernel and no caller
  uses it, so the port has none.

What bounds both on the H100 is bytes (read the input and the flow once,
write the output once).  The kernel works on 8 x 32 output tiles: it
stages a tile's source window, all channels, in shared memory when the
window fits (:func:`window_pixels`), and otherwise gathers from global
memory (the direct path), so it is exact for any flow; :func:`tile_paths`
is that choice in plain PyTorch.  Neither mode has the TPU kernels'
+-max_disp flow clamp or residual bands (see the kernel's source note).
Each mode counts its own launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rvdd_tpu_torch import _build
from rvdd_tpu_torch.ops.warp import warp

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P, _P]
_DTYPES = (torch.float32, torch.bfloat16)

#: the kernel's output tile (rows, columns) and staged-window capacity in
#: bytes and pixels (TILE_H, TILE_W, WIN_BYTES and WIN_PIX in
#: csrc/warp_bicubic.cu)
TILE_H, TILE_W, WINDOW_BYTES, WINDOW_MAX_PIXELS = 8, 32, 104448, 768


def window_pixels(c: int, dtype=torch.float32) -> int:
    """The most pixels a tile's staged window may hold for C channels of
    ``dtype``: a pixel takes ceil(C / 4) vectors of 4 channels."""
    vec_bytes = 16 if dtype == torch.float32 else 8
    return min(WINDOW_MAX_PIXELS, WINDOW_BYTES // (-(-c // 4) * vec_bytes))


def warp_bicubic_plain(x: torch.Tensor, flow: torch.Tensor,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: ``ops.warp.warp(x, flow, "bicubic")[0]`` in fp32,
    cast to out_dtype."""
    return warp(x, flow, "bicubic")[0].to(out_dtype)


def warp_catmull_zero_plain(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The plain version of the solver mode: ``ops.warp.warp(x, flow,
    "bicubic", a=-0.5)[0]`` in fp32, 0 wherever a tap leaves the image."""
    _, h, w, _ = x.shape
    out = warp(x, flow, "bicubic", a=-0.5)[0]
    gx = torch.arange(w, device=x.device, dtype=torch.float32)[None, None, :] + flow[..., 0]
    gy = torch.arange(h, device=x.device, dtype=torch.float32)[None, :, None] + flow[..., 1]
    inside = (gx >= 1.0) & (gx < w - 2.0) & (gy >= 1.0) & (gy < h - 2.0)
    return torch.where(inside[..., None], out, 0.0)


def _per_tile(t: torch.Tensor, fill: int) -> torch.Tensor:
    """[B, H, W] -> [B, tiles_y, TILE_H, tiles_x, TILE_W], the ragged edge
    filled with ``fill``."""
    b, h, w = t.shape
    ty, tx = -(-h // TILE_H), -(-w // TILE_W)
    full = torch.full((b, ty * TILE_H, tx * TILE_W), fill, dtype=t.dtype, device=t.device)
    full[:, :h, :w] = t
    return full.reshape(b, ty, TILE_H, tx, TILE_W)


def tile_paths(flow: torch.Tensor, c: int, dtype=torch.float32,
               zero_outside: bool = False) -> torch.Tensor:
    """The kernel's path for each 8 x 32 output tile of a warp of C channels
    of ``dtype`` by flow [B, H, W, 2], in plain PyTorch: int64 ``[window,
    direct, all zeroed]`` tile counts.  A tile's footprint is the bounding
    box of the clamped 4x4 taps of its pixels that gather (in the solver
    mode, those the zero rule keeps); it takes the window path when the box
    holds at most ``window_pixels(c, dtype)`` pixels, and no path when no
    pixel gathers."""
    b, h, w, _ = flow.shape
    dev = flow.device
    flow = flow.float()
    gx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :] + flow[..., 0]
    gy = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] + flow[..., 1]
    live = torch.ones_like(gx, dtype=torch.bool)
    if zero_outside:
        live = (gx >= 1.0) & (gx < w - 2.0) & (gy >= 1.0) & (gy < h - 2.0)
    tx = torch.floor(gx).clamp(-3.0, w + 1.0).long() - 1
    ty = torch.floor(gy).clamp(-3.0, h + 1.0).long() - 1
    big = 1 << 40
    box = []
    for t, size, lo in ((tx, w, True), (tx + 3, w, False), (ty, h, True), (ty + 3, h, False)):
        fill = big if lo else -big
        t = torch.where(live, t.clamp(0, size - 1), fill)
        t = _per_tile(t, fill)
        box.append(t.amin(dim=(2, 4)) if lo else t.amax(dim=(2, 4)))
    x0, x1, y0, y1 = box
    empty = x0 > x1
    fits = (x1 - x0 + 1) * (y1 - y0 + 1) <= window_pixels(c, dtype)
    window = int((~empty & fits).sum())
    direct = int((~empty & ~fits).sum())
    return torch.tensor([window, direct, int(empty.sum())], dtype=torch.int64)


def _check(what: str, x: torch.Tensor, flow: torch.Tensor, out_dtype,
           tile_counts: Optional[torch.Tensor]) -> None:
    if not (x.is_cuda and flow.is_cuda and x.device == flow.device):
        raise ValueError(f"{what}: x and flow must be on the same CUDA device")
    if x.dtype not in _DTYPES or flow.dtype != torch.float32 or out_dtype not in _DTYPES:
        raise TypeError(
            f"{what}: x must be float32/bfloat16 (got {x.dtype}), flow float32 "
            f"(got {flow.dtype}), out_dtype float32/bfloat16 (got {out_dtype})")
    if x.dim() != 4 or tuple(flow.shape) != (*x.shape[:3], 2):
        raise ValueError(f"{what}: want x [B,H,W,C] and flow [B,H,W,2], got "
                         f"{tuple(x.shape)} and {tuple(flow.shape)}")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty input")
    b, h, w, c = x.shape
    if h * w * max(c, 2) >= 2**31 or b >= 65536 or -(-h // TILE_H) >= 65536:
        raise ValueError(f"{what}: {tuple(x.shape)} is too large (an image's H*W*max(C, 2) "
                         "must stay below 2^31, B and H / 8 below 65536)")
    if not (x.is_contiguous() and flow.is_contiguous()):
        raise ValueError(f"{what}: x and flow must be contiguous")
    if x.data_ptr() % 16 or flow.data_ptr() % 16:
        raise ValueError(f"{what}: x and flow must be 16-byte aligned")
    if tile_counts is not None and not (
            tile_counts.device == x.device and tile_counts.dtype == torch.int32
            and tile_counts.numel() == 3 and tile_counts.is_contiguous()):
        raise ValueError(f"{what}: tile_counts must be a contiguous int32 tensor of 3 "
                         "elements on x's device")


def _launch(what: str, x: torch.Tensor, flow: torch.Tensor, out_dtype, a: float,
            zero_outside: bool, tile_counts: Optional[torch.Tensor]):
    """Check, allocate and launch; returns (lib, rc, out) so the caller
    counts the launch before it raises on rc."""
    _check(what, x, flow, out_dtype, tile_counts)
    lib = _build.load_library("warp_bicubic")
    fn = lib.rvdd_warp_bicubic_tiles
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    b, h, w, c = x.shape
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), flow.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), b, h, w, c,
            a, int(zero_outside), None if tile_counts is None else tile_counts.data_ptr(),
            stream)
    return lib, rc, out


def warp_bicubic(x: torch.Tensor, flow: torch.Tensor, out_dtype=torch.bfloat16,
                 tile_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp x [B, H, W, C] (float32 or bfloat16) by flow [B, H, W, 2]
    (float32); returns [B, H, W, C] in out_dtype.

    CUDA tensors launch the kernel (counted in ``warp_bicubic.launches``);
    CPU tensors run :func:`warp_bicubic_plain`.  ``tile_counts``, an int32
    tensor of 3 on x's device, gets the tiles of each path added
    (``[window, direct, all zeroed]``; on the CPU from :func:`tile_paths`)."""
    if x.device.type == "cpu" and flow.device.type == "cpu":
        if tile_counts is not None:
            tile_counts += tile_paths(flow, x.shape[-1], x.dtype).to(tile_counts.dtype)
        return warp_bicubic_plain(x, flow, out_dtype)
    lib, rc, out = _launch("warp_bicubic", x, flow, out_dtype, -0.75, False, tile_counts)
    warp_bicubic.launches += 1
    _build.check(lib, rc, "warp_bicubic")
    return out


def warp_catmull_zero(x: torch.Tensor, flow: torch.Tensor,
                      tile_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The TV-L1 solver's warp: x [B, H, W, C] float32 sampled at
    (col + u, row + v) with Catmull-Rom weights, 0 wherever a 4x4 tap leaves
    the image; returns [B, H, W, C] float32.

    CUDA tensors launch the kernel in its solver mode (counted in
    ``warp_catmull_zero.launches``); CPU tensors run
    :func:`warp_catmull_zero_plain`.  ``tile_counts`` as in
    :func:`warp_bicubic`."""
    if x.device.type == "cpu" and flow.device.type == "cpu":
        if tile_counts is not None:
            tile_counts += tile_paths(flow, x.shape[-1], zero_outside=True).to(
                tile_counts.dtype)
        return warp_catmull_zero_plain(x, flow)
    if x.dtype != torch.float32:
        raise TypeError(f"warp_catmull_zero: x must be float32 (got {x.dtype})")
    lib, rc, out = _launch("warp_catmull_zero", x, flow, torch.float32, -0.5, True, tile_counts)
    warp_catmull_zero.launches += 1
    _build.check(lib, rc, "warp_catmull_zero")
    return out


warp_bicubic.launches = 0
warp_catmull_zero.launches = 0
