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
write the output once); the kernel gives each thread one pixel's 4-channel
vector so the 16 taps are contiguous 16-byte loads that neighbouring pixels
share in L1/L2.  Neither has the TPU kernels' +-max_disp flow clamp or
residual bands (see the kernel's source note).  Each mode counts its own
launches.
"""

from __future__ import annotations

import ctypes

import torch

from rvdd_tpu_torch import _build
from rvdd_tpu_torch.ops.warp import warp

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_DTYPES = (torch.float32, torch.bfloat16)


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


def _check(what: str, x: torch.Tensor, flow: torch.Tensor, out_dtype) -> None:
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
    if not (x.is_contiguous() and flow.is_contiguous()):
        raise ValueError(f"{what}: x and flow must be contiguous")
    if x.data_ptr() % 16 or flow.data_ptr() % 16:
        raise ValueError(f"{what}: x and flow must be 16-byte aligned")


def _launch(what: str, x: torch.Tensor, flow: torch.Tensor, out_dtype, a: float,
            zero_outside: bool):
    """Check, allocate and launch; returns (lib, rc, out) so the caller
    counts the launch before it raises on rc."""
    _check(what, x, flow, out_dtype)
    lib = _build.load_library("warp_bicubic")
    fn = lib.rvdd_warp_bicubic
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    b, h, w, c = x.shape
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), flow.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), b, h, w, c,
            a, int(zero_outside), stream)
    return lib, rc, out


def warp_bicubic(x: torch.Tensor, flow: torch.Tensor,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Warp x [B, H, W, C] (float32 or bfloat16) by flow [B, H, W, 2]
    (float32); returns [B, H, W, C] in out_dtype.

    CUDA tensors launch the kernel (counted in ``warp_bicubic.launches``);
    CPU tensors run :func:`warp_bicubic_plain`."""
    if x.device.type == "cpu" and flow.device.type == "cpu":
        return warp_bicubic_plain(x, flow, out_dtype)
    lib, rc, out = _launch("warp_bicubic", x, flow, out_dtype, -0.75, False)
    warp_bicubic.launches += 1
    _build.check(lib, rc, "warp_bicubic")
    return out


def warp_catmull_zero(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The TV-L1 solver's warp: x [B, H, W, C] float32 sampled at
    (col + u, row + v) with Catmull-Rom weights, 0 wherever a 4x4 tap leaves
    the image; returns [B, H, W, C] float32.

    CUDA tensors launch the kernel in its solver mode (counted in
    ``warp_catmull_zero.launches``); CPU tensors run
    :func:`warp_catmull_zero_plain`."""
    if x.device.type == "cpu" and flow.device.type == "cpu":
        return warp_catmull_zero_plain(x, flow)
    if x.dtype != torch.float32:
        raise TypeError(f"warp_catmull_zero: x must be float32 (got {x.dtype})")
    lib, rc, out = _launch("warp_catmull_zero", x, flow, torch.float32, -0.5, True)
    warp_catmull_zero.launches += 1
    _build.check(lib, rc, "warp_catmull_zero")
    return out


warp_bicubic.launches = 0
warp_catmull_zero.launches = 0
