"""Bicubic warp of the recurrence state: wrapper of csrc/warp_bicubic.cu.

Replaces rvdd_tpu/ops/pallas/warp_rowmajor.py:warp_planar_pallas.  What
bounds it on the H100 is bytes (read the state once, write the warped copy
once); the kernel gives each thread one pixel's 4-channel vector so the 16
taps are contiguous 16-byte loads that neighbouring pixels share in L1/L2.
Exact semantics of ops/warp.py:warp(..., "bicubic"), with no +-48 px flow
clamp and no residual bands (see the kernel's source note).
"""

from __future__ import annotations

import ctypes

import torch

from rvdd_tpu_torch import _build
from rvdd_tpu_torch.ops.warp import warp

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
_DTYPES = (torch.float32, torch.bfloat16)


def warp_bicubic_plain(x: torch.Tensor, flow: torch.Tensor,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version: ``ops.warp.warp(x, flow, "bicubic")[0]`` in fp32,
    cast to out_dtype."""
    return warp(x, flow, "bicubic")[0].to(out_dtype)


def _check(x: torch.Tensor, flow: torch.Tensor, out_dtype) -> None:
    if not (x.is_cuda and flow.is_cuda and x.device == flow.device):
        raise ValueError("warp_bicubic: x and flow must be on the same CUDA device")
    if x.dtype not in _DTYPES or flow.dtype != torch.float32 or out_dtype not in _DTYPES:
        raise TypeError(
            f"warp_bicubic: x must be float32/bfloat16 (got {x.dtype}), flow float32 "
            f"(got {flow.dtype}), out_dtype float32/bfloat16 (got {out_dtype})")
    if x.dim() != 4 or tuple(flow.shape) != (*x.shape[:3], 2):
        raise ValueError(f"warp_bicubic: want x [B,H,W,C] and flow [B,H,W,2], got "
                         f"{tuple(x.shape)} and {tuple(flow.shape)}")
    if x.numel() == 0:
        raise ValueError("warp_bicubic: empty input")
    if not (x.is_contiguous() and flow.is_contiguous()):
        raise ValueError("warp_bicubic: x and flow must be contiguous")
    if x.data_ptr() % 16 or flow.data_ptr() % 16:
        raise ValueError("warp_bicubic: x and flow must be 16-byte aligned")


def warp_bicubic(x: torch.Tensor, flow: torch.Tensor,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Warp x [B, H, W, C] (float32 or bfloat16) by flow [B, H, W, 2]
    (float32); returns [B, H, W, C] in out_dtype.

    CUDA tensors launch the kernel (counted in ``warp_bicubic.launches``);
    CPU tensors run :func:`warp_bicubic_plain`."""
    if x.device.type == "cpu" and flow.device.type == "cpu":
        return warp_bicubic_plain(x, flow, out_dtype)
    _check(x, flow, out_dtype)
    lib = _build.load_library("warp_bicubic")
    fn = lib.rvdd_warp_bicubic
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    b, h, w, c = x.shape
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), flow.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), b, h, w, c,
            -0.75, stream)
    warp_bicubic.launches += 1
    _build.check(lib, rc, "warp_bicubic")
    return out


warp_bicubic.launches = 0
