"""Hamilton-Adams demosaic: wrapper of csrc/demosaic.cu.

Replaces no TPU kernel (rvdd_tpu demosaics in XLA).  The plain version is
``ops/demosaic.py:hamilton_adams``, whose shifts and elementwise ops cost
about 480 launches a frame; the kernel computes the same function, op for
op in fp32 and bitwise equal on the card, for every frame of a window in
one launch.  ``ops.demosaic.hamilton_adams`` calls it for CUDA raw when no
gradient is wanted and runs the plain version otherwise.

What bounds it on the H100 is bytes: a 1080p frame reads 8.3 MB of packed
raw and writes 24.9 MB of RGB (0.0099 ms at 3.35 TB/s).
"""

from __future__ import annotations

import ctypes

import torch

from rvdd_tpu_torch import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, ctypes.c_longlong, _P, _I, _I, _I, _P]


def hamilton_adams_cuda(raw4: torch.Tensor) -> torch.Tensor:
    """Demosaic packed GBRG raw [..., h, w, 4] (float32, on a CUDA device)
    -> linear RGB [..., 2h, 2w, 3] float32, one launch for all leading
    dims (counted in ``hamilton_adams_cuda.launches``).  Frames whose
    leading dims do not flatten to one stride are copied first."""
    *lead, h, w, c = raw4.shape
    if c != 4:
        raise ValueError(f"packed raw must have 4 channels, got {c}")
    if not raw4.is_cuda:
        raise ValueError("hamilton_adams_cuda: raw4 must be on a CUDA device")
    if raw4.dtype != torch.float32:
        raise TypeError(f"hamilton_adams_cuda: raw4 must be float32, got {raw4.dtype}")
    out = torch.empty((*lead, 2 * h, 2 * w, 3), dtype=torch.float32, device=raw4.device)
    if out.numel() == 0:
        return out
    x = raw4.reshape(-1, h, w, 4)
    if x.stride()[1:] != (4 * w, 4, 1):
        x = x.contiguous()
    n = x.shape[0]
    if n >= 65536 or -(-2 * h // 32) >= 65536 or 12 * h * w >= 2**31:
        raise ValueError(f"hamilton_adams_cuda: {tuple(raw4.shape)} is too large (want fewer "
                         "than 65536 frames and 2h * 2w * 3 below 2^31)")
    lib = _build.load_library("demosaic")
    fn = lib.rvdd_hamilton_adams
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(raw4.device):
        stream = torch.cuda.current_stream(raw4.device).cuda_stream
        rc = fn(x.data_ptr(), x.stride(0), out.data_ptr(), n, h, w, stream)
    hamilton_adams_cuda.launches += 1
    _build.check(lib, rc, "hamilton_adams_cuda")
    return out


hamilton_adams_cuda.launches = 0
