"""Numerical precision policy (port of rvdd_tpu/precision.py).

PyTorch on the card may run fp32 matmuls and convolutions in TF32.  For
parity with fp32 weights, turn that off:

    from rvdd_tpu_torch.precision import use_exact_precision
    use_exact_precision()           # process-wide
    # or
    with exact_precision():         # scoped

The fused path's chains pick their numerics from their preset whatever this
says; it moves the module path's convs and the fused path's cuDNN
eighth-res core.
"""

from __future__ import annotations

import contextlib

import torch


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _set(matmul_tf32: bool, cudnn_tf32: bool, matmul_precision: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.set_float32_matmul_precision(matmul_precision)


def use_exact_precision() -> None:
    """fp32 matmuls and convolutions without TF32 (cuBLAS and cuDNN)."""
    _set(False, False, "highest")


def use_fast_precision() -> None:
    """TF32 allowed in cuBLAS and cuDNN."""
    _set(True, True, "high")


@contextlib.contextmanager
def exact_precision():
    saved = _flags()
    use_exact_precision()
    try:
        yield
    finally:
        _set(*saved)
