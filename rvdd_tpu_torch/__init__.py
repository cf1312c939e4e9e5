"""rvdd_tpu_torch: the PyTorch and CUDA port of rvdd_tpu for NVIDIA Hopper.

Recurrent video denoising and demosaicing, written in PyTorch with the
hot kernels of its two streaming paths (the fused conv chain of convunet,
the fused ConvNeXt block chain of the flagship, and the bicubic warp)
hand-written in CUDA C++ for sm_90a (``csrc/``, built at first use by
``_build.py``).  Public functions keep rvdd_tpu's NHWC layout:
frames ``[B, T, H, W, C]``, flows ``[B, D+fD, H, W, 2]``, outputs
``[B, H, W, 3]``.

Entry points run on the card by default (``device="cuda"``) and raise when
there is none, unless the caller asks for ``device="cpu"``; on CPU tensors
every kernel wrapper runs its plain PyTorch version.
"""

from rvdd_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
