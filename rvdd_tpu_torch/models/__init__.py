"""Networks: ConvUNet (models/unet.py), the factory and the weight converter,
and the fused fast path (models/fast_unet.py)."""

from rvdd_tpu_torch.models.factory import build_network, parse_arch
from rvdd_tpu_torch.models.unet import ConvUNet

__all__ = ["ConvUNet", "build_network", "parse_arch"]
