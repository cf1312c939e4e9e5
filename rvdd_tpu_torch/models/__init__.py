"""Networks: ConvUNet (models/unet.py) and ConvNeXtUNet
(models/convnext_unet.py), the factory and the weight converter, and their
fused fast paths (models/fast_unet.py, models/fast_convnext.py)."""

from rvdd_tpu_torch.models.convnext_unet import ConvNeXtUNet
from rvdd_tpu_torch.models.factory import build_network, parse_arch
from rvdd_tpu_torch.models.unet import ConvUNet

__all__ = ["ConvNeXtUNet", "ConvUNet", "build_network", "parse_arch"]
