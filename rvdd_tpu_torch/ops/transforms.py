"""Value-range transforms between storage, network and display domains
(port of rvdd_tpu/ops/transforms.py).

The network domain is [-1, 1]; images on disk are 12-bit by default and
normalized by 2**bits - 1 on load.
"""

from __future__ import annotations

import torch


def normalize_bitdepth(img, bit_depth: int = 12) -> torch.Tensor:
    """Disk values -> [0, 1] (divide by 2**bit_depth - 1), float32."""
    return torch.as_tensor(img).float() / (2.0 ** float(bit_depth) - 1.0)


def to_net(x):
    """[0, 1] image -> network domain [-1, 1] (transform 'T')."""
    return 2.0 * x - 1.0


def from_net(x):
    """Network domain [-1, 1] -> [0, 1] image (transform 'iT')."""
    return (x + 1.0) / 2.0
