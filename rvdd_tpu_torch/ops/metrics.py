"""Quality metrics (port of rvdd_tpu/ops/metrics.py:psnr)."""

from __future__ import annotations

import torch


def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 2.0) -> torch.Tensor:
    """10*log10(max_val^2 / MSE) over all elements; max_val defaults to 2.0
    because the network domain is [-1, 1]."""
    mse = torch.mean((x.float() - y.float()) ** 2)
    return 10.0 * torch.log10(max_val * max_val / mse)
