"""Network factory (port of rvdd_tpu/models/factory.py): build a model from
the CLI architecture string ``name-k1=v1-k2=v2``.

* ``convunet`` / ``convunet-mode=fixedfeatures`` / ``...+feat`` ->
  :class:`ConvUNet`;
* ``newunet`` / ``newunet-mode=feat`` -> :class:`ConvNeXtUNet`.

Weights are the reference's default ``--init_type kaiming`` (fan_in,
normal, zero bias), drawn from a numpy seed so a run is reproducible on any
device.  Only 4-D conv weights are redrawn (a depthwise 7x7 has fan_in 49);
ConvNeXt's LayerNorm weight and bias and its LayerScale keep their defaults
(1, 0 and 0.1), as rvdd_tpu's ``reinit_convs`` leaves them.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.models.convnext_unet import ConvNeXtUNet
from rvdd_tpu_torch.models.unet import ConvUNet


def _convert_value(v: str):
    if v.isnumeric():
        return int(v)
    low = v.lower()
    if low == "none":
        return None
    if low in ("y", "yes", "t", "true", "on", "1"):
        return True
    if low in ("n", "no", "f", "false", "off", "0"):
        return False
    try:
        return float(v)
    except ValueError:
        return v


def parse_arch(arch: str) -> Tuple[str, Dict[str, Any]]:
    """'name-k1=v1-k2=v2' -> (name, kwargs)."""
    parts = arch.split("-")
    kwargs = {}
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"malformed arch argument '{p}' in '{arch}'")
        k, v = p.split("=", 1)
        kwargs[k] = _convert_value(v)
    return parts[0], kwargs


@torch.no_grad()
def kaiming_init_(net: nn.Module, seed: int = 0) -> nn.Module:
    """Kaiming fan_in normal conv weights, zero biases, drawn from
    ``np.random.default_rng(seed)`` in parameter order."""
    rng = np.random.default_rng(seed)
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            w = rng.standard_normal(tuple(p.shape)) * np.sqrt(2.0 / fan_in)
            p.copy_(torch.from_numpy(w.astype(np.float32)))
    return net


def build_network(arch: str, input_nc: int, output_nc: int,
                  feature_rec: bool = False, *, seed: int = 0,
                  device="cuda", **extra) -> nn.Module:
    """Instantiate the denoiser for an architecture string, with seeded
    kaiming weights, on ``device`` (the card unless ``device="cpu"``).

    ``input_nc`` is the full stacked input channel count
    ((model_patch_depth + future_patch_depth) * per-frame channels)."""
    dev = resolve_device(device)
    name, kwargs = parse_arch(arch)
    mode = kwargs.pop("mode", None)
    if "newunet" in name:
        feat = mode == "feat" or feature_rec
        net = ConvNeXtUNet(input_nc, output_nc, feature_rec=feat, **kwargs, **extra)
        kaiming_init_(net, seed)
        return net.to(dev).eval()
    if "convunet" not in name:
        raise NotImplementedError(f"unknown architecture '{arch}'")
    feat = feature_rec
    if mode in (None, "default", "concat"):
        fixed = False
    elif mode == "fixedfeatures":
        fixed = True
    elif mode == "fixedfeatures+feat":
        fixed, feat = True, True
    else:
        raise ValueError(f"unknown convunet mode '{mode}'")
    kwargs.setdefault("depth", 4)
    net = ConvUNet(input_nc, output_nc, fixed_features=fixed, feature_rec=feat,
                   **kwargs, **extra)
    kaiming_init_(net, seed)
    return net.to(dev).eval()
