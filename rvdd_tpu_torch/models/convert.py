"""Weights across the two packages: rvdd_tpu's flax ConvUNet params (a
nested dict of numpy arrays, HWIO kernels) <-> the port's ConvUNet
``state_dict`` (OIHW).

The port names its parameters after the flax modules, so the mapping is one
to one: ``{"enc_conv0": {"conv0": {"kernel", "bias"}}}`` <->
``enc_conv0.conv0.weight`` / ``enc_conv0.conv0.bias``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def convunet_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ConvUNet params -> the port's ConvUNet state_dict (fp32, CPU)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (k,))
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                sd[".".join(prefix + ("weight",))] = torch.from_numpy(
                    np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
            elif k == "bias":
                sd[".".join(prefix + ("bias",))] = torch.from_numpy(a.copy())
            else:
                raise ValueError(f"unexpected flax leaf {'/'.join(prefix + (k,))}")

    walk(params, ())
    return sd


def convunet_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`convunet_from_flax`: nested dict of numpy arrays."""
    params: dict = {}
    for key, t in state_dict.items():
        *path, kind = key.split(".")
        a = t.detach().cpu().float().numpy()
        node = params
        for p in path:
            node = node.setdefault(p, {})
        if kind == "weight":
            node["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif kind == "bias":
            node["bias"] = a.copy()
        else:
            raise ValueError(f"unexpected state_dict key {key}")
    return params
