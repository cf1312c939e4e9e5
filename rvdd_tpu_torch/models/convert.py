"""Weights across the two packages: rvdd_tpu's flax params (a nested dict of
numpy arrays, HWIO kernels) <-> the port's ``state_dict`` (OIHW), for
ConvUNet and ConvNeXtUNet.

The port names its parameters after the flax modules, so the mapping is one
to one: ``{"enc_conv0": {"conv0": {"kernel", "bias"}}}`` <->
``enc_conv0.conv0.weight`` / ``enc_conv0.conv0.bias``.  Kernels go HWIO ->
OIHW, the depthwise ``[7, 7, 1, 48]`` to ``[48, 1, 7, 7]`` included.
ConvNeXt also has 1-D leaves that copy through: ``ln/{weight,bias}`` and
``layerscale/layerscale``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

#: ConvNeXt's 1-D leaves besides biases (LayerNorm weight, LayerScale)
_CNX_LEAVES = ("weight", "layerscale")


def _from_flax(params: Mapping, leaves=()) -> Dict[str, torch.Tensor]:
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
            elif k == "bias" or (k in leaves and a.ndim == 1):
                sd[".".join(prefix + (k,))] = torch.from_numpy(a.copy())
            else:
                raise ValueError(f"unexpected flax leaf {'/'.join(prefix + (k,))}")

    walk(params, ())
    return sd


def _to_flax(state_dict: Mapping[str, torch.Tensor], leaves=()) -> dict:
    params: dict = {}
    for key, t in state_dict.items():
        *path, kind = key.split(".")
        a = t.detach().cpu().float().numpy()
        node = params
        for p in path:
            node = node.setdefault(p, {})
        if kind == "weight" and a.ndim == 4:
            node["kernel"] = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        elif kind == "bias" or (kind in leaves and a.ndim == 1):
            node[kind] = a.copy()
        else:
            raise ValueError(f"unexpected state_dict key {key}")
    return params


def convunet_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ConvUNet params -> the port's ConvUNet state_dict (fp32, CPU)."""
    return _from_flax(params)


def convunet_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`convunet_from_flax`: nested dict of numpy arrays."""
    return _to_flax(state_dict)


def convnext_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ConvNeXtUNet params -> the port's ConvNeXtUNet state_dict."""
    return _from_flax(params, _CNX_LEAVES)


def convnext_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`convnext_from_flax`."""
    return _to_flax(state_dict, _CNX_LEAVES)
