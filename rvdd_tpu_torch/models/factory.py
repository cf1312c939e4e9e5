"""Network factory (port of rvdd_tpu/models/factory.py): build a model from
the CLI architecture string ``name-k1=v1-k2=v2``.

* ``convunet`` / ``convunet-mode=fixedfeatures`` / ``...+feat`` ->
  :class:`ConvUNet`;
* ``newunet`` / ``newunet-mode=feat`` -> :class:`ConvNeXtUNet`.

Weights follow ``--init_type`` (rvdd_tpu/models/factory.py:107-154), on
every conv kernel (the transposed-conv upsample's ``up_transposed{i}_kernel``
included), with zero biases:

* ``kaiming`` (the reference's default): normal, std sqrt(2 / fan_in),
  drawn from ``np.random.default_rng(seed)`` in parameter order (the draws
  of a seeded net are those of earlier versions);
* ``normal``: normal, std 0.02;
* ``xavier``: normal, std 0.02 * sqrt(2 / (fan_in + fan_out))
  (variance_scaling(0.02^2, 'fan_avg'));
* ``orthogonal``: the kernel as a (kh*kw*in, out) matrix with orthonormal
  columns (rows, when it is wide), times 0.02;
* ``flax``: flax's own defaults, lecun normal (normal truncated at two
  standard deviations, std sqrt(1 / fan_in)).

The four besides ``kaiming`` draw from a ``torch.Generator`` seeded with
``seed``.  Fans are those of rvdd_tpu's HWIO kernel (fan_in = kh*kw*in,
fan_out = kh*kw*out): an OIHW weight is drawn in its HWIO shape and
transposed, and ``up_transposed{i}_kernel`` is kept in HWIO by the port.
The other leaves take flax's initial values under every policy, as
rvdd_tpu's ``reinit_convs`` leaves them: ConvNeXt's LayerNorm weight 1 and
bias 0 and LayerScale its init (0.1), batch norm's scale 1 and offset 0.
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


INIT_TYPES = ("kaiming", "normal", "xavier", "orthogonal", "flax")
INIT_GAIN = 0.02  # rvdd_tpu's reinit_convs gain


def _hwio(name: str, p: torch.Tensor):
    """(rvdd_tpu's HWIO shape of a conv kernel, HWIO -> the port's layout):
    OIHW ``weight``s are transposed, ``*_kernel`` leaves are HWIO already."""
    if name.endswith("_kernel"):
        return tuple(p.shape), lambda a: a
    o, i, kh, kw = p.shape
    return (kh, kw, i, o), lambda a: a.permute(3, 2, 0, 1)


def _fans(shape) -> tuple:
    rf = shape[0] * shape[1]
    return rf * shape[2], rf * shape[3]


def _orthogonal(shape, gen: torch.Generator) -> torch.Tensor:
    """jax.nn.initializers.orthogonal (column axis -1) of an HWIO shape."""
    cols = shape[-1]
    rows = int(np.prod(shape)) // cols
    a = torch.randn((cols, rows) if rows < cols else (rows, cols), generator=gen,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return q.reshape(shape)


def _draw(init_type: str, shape, gen: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    if init_type == "normal":
        return torch.randn(shape, generator=gen) * INIT_GAIN
    if init_type == "xavier":
        return torch.randn(shape, generator=gen) * (INIT_GAIN * np.sqrt(2.0 / (fan_in + fan_out)))
    if init_type == "orthogonal":
        return (_orthogonal(shape, gen) * INIT_GAIN).float()
    # flax's lecun_normal: variance_scaling(1, 'fan_in', 'truncated_normal')
    w = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w * (np.sqrt(1.0 / fan_in) / 0.87962566103423978)


@torch.no_grad()
def init_weights_(net: nn.Module, init_type: str = "kaiming", seed: int = 0) -> nn.Module:
    """Redraw every conv kernel of ``net`` under ``init_type`` (INIT_TYPES)
    in parameter order, zero the biases and reset the other leaves to
    flax's initial values."""
    if init_type is None:
        init_type = "flax"
    if init_type not in INIT_TYPES:
        raise NotImplementedError(f"init_type {init_type}")
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    for name, p in net.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("bias") or leaf.endswith("_bn_offset"):
            p.zero_()
        elif leaf.endswith("_bn_scale") or (leaf == "weight" and p.dim() == 1):
            p.fill_(1.0)  # batch norm's scale, ConvNeXt's LayerNorm weight
        elif leaf == "layerscale":
            p.fill_(net.get_submodule(name.rsplit(".", 1)[0]).init)
        elif p.dim() == 4:
            shape, to_port = _hwio(leaf, p)
            if init_type == "kaiming":
                fan_in = _fans(shape)[0]
                w = rng.standard_normal(tuple(p.shape) if leaf == "weight" else shape)
                p.copy_(torch.from_numpy((w * np.sqrt(2.0 / fan_in)).astype(np.float32)))
            else:
                p.copy_(to_port(_draw(init_type, shape, gen)))
    return net


def build_network(arch: str, input_nc: int, output_nc: int,
                  feature_rec: bool = False, *, seed: int = 0,
                  device="cuda", init_type: str = "kaiming", **extra) -> nn.Module:
    """Instantiate the denoiser for an architecture string, with weights
    seeded under ``init_type`` (INIT_TYPES), on ``device`` (the card unless
    ``device="cpu"``).

    ``input_nc`` is the full stacked input channel count
    ((model_patch_depth + future_patch_depth) * per-frame channels)."""
    dev = resolve_device(device)
    name, kwargs = parse_arch(arch)
    mode = kwargs.pop("mode", None)
    if "newunet" in name:
        feat = mode == "feat" or feature_rec
        net = ConvNeXtUNet(input_nc, output_nc, feature_rec=feat, **kwargs, **extra)
        init_weights_(net, init_type, seed)
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
    init_weights_(net, init_type, seed)
    return net.to(dev).eval()
