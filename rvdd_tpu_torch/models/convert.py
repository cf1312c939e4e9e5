"""Weights across the two packages: rvdd_tpu's flax params (a nested dict of
numpy arrays, HWIO kernels) <-> the port's ``state_dict`` (OIHW), for
ConvUNet and ConvNeXtUNet; and the reference's released PyTorch state dicts
(``trained-nets/*.pth``, the reference's module names) -> the port's
``state_dict`` (port of rvdd_tpu/models/convert.py:30-197).

The port names its parameters after the flax modules, so the mapping is one
to one: ``{"enc_conv0": {"conv0": {"kernel", "bias"}}}`` <->
``enc_conv0.conv0.weight`` / ``enc_conv0.conv0.bias``.  Kernels go HWIO ->
OIHW, the depthwise ``[7, 7, 1, 48]`` to ``[48, 1, 7, 7]`` included.
ConvNeXt also has 1-D leaves that copy through: ``ln/{weight,bias}`` and
``layerscale/layerscale`` (``fuse_scale{i}/layerscale`` under
``fusion_mode='sum'``).  ConvUNet's ablation leaves copy through as they
are: the parameters a module declares itself, ``{conv}_bn_scale`` and
``{conv}_bn_offset`` (1-D), and ``up_transposed{i}_kernel`` (4-D, kept in
flax's HWIO layout by the port) and ``up_transposed{i}_bias``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

#: ConvNeXt's 1-D leaves besides biases (LayerNorm weight, LayerScale)
_CNX_LEAVES = ("weight", "layerscale")
#: 1-D leaves a module declares itself (ConvUNet's ablations)
_OWN_1D = ("_bias", "_bn_scale", "_bn_offset")


def _copies_through(name: str, ndim: int, leaves) -> bool:
    """A leaf both packages hold in one layout under one name."""
    if ndim == 1:
        return name == "bias" or name in leaves or name.endswith(_OWN_1D)
    return ndim == 4 and name.endswith("_kernel")


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
            elif _copies_through(k, a.ndim, leaves):
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
        elif _copies_through(kind, a.ndim, leaves):
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


# ------------------------------------------------ the reference's state dicts


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict, read with ``weights_only=True``, on the CPU."""
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32)).clone()


def _put(out: dict, path: list, kind: str, value) -> None:
    """The port's key of a flax leaf path: ``kernel`` is ``weight``."""
    out[".".join(path + ["weight" if kind == "kernel" else kind])] = _tensor(value)


def convert_convunet(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Reference UNet / UNet_FixedFeatures(+feat) state dict -> the port's
    ConvUNet state_dict (OIHW kernels copy through)."""
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def take(key, path):
        used.update((key + ".weight", key + ".bias"))
        _put(out, path, "kernel", sd[key + ".weight"])
        _put(out, path, "bias", sd[key + ".bias"])

    n_enc = len({k.split(".")[1] for k in sd if k.startswith("EncoderConvs.")})
    for i in range(n_enc):
        j = 0
        while f"EncoderConvs.{i}.blocks.{j}.0.weight" in sd:
            take(f"EncoderConvs.{i}.blocks.{j}.0", [f"enc_conv{i}", f"conv{j}"])
            j += 1
    i = 0
    while f"EncoderDown.{i}.conv.weight" in sd:
        take(f"EncoderDown.{i}.conv", [f"enc_down{i}"])
        i += 1
    i = 0
    while f"bottleneck.{i}.0.weight" in sd:
        take(f"bottleneck.{i}.0", [f"bottleneck{i}"])
        i += 1
    i = 0
    while f"DecoderUp.{i}.up.1.weight" in sd:
        take(f"DecoderUp.{i}.up.1", [f"dec_up{i}"])
        i += 1
    i = 0
    while f"DecoderConvs.{i}.blocks.0.0.weight" in sd:
        j = 0
        while f"DecoderConvs.{i}.blocks.{j}.0.weight" in sd:
            take(f"DecoderConvs.{i}.blocks.{j}.0", [f"dec_conv{i}", f"conv{j}"])
            j += 1
        i += 1
    # post convs: Sequential entries 0..post_depth-2, then the final 1x1
    post_ids = sorted({int(k.split(".")[1]) for k in sd if k.startswith("PostConvs.")})
    for i in post_ids[:-1]:
        take(f"PostConvs.{i}.0", [f"post{i}"])
    take(f"PostConvs.{post_ids[-1]}", ["post_final"])
    if "preprocessing_layer.weight" in sd:
        take("preprocessing_layer", ["pre"])
    leftover = set(sd) - used
    if leftover:
        raise ValueError(f"unconsumed torch keys: {sorted(leftover)[:8]}...")
    return out


_CNX_TOP = {"encoder_convs": "enc_conv{}", "encoder_downs": "enc_down{}",
            "decoder_ups": "dec_up{}", "decoder_convs": "dec_conv{}"}
_CNX_SUB = {"proj": "proj", "block.0": "dw", "block.1": "ln", "block.2": "pw1",
            "block.4": "pw2"}


def convert_convnext(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Reference NewUNet(+feat) state dict -> the port's ConvNeXtUNet
    state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def put_block(path: list, tkey: str):
        for tsub, name in _CNX_SUB.items():
            wkey = f"{tkey}.{tsub}.weight"
            if wkey in sd:
                _put(out, path + [name], "weight", sd[wkey])
                _put(out, path + [name], "bias", sd[f"{tkey}.{tsub}.bias"])
        ls = f"{tkey}.layerscale.layerscale"
        if ls in sd:
            _put(out, path + ["layerscale"], "layerscale", sd[ls])

    for key in sd:
        m = re.match(r"(encoder_convs|decoder_convs)\.(\d+)\.blocks\.(\d+)\.", key)
        if m:
            put_block([_CNX_TOP[m[1]].format(m[2]), f"block{m[3]}"],
                      f"{m[1]}.{m[2]}.blocks.{m[3]}")
            continue
        m = re.match(r"(encoder_downs|decoder_ups)\.(\d+)\.postconv\.", key)
        if m:
            put_block([_CNX_TOP[m[1]].format(m[2])], f"{m[1]}.{m[2]}.postconv")
            continue
        for pat, top in ((r"bottleneck\.blocks\.(\d+)\.", "bottleneck"),
                         (r"postprocessing\.0\.blocks\.(\d+)\.", "post"),
                         (r"preprocessing_layer\.blocks\.(\d+)\.", "pre")):
            m = re.match(pat, key)
            if m:
                put_block([top, f"block{m[1]}"], key[:m.end() - 1])
                break
        else:
            m = re.match(r"layerscales\.(\d+)\.layerscale", key)
            if m:
                _put(out, [f"fuse_scale{m[1]}"], "layerscale", sd[key])
            elif key == "postprocessing.1.weight":
                _put(out, ["post_final"], "kernel", sd[key])
            elif key == "postprocessing.1.bias":
                _put(out, ["post_final"], "bias", sd[key])
    return out


def convert_torch_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Dispatch on the state dict's key shape."""
    if any(k.startswith("EncoderConvs.") for k in sd):
        return convert_convunet(sd)
    if any(k.startswith("encoder_convs.") for k in sd):
        return convert_convnext(sd)
    raise ValueError("unrecognized checkpoint family")


def load_torch_checkpoint(path: str, net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Convert the reference ``.pth`` at ``path`` and check it against
    ``net``'s parameters (names and shapes); returns the state_dict, which
    ``net.load_state_dict`` takes."""
    sd = convert_torch_state_dict(load_torch_state_dict(path))
    check_state_dict(sd, net)
    return sd


def check_state_dict(sd: Mapping[str, torch.Tensor], net: torch.nn.Module) -> None:
    """Raise ValueError unless ``sd`` has exactly ``net``'s keys and shapes."""
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if want != got:
        shapes = {k: (want[k], got[k]) for k in set(want) & set(got) if want[k] != got[k]}
        raise ValueError(
            f"checkpoint/net mismatch: missing={sorted(set(want) - set(got))[:6]} "
            f"extra={sorted(set(got) - set(want))[:6]} "
            f"shape_mismatch={dict(list(shapes.items())[:6])}")
