"""Fused fast-path forward of ConvUNet (port of rvdd_tpu/models/fast_unet.py).

The full-, half- and quarter-resolution levels run as six conv chains
(A, B, C on the way down; dec0, dec1, dec2 on the way up) through the CUDA
``conv_chain`` kernel; the cheap eighth-resolution core (``_middle8``)
stays in plain PyTorch, as it stays in XLA in rvdd_tpu.  Activations are
NHWC bf16 between chains; the chains pool and upsample inside the kernel,
so there is no glue between them.

Numerics: rvdd_tpu's ``fast`` preset, the only one ported: bf16 bands and
weights with fp32 accumulation, and dec2's post0 and head layers with
split (hi + lo) weights.  In the engine's combined-state mode the dec2
chain writes the next recurrence state ``[den 3 | zero 5 | feat 48]`` in
fp32 straight from its accumulator.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rvdd_tpu_torch.models.unet import ConvUNet
from rvdd_tpu_torch.ops.cuda.conv_chain import conv_chain, pack_chain

#: fused-path numerics presets.  Only 'fast' is ported: bf16 bands, 1-pass
#: bf16 products, and dec2's last two layers (post0, head) with split
#: weights.  rvdd_tpu's 'mixed', 'accurate', 'wsplit', 'wf32' and
#: 'hybrid:<chains>' wait for a later slice (ROADMAP.md).
FUSED_PRECISIONS = {
    "fast": dict(weight_split={"dec2": (False, False, False, True, True)}),
}


def get_fused_precision(name: str) -> dict:
    if name not in FUSED_PRECISIONS:
        raise NotImplementedError(
            f"fused precision {name!r} is not ported; only 'fast' is (ROADMAP.md)")
    return FUSED_PRECISIONS[name]


def resolve_fused_precision(name: str, *, arch: str, feature_rec: bool,
                            future: bool) -> str:
    """Resolve 'auto' as rvdd_tpu does: 'fast' for every variant except
    convunet+feat+future, whose preset ('hybrid:glue+A+dec2') is not ported
    yet and raises.  Any other name must be a ported preset."""
    if name == "auto":
        if arch.startswith("convunet") and feature_rec and future:
            raise NotImplementedError(
                "convunet+feat+future resolves to 'hybrid:glue+A+dec2', not ported yet")
        return "fast"
    get_fused_precision(name)
    return name


def supports_fast_path(net, h: int, w: int) -> bool:
    return (
        isinstance(net, ConvUNet)
        and net.fixed_features
        and net.filters == 48
        and net.depth == 4
        and net.bottleneck_depth == 2
        and net.post_depth == 2
        and net.n_blocks_encoder == 2
        and net.n_blocks_decoder == 2
        and net.downsampling_mode == "convmax"
        and net.upsampling_mode == "bilinear"
        and net.activation == "relu"
        and net.normalization in (None, "none")
        and not net.bottleneck_dilation
        and not net.residual
        and net.use_bias
        and h % 8 == 0
        and w % 8 == 0
        and h >= 32
        and w >= 32
    )


# ------------------------------------------------------------------- weights


def _hwio(conv) -> torch.Tensor:
    return conv.weight.detach().float().permute(2, 3, 1, 0)


def _bias(conv) -> torch.Tensor:
    return conv.bias.detach().float()


def _swap_concat(k: torch.Tensor, first: int) -> torch.Tensor:
    # the net concatenates [skip, d]; the kernel reads [conv-out, aux], so
    # move the conv-input block (d) first
    return torch.cat([k[:, :, first:], k[:, :, :first]], dim=2)


@torch.no_grad()
def pack_fast_params(net: ConvUNet, feature_rec: bool, in_nc: int,
                     precision: str = "fast") -> dict:
    """One-time packing of the module's weights into the six chains."""
    if in_nc != net.in_channels:
        raise ValueError(f"in_nc {in_nc} != net.in_channels {net.in_channels}")
    split = get_fused_precision(precision)["weight_split"]

    def chain(name, convs, acts, ks, ws=None):
        return pack_chain(ws or [_hwio(c) for c in convs], [_bias(c) for c in convs],
                          acts, ks, weight_split=split.get(name))

    e = [getattr(net, f"enc_conv{i}") for i in range(4)]
    packed = {}
    if feature_rec:
        # pre (linear) -> concat feat -> enc0 c0, c1 -> down0
        packed["A"] = chain("A", [net.pre, e[0].conv0, e[0].conv1, net.enc_down0],
                            ("none", "relu", "relu", "none"), (3, 3, 3, 3))
        packed["A_emit"], packed["A_pool"] = (2, 3), (3,)
    else:
        packed["A"] = chain("A", [e[0].conv0, e[0].conv1, net.enc_down0],
                            ("relu", "relu", "none"), (3, 3, 3))
        packed["A_emit"], packed["A_pool"] = (1, 2), (2,)
    packed["B"] = chain("B", [e[1].conv0, e[1].conv1, net.enc_down1],
                        ("relu", "relu", "none"), (3, 3, 3))
    packed["C"] = chain("C", [e[2].conv0, e[2].conv1, net.enc_down2],
                        ("relu", "relu", "none"), (3, 3, 3))
    for i in range(3):
        dc = getattr(net, f"dec_conv{i}")
        up = getattr(net, f"dec_up{i}")
        convs = [up, dc.conv0, dc.conv1] + ([net.post0, net.post_final] if i == 2 else [])
        ws = [_hwio(c) for c in convs]
        ws[1] = _swap_concat(ws[1], 48)
        acts = ("relu",) * len(convs)
        if i == 2:
            acts = acts[:-1] + ("none",)
        packed[f"dec{i}"] = chain(f"dec{i}", convs, acts, (3,) * 3 + ((3, 1) if i == 2 else ()),
                                  ws=ws)
    packed["params_mid"] = {
        name: (conv.weight.detach().to(torch.bfloat16), conv.bias.detach().to(torch.bfloat16))
        for name, conv in (("enc_conv3.conv0", e[3].conv0), ("enc_conv3.conv1", e[3].conv1),
                           ("bottleneck0", net.bottleneck0), ("bottleneck1", net.bottleneck1))
    }
    return packed


# --------------------------------------------------------------- eighth res


def _bf16_conv(x, wb, act=True):
    """bf16 operands, fp32 accumulation, bf16 output (a bf16 XLA conv).
    The fp32 conv gives the same result on every device: bf16 values are
    exact in TF32 too, so cuDNN's default TF32 mode does not round them."""
    w, b = wb
    y = F.conv2d(x.float(), w.float(), b.float(), padding=1)
    if act:
        y = torch.relu(y)
    return y.to(torch.bfloat16)


def _middle8(params, d2: torch.Tensor) -> torch.Tensor:
    """Eighth-res core: enc3 -> bottleneck with its running residual sum;
    NHWC bf16 [B, H/8, W/8, 48] in and out.  Plain PyTorch, as it is XLA in
    rvdd_tpu: too small for the chain kernels and cheap."""
    x = d2.permute(0, 3, 1, 2)
    h = _bf16_conv(x, params["enc_conv3.conv0"])
    skip3 = _bf16_conv(h, params["enc_conv3.conv1"])
    d = s = skip3
    for i in range(2):
        d = _bf16_conv(d, params[f"bottleneck{i}"])
        s = (s.float() + d.float()).to(torch.bfloat16)
    return s.permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------------ forward


def fast_forward(net: ConvUNet, packed: dict, x: torch.Tensor,
                 aux: Optional[torch.Tensor] = None, *, aux_channels=None,
                 combine_state: bool = False):
    """Fused forward on NHWC bf16 x [B, H, W, in_nc].

    aux: the recurrent features [B, H, W, 48], or a wider tensor with
    ``aux_channels=(offset, 48)`` (the warped recurrence state).
    Returns (out [B, H, W, out_nc] bf16, new_feat [B, H, W, 48] bf16 or
    None), or with ``combine_state`` the next recurrence state
    [B, H, W, 8 (+48)] fp32 ``[den 3 | zero 5 | feat 48]``.
    """
    feat_rec = net.feature_rec
    skip0, d0 = conv_chain(x, packed["A"], aux=aux if feat_rec else None,
                           aux_channels=aux_channels, emit=packed["A_emit"],
                           pool=packed["A_pool"])
    skip1, d1 = conv_chain(d0, packed["B"], emit=(1, 2), pool=(2,))
    skip2, d2 = conv_chain(d1, packed["C"], emit=(1, 2), pool=(2,))
    m8 = _middle8(packed["params_mid"], d2)
    (dec0,) = conv_chain(m8, packed["dec0"], aux=skip2, emit=(2,), upsample_input=True)
    (dec1,) = conv_chain(dec0, packed["dec1"], aux=skip1, emit=(2,), upsample_input=True)
    if combine_state:
        layers = ((4, 0), (3, 8)) if feat_rec else ((4, 0),)
        (state,) = conv_chain(dec1, packed["dec2"], aux=skip0, upsample_input=True,
                              state_out=(56 if feat_rec else 8, layers))
        return state
    new_feat, out = conv_chain(dec1, packed["dec2"], aux=skip0, emit=(3, 4),
                               upsample_input=True)
    return out, (new_feat if feat_rec else None)
