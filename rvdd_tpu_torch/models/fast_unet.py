"""Fused fast-path forward of ConvUNet (port of rvdd_tpu/models/fast_unet.py).

The full-, half- and quarter-resolution levels run as six conv chains
(A, B, C on the way down; dec0, dec1, dec2 on the way up) through the CUDA
``conv_chain`` kernel; the cheap eighth-resolution core (``_middle8``)
stays in plain PyTorch, as it stays in XLA in rvdd_tpu.  Activations are
NHWC between chains, each in the band dtype of the chain that made it; the
chains pool and upsample inside the kernel, and a chain's input is rounded
to its own band dtype where it is read (``.to(chain.dtype)``, rvdd_tpu's
``x.astype(band_dtype)``).

Numerics: the fused-path presets of rvdd_tpu/models/fast_unet.py:30-129.
Each chain runs in one of the kernel's four modes: bf16 bands with 1-pass
(or split-weight) products, fp32 bands with bf16_3x or HIGHEST products,
or bf16 bands with fp32 weights; 'glue' (the engine's warps and frame
inputs) runs bf16 or fp32, and the eighth-res core (``_middle8``) follows
the glue or runs fp32 operands (where 'middle' is named, and under the
'highest' presets).  In the engine's combined-state mode
the dec2 chain writes the next recurrence state ``[den 3 | zero 5 | feat
48]`` in fp32 straight from its accumulator, in every preset.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from rvdd_tpu_torch.models.unet import ConvUNet
from rvdd_tpu_torch.ops.cuda.conv_chain import conv_chain, pack_chain

#: the six conv chains, in rvdd_tpu's names
CHAINS = ("A", "B", "C", "dec0", "dec1", "dec2")
#: what a hybrid preset may name: the chains, 'middle' (the eighth-res
#: core) and 'glue' (everything between chains: the state and future-frame
#: warps and the frame inputs)
HYBRID_CHAINS = ("A", "B", "C", "middle", "dec0", "dec1", "dec2", "glue")
#: the 'fast' preset's selective split: dec2's post0 and head layers carry
#: about 2/3 of the fused path's error power (rvdd_tpu, PARITY.md)
_FAST_SPLIT = {"dec2": (False, False, False, True, True)}

#: fused-path numerics presets, resolved: ``fp32`` names the parts that
#: run fp32 bands (a chain: the kernel's fp32-band mode; 'middle': fp32
#: operands; 'glue': fp32 warps and inputs); ``mxu_precision`` is
#: rvdd_tpu's: 'high' (bf16_3x) or 'highest' products for the fp32 chains,
#: and 'highest' also runs the eighth-res core in fp32 (rvdd_tpu's
#: ``mid_mp``); ``weight_fp32`` gives the bf16 chains fp32 weights;
#: ``weight_split`` gives the bf16 chains' per-layer hi/lo split (a tuple
#: per chain, or True for every layer of every chain).
#:   fast:     bf16 everywhere, dec2's post0 and head split;
#:   mixed:    fp32 everywhere, bf16_3x products;
#:   accurate: fp32 everywhere, HIGHEST products (fp32 weights);
#:   wsplit:   bf16 bands, every layer split;
#:   wf32:     bf16 bands and glue, fp32 weights, an fp32 eighth-res core.
#: 'hybrid:<c1>+<c2>+...' runs the named parts as 'mixed' and the rest as
#: 'fast' (see get_fused_precision).
FUSED_PRECISIONS = {
    "fast": dict(fp32=frozenset(), weight_split=_FAST_SPLIT, mxu_precision="default",
                 weight_fp32=False),
    "mixed": dict(fp32=frozenset(HYBRID_CHAINS), weight_split={}, mxu_precision="high",
                  weight_fp32=False),
    "accurate": dict(fp32=frozenset(HYBRID_CHAINS), weight_split={}, mxu_precision="highest",
                     weight_fp32=False),
    "wsplit": dict(fp32=frozenset(), weight_split=True, mxu_precision="default",
                   weight_fp32=False),
    "wf32": dict(fp32=frozenset(), weight_split={}, mxu_precision="highest", weight_fp32=True),
}


def get_fused_precision(name: str) -> dict:
    """Resolve a FUSED_PRECISIONS key or a hybrid, as rvdd_tpu's
    get_fused_precision does.  ``hybrid:<c1>+...`` (parts from
    HYBRID_CHAINS) runs the named parts with the 'mixed' numerics and every
    other chain with the 'fast' ones, including fast's split of dec2's last
    two layers when dec2 is not named (rvdd_tpu/models/fast_unet.py:93-95)."""
    if name.startswith("hybrid:"):
        parts = tuple(name[len("hybrid:"):].split("+"))
        bad = [c for c in parts if c not in HYBRID_CHAINS]
        if bad:
            raise ValueError(f"unknown hybrid chains {bad}; pick from {HYBRID_CHAINS}")
        return dict(fp32=frozenset(parts),
                    weight_split={} if "dec2" in parts else _FAST_SPLIT,
                    mxu_precision="high", weight_fp32=False)
    if name not in FUSED_PRECISIONS:
        raise ValueError(f"unknown fused precision {name!r}; pick from "
                         f"{sorted(FUSED_PRECISIONS)} or 'hybrid:<chains>'")
    return FUSED_PRECISIONS[name]


def glue_dtype(prec: dict) -> torch.dtype:
    """The dtype between chains (the engine's state and future-frame warps
    and the frame inputs) of a resolved preset: fp32 where 'glue' runs fp32
    (every part of 'mixed' and 'accurate', or a hybrid that names it), else
    bf16 ('wf32' too: its bands are bf16)."""
    return torch.float32 if "glue" in prec["fp32"] else torch.bfloat16


def resolve_fused_precision(name: str, *, arch: str, feature_rec: bool,
                            future: bool) -> str:
    """Resolve 'auto' as rvdd_tpu does: 'hybrid:glue+A+dec2' for
    convunet+feat+future, whose bf16 error recirculates on the full-res
    cycle carry -> warp -> A -> skip0 -> dec2 -> carry (-0.30 dB under
    'fast'; closing that cycle in fp32 costs -0.002 dB, PARITY.md), and
    'fast' for every other variant.  Any other name is checked and
    returned."""
    if name == "auto":
        if arch.startswith("convunet") and feature_rec and future:
            return "hybrid:glue+A+dec2"
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
    """One-time packing of the module's weights into the six chains, each
    in its mode under ``precision`` (a FUSED_PRECISIONS key or a hybrid):
    ``packed[name].mode`` is the chain's kernel mode (conv_chain.MODES),
    ``packed["middle_dtype"]`` and ``packed["middle_fp32"]`` say how the
    eighth-res core runs (see :func:`_middle8`)."""
    if in_nc != net.in_channels:
        raise ValueError(f"in_nc {in_nc} != net.in_channels {net.in_channels}")
    prec = get_fused_precision(precision)
    split = prec["weight_split"]

    def chain(name, convs, acts, ks, ws=None):
        per_layer = (True,) * len(convs) if split is True else split.get(name)
        fp32 = name in prec["fp32"]
        w32 = prec["weight_fp32"] and not fp32
        return pack_chain(ws or [_hwio(c) for c in convs], [_bias(c) for c in convs],
                          acts, ks, weight_split=per_layer, band_fp32=fp32, weight_fp32=w32,
                          mxu_precision=prec["mxu_precision"] if fp32 or w32 else None)

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
    # the eighth-res core (_middle8): fp32 arrays where the glue is fp32 or
    # it runs fp32 operands, which it does where 'middle' is named and under
    # 'highest' products (rvdd_tpu's mid_mp != 'default',
    # rvdd_tpu/models/fast_unet.py:496-523)
    packed["middle_fp32"] = "middle" in prec["fp32"] or prec["mxu_precision"] == "highest"
    packed["middle_dtype"] = torch.float32 if packed["middle_fp32"] else glue_dtype(prec)
    packed["params_mid"] = {
        name: (conv.weight.detach().float(), conv.bias.detach().float())
        for name, conv in (("enc_conv3.conv0", e[3].conv0), ("enc_conv3.conv1", e[3].conv1),
                           ("bottleneck0", net.bottleneck0), ("bottleneck1", net.bottleneck1))
    }
    return packed


# --------------------------------------------------------------- eighth res


@contextlib.contextmanager
def _cudnn_fp32():
    """cuDNN's convs in full fp32 for the scope: its default TF32 keeps 10
    mantissa bits, against about 16 for rvdd_tpu's 'high' (bf16_3x) and 24
    for its 'highest', which an fp32 middle stands for.  Outside the scope the flag is as the caller
    left it (TF32 off slows the bf16-valued convs of the other modes and
    buys them nothing: bf16 values are exact in TF32)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _middle8(params, d2: torch.Tensor, store: torch.dtype = torch.bfloat16,
             exact: bool = False) -> torch.Tensor:
    """Eighth-res core: enc3 -> bottleneck with its running residual sum;
    NHWC [B, H/8, W/8, 48] in and out (``store``).  Plain PyTorch, as it is
    XLA in rvdd_tpu: too small for the chain kernels and cheap.  rvdd_tpu
    runs it on arrays of its glue dtype with 1-pass dots, or on fp32 arrays
    with 'high' dots where the preset names 'middle' and 'highest' dots
    under 'accurate' and 'wf32' (rvdd_tpu/models/fast_unet.py:257-267 and
    :519-523), so three modes:

    * ``store`` bf16: bf16 operands, each conv's result and the residual
      sum rounded to bf16 (bf16 XLA convs);
    * ``store`` fp32: 1-pass dots on fp32 arrays, as the TPU runs them:
      activations and weights rounded to bf16 at each conv, results,
      biases and the residual sum kept fp32;
    * ``exact`` (store fp32): fp32 operands throughout, under
      :func:`_cudnn_fp32`.

    A conv of bf16-rounded operands is exact in fp32 on every device (bf16
    values are exact in TF32 too)."""
    def conv(h, name, act=True):
        w, b = params[name]
        if not exact:
            h, w = h.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
            if store == torch.bfloat16:
                b = b.to(torch.bfloat16).float()
        y = F.conv2d(h, w, b, padding=1)
        return (torch.relu(y) if act else y).to(store).float()

    x = d2.permute(0, 3, 1, 2).float()
    with _cudnn_fp32() if exact else contextlib.nullcontext():
        d = s = conv(conv(x, "enc_conv3.conv0"), "enc_conv3.conv1")  # skip3
        for i in range(2):
            d = conv(d, f"bottleneck{i}")
            s = (s + d).to(store).float()
    return s.to(store).permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------------ forward


def fast_forward(net: ConvUNet, packed: dict, x: torch.Tensor,
                 aux: Optional[torch.Tensor] = None, *, aux_channels=None,
                 combine_state: bool = False):
    """Fused forward on NHWC x [B, H, W, in_nc], each chain and the
    eighth-res core in the mode :func:`pack_fast_params` gave them.

    aux: the recurrent features [B, H, W, 48], or a wider tensor with
    ``aux_channels=(offset, 48)`` (the warped recurrence state).  Each
    chain's inputs are rounded to its band dtype where it reads them, so x
    and aux may come in either dtype (the engine passes its glue dtype).
    Returns (out [B, H, W, out_nc], new_feat [B, H, W, 48] or None) in
    dec2's band dtype, or with ``combine_state`` the next recurrence state
    [B, H, W, 8 (+48)] fp32 ``[den 3 | zero 5 | feat 48]``.
    """
    feat_rec = net.feature_rec
    ca, cb, cc, c0, c1, c2 = (packed[n] for n in CHAINS)
    skip0, d0 = conv_chain(x.to(ca.dtype), ca, aux=aux.to(ca.dtype) if feat_rec else None,
                           aux_channels=aux_channels, emit=packed["A_emit"],
                           pool=packed["A_pool"])
    skip1, d1 = conv_chain(d0.to(cb.dtype), cb, emit=(1, 2), pool=(2,))
    skip2, d2 = conv_chain(d1.to(cc.dtype), cc, emit=(1, 2), pool=(2,))
    m8 = _middle8(packed["params_mid"], d2, packed["middle_dtype"], packed["middle_fp32"])
    (dec0,) = conv_chain(m8.to(c0.dtype), c0, aux=skip2.to(c0.dtype), emit=(2,),
                         upsample_input=True)
    (dec1,) = conv_chain(dec0.to(c1.dtype), c1, aux=skip1.to(c1.dtype), emit=(2,),
                         upsample_input=True)
    if combine_state:
        layers = ((4, 0), (3, 8)) if feat_rec else ((4, 0),)
        (state,) = conv_chain(dec1.to(c2.dtype), c2, aux=skip0.to(c2.dtype),
                              upsample_input=True, state_out=(56 if feat_rec else 8, layers))
        return state
    new_feat, out = conv_chain(dec1.to(c2.dtype), c2, aux=skip0.to(c2.dtype), emit=(3, 4),
                               upsample_input=True)
    return out, (new_feat if feat_rec else None)
