"""Fused fast-path forward of ConvNeXtUNet (port of
rvdd_tpu/models/fast_convnext.py).

The net runs as seven ConvNeXt block chains through the CUDA
``convnext_chain`` kernel: A, B, C on the way down, ``mid`` (the
eighth-resolution core enc_down2 -> enc_conv3 -> bottleneck, five blocks),
then dec0, dec1, dec2 on the way up.  rvdd_tpu runs the eighth-resolution
core in XLA (``_middle8_cnx``); here the kernel takes it too, since it tiles
any size.  Activations are NHWC between chains; the chains pool and
upsample (bilinear, align_corners=True) inside the kernel.  The decoder
concatenates ``[h, skip]``, which is already the kernel's ``[block-0
output, aux]`` order, so no weight is reordered.

Three parts of rvdd_tpu's module are not ported, because they exist only
for the TPU's layout or VMEM: the lane half of the upsample as an MXU matmul
(``lane_resize2x_ac``: the kernel does the whole 2D upsample), the
row-tile feasibility test and its small-image XLA fallback
(``_quarter_tileable``, ``_middle_quarter_xla``: the kernel has no row-tile
limit, so chains C and dec0 always run) and the depthwise-engine knobs
(``DW_KNOBS``).

Numerics: rvdd_tpu's five fused presets for this family
(:data:`CNX_PRECISIONS`).  Each chain runs in one of the kernel's two modes:
bf16 bands and weights with fp32 accumulation and tanh GELU, or fp32 bands
and weights with fp32-faithful products and the erf GELU.  Activations
between chains are in the dtype of the chain that made it, and a chain's
input is rounded or widened to its own dtype where it is read
(``.to(chain.dtype)``).  In the engine's combined-state mode the dec2 chain
writes the next recurrence state ``[den 3 | zero 5 | feat 48]`` in fp32, in
every preset.
"""

from __future__ import annotations

from typing import Optional

import torch

from rvdd_tpu_torch.models.convnext_unet import ConvNeXtUNet
from rvdd_tpu_torch.ops.cuda.convnext_chain import (
    WIDTH,
    convnext_chain,
    pack_chain,
)


def supports_fast_path_cnx(net, h: int, w: int) -> bool:
    return (
        isinstance(net, ConvNeXtUNet)
        and net.filters == WIDTH
        and net.kernel_size == 7
        and net.depth == 4
        and net.n_blocks_encoder == 2
        and net.n_blocks_decoder == 2
        and net.n_blocks_bottleneck == 2
        and net.n_blocks_postprocessing == 2
        and net.downsampling_mode == "maxpool"
        and net.upsampling_mode == "bilinear"
        and net.fusion_mode == "cat"
        and h % 8 == 0
        and w % 8 == 0
        and h >= 64
        and w >= 64
    )


#: the seven chains; 'mid' is the five-block eighth-res chain that stands
#: for rvdd_tpu's XLA core _middle8_cnx
CNX_CHAINS = ("A", "B", "C", "mid", "dec0", "dec1", "dec2")
_FP32_ALL = dict(fp32=frozenset(CNX_CHAINS), glue=torch.float32)
_FP32_MID = dict(fp32=frozenset({"mid"}), glue=torch.bfloat16)

#: ConvNeXt fused-path presets as rvdd_tpu computes them for this family:
#: ``fp32`` names the chains in the kernel's fp32 mode, ``glue`` is the
#: dtype of the engine's warps and frame inputs.
#:   fast:             every chain bf16 (tanh GELU), bf16 glue;
#:   mixed, accurate:  every chain fp32 (erf GELU, fp32 bands and weights,
#:                     HIGHEST products: rvdd_tpu's _chain maps 'high' to
#:                     'highest', rvdd_tpu/models/fast_convnext.py:275-278,
#:                     so the two are one function), fp32 glue;
#:   wsplit, wf32:     the chains of 'fast' (_chain ignores weight_dtype;
#:                     wf32's HIGHEST acts on bf16 operands, exact anyway)
#:                     and an fp32 eighth-res core with the erf GELU
#:                     (_middle8_cnx runs fp32 for any preset but 'fast',
#:                     :212-225), bf16 glue.
#: These are not ConvUNet's semantics (models/fast_unet.py:FUSED_PRECISIONS),
#: so the table lives here.  A hybrid is refused as rvdd_tpu refuses it
#: (:298-304).
CNX_PRECISIONS = {
    "fast": dict(fp32=frozenset(), glue=torch.bfloat16),
    "mixed": _FP32_ALL,
    "accurate": _FP32_ALL,
    "wsplit": _FP32_MID,
    "wf32": _FP32_MID,
}


def cnx_precision(name: str) -> dict:
    """Resolve a ConvNeXt preset name (see :data:`CNX_PRECISIONS`);
    ValueError for a hybrid or an unknown name."""
    if name.startswith("hybrid:"):
        raise ValueError("per-chain hybrid presets are a ConvUNet feature; the ConvNeXt "
                         f"fused path takes {sorted(CNX_PRECISIONS)}")
    if name not in CNX_PRECISIONS:
        raise ValueError(f"unknown ConvNeXt fused precision {name!r}; pick from "
                         f"{sorted(CNX_PRECISIONS)}")
    return CNX_PRECISIONS[name]


# ------------------------------------------------------------------- weights


@torch.no_grad()
def pack_fast_cnx(net: ConvNeXtUNet, feature_rec: bool, in_nc: int,
                  precision: str = "fast") -> dict:
    """One-time packing of the module's weights into the seven chains, each
    in its mode under ``precision`` (a :data:`CNX_PRECISIONS` key)."""
    if in_nc != net.in_channels:
        raise ValueError(f"in_nc {in_nc} != net.in_channels {net.in_channels}")
    fp32 = cnx_precision(precision)["fp32"]

    def chain(name, names, cin0, **kw):
        sds = [net.get_submodule(n).state_dict() for n in names]
        return pack_chain(sds, cin0, band_fp32=name in fp32, **kw)

    packed = {}
    if feature_rec:
        packed["A"] = chain("A", ("pre.block0", "enc_conv0.block0", "enc_conv0.block1"),
                            in_nc, aux_c=WIDTH)
    else:
        packed["A"] = chain("A", ("enc_conv0.block0", "enc_conv0.block1"), in_nc)
    packed["B"] = chain("B", ("enc_down0", "enc_conv1.block0", "enc_conv1.block1"), WIDTH)
    packed["C"] = chain("C", ("enc_down1", "enc_conv2.block0", "enc_conv2.block1"), WIDTH)
    for i in range(2):
        packed[f"dec{i}"] = chain(
            f"dec{i}", (f"dec_up{i}", f"dec_conv{i}.block0", f"dec_conv{i}.block1"), WIDTH,
            aux_c=WIDTH)
    packed["dec2"] = chain(
        "dec2", ("dec_up2", "dec_conv2.block0", "dec_conv2.block1", "post.block0",
                 "post.block1"),
        WIDTH, aux_c=WIDTH, head=(net.post_final.weight, net.post_final.bias))
    packed["mid"] = chain("mid", ("enc_down2", "enc_conv3.block0", "enc_conv3.block1",
                                  "bottleneck.block0", "bottleneck.block1"), WIDTH)
    return packed


# ------------------------------------------------------------------ forward


def fast_forward_cnx(net: ConvNeXtUNet, packed: dict, x: torch.Tensor,
                     aux: Optional[torch.Tensor] = None, *, aux_channels=None,
                     combine_state: bool = False):
    """Fused forward on NHWC x [B, H, W, in_nc].

    aux: the recurrent features [B, H, W, 48], or a wider tensor with
    ``aux_channels=(offset, 48)`` (the warped recurrence state).  Each
    chain's inputs are rounded or widened to its dtype where it reads them,
    so x and aux may come in either dtype (the engine passes its glue
    dtype).  Returns (out [B, H, W, out_nc], new_feat [B, H, W, 48] or
    None) in dec2's dtype, or with ``combine_state`` the next recurrence
    state [B, H, W, 8 (+48)] fp32 ``[den 3 | zero 5 | feat 48]``.
    """
    feat_rec = net.feature_rec
    ca, cb, cc, cm = packed["A"], packed["B"], packed["C"], packed["mid"]
    c0, c1, c2 = packed["dec0"], packed["dec1"], packed["dec2"]
    last_a = len(ca.blocks) - 1
    skip0, d0 = convnext_chain(x.to(ca.dtype), ca, aux=aux.to(ca.dtype) if feat_rec else None,
                               aux_channels=aux_channels, emit=(last_a,), pool=(last_a,))
    skip1, d1 = convnext_chain(d0.to(cb.dtype), cb, emit=(2,), pool=(2,))
    skip2, d2 = convnext_chain(d1.to(cc.dtype), cc, emit=(2,), pool=(2,))
    (m8,) = convnext_chain(d2.to(cm.dtype), cm)
    (dec0,) = convnext_chain(m8.to(c0.dtype), c0, aux=skip2.to(c0.dtype), upsample_input=True)
    (dec1,) = convnext_chain(dec0.to(c1.dtype), c1, aux=skip1.to(c1.dtype),
                             upsample_input=True)
    if combine_state:
        (state,) = convnext_chain(dec1.to(c2.dtype), c2, aux=skip0.to(c2.dtype),
                                  upsample_input=True,
                                  state_out=(56, 8) if feat_rec else (8, None))
        return state
    new_feat, out = convnext_chain(dec1.to(c2.dtype), c2, aux=skip0.to(c2.dtype),
                                   upsample_input=True, emit=(4,))
    return out, (new_feat if feat_rec else None)
