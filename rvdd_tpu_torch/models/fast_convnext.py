"""Fused fast-path forward of ConvNeXtUNet (port of
rvdd_tpu/models/fast_convnext.py).

The net runs as seven ConvNeXt block chains through the CUDA
``convnext_chain`` kernel: A, B, C on the way down, ``mid`` (the
eighth-resolution core enc_down2 -> enc_conv3 -> bottleneck, five blocks),
then dec0, dec1, dec2 on the way up.  rvdd_tpu runs the eighth-resolution
core in XLA (``_middle8_cnx``); here the kernel takes it too, since it tiles
any size.  Activations are NHWC bf16 between chains; the chains pool and
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

Numerics: rvdd_tpu's ``fast`` preset, the only one ported: bf16 bands and
weights with fp32 accumulation and tanh GELU (:func:`check_precision`).  In
the engine's combined-state mode the dec2 chain writes the next recurrence
state ``[den 3 | zero 5 | feat 48]`` in fp32.
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


def check_precision(precision: str) -> None:
    """Only 'fast' is ported.  rvdd_tpu's 'mixed' and 'accurate' need the
    erf GELU and fp32 bands in convnext_chain (ROADMAP.md, Queue 2 item 2);
    a hybrid names ConvUNet chains and is refused as rvdd_tpu refuses it
    (rvdd_tpu/models/fast_convnext.py:298-303)."""
    if precision.startswith("hybrid:"):
        raise ValueError("per-chain hybrid presets are a ConvUNet feature; the ConvNeXt "
                         "fused path takes 'fast'")
    if precision != "fast":
        raise NotImplementedError(
            f"fused precision {precision!r} is not ported for ConvNeXt; only 'fast' is "
            "(ROADMAP.md, Queue 2 item 2)")


# ------------------------------------------------------------------- weights


@torch.no_grad()
def pack_fast_cnx(net: ConvNeXtUNet, feature_rec: bool, in_nc: int,
                  precision: str = "fast") -> dict:
    """One-time packing of the module's weights into the seven chains."""
    if in_nc != net.in_channels:
        raise ValueError(f"in_nc {in_nc} != net.in_channels {net.in_channels}")
    check_precision(precision)

    def sds(*names):
        return [net.get_submodule(n).state_dict() for n in names]

    packed = {}
    if feature_rec:
        packed["A"] = pack_chain(sds("pre.block0", "enc_conv0.block0", "enc_conv0.block1"),
                                 in_nc, aux_c=WIDTH)
    else:
        packed["A"] = pack_chain(sds("enc_conv0.block0", "enc_conv0.block1"), in_nc)
    packed["B"] = pack_chain(sds("enc_down0", "enc_conv1.block0", "enc_conv1.block1"), WIDTH)
    packed["C"] = pack_chain(sds("enc_down1", "enc_conv2.block0", "enc_conv2.block1"), WIDTH)
    for i in range(2):
        packed[f"dec{i}"] = pack_chain(
            sds(f"dec_up{i}", f"dec_conv{i}.block0", f"dec_conv{i}.block1"), WIDTH, aux_c=WIDTH)
    packed["dec2"] = pack_chain(
        sds("dec_up2", "dec_conv2.block0", "dec_conv2.block1", "post.block0", "post.block1"),
        WIDTH, aux_c=WIDTH, head=(net.post_final.weight, net.post_final.bias))
    packed["mid"] = pack_chain(sds("enc_down2", "enc_conv3.block0", "enc_conv3.block1",
                                   "bottleneck.block0", "bottleneck.block1"), WIDTH)
    return packed


# ------------------------------------------------------------------ forward


def fast_forward_cnx(net: ConvNeXtUNet, packed: dict, x: torch.Tensor,
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
    last_a = len(packed["A"].blocks) - 1
    skip0, d0 = convnext_chain(x, packed["A"], aux=aux if feat_rec else None,
                               aux_channels=aux_channels, emit=(last_a,), pool=(last_a,))
    skip1, d1 = convnext_chain(d0, packed["B"], emit=(2,), pool=(2,))
    skip2, d2 = convnext_chain(d1, packed["C"], emit=(2,), pool=(2,))
    (m8,) = convnext_chain(d2, packed["mid"])
    (dec0,) = convnext_chain(m8, packed["dec0"], aux=skip2, upsample_input=True)
    (dec1,) = convnext_chain(dec0, packed["dec1"], aux=skip1, upsample_input=True)
    if combine_state:
        (state,) = convnext_chain(dec1, packed["dec2"], aux=skip0, upsample_input=True,
                                  state_out=(56, 8) if feat_rec else (8, None))
        return state
    new_feat, out = convnext_chain(dec1, packed["dec2"], aux=skip0, upsample_input=True,
                                   emit=(4,))
    return out, (new_feat if feat_rec else None)
