"""ConvNeXtUNet ('newunet'): the ConvNeXt-block U-Net with optional feature
recurrence (port of rvdd_tpu/models/convnext_unet.py as nn.Modules).

Block anatomy: an optional 1x1 projection, then
``[7x7 depthwise -> channel LayerNorm -> 1x1 x4 -> GELU -> 1x1]`` scaled by
a learned per-channel LayerScale and added residually.  Decoder upsampling
is bilinear with align_corners=True (convunet's is False).

Every module takes and returns NHWC.  Parameters carry the flax module
names (``pre.block0.proj``, ``enc_conv0.block1.dw``, ``.ln``, ``.pw1``,
``.pw2``, ``.layerscale``, ``enc_down0``, ``bottleneck``, ``dec_up0``,
``dec_conv0``, ``post``, ``post_final``), so models/convert.py maps them one
to one.  rvdd_tpu's ``ops/fastconv.py`` exists for the TPU's lowering only;
here the 1x1s are ``nn.Conv2d(k=1)`` (applied as a matmul over the channel
axis) and the depthwise conv is ``nn.Conv2d(groups=features)``, with the
same parameter shapes.

The knobs of rvdd_tpu's ConvNeXtUNet (rvdd_tpu/models/convnext_unet.py:
180-210): ``downsampling_mode`` ``maxpool`` (the default) or ``avgpool``;
``upsampling_mode`` ``bilinear`` (the default) or ``nearest``;
``fusion_mode`` ``cat`` (the default: ``[up, skip]`` into the decoder
block) or ``sum`` (``up + fuse_scale{i}(skip)``, a LayerScale on the skip);
and the exact or tanh GELU (``fast_act``).

On a shard of the mesh's space axis (parallel/space.py:scope) each level
runs on this process's rows: the depthwise conv reads ``kernel_size // 2``
rows of its neighbours on each side (zeros beyond the sample), the
align_corners=True upsample reads the rows its taps reach in the sample,
the pools stay local and the LayerNorm and the 1x1s are per pixel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from rvdd_tpu_torch.models.unet import conv2d, zero_pad_to
from rvdd_tpu_torch.ops.resize import (
    avgpool2x2,
    maxpool2x2,
    upsample2x_bilinear,
    upsample2x_nearest,
)
from rvdd_tpu_torch.parallel import space
from rvdd_tpu_torch.parallel.space import Rows


def conv1x1_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``nn.Conv2d`` applied to NHWC as a matmul over channels."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis, biased variance."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        u = x.mean(-1, keepdim=True)
        s = ((x - u) ** 2).mean(-1, keepdim=True)
        return (x - u) / torch.sqrt(s + self.eps) * self.weight + self.bias


class LayerScale(nn.Module):
    """Learned per-channel residual scale, init 0.1."""

    def __init__(self, features: int, init: float = 0.1):
        super().__init__()
        self.init = float(init)
        self.layerscale = nn.Parameter(torch.full((features,), float(init)))

    def forward(self, x):
        return x * self.layerscale


class ConvNeXtBlock(nn.Module):
    """proj? -> (dw7x7 -> LN -> 1x1 x4 -> GELU -> 1x1) * layerscale + x."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 7,
                 layerscale_init: float = 0.1, fast_act: bool = False):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.kernel_size = kernel_size
        self.fast_act = fast_act
        if in_features != features:
            self.proj = nn.Conv2d(in_features, features, 1)
        self.dw = nn.Conv2d(features, features, kernel_size, padding=kernel_size // 2,
                            groups=features)
        self.ln = ChannelLayerNorm(features)
        self.pw1 = nn.Conv2d(features, 4 * features, 1)
        self.pw2 = nn.Conv2d(4 * features, features, 1)
        self.layerscale = LayerScale(features, layerscale_init)

    def forward(self, x, rows: Optional[Rows] = None):
        if self.in_features != self.features:
            x = conv1x1_nhwc(self.proj, x)
        h = conv2d(self.dw, x.permute(0, 3, 1, 2), rows).permute(0, 2, 3, 1)
        h = self.ln(h)
        h = conv1x1_nhwc(self.pw1, h)
        h = F.gelu(h, approximate="tanh" if self.fast_act else "none")
        h = conv1x1_nhwc(self.pw2, h)
        return x + self.layerscale(h)


class NConvNeXtBlock(nn.Module):
    """n ConvNeXt blocks, parameters block0, block1, ..."""

    def __init__(self, in_features: int, features: int, n_blocks: int = 2,
                 kernel_size: int = 7, layerscale_init: float = 0.1,
                 fast_act: bool = False):
        super().__init__()
        self.n_blocks = n_blocks
        for j in range(n_blocks):
            self.add_module(f"block{j}", ConvNeXtBlock(
                in_features if j == 0 else features, features, kernel_size,
                layerscale_init, fast_act))

    def forward(self, x, rows: Optional[Rows] = None):
        for j in range(self.n_blocks):
            x = getattr(self, f"block{j}")(x, rows)
        return x


class ConvNeXtUNet(nn.Module):
    """The 'newunet' architecture (ConvNeXtUnet in the paper)."""

    def __init__(self, in_channels: int, out_channels: int, filters: int = 48,
                 kernel_size: int = 7, depth: int = 4, n_blocks_encoder: int = 2,
                 n_blocks_decoder: int = 2, n_blocks_bottleneck: int = 2,
                 n_blocks_postprocessing: int = 2, downsampling_mode: str = "maxpool",
                 upsampling_mode: str = "bilinear", fusion_mode: str = "cat",
                 layerscale_init: float = 0.1, feature_rec: bool = False,
                 fast_act: bool = False):
        super().__init__()
        if downsampling_mode not in ("maxpool", "avgpool"):
            raise NotImplementedError(f"downsampling_mode {downsampling_mode}")
        if upsampling_mode not in ("bilinear", "nearest"):
            raise NotImplementedError(f"upsampling_mode {upsampling_mode}")
        if fusion_mode not in ("cat", "sum"):
            raise NotImplementedError(f"fusion_mode {fusion_mode}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.filters = filters
        self.kernel_size = kernel_size
        self.depth = depth
        self.n_blocks_encoder = n_blocks_encoder
        self.n_blocks_decoder = n_blocks_decoder
        self.n_blocks_bottleneck = n_blocks_bottleneck
        self.n_blocks_postprocessing = n_blocks_postprocessing
        self.downsampling_mode = downsampling_mode
        self.upsampling_mode = upsampling_mode
        self.fusion_mode = fusion_mode
        self.feature_rec = feature_rec

        f = filters

        def nconv(in_f, n):
            return NConvNeXtBlock(in_f, f, n, kernel_size, layerscale_init, fast_act)

        def block():
            return ConvNeXtBlock(f, f, kernel_size, layerscale_init, fast_act)

        if feature_rec:
            self.pre = nconv(in_channels, 1)
            enc0_in = 2 * f
        else:
            enc0_in = in_channels
        for i in range(depth):
            self.add_module(f"enc_conv{i}", nconv(enc0_in if i == 0 else f, n_blocks_encoder))
            if i < depth - 1:
                self.add_module(f"enc_down{i}", block())
        self.bottleneck = nconv(f, n_blocks_bottleneck)
        for i in range(depth - 1):
            self.add_module(f"dec_up{i}", block())
            if fusion_mode == "sum":
                self.add_module(f"fuse_scale{i}", LayerScale(f, layerscale_init))
            self.add_module(f"dec_conv{i}", nconv(f if fusion_mode == "sum" else 2 * f,
                                                  n_blocks_decoder))
        self.post = nconv(f, n_blocks_postprocessing)
        self.post_final = nn.Conv2d(f, out_channels, 1)

    def nil_features(self, batch: int, h: int, w: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
        """Zero recurrent feature state [batch, h, w, filters]."""
        if device is None:
            device = self.post_final.weight.device
        return torch.zeros(batch, h, w, self.filters, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, feat: Optional[torch.Tensor] = None):
        """(x [B, H, W, Cin], feat [B, H, W, F] or None) -> (y [B, H, W, Cout]
        fp32, new_feat [B, H, W, F] fp32 or None)."""
        # this shard's rows at each level (None: the whole sample)
        rows = [space.rows_of(x)]
        for _ in range(self.depth - 1):
            rows.append(None if rows[-1] is None else rows[-1].down())
        if self.feature_rec:
            if feat is None:
                raise ValueError("feature-recurrent net needs a feat input")
            h = torch.cat([self.pre(x, rows[0]), feat], dim=-1)
        else:
            h = x
        skips = []
        for i in range(self.depth):
            h = getattr(self, f"enc_conv{i}")(h, rows[i])
            skips.append(h)
            if i < self.depth - 1:
                pool = avgpool2x2 if self.downsampling_mode == "avgpool" else maxpool2x2
                h = getattr(self, f"enc_down{i}")(pool(h), rows[i + 1])
        h = self.bottleneck(h, rows[-1])
        for i in range(self.depth - 1):
            low = rows[self.depth - 1 - i]
            if self.upsampling_mode == "nearest":
                h = upsample2x_nearest(h)
            else:  # align_corners=True here, unlike convunet
                h = upsample2x_bilinear(h, align_corners=True, rows=low)
            up = None if low is None else low.scale(2)
            h = getattr(self, f"dec_up{i}")(h, up)
            skip = skips[-(i + 2)]
            h = zero_pad_to(h, skip.shape[-3], skip.shape[-2], up, rows[self.depth - 2 - i])
            if self.fusion_mode == "sum":
                h = h + getattr(self, f"fuse_scale{i}")(skip)
            else:
                h = torch.cat([h, skip], dim=-1)
            h = getattr(self, f"dec_conv{i}")(h, rows[self.depth - 2 - i])
        h = self.post(h, rows[0])
        new_feat = h.float() if self.feature_rec else None
        return conv1x1_nhwc(self.post_final, h).float(), new_feat
