"""ConvUNet ('convunet'): plain conv U-Nets with optional feature recurrence
(port of rvdd_tpu/models/unet.py:ConvUNet as an nn.Module).

Parameters carry the flax module names (``pre``, ``enc_conv0.conv0``,
``enc_down0``, ``bottleneck0``, ``dec_up0``, ``dec_conv0.conv0``, ``post0``,
``post_final``) so models/convert.py maps them one to one.  ``forward``
takes and returns NHWC: ``(x [B, H, W, Cin], feat [B, H, W, F] or None) ->
(y [B, H, W, Cout] fp32, new_feat [B, H, W, F] fp32 or None)``, where
``new_feat`` is the activation before the final 1x1 conv.

Supported: convmax downsampling (a conv with no activation, then a 2x2 max
pool), bilinear align_corners=False upsampling, relu, no normalization,
bias, fixed or doubling features, any depth.  The other ablation knobs of
rvdd_tpu's ConvUNet raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from rvdd_tpu_torch.ops.resize import maxpool2x2, upsample2x_bilinear


def zero_pad_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Center an NHWC feature map in a zero canvas of (h, w)."""
    dh = (h - x.shape[-3]) // 2
    dw = (w - x.shape[-2]) // 2
    return F.pad(x, (0, 0, dw, w - x.shape[-2] - dw, dh, h - x.shape[-3] - dh))


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class NConvBlock(nn.Module):
    """n x (3x3 conv + relu), parameters conv0, conv1, ..."""

    def __init__(self, cin: int, features: int, n_blocks: int = 2):
        super().__init__()
        for j in range(n_blocks):
            self.add_module(f"conv{j}", _conv3(cin if j == 0 else features, features))
        self.n_blocks = n_blocks

    def forward(self, x):
        for j in range(self.n_blocks):
            x = torch.relu(getattr(self, f"conv{j}")(x))
        return x


class ConvUNet(nn.Module):
    """U-Net with conv+maxpool downsampling and a bilinear-up decoder."""

    def __init__(self, in_channels: int, out_channels: int, filters: int = 48,
                 depth: int = 4, bottleneck_depth: int = 2, post_depth: int = 2,
                 n_blocks_encoder: int = 2, n_blocks_decoder: int = 2,
                 downsampling_mode: str = "convmax",
                 upsampling_mode: str = "bilinear", activation: str = "relu",
                 normalization: Optional[str] = "none",
                 bottleneck_dilation: bool = False, use_bias: bool = True,
                 residual: bool = False, fixed_features: bool = True,
                 feature_rec: bool = False):
        super().__init__()
        unsupported = {
            "downsampling_mode": downsampling_mode != "convmax",
            "upsampling_mode": upsampling_mode != "bilinear",
            "activation": activation != "relu",
            "normalization": normalization not in (None, "none"),
            "bottleneck_dilation": bool(bottleneck_dilation),
            "use_bias": not use_bias,
            "residual": bool(residual),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"ConvUNet: {bad} not ported (see ROADMAP.md)")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.filters = filters
        self.depth = depth
        self.bottleneck_depth = bottleneck_depth
        self.post_depth = post_depth
        self.n_blocks_encoder = n_blocks_encoder
        self.n_blocks_decoder = n_blocks_decoder
        self.downsampling_mode = downsampling_mode
        self.upsampling_mode = upsampling_mode
        self.activation = activation
        self.normalization = normalization
        self.bottleneck_dilation = bottleneck_dilation
        self.use_bias = use_bias
        self.residual = residual
        self.fixed_features = fixed_features
        self.feature_rec = feature_rec

        if feature_rec:
            self.pre = _conv3(in_channels, filters)
            cin = 2 * filters
        else:
            cin = in_channels
        for i in range(depth):
            f = self._enc_features(i)
            self.add_module(f"enc_conv{i}", NConvBlock(cin, f, n_blocks_encoder))
            if i < depth - 1:
                self.add_module(f"enc_down{i}", _conv3(f, f))
            cin = f
        fb = self._enc_features(depth - 1)
        for i in range(bottleneck_depth):
            self.add_module(f"bottleneck{i}", _conv3(fb, fb))
        d = fb
        for i in range(depth - 1):
            f = self._enc_features(depth - 2 - i)
            self.add_module(f"dec_up{i}", _conv3(d, f))
            self.add_module(f"dec_conv{i}", NConvBlock(2 * f, f, n_blocks_decoder))
            d = f
        for i in range(post_depth - 1):
            self.add_module(f"post{i}", _conv3(d, filters))
            d = filters
        self.post_final = nn.Conv2d(d, out_channels, 1)

    def _enc_features(self, i: int) -> int:
        return self.filters if self.fixed_features else self.filters * 2**i

    def nil_features(self, batch: int, h: int, w: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
        """Zero recurrent feature state [batch, h, w, filters]."""
        if device is None:
            device = self.post_final.weight.device
        return torch.zeros(batch, h, w, self.filters, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, feat: Optional[torch.Tensor] = None):
        to_nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        to_nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        if self.feature_rec:
            if feat is None:
                raise ValueError("feature-recurrent net needs a feat input")
            y = self.pre(to_nchw(x))
            h = torch.cat([y, to_nchw(feat)], dim=1)
        else:
            h = to_nchw(x)

        skips = []
        for i in range(self.depth):
            h = getattr(self, f"enc_conv{i}")(h)
            skips.append(h)
            if i < self.depth - 1:
                # convmax: a conv with no activation, then the 2x2 max pool
                h = getattr(self, f"enc_down{i}")(h)
                h = to_nchw(maxpool2x2(to_nhwc(h)))

        d = skips[-1]
        s = d
        for i in range(self.bottleneck_depth):
            d = torch.relu(getattr(self, f"bottleneck{i}")(d))
            s = s + d
        d = s

        for i in range(self.depth - 1):
            skip = skips[self.depth - 2 - i]
            d = to_nchw(upsample2x_bilinear(to_nhwc(d), align_corners=False))
            d = torch.relu(getattr(self, f"dec_up{i}")(d))
            d = to_nchw(zero_pad_to(to_nhwc(d), skip.shape[-2], skip.shape[-1]))
            d = torch.cat([skip, d], dim=1)  # [skip, d], as rvdd_tpu
            d = getattr(self, f"dec_conv{i}")(d)

        for i in range(self.post_depth - 1):
            d = torch.relu(getattr(self, f"post{i}")(d))
        new_feat = to_nhwc(d).float() if self.feature_rec else None
        y = to_nhwc(self.post_final(d)).float()
        return y, new_feat
