"""Plain fp32 PyTorch of the two nets the benchmark runs, frozen.

* :class:`ConvUNet`: the RVDD reference's networks/unet.py as its
  ``convunet-mode=fixedfeatures+feat`` script runs it: 48 filters at every
  level, depth 4, two 3x3 convs a level, a 3x3 conv before each 2x2 max
  pool, a two-conv bottleneck with a running residual sum, bilinear x2
  upsampling (align_corners=False), ReLU, no normalization, a 3x3 ``pre``
  conv of the input concatenated with the recurrent features, and the
  activation before the final 1x1 conv returned as the next features.
* :class:`ConvNeXtUNet`: networks/new_unet.py (``newunet-mode=feat``):
  ConvNeXt blocks ``x + layerscale * pw2(GELU(pw1(LN(dw7x7(proj(x))))))``,
  48 channels, depth 4, two blocks a stage, 2x2 max pools, bilinear x2
  upsampling (align_corners=True), ``[up, skip]`` concatenation, the erf
  GELU and a channel LayerNorm (eps 1e-6, biased variance).

Parameter names and shapes are the program's, so one set of weight tensors
loads into both.  Every module takes and returns NHWC; ``forward(x, feat)``
returns ``(out, new_feat)``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100_bench.reference.ops import maxpool2x2, upsample2x


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _pad_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Centre NHWC x in a zero canvas of (h, w)."""
    dh, dw = (h - x.shape[-3]) // 2, (w - x.shape[-2]) // 2
    return F.pad(x, (0, 0, dw, w - x.shape[-2] - dw, dh, h - x.shape[-3] - dh))


class Block(nn.Module):
    """A block whose activations can be recomputed in the backward
    (``recompute``: the same gradients in the memory of one block)."""

    recompute = False

    def forward(self, x):
        if self.recompute and torch.is_grad_enabled():
            return checkpoint(self.body, x, use_reentrant=False)
        return self.body(x)


def recompute_blocks(net: nn.Module, on: bool = True) -> nn.Module:
    """Recompute every block of ``net`` in the backward (or not)."""
    for m in net.modules():
        if isinstance(m, Block):
            m.recompute = on
    return net


class NConv(Block):
    """n x (3x3 conv + ReLU), parameters conv0, conv1, ..."""

    def __init__(self, cin: int, f: int, n: int):
        super().__init__()
        self.n = n
        for j in range(n):
            self.add_module(f"conv{j}", nn.Conv2d(cin if j == 0 else f, f, 3, padding=1))

    def body(self, x):  # NCHW
        for j in range(self.n):
            x = torch.relu(getattr(self, f"conv{j}")(x))
        return x


class ConvUNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, filters: int = 48, depth: int = 4,
                 bottleneck_depth: int = 2, post_depth: int = 2, n_blocks: int = 2,
                 feature_rec: bool = True):
        super().__init__()
        self.depth, self.bottleneck_depth, self.post_depth = depth, bottleneck_depth, post_depth
        self.filters, self.feature_rec = filters, feature_rec
        f = filters
        if feature_rec:
            self.pre = nn.Conv2d(in_channels, f, 3, padding=1)
        cin = 2 * f if feature_rec else in_channels
        for i in range(depth):
            self.add_module(f"enc_conv{i}", NConv(cin, f, n_blocks))
            if i < depth - 1:
                self.add_module(f"enc_down{i}", nn.Conv2d(f, f, 3, padding=1))
            cin = f
        for i in range(bottleneck_depth):
            self.add_module(f"bottleneck{i}", nn.Conv2d(f, f, 3, padding=1))
        for i in range(depth - 1):
            self.add_module(f"dec_up{i}", nn.Conv2d(f, f, 3, padding=1))
            self.add_module(f"dec_conv{i}", NConv(2 * f, f, n_blocks))
        for i in range(post_depth - 1):
            self.add_module(f"post{i}", nn.Conv2d(f, f, 3, padding=1))
        self.post_final = nn.Conv2d(f, out_channels, 1)

    def forward(self, x, feat=None):
        h = _nchw(x)
        if self.feature_rec:
            h = torch.cat([self.pre(h), _nchw(feat)], dim=1)
        skips = []
        for i in range(self.depth):
            h = getattr(self, f"enc_conv{i}")(h)
            skips.append(h)
            if i < self.depth - 1:
                h = _nchw(maxpool2x2(_nhwc(getattr(self, f"enc_down{i}")(h))))
        d = s = skips[-1]
        for i in range(self.bottleneck_depth):
            d = torch.relu(getattr(self, f"bottleneck{i}")(d))
            s = s + d
        d = s
        for i in range(self.depth - 1):
            skip = skips[self.depth - 2 - i]
            d = _nchw(upsample2x(_nhwc(d), align_corners=False))
            d = torch.relu(getattr(self, f"dec_up{i}")(d))
            d = _nchw(_pad_to(_nhwc(d), skip.shape[-2], skip.shape[-1]))
            d = getattr(self, f"dec_conv{i}")(torch.cat([skip, d], dim=1))
        for i in range(self.post_depth - 1):
            d = torch.relu(getattr(self, f"post{i}")(d))
        new_feat = _nhwc(d) if self.feature_rec else None
        return _nhwc(self.post_final(d)), new_feat


class ChannelLayerNorm(nn.Module):
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
    def __init__(self, features: int, init: float = 0.1):
        super().__init__()
        self.layerscale = nn.Parameter(torch.full((features,), init))

    def forward(self, x):
        return x * self.layerscale


def _pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv on NHWC, as a product over the channel axis."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class ConvNeXtBlock(Block):
    def __init__(self, cin: int, f: int, k: int = 7):
        super().__init__()
        self.has_proj = cin != f
        if self.has_proj:
            self.proj = nn.Conv2d(cin, f, 1)
        self.dw = nn.Conv2d(f, f, k, padding=k // 2, groups=f)
        self.ln = ChannelLayerNorm(f)
        self.pw1 = nn.Conv2d(f, 4 * f, 1)
        self.pw2 = nn.Conv2d(4 * f, f, 1)
        self.layerscale = LayerScale(f)

    def body(self, x):  # NHWC
        if self.has_proj:
            x = _pointwise(self.proj, x)
        h = self.ln(_nhwc(self.dw(_nchw(x))))
        h = _pointwise(self.pw2, F.gelu(_pointwise(self.pw1, h)))
        return x + self.layerscale(h)


class NBlocks(nn.Module):
    def __init__(self, cin: int, f: int, n: int):
        super().__init__()
        self.n = n
        for j in range(n):
            self.add_module(f"block{j}", ConvNeXtBlock(cin if j == 0 else f, f))

    def forward(self, x):
        for j in range(self.n):
            x = getattr(self, f"block{j}")(x)
        return x


class ConvNeXtUNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, filters: int = 48, depth: int = 4,
                 n_blocks: int = 2, feature_rec: bool = True):
        super().__init__()
        self.depth, self.filters, self.feature_rec = depth, filters, feature_rec
        f = filters
        if feature_rec:
            self.pre = NBlocks(in_channels, f, 1)
        for i in range(depth):
            cin = (2 * f if feature_rec else in_channels) if i == 0 else f
            self.add_module(f"enc_conv{i}", NBlocks(cin, f, n_blocks))
            if i < depth - 1:
                self.add_module(f"enc_down{i}", ConvNeXtBlock(f, f))
        self.bottleneck = NBlocks(f, f, n_blocks)
        for i in range(depth - 1):
            self.add_module(f"dec_up{i}", ConvNeXtBlock(f, f))
            self.add_module(f"dec_conv{i}", NBlocks(2 * f, f, n_blocks))
        self.post = NBlocks(f, f, n_blocks)
        self.post_final = nn.Conv2d(f, out_channels, 1)

    def forward(self, x, feat=None):
        h = torch.cat([self.pre(x), feat], dim=-1) if self.feature_rec else x
        skips = []
        for i in range(self.depth):
            h = getattr(self, f"enc_conv{i}")(h)
            skips.append(h)
            if i < self.depth - 1:
                h = getattr(self, f"enc_down{i}")(maxpool2x2(h))
        h = self.bottleneck(h)
        for i in range(self.depth - 1):
            h = getattr(self, f"dec_up{i}")(upsample2x(h, align_corners=True))
            skip = skips[-(i + 2)]
            h = torch.cat([_pad_to(h, skip.shape[-3], skip.shape[-2]), skip], dim=-1)
            h = getattr(self, f"dec_conv{i}")(h)
        h = self.post(h)
        return _pointwise(self.post_final, h), (h if self.feature_rec else None)


#: config "family" -> the reference net's class
FAMILIES = {"convunet": ConvUNet, "convnext": ConvNeXtUNet}


def build(cfg: dict, device="cpu") -> nn.Module:
    """The reference net of a configuration file's ``net`` entry, with the
    constructor's (placeholder) weights; load the benchmark's weights into
    it with ``load_state_dict``."""
    net = cfg["net"]
    kw = {k: v for k, v in net.items() if k not in ("family", "arch")}
    with torch.device(device):
        return FAMILIES[net["family"]](**kw)
