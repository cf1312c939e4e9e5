"""ConvUNet ('convunet'): plain conv U-Nets with optional feature recurrence
(port of rvdd_tpu/models/unet.py:ConvUNet as an nn.Module).

Parameters carry the flax module names (``pre``, ``enc_conv0.conv0``,
``enc_down0``, ``bottleneck0``, ``dec_up0``, ``dec_conv0.conv0``, ``post0``,
``post_final``) so models/convert.py maps them one to one.  ``forward``
takes and returns NHWC: ``(x [B, H, W, Cin], feat [B, H, W, F] or None) ->
(y [B, H, W, Cout] fp32, new_feat [B, H, W, F] fp32 or None)``, where
``new_feat`` is the activation before the final 1x1 conv.

The ablation knobs of rvdd_tpu's ConvUNet (rvdd_tpu/models/unet.py:45-80,
160-287), with its parameters:

* ``downsampling_mode``: ``convmax`` (a conv with no activation, then a 2x2
  max pool; the default), ``convavg`` (the same with an average pool),
  ``maxpool`` (no conv), ``stridedconv`` (a 2x2 conv of stride 2, flax's
  'SAME' padding);
* ``upsampling_mode``: ``bilinear`` (align_corners=False; the default),
  ``nearest``, ``transposedconv<k>`` (k = 2 when absent): the parameters
  ``up_transposed{i}_kernel`` [k, k, ch, ch] in flax's HWIO layout and
  ``up_transposed{i}_bias``, applied as ``nn.ConvTranspose2d(ch, ch, k,
  stride=2, padding=(k-1)//2)`` with the weight ``kernel.permute(2, 3, 0,
  1)``;
* ``activation``: ``relu`` (the default; any name but ``silu``) or ``silu``;
* ``normalization`` after each conv but the bottleneck's, the
  downsampling's and the last: ``none``, ``instance`` (no affine, eps
  1e-5) or ``batch`` (batch statistics over N, H, W in training and in eval
  alike, no running statistics, eps 1e-5, with the affine parameters
  ``{conv}_bn_scale`` and ``{conv}_bn_offset`` on the module that calls the
  conv: ``enc_conv0.conv0_bn_scale``, ``dec_up0_bn_offset``, ...);
* ``bottleneck_dilation``: bottleneck conv i dilated (and padded) by 2^i;
* ``use_bias=False``: no conv has a bias;
* ``residual``: the output is ``x[..., 4:] - y``.

On a shard of the mesh's space axis (parallel/space.py:scope) each level
runs on this process's rows: a 3x3 conv reads ``dilation`` rows of its
neighbours on each side (zeros beyond the sample) and runs unpadded in H,
a transposed conv reads the rows its taps reach and keeps its own output
rows, the pools and ``stridedconv`` stay local (the row cut is aligned to
the levels), ``zero_pad_to`` centres in the sample's height, instance norm
takes its statistics over the sample's shards and batch norm over the
whole mesh (also under a data axis alone).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from rvdd_tpu_torch.ops.resize import (
    avgpool2x2,
    maxpool2x2,
    upsample2x_bilinear,
    upsample2x_nearest,
)
from rvdd_tpu_torch.parallel import space
from rvdd_tpu_torch.parallel.space import Rows

DOWNSAMPLING = ("convmax", "convavg", "maxpool", "stridedconv")
NORMALIZATIONS = (None, "none", "instance", "batch")


def zero_pad_to(x: torch.Tensor, h: int, w: int, rows: Optional[Rows] = None,
                out_rows: Optional[Rows] = None) -> torch.Tensor:
    """Center an NHWC feature map in a zero canvas of (h, w).  On a shard,
    ``rows`` are x's and ``out_rows`` the canvas's (``h`` is then the
    shard's own rows of it)."""
    dw = (w - x.shape[-2]) // 2
    if rows is not None:
        dh = (out_rows.height - rows.height) // 2
        x = space.window(x, rows, [(a - dh, b - dh) for a, b in out_rows.bounds], "zero")
        return F.pad(x, (0, 0, dw, w - x.shape[-2] - dw))
    dh = (h - x.shape[-3]) // 2
    return F.pad(x, (0, 0, dw, w - x.shape[-2] - dw, dh, h - x.shape[-3] - dh))


def conv2d(conv: nn.Conv2d, x: torch.Tensor, rows: Optional[Rows] = None) -> torch.Tensor:
    """``conv(x)`` on NCHW x; on a shard a 'same' stride-1 conv reads its
    padding's rows of the neighbours (zeros beyond the sample) and runs
    unpadded in H."""
    if rows is None:
        return conv(x)
    ph, pw = conv.padding
    if conv.stride[0] != 1:
        raise ValueError(f"a conv of stride {conv.stride} on a shard of rows")
    xh = space.halo(x, rows, ph, ph, "zero", dim=-2)
    return F.conv2d(xh, conv.weight, conv.bias, conv.stride, (0, pw), conv.dilation,
                    conv.groups)


def _conv3(cin: int, cout: int, bias: bool = True, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation, bias=bias)


def _activation(name: str):
    return F.silu if name == "silu" else torch.relu


def _add_norm_params(mod: nn.Module, kind, name: str, c: int) -> None:
    """Register the affine parameters of batch normalization after the conv
    ``name`` on ``mod`` (flax: ``mod.param(f"{name}_bn_scale")``)."""
    if kind == "batch":
        mod.register_parameter(f"{name}_bn_scale", nn.Parameter(torch.ones(c)))
        mod.register_parameter(f"{name}_bn_offset", nn.Parameter(torch.zeros(c)))


def _stats_group(kind, rows: Optional[Rows]):
    """The group the statistics of ``kind`` span beyond this process's
    rows: instance norm's a sample's shards, batch norm's the whole mesh
    (the active scope's); None: this process's own."""
    if kind == "instance":
        return None if rows is None else rows.group
    sc = space.active()
    return None if sc is None else sc.batch_group


def _moments(x: torch.Tensor, dims, group):
    """Mean and biased variance over ``dims`` and over ``group``: the
    sums and the count in one all-reduce, then the squared deviations from
    the mean in another (two passes, as the single-process code), in fp32."""
    xf = x.float()
    s = xf.sum(dim=dims, keepdim=True)
    count = xf.numel() // s.numel()
    both = space.all_sum(torch.cat([s.reshape(-1), s.new_full((1,), count)]), group)
    count = both[-1]
    mean = (both[:-1] / count).reshape(s.shape)
    var = space.all_sum((xf - mean).square().sum(dim=dims, keepdim=True), group) / count
    return mean.to(x.dtype), var.to(x.dtype)


def _normalize(x: torch.Tensor, kind, mod: nn.Module, name: str,
               rows: Optional[Rows] = None) -> torch.Tensor:
    """The conv -> norm -> act slot on NCHW ``x`` (rvdd_tpu/models/unet.py:
    _normalize): biased variances, eps 1e-5; ``rows``: x's on a shard."""
    if kind in (None, "none"):
        return x
    dims = (2, 3) if kind == "instance" else (0, 2, 3)
    group = _stats_group(kind, rows)
    if group is None:
        mean = x.mean(dim=dims, keepdim=True)
        var = (x - mean).square().mean(dim=dims, keepdim=True)
    else:
        mean, var = _moments(x, dims, group)
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    if kind == "instance":
        return y
    scale = getattr(mod, f"{name}_bn_scale")
    offset = getattr(mod, f"{name}_bn_offset")
    return y * scale[:, None, None] + offset[:, None, None]


class NConvBlock(nn.Module):
    """n x (3x3 conv + norm + activation), parameters conv0, conv1, ..."""

    def __init__(self, cin: int, features: int, n_blocks: int = 2, activation: str = "relu",
                 use_bias: bool = True, normalization: Optional[str] = "none"):
        super().__init__()
        for j in range(n_blocks):
            self.add_module(f"conv{j}", _conv3(cin if j == 0 else features, features, use_bias))
            _add_norm_params(self, normalization, f"conv{j}", features)
        self.n_blocks = n_blocks
        self.act = _activation(activation)
        self.normalization = normalization

    def forward(self, x, rows: Optional[Rows] = None):
        for j in range(self.n_blocks):
            x = conv2d(getattr(self, f"conv{j}"), x, rows)
            x = self.act(_normalize(x, self.normalization, self, f"conv{j}", rows))
        return x


class ConvUNet(nn.Module):
    """U-Net with conv(+pool) downsampling and an upsampling decoder."""

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
        if downsampling_mode not in DOWNSAMPLING:
            raise NotImplementedError(f"downsampling_mode {downsampling_mode}")
        if normalization not in NORMALIZATIONS:
            raise NotImplementedError(f"normalization '{normalization}'")
        up_k = self._transposed_k(upsampling_mode)
        if up_k is None and upsampling_mode not in ("bilinear", "nearest"):
            raise NotImplementedError(f"upsampling_mode {upsampling_mode}")
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
        self.act = _activation(activation)
        norm, bias = normalization, use_bias

        if feature_rec:
            self.pre = _conv3(in_channels, filters, bias)
            cin = 2 * filters
        else:
            cin = in_channels
        for i in range(depth):
            f = self._enc_features(i)
            self.add_module(f"enc_conv{i}", NConvBlock(cin, f, n_blocks_encoder, activation,
                                                       bias, norm))
            if i < depth - 1 and downsampling_mode in ("convmax", "convavg"):
                self.add_module(f"enc_down{i}", _conv3(f, f, bias))
            elif i < depth - 1 and downsampling_mode == "stridedconv":
                self.add_module(f"enc_down{i}", nn.Conv2d(f, f, 2, stride=2, bias=bias))
            cin = f
        fb = self._enc_features(depth - 1)
        for i in range(bottleneck_depth):
            dil = 2**i if bottleneck_dilation else 1
            self.add_module(f"bottleneck{i}", _conv3(fb, fb, bias, dil))
        d = fb
        for i in range(depth - 1):
            f = self._enc_features(depth - 2 - i)
            if up_k is not None:
                kernel = torch.randn(up_k, up_k, d, d) * (up_k * up_k * d) ** -0.5
                self.register_parameter(f"up_transposed{i}_kernel", nn.Parameter(kernel))
                if bias:
                    self.register_parameter(f"up_transposed{i}_bias",
                                            nn.Parameter(torch.zeros(d)))
            self.add_module(f"dec_up{i}", _conv3(d, f, bias))
            _add_norm_params(self, norm, f"dec_up{i}", f)
            self.add_module(f"dec_conv{i}", NConvBlock(2 * f, f, n_blocks_decoder, activation,
                                                       bias, norm))
            d = f
        for i in range(post_depth - 1):
            self.add_module(f"post{i}", _conv3(d, filters, bias))
            _add_norm_params(self, norm, f"post{i}", filters)
            d = filters
        self.post_final = nn.Conv2d(d, out_channels, 1, bias=bias)

    @staticmethod
    def _transposed_k(mode: str) -> Optional[int]:
        """k of ``transposedconv<k>`` (2 when absent), else None."""
        if mode[:14].lower() != "transposedconv":
            return None
        return int(mode[14:]) if len(mode) > 14 else 2

    def _enc_features(self, i: int) -> int:
        return self.filters if self.fixed_features else self.filters * 2**i

    def nil_features(self, batch: int, h: int, w: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
        """Zero recurrent feature state [batch, h, w, filters]."""
        if device is None:
            device = self.post_final.weight.device
        return torch.zeros(batch, h, w, self.filters, dtype=dtype, device=device)

    def _downsample(self, h: torch.Tensor, i: int, rows: Optional[Rows] = None):
        """NCHW in and out; on a shard each shard pools its own rows (its
        cut is even, and only the last shard can end on an odd row)."""
        mode = self.downsampling_mode
        if mode == "stridedconv":
            # flax's 'SAME' for a 2x2 window of stride 2: one row (column)
            # after an odd size, none before
            h = F.pad(h, (0, h.shape[-1] % 2, 0, h.shape[-2] % 2))
            return getattr(self, f"enc_down{i}")(h)
        if mode in ("convmax", "convavg"):
            h = conv2d(getattr(self, f"enc_down{i}"), h, rows)
        pool = avgpool2x2 if mode == "convavg" else maxpool2x2
        return pool(h.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def _up_rows(self, rows: Optional[Rows]) -> Optional[Rows]:
        """The rows of :meth:`_upsample`'s output on a shard (``rows``: its
        input's): twice them, and ``transposedconv<k>``'s sample is
        2(h - 1) - 2p + k rows tall."""
        if rows is None:
            return None
        k = self._transposed_k(self.upsampling_mode)
        if k is None:
            return rows.scale(2)
        return rows.scale(2).with_height(2 * (rows.height - 1) - 2 * ((k - 1) // 2) + k)

    def _upsample(self, d: torch.Tensor, i: int, rows: Optional[Rows] = None) -> torch.Tensor:
        """NCHW in and out; on a shard (``rows``: d's) the output holds the
        rows of :meth:`_up_rows`."""
        k = self._transposed_k(self.upsampling_mode)
        if k is not None:
            w = getattr(self, f"up_transposed{i}_kernel").permute(2, 3, 0, 1)
            b = getattr(self, f"up_transposed{i}_bias", None)
            p = (k - 1) // 2
            if rows is None:
                return F.conv_transpose2d(d, w, b, stride=2, padding=p)
            # output row y takes input rows (y + p - j) / 2 for taps j < k:
            # (k - 1 - p) // 2 rows above this shard's, (p + 1) // 2 below
            lo = (k - 1 - p) // 2
            y = F.conv_transpose2d(space.halo(d, rows, lo, (p + 1) // 2, "zero", dim=-2), w, b,
                                   stride=2, padding=(0, p))
            out = self._up_rows(rows)
            off = out.start - 2 * (rows.start - lo) + p
            return y[:, :, off:off + out.n]
        nhwc = d.permute(0, 2, 3, 1)
        if self.upsampling_mode == "nearest":
            return upsample2x_nearest(nhwc).permute(0, 3, 1, 2)
        return upsample2x_bilinear(nhwc, align_corners=False, rows=rows).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, feat: Optional[torch.Tensor] = None):
        to_nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        to_nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        norm = self.normalization
        # this shard's rows at each level (None: the whole sample)
        rows = [space.rows_of(x)]
        for _ in range(self.depth - 1):
            rows.append(None if rows[-1] is None
                        else rows[-1].down(ceil=self.downsampling_mode == "stridedconv"))
        if self.feature_rec:
            if feat is None:
                raise ValueError("feature-recurrent net needs a feat input")
            y = conv2d(self.pre, to_nchw(x), rows[0])
            h = torch.cat([y, to_nchw(feat)], dim=1)
        else:
            h = to_nchw(x)

        skips = []
        for i in range(self.depth):
            h = getattr(self, f"enc_conv{i}")(h, rows[i])
            skips.append(h)
            if i < self.depth - 1:
                h = self._downsample(h, i, rows[i])

        # bottleneck with a running residual sum; no norm in the bottleneck
        d = skips[-1]
        s = d
        for i in range(self.bottleneck_depth):
            d = self.act(conv2d(getattr(self, f"bottleneck{i}"), d, rows[-1]))
            s = s + d
        d = s

        for i in range(self.depth - 1):
            skip = skips[self.depth - 2 - i]
            low = rows[self.depth - 1 - i]
            d, up_rows = self._upsample(d, i, low), self._up_rows(low)
            d = conv2d(getattr(self, f"dec_up{i}"), d, up_rows)
            d = self.act(_normalize(d, norm, self, f"dec_up{i}", up_rows))
            d = to_nchw(zero_pad_to(to_nhwc(d), skip.shape[-2], skip.shape[-1], up_rows,
                                    rows[self.depth - 2 - i]))
            d = torch.cat([skip, d], dim=1)  # [skip, d], as rvdd_tpu
            d = getattr(self, f"dec_conv{i}")(d, rows[self.depth - 2 - i])

        for i in range(self.post_depth - 1):
            d = conv2d(getattr(self, f"post{i}"), d, rows[0])
            d = self.act(_normalize(d, norm, self, f"post{i}", rows[0]))
        new_feat = to_nhwc(d).float() if self.feature_rec else None
        y = to_nhwc(self.post_final(d)).float()
        if self.residual:
            # the first 4 input channels are raw (rvdd_tpu/models/unet.py:232-235)
            y = x[..., 4:] - y
        return y, new_feat
