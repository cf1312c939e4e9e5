"""Recurrent denoising engine, streaming-inference subset (port of
rvdd_tpu/recurrent/engine.py).

    frames, flows = prepare_frames(cfg, raw_window, raw_flows)
    den, state = inference_step(cfg, net, None, frames, flows[:, 0], nil)
    den, state = inference_step(cfg, net, state, frames, flows[:, 0], nil)

Frames are stacked on a time axis ([B, T, H, W, C]); flows are
[B, D+fD, H, W, 2] for one step.  The recurrence state is an explicit value
the caller carries.

Two step implementations, chosen by ``EngineConfig.net_impl``:

* ``'module'``: the generic path; the ConvUNet module in fp32 with the warp
  chosen by ``warp_impl`` (``'plain'`` PyTorch, or ``'kernel'``, the CUDA
  warp, which on CPU tensors runs its plain version);
* ``'fused'``: the main path; the 56-channel fp32 state
  ``[den 3 | zero 5 | feat 48]`` is warped by the CUDA warp kernel and fed
  to the CUDA chains of the net's family (six ``conv_chain`` chains for
  ConvUNet, seven ``convnext_chain`` chains for ConvNeXtUNet), whose last
  one writes the next state.  With ``future_patch_depth=1`` the future frame is warped by the
  same CUDA warp and joins the net input.  ``fused_precision`` picks the
  chains' numerics from the presets of the net's family
  (models/fast_unet.py:FUSED_PRECISIONS for ConvUNet,
  models/fast_convnext.py:CNX_PRECISIONS for ConvNeXtUNet); the warps and
  the frame inputs run in its glue dtype (bf16, or fp32).

Online flow: ``compute_window_flows`` computes a window's flows on the
device with the TV-L1 solver (ops/tvl1.py; on CUDA tensors its warp is
always the CUDA kernel ``warp_catmull_zero``, on either path), so a video can be
denoised without a precomputed flow cache.  The solver is plain PyTorch
around that kernel, a host loop of small launches with one read of the
convergence measure an iteration, so its launches, not the card's
arithmetic, bound it (PERF.md).

Training (``unrolled_forward``, ``compute_losses``) and ``scan_video`` wait
for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

from rvdd_tpu_torch.models.convnext_unet import ConvNeXtUNet
from rvdd_tpu_torch.models.fast_convnext import (
    cnx_precision,
    fast_forward_cnx,
    pack_fast_cnx,
    supports_fast_path_cnx,
)
from rvdd_tpu_torch.models.fast_unet import (
    fast_forward,
    get_fused_precision,
    glue_dtype,
    pack_fast_params,
    supports_fast_path,
)
from rvdd_tpu_torch.ops.bayer import remosaic
from rvdd_tpu_torch.ops.cuda.warp_bicubic import warp_bicubic
from rvdd_tpu_torch.ops.demosaic import hamilton_adams
from rvdd_tpu_torch.ops.tvl1 import TVL1Params, to_gray, tvl1_flow
from rvdd_tpu_torch.ops.warp import flow_upsample_2x, warp

#: channels of the fused recurrence state: [den 3 | zero 5 | feat 48]
STATE_DEN = 3
STATE_FEAT_OFF = 8
STATE_FEAT = 48


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    model_patch_depth: int = 2  # D+1: previous frames + current
    future_patch_depth: int = 0  # fD
    input_nc: int = 3
    output_nc: int = 3
    no_warp: bool = False
    no_predemosaic: bool = False
    warp_raw: bool = False
    prev_noisy_frame: bool = False
    feature_rec: bool = False
    #: 'plain' (PyTorch) or 'kernel' (the CUDA warp) for the module path
    warp_impl: str = "plain"
    #: carried state dtype: 'float32' (the production default) or 'bfloat16'
    #: (module path only)
    state_dtype: str = "float32"
    #: 'module' (the net's forward) or 'fused' (the CUDA chains)
    net_impl: str = "module"
    #: fused-path preset of the net's family (ConvUNet:
    #: models/fast_unet.py:FUSED_PRECISIONS or 'hybrid:<chains>'; ConvNeXtUNet:
    #: models/fast_convnext.py:CNX_PRECISIONS)
    fused_precision: str = "fast"

    @property
    def d(self) -> int:
        return self.model_patch_depth - 1

    @property
    def network_input_nc(self) -> int:
        return (self.model_patch_depth + self.future_patch_depth) * self.input_nc


class RecurrentState(NamedTuple):
    """Module path: ring buffer of D previous outputs [B, D, H, W, C] and
    feature maps [B, D, H, W, F] (or None).  Fused path: ``lastden`` holds
    the combined state [B, H, W, 8 (+48)] fp32 and ``feat`` is None."""

    lastden: torch.Tensor
    feat: Optional[torch.Tensor]


def prepare_frames(cfg: EngineConfig, raw_frames: torch.Tensor,
                   flows: Optional[torch.Tensor]):
    """raw_frames [B, T, h, w, 4] packed raw -> demosaicked RGB
    [B, T, 2h, 2w, 3]; flows [B, TD, D+fD, h, w, 2] -> x2 upsampled and
    scaled, unless no_predemosaic."""
    if cfg.no_predemosaic:
        return raw_frames, flows
    t = raw_frames.shape[1]
    rgb = torch.stack([hamilton_adams(raw_frames[:, i]) for i in range(t)], dim=1)
    if flows is not None and not cfg.warp_raw:
        bt, td, dd, fh, fw, _ = flows.shape
        flows = flow_upsample_2x(flows.reshape(bt * td * dd, fh, fw, 2))
        flows = flows.reshape(bt, td, dd, 2 * fh, 2 * fw, 2)
    return rgb, flows


def _warp(cfg: EngineConfig, x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    if cfg.warp_impl == "kernel":
        return warp_bicubic(x.float().contiguous(), flow.float().contiguous(),
                            out_dtype=torch.float32)
    if cfg.warp_impl != "plain":
        raise ValueError(f"unknown warp_impl {cfg.warp_impl!r}")
    return warp(x, flow, "bicubic")[0]


def _warp_frame(cfg: EngineConfig, frame: torch.Tensor, flow: Optional[torch.Tensor]):
    if cfg.no_warp or flow is None:
        return frame
    if (not cfg.no_predemosaic) and cfg.warp_raw:
        return hamilton_adams(_warp(cfg, remosaic(frame), flow))
    return _warp(cfg, frame, flow)


def _state_dtype(cfg: EngineConfig):
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def _check_fused(cfg: EngineConfig, net=None) -> None:
    """The fused path's knobs, and the preset against the presets of the
    net's family (ConvUNet's where no net is given)."""
    bad = {
        "model_patch_depth != 2": cfg.d != 1,
        "no_warp": cfg.no_warp,
        "warp_raw": cfg.warp_raw,
        "no_predemosaic": cfg.no_predemosaic,
        "prev_noisy_frame": cfg.prev_noisy_frame,
        "output_nc != 3": cfg.output_nc != 3,
        "state_dtype != float32": cfg.state_dtype != "float32",
    }
    what = [k for k, v in bad.items() if v]
    if what:
        raise NotImplementedError(f"net_impl='fused' does not support {what} yet (ROADMAP.md)")
    _fused_glue_dtype(cfg, net)


def _fused_glue_dtype(cfg: EngineConfig, net) -> torch.dtype:
    """The dtype of the warped state window, the current frame and the
    warped future frames under the net family's preset
    (rvdd_tpu/recurrent/engine.py:215-218); raises for a preset the family
    does not have."""
    if isinstance(net, ConvNeXtUNet):
        return cnx_precision(cfg.fused_precision)["glue"]
    return glue_dtype(get_fused_precision(cfg.fused_precision))


def _fused_state_c(cfg: EngineConfig) -> int:
    return STATE_FEAT_OFF + (STATE_FEAT if cfg.feature_rec else 0)


def init_state(cfg: EngineConfig, frames: torch.Tensor, nil_feat=None,
               net=None) -> RecurrentState:
    """Initial recurrence: the previous noisy frame(s) and zero features.
    The fused path checks its preset against the family of ``net``
    (ConvUNet's presets where no net is given)."""
    if cfg.net_impl == "fused":
        _check_fused(cfg, net)
        f0 = frames[:, 0].float()
        b, h, w, _ = f0.shape
        state = torch.zeros(b, h, w, _fused_state_c(cfg), dtype=torch.float32,
                            device=f0.device)
        state[..., :STATE_DEN] = f0
        return RecurrentState(state, None)
    sd = _state_dtype(cfg)
    lastden = frames[:, : cfg.d].to(sd)
    feat = None
    if cfg.feature_rec:
        if nil_feat is None:
            raise ValueError("feature_rec requires nil_feat [B, H, W, F]")
        feat = nil_feat[:, None].to(sd).expand(
            nil_feat.shape[0], cfg.d, *nil_feat.shape[1:]).contiguous()
    return RecurrentState(lastden, feat)


def _fused_impl(net):
    """(fast_forward, pack, supports_fast_path) of the net's family."""
    if isinstance(net, ConvNeXtUNet):
        return fast_forward_cnx, pack_fast_cnx, supports_fast_path_cnx
    return fast_forward, pack_fast_params, supports_fast_path


def fused_pack(cfg: EngineConfig, net) -> dict:
    """One-time weight packing for the fused path; pass the result to
    step/inference_step."""
    _, pack, _ = _fused_impl(net)
    return pack(net, cfg.feature_rec, cfg.network_input_nc, cfg.fused_precision)


def step(cfg: EngineConfig, net, state: RecurrentState, cur: torch.Tensor,
         future: Optional[torch.Tensor], flows: Optional[torch.Tensor],
         packed=None) -> Tuple[torch.Tensor, RecurrentState]:
    """One denoising step.  cur [B, H, W, C]; future [B, fD, H, W, C] or
    None; flows [B, D+fD, H, W, 2] to the current time.  Returns
    (denoised [B, H, W, C_out] fp32, next state)."""
    if cfg.net_impl == "fused":
        return _fused_step(cfg, net, state, cur, future, flows, packed)
    if cfg.net_impl != "module":
        raise ValueError(f"unknown net_impl {cfg.net_impl!r}")
    d = cfg.d
    sd = _state_dtype(cfg)
    cur = cur.to(sd)
    inputs, feat_parts = [], []
    fuse = (cfg.feature_rec and not cfg.no_warp and not cfg.warp_raw
            and cfg.warp_impl == "kernel" and flows is not None)
    for bi in range(d):
        fl = flows[:, bi] if flows is not None else None
        if fuse:
            # one launch warps the previous frame and its feature map
            c = state.lastden.shape[-1]
            both = torch.cat([state.lastden[:, bi], state.feat[:, bi]], dim=-1)
            warped = _warp(cfg, both, fl)
            inputs.append(warped[..., :c].to(sd))
            feat_parts.append(warped[..., c:].to(sd))
            continue
        inputs.append(_warp_frame(cfg, state.lastden[:, bi], fl).to(sd))
        if cfg.feature_rec and not cfg.no_warp and fl is not None:
            feat_parts.append(_warp(cfg, state.feat[:, bi], fl).to(sd))
        elif cfg.feature_rec:
            feat_parts.append(state.feat[:, bi])
    inputs.append(cur)
    for k in range(cfg.future_patch_depth):
        fl = flows[:, d + k] if flows is not None else None
        inputs.append(_warp_frame(cfg, future[:, k].to(sd), fl).to(sd))

    netinput = torch.cat(inputs, dim=-1).float()
    feat_in = torch.cat(feat_parts, dim=-1).float() if cfg.feature_rec else None
    denoised, new_feat = net(netinput, feat_in)

    store = (cur if cfg.prev_noisy_frame else denoised).to(sd)
    lastden = torch.cat([state.lastden[:, 1:], store[:, None]], dim=1)
    feat = None
    if cfg.feature_rec:
        feat = torch.cat([state.feat[:, 1:], new_feat.to(sd)[:, None]], dim=1)
    return denoised, RecurrentState(lastden, feat)


def _fused_step(cfg, net, state, cur, future, flows, packed):
    """Main path: warp the fp32 state with the CUDA warp and each future
    frame (rounded to the glue dtype, warped to it), feed
    [warped den | cur | warped future] and the warped features to the
    chains, whose dec2 chain writes the next state from its fp32 values.
    The glue dtype is the preset's: bf16, or fp32 (ConvUNet: where the
    preset names 'glue'; ConvNeXtUNet: under 'mixed' and 'accurate')."""
    _check_fused(cfg, net)
    if flows is None:
        raise NotImplementedError("net_impl='fused' needs flows")
    b, h, w, _ = cur.shape
    forward, _, supports = _fused_impl(net)
    if not supports(net, h, w):
        raise ValueError(f"net_impl='fused': no fast path for {type(net).__name__} at {h}x{w}")
    if packed is None:
        packed = fused_pack(cfg, net)
    glue = _fused_glue_dtype(cfg, net)
    fused = state.lastden
    warped = warp_bicubic(fused, flows[:, 0].float().contiguous(), out_dtype=glue)
    parts = [warped[..., :STATE_DEN], cur.to(glue)]
    for k in range(cfg.future_patch_depth):
        parts.append(warp_bicubic(future[:, k].to(glue).contiguous(),
                                  flows[:, cfg.d + k].float().contiguous(),
                                  out_dtype=glue))
    x = torch.cat(parts, dim=-1)
    nxt = forward(net, packed, x, warped if cfg.feature_rec else None,
                  aux_channels=(STATE_FEAT_OFF, STATE_FEAT), combine_state=True)
    den = nxt[..., :STATE_DEN].contiguous()
    return den, RecurrentState(nxt, None)


def inference_step(cfg: EngineConfig, net, state: Optional[RecurrentState],
                   frames: torch.Tensor, flows: Optional[torch.Tensor],
                   nil_feat=None, packed=None) -> Tuple[torch.Tensor, RecurrentState]:
    """Single-frame inference with carried state.  frames
    [B, D+1+fD, H, W, C] is the window ending at the current frame; pass
    ``state=None`` on the first frame of a video (the recurrence restarts
    from the noisy previous frames and zero features)."""
    d = cfg.d
    if state is None:
        state = init_state(cfg, frames, nil_feat, net)
    cur = frames[:, d]
    future = frames[:, d + 1:] if cfg.future_patch_depth else None
    with torch.no_grad():
        return step(cfg, net, state, cur, future, flows, packed)


def compute_window_flows(cfg: EngineConfig, raw_window: torch.Tensor,
                         flow_params: Union[None, str, TVL1Params] = None,
                         iterations: Optional[list] = None) -> torch.Tensor:
    """On-device TV-L1 flows for one inference window (no disk cache).

    raw_window: [B, D+1+fD, h, w, 4] packed raw (any affine range: the
    solver normalizes jointly).  Returns [B, D+fD, h, w, 2] flows to the
    current frame, previous frames first, then future frames, matching the
    offline cache's convention (reference: data/base_dataset.py:134-249).
    flow_params: a TVL1Params or a preset name of ops/tvl1.py:FLOW_PRESETS
    (None: default).  The solver's warp is always ``warp_catmull_zero``
    (the CUDA kernel on CUDA tensors, its plain version on CPU tensors),
    whatever ``cfg.warp_impl`` picks for the state warp.  The iterations of
    every warp stage of every flow are appended to ``iterations`` if it is
    a list.
    """
    d, fd = cfg.d, cfg.future_patch_depth
    gray = to_gray(raw_window)  # [B, T, h, w]
    others = list(range(d)) + [d + 1 + k for k in range(fd)]
    outs = []
    for bi in range(raw_window.shape[0]):
        cur = gray[bi, d]
        outs.append(torch.stack([
            tvl1_flow(cur, gray[bi, k], flow_params, iterations=iterations) for k in others]))
    return torch.stack(outs)
