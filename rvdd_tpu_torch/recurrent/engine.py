"""Recurrent denoising engine, the inference half (port of
rvdd_tpu/recurrent/engine.py).

    frames, flows = prepare_frames(cfg, raw_window, raw_flows)
    den, state = inference_step(cfg, net, None, frames, flows[:, 0], nil)
    den, state = inference_step(cfg, net, state, frames, flows[:, 0], nil)
    dens = scan_video(cfg, net, frames_t, flows_t, nil)   # a whole clip

Frames are stacked on a time axis ([B, T, H, W, C]); flows are
[B, D+fD, H, W, 2] for one step.  The recurrence state is an explicit value
the caller carries.  B is any number of independent streams: each stream's
result is its own single-stream run's, and the fused path launches each
kernel once a layer for the whole batch (rvdd_tpu's fused step loops over
the samples, rvdd_tpu/recurrent/engine.py:402).

Two step implementations, chosen by ``EngineConfig.net_impl``:

* ``'module'``: the generic path; the ConvUNet module in fp32 with the warp
  chosen by ``warp_impl`` (``'plain'`` PyTorch, the default ``'auto'``
  included, or ``'kernel'``, the CUDA warp, which on CPU tensors runs its
  plain version);
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

The fused path takes rvdd_tpu's options (rvdd_tpu/recurrent/engine.py:
_fast_planar_step) with its rounding:

* ``no_warp``, or flows of None: the state's image region and the future
  frames go unwarped (the state in its own dtype, promoted with the glue
  dtype as rvdd_tpu's glue-dtype lane mask promotes it);
* ``prev_noisy_frame``: the next state is ``[cur | 0 x 5 | feat]``, the
  current frame rounded to the glue dtype and then to the state's;
* ``state_dtype='bfloat16'``: the carry takes the preset's glue dtype
  (bf16 under 'fast', fp32 under the fp32-glue presets).  The chains'
  state emit is fp32 only, so the state is rounded once after the emit and
  stored in that dtype; the warp kernel reads a bf16 state as it is;
* ``warp_impl='plain'``: the state is warped by the plain PyTorch warp
  (rvdd_tpu's diagnostic ``warp_impl='xla'``); the future frames stay on
  the kernel, as in rvdd_tpu.  ``'auto'`` and ``'kernel'`` warp the state
  with the kernel.

Whole clips: ``scan_video`` streams a clip with O(1) state, a host loop
over ``inference_step`` with the edge frames replicated and the weights
packed once.

Online flow: ``compute_window_flows`` computes a window's flows on the
device with the TV-L1 solver (ops/tvl1.py; on CUDA tensors its warp is
always the CUDA kernel ``warp_catmull_zero``, on either path), so a video can be
denoised without a precomputed flow cache.  The solver is plain PyTorch
around that kernel, a host loop of small launches with one read of the
convergence measure an iteration, so its launches, not the card's
arithmetic, bound it (PERF.md).

Training: ``unrolled_forward`` runs a sample's unrollings on the module
path under autograd and ``compute_losses`` weighs their L1 and PSNR.  The
backward is PyTorch's: rvdd_tpu's train step differentiates its XLA net
and warp, never a Pallas kernel, so the fused chains (forward-only here as
there) refuse to train.  ``warp_impl='shift'`` is the exact plain warp,
the gradient of whose gather is a scatter-add on the card; the train step
only logs what rvdd_tpu's banded sweep would have clamped
(ops/warp_shift.py).  ``remat`` recomputes each unrolling in the backward
(``torch.utils.checkpoint``), as rvdd_tpu's ``jax.checkpoint``.

On a shard of the mesh's space axis (inside parallel/space.py:scope: the
train step and the sharded inference) the module path runs on this
process's rows of each frame: the demosaic, the flow upsample, the warps
(which read the whole sample of their source) and the nets exchange the
rows they need, and ``compute_losses`` returns this shard's part of each
global mean.  The fused path refuses a space axis, as rvdd_tpu runs no
Pallas chain under a space mesh.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

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
from rvdd_tpu_torch.ops.cuda.warp_bicubic import warp_bicubic, warp_bicubic_plain
from rvdd_tpu_torch.ops.demosaic import hamilton_adams
from rvdd_tpu_torch.ops.metrics import psnr
from rvdd_tpu_torch.ops.tvl1 import TVL1Params, to_gray, tvl1_flow
from rvdd_tpu_torch.ops.warp import flow_upsample_2x, warp
from rvdd_tpu_torch.parallel import space
from rvdd_tpu_torch.tracing import span

#: channels of the fused recurrence state: [den 3 | zero 5 | feat 48]
STATE_DEN = 3
STATE_FEAT_OFF = 8
STATE_FEAT = 48


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    model_patch_depth: int = 2  # D+1: previous frames + current
    patch_depth: int = 5  # frames per training sample (train_unrollings)
    future_patch_depth: int = 0  # fD
    input_nc: int = 3
    output_nc: int = 3
    no_warp: bool = False
    no_predemosaic: bool = False
    warp_raw: bool = False
    prev_noisy_frame: bool = False
    feature_rec: bool = False
    #: the ground truth is packed raw: the output is remosaicked to score it
    raw_gt: bool = False
    lambda_l1: float = 100.0
    #: the state warp: 'auto' (the CUDA warp on the fused path, the plain
    #: one on the module path), 'plain' (PyTorch), 'kernel' (the CUDA
    #: warp, which on CPU tensors runs its plain version) or 'shift' (the
    #: plain warp, with the train step's clamp telemetry of rvdd_tpu's
    #: banded training warp)
    warp_impl: str = "auto"
    #: carried state dtype: 'float32' (the production default) or
    #: 'bfloat16' (the module path's carry; the fused path's carry takes
    #: the preset's glue dtype)
    state_dtype: str = "float32"
    #: 'module' (the net's forward) or 'fused' (the CUDA chains)
    net_impl: str = "module"
    #: fused-path preset of the net's family (ConvUNet:
    #: models/fast_unet.py:FUSED_PRECISIONS or 'hybrid:<chains>'; ConvNeXtUNet:
    #: models/fast_convnext.py:CNX_PRECISIONS)
    fused_precision: str = "fast"
    #: residual radius of rvdd_tpu's banded 'shift' warp, for the clamp
    #: telemetry of ``warp_impl='shift'``
    shift_warp_radius: int = 8
    #: recompute each unrolling in the training backward
    #: (torch.utils.checkpoint): the same gradients, activation memory of
    #: one unrolling instead of all
    remat: bool = False

    @property
    def d(self) -> int:
        return self.model_patch_depth - 1

    @property
    def train_unrollings(self) -> int:
        return self.patch_depth - self.model_patch_depth + 1

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
    with span("prepare_frames"):
        t = raw_frames.shape[1]
        rows = space.rows_of(raw_frames)
        with span("demosaic"):
            rgb = torch.stack([hamilton_adams(raw_frames[:, i], rows) for i in range(t)], dim=1)
        if flows is not None and not cfg.warp_raw:
            bt, td, dd, fh, fw, _ = flows.shape
            with span("flow_upsample"):
                flows = flow_upsample_2x(flows.reshape(bt * td * dd, fh, fw, 2), rows)
            flows = flows.reshape(bt, td, dd, 2 * fh, 2 * fw, 2)
        return rgb, flows


def _warp(cfg: EngineConfig, x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    rows = space.rows_of(x)
    if cfg.warp_impl == "kernel":
        if rows is not None:
            raise ValueError("warp_impl='kernel' on a shard of the space axis: the CUDA warp "
                             "reads one process's rows; use the plain warp (ROADMAP.md)")
        return warp_bicubic(x.float().contiguous(), flow.float().contiguous(),
                            out_dtype=torch.float32)
    if cfg.warp_impl not in ("plain", "auto", "shift"):
        raise ValueError(f"unknown warp_impl {cfg.warp_impl!r}")
    return warp(x, flow, "bicubic", rows=rows)[0]


def _warp_frame(cfg: EngineConfig, frame: torch.Tensor, flow: Optional[torch.Tensor]):
    if cfg.no_warp or flow is None:
        return frame
    if (not cfg.no_predemosaic) and cfg.warp_raw:
        raw = _warp(cfg, remosaic(frame), flow)
        return hamilton_adams(raw, space.rows_of(raw))
    return _warp(cfg, frame, flow)


def _state_dtype(cfg: EngineConfig):
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def _check_fused(cfg: EngineConfig, net=None) -> None:
    """The fused path's knobs, and the preset against the presets of the
    net's family (ConvUNet's where no net is given).  The settings refused
    here are those rvdd_tpu's fused step refuses too
    (rvdd_tpu/recurrent/engine.py:375-379), and a shard of the space axis,
    under which rvdd_tpu runs its module path."""
    sc = space.active()
    if sc is not None and sc.rows is not None:
        raise ValueError("net_impl='fused' on a shard of the space axis: the CUDA chains run "
                         "on whole frames; run the module path (net_impl='module'), as "
                         "rvdd_tpu does under a space mesh (ROADMAP.md)")
    bad = {
        "model_patch_depth != 2": cfg.d != 1,
        "warp_raw": cfg.warp_raw,
        "no_predemosaic": cfg.no_predemosaic,
        "output_nc != 3": cfg.output_nc != 3,
    }
    what = [k for k, v in bad.items() if v]
    if what:
        raise NotImplementedError(
            f"net_impl='fused' supports model_patch_depth=2, RGB pre-demosaic, frame-domain "
            f"warping and output_nc=3, as rvdd_tpu's fused step; got {what}")
    if cfg.warp_impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown warp_impl {cfg.warp_impl!r}")
    if cfg.state_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
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


def _fused_state_dtype(cfg: EngineConfig, net) -> torch.dtype:
    """The fused carry's dtype: fp32, or under ``state_dtype='bfloat16'``
    the preset's glue dtype (rvdd_tpu/recurrent/engine.py:221-228)."""
    if cfg.state_dtype == "float32":
        return torch.float32
    return _fused_glue_dtype(cfg, net)


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
        return RecurrentState(state.to(_fused_state_dtype(cfg, net)), None)
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
    with span("step"):
        if cfg.net_impl == "fused":
            return _fused_step(cfg, net, state, cur, future, flows, packed)
        if cfg.net_impl != "module":
            raise ValueError(f"unknown net_impl {cfg.net_impl!r}")
        return _module_step(cfg, net, state, cur, future, flows)


def _module_step(cfg, net, state, cur, future, flows):
    """The module path's step (:func:`step`): warp the carried outputs and
    features and the future frames, then the net's forward."""
    d = cfg.d
    sd = _state_dtype(cfg)
    cur = cur.to(sd)
    inputs, feat_parts, futures = [], [], []
    fuse = (cfg.feature_rec and not cfg.no_warp and not cfg.warp_raw
            and cfg.warp_impl == "kernel" and flows is not None)
    with span("warp"):
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
        for k in range(cfg.future_patch_depth):
            fl = flows[:, d + k] if flows is not None else None
            futures.append(_warp_frame(cfg, future[:, k].to(sd), fl).to(sd))

    netinput = torch.cat(inputs + [cur] + futures, dim=-1).float()
    feat_in = torch.cat(feat_parts, dim=-1).float() if cfg.feature_rec else None
    with span("net"):
        denoised, new_feat = net(netinput, feat_in)

    store = (cur if cfg.prev_noisy_frame else denoised).to(sd)
    lastden = torch.cat([state.lastden[:, 1:], store[:, None]], dim=1)
    feat = None
    if cfg.feature_rec:
        feat = torch.cat([state.feat[:, 1:], new_feat.to(sd)[:, None]], dim=1)
    return denoised, RecurrentState(lastden, feat)


def _fused_step(cfg, net, state, cur, future, flows, packed):
    """Main path: warp the state with the CUDA warp and each future frame
    (rounded to the glue dtype, warped to it), feed
    [warped den | cur | warped future] and the warped features to the
    chains, whose dec2 chain writes the next state from its fp32 values.
    The glue dtype is the preset's: bf16, or fp32 (ConvUNet: where the
    preset names 'glue'; ConvNeXtUNet: under 'mixed' and 'accurate').  The
    options (no_warp, prev_noisy_frame, the bf16 carry, the plain state
    warp) follow rvdd_tpu's _fast_planar_step; see the module docstring."""
    _check_fused(cfg, net)
    b, h, w, _ = cur.shape
    forward, _, supports = _fused_impl(net)
    if not supports(net, h, w):
        raise ValueError(f"net_impl='fused': no fast path for {type(net).__name__} at {h}x{w}")
    if packed is None:
        packed = fused_pack(cfg, net)
    glue = _fused_glue_dtype(cfg, net)
    sd = _fused_state_dtype(cfg, net)
    fused = state.lastden
    warping = not cfg.no_warp and flows is not None
    futures = []
    with span("warp"):
        if not warping:
            warped = fused.to(torch.promote_types(fused.dtype, glue))
        elif cfg.warp_impl == "plain":
            warped = warp_bicubic_plain(fused, flows[:, 0].float(), out_dtype=glue)
        else:
            warped = warp_bicubic(fused.contiguous(), flows[:, 0].float().contiguous(),
                                  out_dtype=glue)
        for k in range(cfg.future_patch_depth):
            fk = future[:, k].to(glue)
            if warping:
                fk = warp_bicubic(fk.contiguous(), flows[:, cfg.d + k].float().contiguous(),
                                  out_dtype=glue)
            futures.append(fk)
    curp = cur.to(glue)
    x = torch.cat([warped[..., :STATE_DEN], curp] + futures, dim=-1)
    with span("chains"):
        nxt = forward(net, packed, x, warped if cfg.feature_rec else None,
                      aux_channels=(STATE_FEAT_OFF, STATE_FEAT), combine_state=True).to(sd)
    den = nxt[..., :STATE_DEN].float().contiguous()
    if cfg.prev_noisy_frame:
        # the ablation carries the noisy current frame and the new features
        keep = torch.zeros_like(nxt)
        keep[..., :STATE_DEN] = curp.to(sd)
        keep[..., STATE_FEAT_OFF:] = nxt[..., STATE_FEAT_OFF:]
        nxt = keep
    return den, RecurrentState(nxt, None)


def unrolled_forward(cfg: EngineConfig, net, frames: torch.Tensor,
                     flows: Optional[torch.Tensor], unrollings: int,
                     nil_feat=None) -> torch.Tensor:
    """Training forward (rvdd_tpu/recurrent/engine.py:unrolled_forward):
    run ``unrollings`` steps of the module path from the noisy previous
    frames and return every output [B, unrollings, H, W, C_out].  frames
    [B, T, H, W, C] prepared; flows [B, TD, D+fD, H, W, 2] prepared, or
    None.  With ``cfg.remat`` each step is recomputed in the backward."""
    if cfg.net_impl != "module":
        raise ValueError(
            f"net_impl={cfg.net_impl!r} cannot train: the fused chains are forward-only "
            "(as rvdd_tpu's Pallas chains, which have no VJP); train with net_impl='module'")
    d = cfg.d
    state = init_state(cfg, frames, nil_feat, net)
    outs = []
    for a in range(unrollings):
        cur = frames[:, a + d]
        future = (frames[:, a + d + 1:a + d + 1 + cfg.future_patch_depth]
                  if cfg.future_patch_depth else None)
        fl = flows[:, a] if flows is not None else None
        if cfg.remat:
            den, state = checkpoint(step, cfg, net, state, cur, future, fl,
                                    use_reentrant=False)
        else:
            den, state = step(cfg, net, state, cur, future, fl)
        outs.append(den)
    return torch.stack(outs, dim=1)


def compute_losses(cfg: EngineConfig, outputs: torch.Tensor, gt: torch.Tensor,
                   weights: torch.Tensor, mses: Optional[list] = None) -> dict:
    """Weighted L1 (x ``lambda_l1``) and PSNR (peak 2.0) over the unrolling
    outputs [B, A, H, W, C_out] against gt [B, T, H', W', C_gt], with
    unrolling weights [A]; a raw ground truth scores the remosaicked output
    (rvdd_tpu/recurrent/engine.py:compute_losses; reference:
    recurrent_model.py:473-510).  Given a list, ``mses`` receives each
    unrolling's mean squared error (detached), from which a data-parallel
    step computes the global batch's PSNR.

    On a shard of the space axis each mean is this shard's part of the
    sample's: its sum over the elements of the whole sample's rows (the
    shards are unequal), so the shards' L1 and squared errors add up to the
    sample's; the step sums them (its PSNR is then the global one)."""
    d = cfg.d
    l1s, psnrs = [], []
    for a in range(outputs.shape[1]):
        den = outputs[:, a].float()
        target = gt[:, a + d]
        if cfg.raw_gt and not cfg.no_predemosaic:
            den = remosaic(den)
        rows = space.rows_of(target)
        if rows is None:
            mean = torch.mean
        else:
            count = target.numel() // rows.n * rows.height
            mean = lambda t: t.sum() / count  # noqa: E731
        l1s.append(mean((den - target).abs()) * cfg.lambda_l1)
        psnrs.append(psnr(den, target, 2.0))
        if mses is not None:
            mses.append(mean((den.detach() - target) ** 2))
    weights = weights.to(outputs.device, torch.float32)
    loss_l1 = (weights * torch.stack(l1s)).sum()
    loss_psnr = (weights * torch.stack(psnrs)).sum()
    return {"L1": loss_l1, "PSNR": loss_psnr, "Denoiser": loss_l1}


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


def scan_video(cfg: EngineConfig, net, frames: torch.Tensor,
               flows: Optional[torch.Tensor], nil_feat=None) -> torch.Tensor:
    """Stream a whole clip with O(1) state (rvdd_tpu/recurrent/engine.py:
    scan_video).  frames [T, B, H, W, C] prepared frames of one clip; flows
    [T, B, D+fD, H, W, 2] to each frame, or None.  Frame t uses the window
    [t-D, t+fD], the clip's first and last frames replicated beyond its
    edges (the caller's flows there are zero, the reference's rule for
    missing flows); the recurrence starts from the replicated first frame,
    so frame 0 already sees a carried state.  The weights are packed once,
    before the loop; each window is cut inside it.  Returns
    [T, B, H, W, C_out]."""
    t_total = frames.shape[0]
    d, fd = cfg.d, cfg.future_patch_depth
    packed = fused_pack(cfg, net) if cfg.net_impl == "fused" else None

    def window(t):
        idx = [min(max(t + j - d, 0), t_total - 1) for j in range(d + 1 + fd)]
        return torch.stack([frames[i] for i in idx], dim=1)  # [B, D+1+fD, ...]

    state = init_state(cfg, window(0), nil_feat, net)
    dens = []
    for t in range(t_total):
        den, state = inference_step(cfg, net, state, window(t),
                                    None if flows is None else flows[t], nil_feat, packed)
        dens.append(den)
    return torch.stack(dens)


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
    with span("flows"):
        gray = to_gray(raw_window)  # [B, T, h, w]
        others = list(range(d)) + [d + 1 + k for k in range(fd)]
        outs = []
        for bi in range(raw_window.shape[0]):
            cur = gray[bi, d]
            outs.append(torch.stack([
                tvl1_flow(cur, gray[bi, k], flow_params, iterations=iterations)
                for k in others]))
        return torch.stack(outs)
