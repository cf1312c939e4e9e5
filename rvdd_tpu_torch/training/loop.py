"""The validation loop, the serving half of rvdd_tpu/training/loop.py
(reference: validate.py:54-114).

Serial full-frame validation carries the recurrence state across frames
with a FirstOfVideo reset (:func:`compute_validation`), or streams each clip
through ``engine.scan_video`` (:func:`compute_validation_scan`, the
``--val_scan`` protocol: from frame 0 on, every frame sees a denoised
previous frame, where the per-frame path's first window sees the noisy
one).  Everything runs on the options' device; the fused path packs its
weights once a run.  The epoch loop, the Logger and the train step wait for
the training slice (ROADMAP.md).
"""

from __future__ import annotations

import os
from os.path import basename, join
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rvdd_tpu_torch.config import Options
from rvdd_tpu_torch.data.datasets import InferenceDataset, _to_net
from rvdd_tpu_torch.data.flow_cache import FlowCache
from rvdd_tpu_torch.data.io import imwrite, list_video_files, load_image, load_image_stack
from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.ops.bayer import remosaic
from rvdd_tpu_torch.ops.metrics import psnr
from rvdd_tpu_torch.ops.tvl1 import FLOW_PRESETS, to_gray, tvl1_flow
from rvdd_tpu_torch.recurrent.engine import (
    EngineConfig,
    compute_window_flows,
    fused_pack,
    inference_step,
    prepare_frames,
    scan_video,
)


def build_validation(opt: Options) -> InferenceDataset:
    cache = None
    if not opt.no_warp and not opt.online_flow:
        cache = FlowCache(opt.val_dataroot, opt.nFolder, opt.flowFolder, opt.warp_method,
                          persist=opt.persist_flows, device=opt.device)
    from rvdd_tpu_torch.registry import get_dataset

    return get_dataset(opt.val_dataset_mode)(
        opt.val_dataroot,
        opt.gt_folder_for_mode(),
        opt.nFolder,
        patch_depth=opt.model_patch_depth,
        future_patch_depth=opt.future_patch_depth,
        bit_depth=opt.bit_depth,
        raw_gt=opt.raw_gt,
        no_predemosaic=opt.no_predemosaic,
        videos=opt.val_videos,
        flow_cache=cache,
        no_warp=opt.no_warp,
        crop_data=opt.crop_data,
    )


def _val_step(net, state, frames, flows, gt_last, valid_hw, *, cfg: EngineConfig,
              online_flow: bool, flow_preset: str = "default", padded: bool = False,
              packed=None):
    """One validation step: [online flows +] demosaic + step + losses.

    With ``padded``, frames and gt arrive padded to the same bucket and
    ``valid_hw`` holds the true gt size; the losses are masked to it."""
    if online_flow and not cfg.no_warp:
        fp = FLOW_PRESETS["fast"] if flow_preset == "fast" else None
        flows = compute_window_flows(cfg, frames, fp)[:, None]
    frames2, flows2 = prepare_frames(cfg, frames, flows)
    fl = flows2[:, 0] if flows2 is not None else None
    nil = (net.nil_features(frames2.shape[0], frames2.shape[2], frames2.shape[3])
           if cfg.feature_rec else None)
    den, state = inference_step(cfg, net, state, frames2, fl, nil, packed)
    raw_domain_gt = cfg.raw_gt and not cfg.no_predemosaic
    g = 2 if raw_domain_gt else 1
    den_c = den[:, : g * gt_last.shape[1], : g * gt_last.shape[2]]
    out = remosaic(den_c) if raw_domain_gt else den_c
    if padded:
        gh, gw = gt_last.shape[1], gt_last.shape[2]
        dev = out.device
        mask = ((torch.arange(gh, device=dev)[:, None] < valid_hw[0])
                & (torch.arange(gw, device=dev)[None, :] < valid_hw[1])
                ).to(out.dtype)[None, :, :, None]
        n_valid = mask.sum() * out.shape[0] * out.shape[-1]
        diff = (out - gt_last) * mask
        l1 = diff.abs().sum() / n_valid * cfg.lambda_l1
        ps = 10.0 * torch.log10(4.0 / ((diff * diff).sum() / n_valid))
    else:
        l1 = (out - gt_last).abs().mean() * cfg.lambda_l1
        ps = psnr(out, gt_last, 2.0)
    return den_c, state, {"L1": l1, "PSNR": ps, "Denoiser": l1}


def _flow_from_prev(prev_den, cur_noisy_raw, *, cfg: EngineConfig):
    """--val_flow_from_denoised: TV-L1 between the remosaicked previous
    output and the current noisy raw (reference: validate.py:16-38)."""
    prev = prev_den if cfg.no_predemosaic else remosaic(prev_den)
    prev01 = (prev + 1.0) / 2.0
    cur01 = (cur_noisy_raw + 1.0) / 2.0
    return tvl1_flow(to_gray(cur01[0]), to_gray(prev01[0]))[None]


def _pad_window(frames, flows, multiple: int):
    """Pad a raw window (and its flows) up to the next multiple: frames
    edge-replicated, flows zero."""
    h, w = frames.shape[2], frames.shape[3]
    ph, pw = (-h) % multiple, (-w) % multiple
    if not ph and not pw:
        return frames, flows
    dev = frames.device
    rows = torch.arange(h + ph, device=dev).clamp(max=h - 1)
    cols = torch.arange(w + pw, device=dev).clamp(max=w - 1)
    frames = frames.index_select(2, rows).index_select(3, cols)
    if flows is not None:
        flows = F.pad(flows, (0, 0, 0, pw, 0, ph))
    return frames, flows


def _save(den: torch.Tensor, val_image_dir: str, seq: str, n_path: str) -> None:
    """<seq>/<frame>_denoised.tif: the output [H, W, C] in [0, 255], fp32
    (scaled on its device)."""
    name = os.path.splitext(basename(n_path))[0]
    img = ((den.float() + 1.0) / 2.0 * 255.0).cpu().numpy()
    imwrite(join(val_image_dir, seq, f"{name}_denoised.tif"), img)


@torch.no_grad()
def compute_validation(opt: Options, net, val_dataset: InferenceDataset,
                       val_image_dir: Optional[str] = None, save_visuals: bool = True,
                       flow_from_denoised: bool = False,
                       carry_state: Optional[bool] = None) -> Dict[str, float]:
    """Serial full-frame validation with carried recurrence (reference:
    validate.py:54-114).  Returns averaged losses ('<name>_valLoss').

    ``carry_state`` overrides the recurrence-carry protocol; by default a
    net trained with one unrolling (patch_depth == model_patch_depth) is
    non-recurrent, and its recurrence restarts from the noisy previous
    frame on every frame (reference: recurrent_model.py:233-238)."""
    cfg = opt.engine_config()
    dev = resolve_device(opt.device)
    pad_multiple = opt.val_pad_multiple
    if pad_multiple and flow_from_denoised:
        raise NotImplementedError("--val_flow_from_denoised with --val_pad_multiple")
    if carry_state is None:
        carry_state = cfg.train_unrollings > 1
    packed = fused_pack(cfg, net) if cfg.net_impl == "fused" else None

    totals: Dict[str, float] = {}
    count = 0
    state = None
    prev_den = None
    for item in val_dataset:
        first = item["FirstOfVideo"]
        if first or not carry_state:
            state = None
        frames = torch.from_numpy(item["n"])[None].to(dev)
        flows = None
        if "flow" in item:
            flows = torch.from_numpy(item["flow"])[None][:, None].to(dev)  # [B,1,D+fD,H,W,2]
        if flow_from_denoised and not first and prev_den is not None and flows is not None:
            # recompute the past-frame flow from the previous denoised output
            # (reference: validate.py:16-38, future_patch_depth == 0 only)
            if cfg.future_patch_depth:
                raise NotImplementedError("--val_flow_from_denoised with future frames")
            if cfg.d > 1 and count == 0:
                print("warning: --val_flow_from_denoised with model_patch_depth > 2 repeats "
                      "the last-frame flow for all previous-frame slots (reference behaviour)")
            fl = _flow_from_prev(prev_den, frames[:, -1], cfg=cfg)
            flows = fl[:, None, None].repeat(1, 1, flows.shape[2], 1, 1, 1)
        gt_last = torch.from_numpy(item["gt"][-1])[None].to(dev)
        gh, gw = gt_last.shape[1], gt_last.shape[2]
        valid_hw = (gh, gw)
        if pad_multiple:
            frames, flows = _pad_window(frames, flows, pad_multiple)
            raw_domain_gt = cfg.raw_gt and not cfg.no_predemosaic
            gm = pad_multiple * (1 if raw_domain_gt or cfg.no_predemosaic else 2)
            gt_last = F.pad(gt_last, (0, 0, 0, (-gw) % gm, 0, (-gh) % gm))
        den, state, losses = _val_step(
            net, state, frames, flows, gt_last, valid_hw, cfg=cfg,
            online_flow=opt.online_flow, flow_preset=opt.flow_preset,
            padded=bool(pad_multiple), packed=packed)
        prev_den = den
        for k, v in losses.items():
            totals[k] = totals.get(k, 0.0) + float(v)
        count += 1
        if save_visuals and val_image_dir is not None:
            g = 2 if (cfg.raw_gt and not cfg.no_predemosaic) else 1
            _save(den[0, : g * gh, : g * gw], val_image_dir, item["seq"], item["n_path"])
    return {f"{k}_valLoss": v / max(count, 1) for k, v in totals.items()}


@torch.no_grad()
def compute_validation_scan(opt: Options, net, val_dataset: InferenceDataset,
                            val_image_dir: Optional[str] = None,
                            save_visuals: bool = True) -> Dict[str, float]:
    """--val_scan: each clip through ``engine.scan_video`` instead of
    per-frame steps.  Every frame runs through the denoised-previous
    recursion from frame 0, so the first D scored frames see a denoised
    (not noisy) previous frame; the scored frames are the same N-D-fD
    frames a video as the per-frame path's."""
    cfg = opt.engine_config()
    dev = resolve_device(opt.device)
    d, fd = cfg.d, cfg.future_patch_depth
    totals: Dict[str, float] = {}
    count = 0
    for gt_dir, n_dir in zip(val_dataset.gt_dirs, val_dataset.n_dirs):
        n_paths = list_video_files(n_dir)
        gt_paths = list_video_files(gt_dir)
        seq = basename(n_dir)
        noisy01 = load_image_stack(n_paths, val_dataset.bit_depth)
        # flows are computed or read at full frame size (as the per-frame
        # path, which crops only after the cache lookup)
        raw_full = noisy01 * (2.0 ** float(val_dataset.bit_depth) - 1.0)
        if val_dataset.crop is not None:
            cx, cy = val_dataset.crop
            noisy01 = noisy01[:, :cx, :cy]
        noisy = _to_net(noisy01)  # [N, h, w, 4]
        n = noisy.shape[0]

        flows = None
        if not cfg.no_warp and val_dataset.flow_cache is not None:
            flows = np.zeros(noisy.shape[:1] + (d + fd,) + noisy.shape[1:3] + (2,), np.float32)
            for p in range(n):
                pairs, slots = [], []
                for k in range(d):  # frame p-d+k -> p
                    if p - d + k >= 0:
                        pairs.append((p - d + k, p))
                        slots.append(k)
                for j in range(fd):  # frame p+1+j -> p
                    if p + 1 + j < n:
                        pairs.append((p + 1 + j, p))
                        slots.append(d + j)
                if pairs:
                    fl = val_dataset.flow_cache.get_flows(seq, n_paths, pairs, frames=raw_full)
                    for s, f in zip(slots, fl):
                        flows[p, s] = f[: flows.shape[2], : flows.shape[3]]
            flows = torch.from_numpy(flows)[None].to(dev)  # [1, N, d+fd, h, w, 2]

        frames, flows2 = prepare_frames(cfg, torch.from_numpy(noisy)[None].to(dev), flows)
        nil = (net.nil_features(1, frames.shape[2], frames.shape[3])
               if cfg.feature_rec else None)
        dens = scan_video(cfg, net, frames.transpose(0, 1),
                          None if flows2 is None else flows2.transpose(0, 1), nil)[:, 0]

        raw_domain_gt = cfg.raw_gt and not cfg.no_predemosaic
        for p in range(d, n - fd):
            gt_np = load_image(gt_paths[p], val_dataset.bit_depth) * 2.0 - 1.0
            if val_dataset.crop is not None:
                cx, cy = val_dataset.crop
                g = 1 if val_dataset.raw_gt else 2
                gt_np = gt_np[: g * cx, : g * cy]
            gt_last = torch.from_numpy(gt_np).to(dev)
            out = remosaic(dens[p][None])[0] if raw_domain_gt else dens[p]
            l1 = float((out - gt_last).abs().mean()) * cfg.lambda_l1
            ps = float(psnr(out, gt_last, 2.0))
            for k, v in {"L1": l1, "PSNR": ps, "Denoiser": l1}.items():
                totals[k] = totals.get(k, 0.0) + v
            count += 1
            if save_visuals and val_image_dir is not None:
                _save(dens[p], val_image_dir, seq, n_paths[p])
    return {f"{k}_valLoss": v / max(count, 1) for k, v in totals.items()}
