"""The epoch loop and the validation loop (port of
rvdd_tpu/training/loop.py; reference: train.py:67-130, validate.py:54-114).

:func:`train` runs rvdd_tpu's epoch protocol on the options' device:
windowed patches from ``TrainWindowDataset`` (flows from a
:class:`FlowCache`, computed on the device where missing), one train step a
batch (autograd through every unrolling, weighted by the ``--unroll_focus``
schedule), checkpoints ('0', every epoch and 'latest', 'latest_val' at the
best validation loss) with ``status.json`` for ``--autoresume``, and
in-loop validation.  ``--distributed`` trains over the processes torchrun
starts: data-parallel over the mesh's ``data`` axis, and with
``--mesh_shape data<N>xspace<M>`` each sample's rows cut over its ``space``
axis (parallel/mesh.py, parallel/space.py), and
``--profile_dir`` exports a torch.profiler trace of steps 2..5 of the first
epoch (with the port's ``rvdd.*`` spans, tracing.py).  On a space axis each
epoch's record holds ``exchange_mb_per_step``: the MB a step this process
handed to the space axis's collectives (``space.all_gather.bytes`` and
``space.all_sum.bytes``).

Serial full-frame validation carries the recurrence state across frames
with a FirstOfVideo reset (:func:`compute_validation`), or streams each clip
through ``engine.scan_video`` (:func:`compute_validation_scan`, the
``--val_scan`` protocol: from frame 0 on, every frame sees a denoised
previous frame, where the per-frame path's first window sees the noisy
one).  The fused path packs its weights once a run.
"""

from __future__ import annotations

import dataclasses
import os
import time
from os.path import basename, join
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from rvdd_tpu_torch.config import Options
from rvdd_tpu_torch.data.datasets import InferenceDataset, _to_net
from rvdd_tpu_torch.data.flow_cache import FlowCache
from rvdd_tpu_torch.data.io import imwrite, list_video_files, load_image, load_image_stack
from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.ops.bayer import remosaic
from rvdd_tpu_torch.ops.metrics import psnr
from rvdd_tpu_torch.ops.tvl1 import FLOW_PRESETS, to_gray, tvl1_flow
from rvdd_tpu_torch.parallel import space
from rvdd_tpu_torch.parallel.mesh import init_distributed, make_mesh, replicate, shard_batch
from rvdd_tpu_torch.recurrent.engine import (
    EngineConfig,
    compute_window_flows,
    fused_pack,
    inference_step,
    prepare_frames,
    scan_video,
)
from rvdd_tpu_torch.recurrent.schedules import active_unrollings, unroll_weights
from rvdd_tpu_torch.training.checkpoints import (
    load_checkpoint,
    load_status,
    save_checkpoint,
    save_status,
)
from rvdd_tpu_torch.training.train_state import (
    create_train_state,
    lr_for_epoch,
    make_train_step,
    set_learning_rate,
)


class Logger:
    """loss_log.txt writer (reference: util/visualizer.py:36-102); a logger
    not ``enabled`` (a data-parallel rank other than 0) neither prints nor
    writes."""

    def __init__(self, save_dir: str, enabled: bool = True):
        self.path = join(save_dir, "loss_log.txt") if enabled else None
        if enabled:
            os.makedirs(save_dir, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(f"================ Training Loss ({time.strftime('%c')}) "
                        "================\n")

    def line(self, msg: str) -> None:
        if self.path is None:
            return
        print(msg)
        with open(self.path, "a") as f:
            f.write(msg + "\n")


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


def prepare_host_batch(batch: Dict[str, np.ndarray], device):
    """A numpy batch -> (frames, flows or None, gt) on ``device``; the
    demosaic and the flow upsample run on the device inside the train step
    (engine.prepare_frames)."""
    frames = torch.from_numpy(batch["n"]).to(device)
    flows = torch.from_numpy(batch["flow"]).to(device) if "flow" in batch else None
    return frames, flows, torch.from_numpy(batch["gt"]).to(device)


def _set_train_precision(name: str) -> None:
    """``--train_matmul_precision``: 'highest' turns TF32 off in cuBLAS and
    cuDNN; 'high' turns it on (the TF32 class the reference trains under on
    Ampere); 'default' turns it on and the train step runs its forward
    under bf16 autocast.  Process-wide, in-loop validation included, as in
    rvdd_tpu; the validate CLI is a separate process."""
    from rvdd_tpu_torch.precision import use_exact_precision, use_fast_precision

    if name == "highest":
        use_exact_precision()
    elif name in ("high", "default"):
        use_fast_precision()
    else:
        raise ValueError(f"unknown --train_matmul_precision {name!r}")


def _start_trace(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    prof.start()
    return prof


def _stop_trace(prof, profile_dir: str, rank: int, sync):
    """Stop a trace after the device has finished its steps and export it
    as ``<profile_dir>/rank<r>.json`` (Chrome trace); returns the path and
    the seconds the stop and export took (after the synchronize)."""
    sync()
    t0 = time.perf_counter()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = join(profile_dir, f"rank{rank}.json")
    prof.export_chrome_trace(path)
    return path, time.perf_counter() - t0


#: --profile_dir traces these steps of the first epoch, both included
#: (rvdd_tpu/training/loop.py:530-543)
TRACE_FIRST, TRACE_LAST = 2, 5


def train(opt: Options) -> dict:
    """Full training entry (reference: train.py).  Returns what the run
    measured: per epoch its steps, learning rate, first and last losses,
    whether every loss was finite, the milliseconds an optimizer step
    (synchronized, the epoch's first step left out, and the profile's
    stop and export, ``trace_s``, taken out), the seconds the steps waited
    for data, on a space axis the MB a step handed to its collectives
    (``exchange_mb_per_step``), and the validation losses and seconds; the
    flows the caches computed with their seconds; this process's rank, the
    processes and their backend; the profile's path.

    With ``--distributed`` the process group starts first, from torchrun's
    environment (parallel/mesh.py:init_distributed), and is destroyed when
    training ends or fails."""
    if not opt.distributed:
        return _train(opt, resolve_device(opt.device))
    dev = init_distributed(opt.device)
    try:
        return _train(opt, dev)
    finally:
        dist.destroy_process_group()


def _train(opt: Options, dev: torch.device) -> dict:
    """:func:`train` on ``dev``.  In a data-parallel run every process
    builds the same dataset and net from the seed, iterates the same global
    batches and trains on its shard of each; rank 0 alone writes (the log,
    the options, checkpoints, status.json, flows and validation visuals),
    with a barrier after each save, and validates: its validation loss is
    broadcast, so that every rank takes the same best-checkpoint and
    plateau decisions."""
    from rvdd_tpu_torch.models import build_network
    from rvdd_tpu_torch.registry import get_dataset

    rank = dist.get_rank() if opt.distributed else 0
    writer = rank == 0
    barrier = dist.barrier if opt.distributed else (lambda: None)
    _set_train_precision(opt.train_matmul_precision)
    cfg = dataclasses.replace(opt.engine_config(), warp_impl=opt.resolve_train_warp_impl())
    save_dir = opt.save_dir
    log = Logger(save_dir, enabled=writer)
    if writer:
        opt.save(join(save_dir, "opt_train.json"))
    log.line(opt.dump())

    cache = None
    if not opt.no_warp:
        cache = FlowCache(opt.dataroot, opt.nFolder, opt.flowFolder, opt.warp_method,
                          persist=opt.persist_flows and writer, device=dev)
    train_ds = get_dataset(opt.dataset_mode)(
        opt.dataroot, opt.gt_folder_for_mode(), opt.nFolder, patch_width=opt.patch_width,
        patch_stride=opt.patch_stride, patch_depth=opt.patch_depth,
        model_patch_depth=opt.model_patch_depth, future_patch_depth=opt.future_patch_depth,
        frames2load=opt.frames2load, bit_depth=opt.bit_depth, raw_gt=opt.raw_gt,
        no_predemosaic=opt.no_predemosaic, videos=opt.videos, flow_cache=cache,
        no_warp=opt.no_warp, seed=opt.seed)
    log.line(f"The number of training images = {len(train_ds)}")
    val_ds = None if opt.no_val or not writer else build_validation(opt)
    if val_ds is not None:
        log.line(f"Number of validation images = {len(val_ds)}")

    net = build_network(opt.netDenoiser, cfg.network_input_nc, opt.output_nc, cfg.feature_rec,
                        seed=opt.seed, device=dev, init_type=opt.init_type)
    if opt.path2epoch:
        load_checkpoint(opt.path2epoch, None, net)
        log.line(f"loaded weights from {opt.path2epoch}")
    state = create_train_state(net, opt.optimizer, opt.beta1, opt.weight_decay)

    # a space axis cuts the rows in blocks that every pool of the net keeps
    # inside a shard
    mesh = make_mesh(opt.mesh_shape, batch_size=opt.batch_size,
                     row_align=2 ** (net.depth - 1))
    replicate(mesh, net)
    train_step = make_train_step(cfg, opt.train_matmul_precision,
                                 mesh if opt.distributed else None)
    if opt.distributed:
        log.line(f"data-parallel: {mesh.world_size} process(es) on {dist.get_backend()}, "
                 f"{opt.batch_size // mesh.data} of each batch's {opt.batch_size} rows a process"
                 f" (mesh data{mesh.data}xspace{mesh.space}"
                 + (f": each patch's rows in blocks of {mesh.row_align} raw rows over the "
                    f"space axis" if mesh.space > 1 else "") + ")")

    # autoresume (reference: train.py:15-28), with the optimizer state
    # where the run saved one (an rvdd_tpu run directory has none the port
    # reads: its moments restart, as the reference's do)
    epoch_start = 1
    status = load_status(save_dir)
    if opt.autoresume and status:
        restored = load_checkpoint(save_dir, str(status["epoch"]), net, state.optimizer)
        replicate(mesh, net)
        epoch_start = status["epoch"] + 1
        log.line(f"autoresumed from epoch {status['epoch']}"
                 + ("" if restored else " (no optimizer state: the moments restart)"))
    else:
        if writer:
            save_checkpoint(save_dir, "0", net)
        barrier()

    best_val = float(status.get("best_val", "inf")) if status else float("inf")
    td = opt.patch_depth - 1
    total_iters = 0
    val_image_dir = join(save_dir, "val_visuals")
    # plateau policy state (reference: networks/__init__.py:39-46)
    plateau_factor, plateau_best, plateau_wait = 1.0, float("inf"), 0
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    epochs = []
    trace, prof = None, None

    for epoch in range(epoch_start, opt.niter + opt.niter_decay + 1):
        if opt.lr_policy == "plateau":
            lr = opt.lr * plateau_factor
        else:
            lr = lr_for_epoch(epoch, opt.lr, opt.lr_policy, opt.niter, opt.niter_decay,
                              opt.lr_decay_iters)
        set_learning_rate(state, lr)
        epoch_t0 = time.time()
        epoch_len = max(len(train_ds) // opt.batch_size, 1)
        rec = dict(epoch=epoch, lr=lr, data_s=0.0)
        losses_seen, t_first = [], None
        sent0 = space.all_gather.bytes + space.all_sum.bytes
        data_t0 = time.time()
        for it, batch in enumerate(train_ds.batches(opt.batch_size)):
            t_data = time.time() - data_t0
            rec["data_s"] += t_data
            w = unroll_weights(opt.unroll_focus, td, epoch, it, epoch_len)
            # this process's data rows, then its space rows of each patch
            # (the flows come whole from the FlowCache, then are cut)
            frames, flows, gt = prepare_host_batch(
                shard_batch(mesh, {k: batch[k] for k in ("n", "flow", "gt") if k in batch},
                            spatial_axis=-3 if mesh.space > 1 else None), dev)
            if opt.profile_dir and epoch == epoch_start and it == TRACE_FIRST:
                prof = _start_trace(dev)
            t0 = time.time()
            state, losses = train_step(state, frames, flows, gt, torch.from_numpy(w),
                                       height=batch["n"].shape[-3])
            losses_seen.append(losses)
            if prof is not None and it == TRACE_LAST:
                trace, rec["trace_s"] = _stop_trace(prof, opt.profile_dir, rank, sync)
                prof = None
            if t_first is None:
                sync()
                t_first = time.perf_counter()
            total_iters += opt.batch_size
            if total_iters % opt.print_freq < opt.batch_size:
                sync()
                t_comp = (time.time() - t0) / opt.batch_size
                msg = (f"(epoch: {epoch}, iters: {total_iters}, time: {t_comp:.3f}, "
                       f"data: {t_data:.3f}) ")
                msg += " ".join(f"{k}: {float(v):.3f}" for k, v in losses.items())
                log.line(msg)
                clamp = float(losses.get("warp_clamp", 0.0))
                if clamp > 0.0:
                    log.line(
                        f"WARNING: rvdd_tpu's banded shift warp would have clamped "
                        f"{100 * clamp:.2f}% of the warped pixels this step (flows beyond "
                        f"its sweep radius {cfg.shift_warp_radius}), so its gradients "
                        "there would be approximate; the port's warp is exact.  Raise "
                        "--shift_warp_radius to match an rvdd_tpu run.")
            data_t0 = time.time()
        if prof is not None:  # the epoch ended before TRACE_LAST
            trace, rec["trace_s"] = _stop_trace(prof, opt.profile_dir, rank, sync)
            prof = None
        sync()
        steps = len(losses_seen)
        rec["steps"] = steps
        if mesh.space > 1 and steps:
            sent = space.all_gather.bytes + space.all_sum.bytes - sent0
            rec["exchange_mb_per_step"] = sent / 1e6 / steps
        # the trace's stop and export are not a step's time
        rec["step_ms"] = ((time.perf_counter() - t_first - rec.get("trace_s", 0.0)) * 1e3
                          / (steps - 1) if steps > 1 else None)
        if steps:
            every = torch.stack([v for step in losses_seen for v in step.values()])
            rec["finite"] = bool(torch.isfinite(every).all())
            rec["first"] = {k: float(v) for k, v in losses_seen[0].items()}
            rec["last"] = {k: float(v) for k, v in losses_seen[-1].items()}

        if epoch % opt.save_epoch_freq == 0:
            if writer:
                save_checkpoint(save_dir, "latest", net, state.optimizer)
                save_checkpoint(save_dir, str(epoch), net, state.optimizer)
                save_status(save_dir, {"epoch": epoch, "best_val": best_val})
            barrier()

        if not opt.no_val and epoch % opt.val_epoch_freq == 0:
            v0 = time.time()
            val_losses = {}
            if writer:
                # the reference validates non-recurrently while the gradual
                # schedule still trains with 1 unrolling
                # (recurrent_model.py:233-238,255-264)
                val_losses = compute_validation(
                    opt, net, val_ds, val_image_dir,
                    carry_state=active_unrollings(opt.unroll_focus, td, epoch) > 1)
            if opt.distributed:
                v = torch.tensor([val_losses.get("Denoiser_valLoss", 0.0)],
                                 dtype=torch.float64, device=dev)
                dist.broadcast(v, src=0)
                val_losses["Denoiser_valLoss"] = float(v)
            rec["val_s"] = time.time() - v0
            rec["val"] = dict(val_losses)
            val_losses["lr"] = lr
            if writer:
                msg = (f"---> validation: (epoch: {epoch}, time: {rec['val_s']:.1f}, "
                       f"#data: {len(val_ds)}) [")
                msg += ", ".join(f"{k}: {v:.3f}" for k, v in val_losses.items()) + "]"
                log.line(msg)
            if val_losses["Denoiser_valLoss"] < best_val:
                best_val = val_losses["Denoiser_valLoss"]
                if writer:
                    save_checkpoint(save_dir, "latest_val", net, state.optimizer)
                    save_status(save_dir, {"epoch": epoch, "best_val": best_val})
                barrier()

            if opt.lr_policy == "plateau":
                v = val_losses["Denoiser_valLoss"]
                if v < plateau_best * (1.0 - 0.01):
                    plateau_best, plateau_wait = v, 0
                else:
                    plateau_wait += 1
                    if plateau_wait > 5:
                        plateau_factor *= 0.2
                        plateau_wait = 0
                        log.line(f"plateau: lr factor -> {plateau_factor:.3e}")

        train_ds.prepare_epoch()
        epochs.append(rec)
        log.line(f"End of epoch {epoch} / {opt.niter + opt.niter_decay} \t"
                 f" Time Taken: {int(time.time() - epoch_t0)} sec (lr {lr:.7f})")

    caches = [c for c in (cache, val_ds.flow_cache if val_ds is not None else None) if c]
    return dict(epochs=epochs, flows_computed=sum(c.computed for c in caches),
                flow_seconds=sum(c.seconds for c in caches), rank=rank,
                world_size=mesh.world_size,
                backend=dist.get_backend() if opt.distributed else None, trace=trace)
