"""Validation / inference CLI (port of rvdd_tpu/cli/validate.py; reference:
validate.py).

Runs serial full-frame inference over the validation videos, carrying the
recurrence across frames (or, with ``--val_scan``, streaming each clip
through ``engine.scan_video``), saving ``<frame>_denoised.tif`` visuals and
``val_losses.json``.  Loads rvdd_tpu checkpoints (``--epoch latest_val``
etc. under ``--checkpoints_dir``, or ``--path2epoch`` a ``.msgpack`` file)
or released PyTorch weights (``--path2epoch <prefix>`` of a
``<prefix>_net_Denoise.pth``).  Runs on the card; ``--device cpu`` runs the
plain versions on the CPU.

    python -m rvdd_tpu_torch.cli.validate --netDenoiser convunet-mode=fixedfeatures+feat \\
        --feature_rec --path2epoch trained-nets/recurrent-convunet+feat-tinyconv-iso3200.msgpack \\
        --val_dataroot data/validation --gtFolder gt_iso3200 --nFolder noisy_iso3200 \\
        --gt_linear_RGB_Folder gt_raw_linear_RGB_iso3200 [--net_impl fused] [--val_scan]
"""

from __future__ import annotations

import json
import os
import time
from os.path import join

import torch

from rvdd_tpu_torch.config import parse_options
from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.models import build_network
from rvdd_tpu_torch.training.checkpoints import load_checkpoint
from rvdd_tpu_torch.training.loop import (
    build_validation,
    compute_validation,
    compute_validation_scan,
)


def main(argv=None) -> dict:
    """Returns the averaged losses, the frames scored, the seconds of the
    run (host clock, the card synchronized) and the flows the cache
    computed with their seconds."""
    opt = parse_options(argv, train=False)
    opt.isTrain = False
    dev = resolve_device(opt.device)
    if opt.exact_precision:
        from rvdd_tpu_torch.precision import use_exact_precision

        use_exact_precision()

    cfg = opt.engine_config()
    val_ds = build_validation(opt)
    print(f"Number of validation images = {len(val_ds)}")

    net = build_network(opt.netDenoiser, cfg.network_input_nc, opt.output_nc, cfg.feature_rec,
                        device=dev)
    if opt.path2epoch:
        load_checkpoint(opt.path2epoch, None, net)
        print(f"loading the model from {opt.path2epoch}")
    else:
        load_checkpoint(opt.save_dir, opt.epoch, net)
        print(f"loading the model from {opt.save_dir} @ {opt.epoch}")

    val_image_dir = join(opt.save_dir, "val_visuals")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    if opt.val_scan:
        if opt.val_flow_from_denoised:
            raise NotImplementedError("--val_scan with --val_flow_from_denoised")
        losses = compute_validation_scan(opt, net, val_ds, val_image_dir)
    else:
        losses = compute_validation(opt, net, val_ds, val_image_dir,
                                    flow_from_denoised=opt.val_flow_from_denoised)
    sync()
    seconds = time.perf_counter() - t0
    msg = ", ".join(f"{k}: {v:.3f}" for k, v in losses.items())
    print(f"---> validation: (time: {seconds:.1f}, #data: {len(val_ds)}) [{msg}]")
    os.makedirs(opt.save_dir, exist_ok=True)
    with open(join(opt.save_dir, "val_losses.json"), "w") as f:
        json.dump(losses, f, indent=2)
    cache = val_ds.flow_cache
    return dict(losses=losses, frames=len(val_ds), seconds=seconds,
                flows_computed=cache.computed if cache else 0,
                flow_seconds=cache.seconds if cache else 0.0)


if __name__ == "__main__":
    main()
