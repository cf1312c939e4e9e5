"""Scoring CLI: forward pipeline + sRGB PSNR/SSIM tables (port of
rvdd_tpu/cli/score.py; reference: dataset/fwd_ppipe.py:91-163).

Converts ``<seq>/<frame>_denoised.tif`` results to sRGB through the forward
camera pipeline (on the card; ``--device cpu`` on the CPU), scores them
against ``gt_RGB_iso*`` and writes PSNR.txt / SSIM.txt with averages.
"""

from __future__ import annotations

import argparse
from os.path import join

import numpy as np
import torch

from rvdd_tpu_torch.data.io import imread, imwrite
from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.ops.metrics import psnr_srgb, ssim_srgb
from rvdd_tpu_torch.ops.pipeline import find_gains, forward_pipeline


def main(argv=None) -> dict:
    """Returns the average PSNR and SSIM."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--validation_path", type=str, required=True)
    p.add_argument("--result_folder", type=str, required=True)
    p.add_argument("--videos", type=str, default="")
    p.add_argument("--first", type=int, default=3)
    p.add_argument("--last", type=int, default=264)
    p.add_argument("--step", type=int, default=3)
    p.add_argument("--bit_depth", type=int, default=8)
    p.add_argument("--ISO", type=int, default=3200)
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)

    seqs = list(range(30)) if not a.videos else [int(s) for s in a.videos.split(",")]
    all_psnr, all_ssim = [], []
    with open(join(a.result_folder, "PSNR.txt"), "w") as psnr_f, \
            open(join(a.result_folder, "SSIM.txt"), "w") as ssim_f:
        for seq in seqs:
            gains = find_gains(seq, a.ISO)
            for i in range(a.first, a.last + a.step, a.step):
                img = imread(join(a.result_folder, f"{seq:03d}/{i:08d}_denoised.tif")
                             ).astype(np.float64)
                if img.shape[-1] != 3:
                    raise ValueError(f"results must be RGB, got {img.shape}")
                # normalize to [0, 4095] (reference: fwd_ppipe.py:127-133)
                if a.bit_depth == 0:
                    img = img * 4095
                else:
                    img = img / {8: 255, 10: 1024, 12: 4095}[a.bit_depth] * 4095
                im = torch.from_numpy(img.astype(np.float32)).to(dev)
                srgb = forward_pipeline(im, gains, a.ISO).cpu().numpy()
                srgb = srgb.round().clip(0, 255).astype(np.uint8)
                imwrite(join(a.result_folder, f"{seq:03d}/{i:08d}_processed_pipeline.png"), srgb)
                gt = imread(join(a.validation_path, f"gt_RGB_iso{a.ISO}/{seq:03d}/{i:08d}.png"))
                pv, sv = psnr_srgb(srgb, gt), ssim_srgb(srgb, gt)
                all_psnr.append(pv)
                all_ssim.append(sv)
                psnr_f.write(f"{pv}\n")
                ssim_f.write(f"{sv}\n")
                print(f"seq {seq:03d} frame {i:03d}: PSNR {pv:.2f}  SSIM {sv:.4f}")
        psnr_f.write(f"\n\n###  Average: {np.mean(all_psnr):4.2f} dB  ###")
        ssim_f.write(f"\n\n###  Average: {np.mean(all_ssim):4.3f}  ###")
    print(f"Average PSNR: {np.mean(all_psnr):4.2f}")
    print(f"Average SSIM: {np.mean(all_ssim):4.3f}")
    return dict(psnr=float(np.mean(all_psnr)), ssim=float(np.mean(all_ssim)))


if __name__ == "__main__":
    main()
