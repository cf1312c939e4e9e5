"""Dataset generation CLI: sRGB video -> synthetic noisy GBRG raw, on the
card (port of rvdd_tpu/cli/generate_data.py; reference:
dataset/generate_raw_from_RGB.py).  Emits the same folder structure:

    <out>/gt_iso<ISO>/<seq>/<frame>.tiff                 packed raw GT
    <out>/gt_raw_linear_RGB_iso<ISO>/<seq>/<frame>.tiff  uint16 linear RGB GT
    <out>/gt_RGB_iso<ISO>/<seq>/<frame>.png              sRGB GT (val only)
    <out>/noisy_iso<ISO>/<seq>/<frame>.tiff              noisy raw

The dither and the noise come from a ``torch.Generator`` on the device,
seeded by ``--seed`` (``--seed + 1`` for the validation split).

    python -m rvdd_tpu_torch.cli.generate_data \\
        --input_val_dataset path/%03d/%08d.png --output_val_dataset out \\
        --ISO 3200 --nb_seq_val 1 --first 0 --last 6 --step 1
"""

from __future__ import annotations

import argparse
from os.path import join

import numpy as np
import torch

from rvdd_tpu_torch.data.io import imread, imwrite
from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.ops.pipeline import find_gains, forward_pipeline, synthesize_raw


def process_split(in_pattern, out_root, nb_seq, iso, first, last, step, is_val, seed,
                  device="cuda"):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for seq in range(nb_seq):
        gains = find_gains(seq, iso)
        print(f"{'Validation' if is_val else 'Train'} dataset, sequence {seq:03d}")
        for i in range(first, last + step, step):
            img = imread(in_pattern % (seq, i)).astype(np.float32)
            h, w, _ = img.shape
            img = torch.from_numpy(img[: 2 * (h // 2), : 2 * (w // 2), :]).to(dev)
            gt_raw, gt_linear, noisy = synthesize_raw(img, gains, iso, gen)
            imwrite(join(out_root, f"gt_iso{iso:4d}", f"{seq:03d}", f"{i:08d}.tiff"),
                    gt_raw.cpu().numpy())
            imwrite(join(out_root, f"gt_raw_linear_RGB_iso{iso:4d}", f"{seq:03d}",
                         f"{i:08d}.tiff"),
                    torch.round(gt_linear).cpu().numpy().clip(0, 4095).astype(np.uint16))
            imwrite(join(out_root, f"noisy_iso{iso:4d}", f"{seq:03d}", f"{i:08d}.tiff"),
                    noisy.cpu().numpy())
            if is_val:
                srgb = forward_pipeline(gt_linear, gains, iso)
                imwrite(join(out_root, f"gt_RGB_iso{iso:4d}", f"{seq:03d}", f"{i:08d}.png"),
                        srgb.cpu().numpy().round().clip(0, 255).astype(np.uint8))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_val_dataset", type=str, default="")
    p.add_argument("--input_train_dataset", type=str, default="")
    p.add_argument("--output_val_dataset", type=str, default="")
    p.add_argument("--output_train_dataset", type=str, default="")
    p.add_argument("--nb_seq_val", type=int, default=5)
    p.add_argument("--nb_seq_train", type=int, default=240)
    p.add_argument("--ISO", type=int, default=3200, choices=[3200, 12800])
    p.add_argument("--first", type=int, default=0)
    p.add_argument("--last", type=int, default=498)
    p.add_argument("--step", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)
    resolve_device(a.device)

    if a.input_train_dataset:
        process_split(a.input_train_dataset, a.output_train_dataset, a.nb_seq_train, a.ISO,
                      a.first, a.last, a.step, False, a.seed, a.device)
    if a.input_val_dataset:
        process_split(a.input_val_dataset, a.output_val_dataset, a.nb_seq_val, a.ISO,
                      a.first, a.last, a.step, True, a.seed + 1, a.device)


if __name__ == "__main__":
    main()
