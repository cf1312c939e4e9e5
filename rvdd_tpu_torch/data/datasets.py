"""Serial full-frame inference windows over validation videos (port of
rvdd_tpu/data/datasets.py:InferenceDataset; reference:
data/infer4rec_dataset.py).

Frames come stacked on a time axis, NHWC, normalized to [0, 1] by bit depth
and mapped to [-1, 1] (transform 'T').  Flows come from a
:class:`FlowCache`; the first frames of a video have none, and the caller
treats them as zero (reference: infer4rec_dataset.py:198-200).  The
training dataset (``TrainWindowDataset``) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from os.path import basename, join
from typing import Dict, Optional

import numpy as np

from rvdd_tpu_torch.data.flow_cache import FlowCache
from rvdd_tpu_torch.data.io import list_sequence_dirs, list_video_files, load_image_stack


def _to_net(x: np.ndarray) -> np.ndarray:
    return (2.0 * x - 1.0).astype(np.float32)


class InferenceDataset:
    """Serial full-frame windows [t-D, t+fD] of each validation video, in
    order, with ``FirstOfVideo`` marking each video's first window."""

    def __init__(self, dataroot: str, gt_folder: str, n_folder: str, *,
                 patch_depth: int = 2, future_patch_depth: int = 0, bit_depth: int = 12,
                 raw_gt: bool = False, no_predemosaic: bool = False,
                 videos: Optional[str] = None, flow_cache: Optional[FlowCache] = None,
                 no_warp: bool = False, crop_data: Optional[str] = None):
        self.gt_dirs = list_sequence_dirs(join(dataroot, gt_folder), videos)
        self.n_dirs = list_sequence_dirs(join(dataroot, n_folder), videos)
        if len(self.gt_dirs) != len(self.n_dirs) or not self.gt_dirs:
            raise ValueError(f"bad dataset layout under {dataroot}: {len(self.gt_dirs)} "
                             f"ground-truth and {len(self.n_dirs)} noisy sequences")
        self.pd = patch_depth
        self.fd = future_patch_depth
        self.bit_depth = bit_depth
        self.raw_gt = raw_gt
        self.no_predemosaic = no_predemosaic
        self.no_warp = no_warp
        self.flow_cache = flow_cache
        self.crop = tuple(int(s) for s in crop_data.split(",")) if crop_data else None

        self.samples = []  # (seq, n_paths, gt_paths, window_start)
        for gt_dir, n_dir in zip(self.gt_dirs, self.n_dirs):
            gt_paths = list_video_files(gt_dir)
            n_paths = list_video_files(n_dir)
            seq = basename(n_dir)
            for z in range(len(n_paths) - self.pd - self.fd + 1):
                self.samples.append((seq, n_paths, gt_paths, z))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict:
        seq, n_paths, gt_paths, z = self.samples[index]
        gt = load_image_stack([gt_paths[z + k] for k in range(self.pd)], self.bit_depth)
        noisy = load_image_stack([n_paths[z + k] for k in range(self.pd + self.fd)],
                                 self.bit_depth)
        item = {
            "gt": _to_net(gt),
            "n": _to_net(noisy),
            "n_path": n_paths[z + self.pd - 1],
            "gt_path": gt_paths[z + self.pd - 1],
            "FirstOfVideo": z == 0,
            "seq": seq,
        }
        if not self.no_warp and self.flow_cache is not None:
            pairs = self.flow_cache.window_pairs(z, self.pd, self.fd)
            # cache misses reuse the loaded window (raw range)
            raw = noisy * (2.0 ** float(self.bit_depth) - 1.0)
            item["flow"] = self.flow_cache.get_flows(
                seq, n_paths, pairs, frames=raw, frame_offset=z).astype(np.float32)
        if self.crop is not None:
            cx, cy = self.crop
            item["n"] = item["n"][:, :cx, :cy]
            if "flow" in item:
                item["flow"] = item["flow"][:, :cx, :cy]
            g = 1 if self.raw_gt else 2
            item["gt"] = item["gt"][:, : g * cx, : g * cy]
        return item

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
