"""Datasets: windowed training patches and serial full-frame inference
windows (port of rvdd_tpu/data/datasets.py; reference:
data/axel4rec_dataset.py and data/infer4rec_dataset.py).

Frames come stacked on a time axis, NHWC, normalized to [0, 1] by bit depth
and mapped to [-1, 1] (transform 'T').  Flows come from a
:class:`FlowCache`, which computes missing ones on its device.  The first
frames of a video have none at inference, and the caller treats them as
zero (reference: infer4rec_dataset.py:198-200).

:class:`TrainWindowDataset` draws its windows, keys and order from the same
``np.random.default_rng(seed)`` and ``random.Random(seed)`` streams as
rvdd_tpu's, so both packages give the same batches from the same data.
"""

from __future__ import annotations

import queue
import random
import threading
from os.path import basename, join
from typing import Dict, Iterator, Optional

import numpy as np

from rvdd_tpu_torch.data.flow_cache import FlowCache
from rvdd_tpu_torch.data.io import list_sequence_dirs, list_video_files, load_image_stack


def _to_net(x: np.ndarray) -> np.ndarray:
    return (2.0 * x - 1.0).astype(np.float32)


class TrainWindowDataset:
    """Random 3-D patches from a windowed in-RAM cache of each video.

    Epoch protocol (reference: axel4rec_dataset.py:113-179): per video pick
    a random temporal window of ``frames2load`` frames, load it (and its
    flow stacks) to RAM, grid the spatial and temporal patch keys with
    stride ``patch_stride`` and shuffle.  Call :meth:`prepare_epoch`
    between epochs to re-randomize.
    """

    def __init__(self, dataroot: str, gt_folder: str, n_folder: str, *,
                 patch_width: int = 136, patch_stride: int = 3, patch_depth: int = 5,
                 model_patch_depth: int = 2, future_patch_depth: int = 0,
                 frames2load: int = 10, bit_depth: int = 12, raw_gt: bool = False,
                 no_predemosaic: bool = False, videos: Optional[str] = None,
                 flow_cache: Optional[FlowCache] = None, no_warp: bool = False,
                 seed: Optional[int] = None):
        self.gt_dirs = list_sequence_dirs(join(dataroot, gt_folder), videos)
        self.n_dirs = list_sequence_dirs(join(dataroot, n_folder), videos)
        if len(self.gt_dirs) != len(self.n_dirs) or not self.gt_dirs:
            raise ValueError(f"bad dataset layout under {dataroot}: {len(self.gt_dirs)} "
                             f"ground-truth and {len(self.n_dirs)} noisy sequences")
        self.pw = patch_width
        self.stride = patch_stride
        self.total_depth = patch_depth
        self.pd = model_patch_depth
        self.fd = future_patch_depth
        self.frames2load = frames2load
        self.bit_depth = bit_depth
        self.raw_gt = raw_gt
        self.no_predemosaic = no_predemosaic
        self.no_warp = no_warp
        self.flow_cache = flow_cache
        self.rng = np.random.default_rng(seed)
        self.pyrng = random.Random(seed)
        self.prepare_epoch()

    def prepare_epoch(self) -> None:
        self.videos_gt, self.videos_noisy, self.videos_flow = [], [], []
        self.noisy_paths = []
        n_load = self.frames2load
        for gt_dir, n_dir in zip(self.gt_dirs, self.n_dirs):
            gt_paths = list_video_files(gt_dir)
            n_paths = list_video_files(n_dir)
            if len(gt_paths) != len(n_paths):
                raise ValueError(f"{gt_dir}: {len(gt_paths)} ground-truth frames, "
                                 f"{len(n_paths)} noisy")
            start = int(self.rng.integers(len(gt_paths) - n_load + 1))
            gt_paths = gt_paths[start:start + n_load]
            n_paths = n_paths[start:start + n_load]
            self.videos_gt.append(load_image_stack(gt_paths, self.bit_depth))
            noisy = load_image_stack(n_paths, self.bit_depth)
            self.videos_noisy.append(noisy)
            self.noisy_paths.append(n_paths)
            if self.no_warp or self.flow_cache is None:
                self.videos_flow.append(None)
                continue
            seq = basename(n_dir)
            raw_frames = noisy * (2.0 ** float(self.bit_depth) - 1.0)
            windows = [self.flow_cache.get_flows(seq, n_paths,
                                                 self.flow_cache.window_pairs(z, self.pd, self.fd),
                                                 frames=raw_frames)
                       for z in range(n_load - self.pd - self.fd + 1)]
            self.videos_flow.append(np.stack(windows))  # [Z, D+fD, H, W, 2]

        # 3-D patch key grid (reference: axel4rec_dataset.py:161-178)
        keys = []
        for i, v in enumerate(self.videos_noisy):
            zs = np.arange(0, v.shape[0] - self.total_depth - self.fd + 1, self.stride)
            ys = np.arange(self.pw + 1, v.shape[1] + 1, self.stride)
            xs = np.arange(self.pw + 1, v.shape[2] + 1, self.stride)
            xx, yy, zz = np.meshgrid(xs, ys, zs)
            keys.append(np.stack([np.full(xx.size, i, np.uint32), xx.ravel(), yy.ravel(),
                                  zz.ravel()], 1))
        self.keys = np.concatenate(keys, 0)
        self.indices = list(range(len(self.keys)))
        self.pyrng.shuffle(self.indices)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        i, x, y, z = (int(v) for v in self.keys[self.indices[index]])
        pw = self.pw
        if not self.no_predemosaic:
            # keep the crop Bayer-phase aligned (reference:
            # axel4rec_dataset.py:207-210)
            x -= (x - pw) % 2
            y -= (y - pw) % 2
        up = 1 if self.raw_gt else 2  # the linear RGB ground truth is full size
        gt = self.videos_gt[i][z:z + self.total_depth, up * (y - pw):up * y,
                               up * (x - pw):up * x]
        noisy = self.videos_noisy[i][z:z + self.total_depth + self.fd, y - pw:y, x - pw:x]
        item = {"gt": _to_net(gt), "n": _to_net(noisy),
                "n_path": self.noisy_paths[i][z + self.total_depth - 1]}
        if self.videos_flow[i] is not None:
            item["flow"] = self.videos_flow[i][z:z + self.total_depth - self.pd + 1, :,
                                               y - pw:y, x - pw:x].astype(np.float32)
        return item

    def batches(self, batch_size: int, drop_last: bool = True,
                prefetch: int = 2) -> Iterator[Dict]:
        """Shuffled numpy batches, assembled by a background thread so host
        batch prep overlaps device compute (the reference used DataLoader
        worker processes for this; data/__init__.py:75-80).  A generator
        abandoned mid-epoch stops its thread when it is closed."""
        n = len(self)
        stop = n - (n % batch_size) if drop_last else n

        def make(s):
            items = [self[k] for k in range(s, min(s + batch_size, n))]
            out = {k: np.stack([it[k] for it in items]) for k in items[0]
                   if isinstance(items[0][k], np.ndarray)}
            out["n_path"] = [it["n_path"] for it in items]
            return out

        starts = list(range(0, stop, batch_size))
        if prefetch <= 0:
            for s in starts:
                yield make(s)
            return

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        cancelled = threading.Event()

        def put(item) -> bool:
            # a plain q.put would block forever once the consumer abandons
            # the generator (a bounded queue nobody drains), and the thread
            # would go on assembling batches beside whatever runs next: poll
            # the cancel flag instead
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for s in starts:
                    if cancelled.is_set() or not put(("ok", make(s))):
                        return
            except Exception as e:  # surface the worker's error in the consumer
                put(("err", e))
            put(("done", None))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    break
                if kind == "err":
                    raise payload
                yield payload
        finally:
            cancelled.set()
            while True:  # unblock a producer between put attempts
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)


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
