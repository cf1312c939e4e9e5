"""Flow cache: TV-L1 on the card with the reference's disk layout (port of
rvdd_tpu/data/flow_cache.py).

One ``<from>_<to>.tif`` per frame pair under
``dataroot/flow/<nFolder>/tvl1/noisyinputs/<seq>/`` (reference:
data/base_dataset.py:134-249, library.py:140-141).  Missing flows are
computed by the port's solver (ops/tvl1.py, whose warp on the card is the
``warp_catmull_zero`` kernel) on the cache's device and persisted in that
layout, so a cache written by either package serves the other.  A file
is written whole (a temporary file renamed into place); in a data-parallel
run only rank 0's cache persists (training/loop.py).
"""

from __future__ import annotations

import os
import time
from os.path import basename, isfile, join, splitext
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rvdd_tpu_torch.data.io import imread, imwrite
from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.ops.tvl1 import TVL1Params, to_gray, tvl1_flow


def flow_filename(flow_dir: str, from_code: str, to_code: str) -> str:
    return join(flow_dir, f"{from_code}_{to_code}.tif")


def frame_code(path: str) -> str:
    return splitext(basename(path))[0]


class FlowCache:
    """Computes and caches flows between frames of noisy sequences, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, dataroot: str, n_folder: str, flow_folder: str = "flow",
                 method: str = "tvl1", persist: bool = True,
                 params: Union[None, str, TVL1Params] = None, device="cuda"):
        self.base = join(dataroot, flow_folder, n_folder, method, "noisyinputs")
        self.persist = persist
        self.params = params
        self.device = resolve_device(device)
        #: flows computed (not read from disk) by this cache, and the
        #: seconds the solver took for them (host clock, device synchronized)
        self.computed = 0
        self.seconds = 0.0

    def seq_dir(self, seq_name: str) -> str:
        return join(self.base, seq_name)

    def _flow_batch(self, grays0: Sequence[torch.Tensor],
                    grays1: Sequence[torch.Tensor]) -> np.ndarray:
        """Flows of N pairs, one solver call each (each keeps its own
        early exits)."""
        t0 = time.perf_counter()
        outs = np.stack([tvl1_flow(g0, g1, self.params).cpu().numpy()
                         for g0, g1 in zip(grays0, grays1)])
        self.seconds += time.perf_counter() - t0
        self.computed += len(outs)
        return outs

    def get_flows(self, seq_name: str, frame_paths: Sequence[str],
                  pairs: Sequence[Tuple[int, int]], frames: Optional[np.ndarray] = None,
                  frame_offset: int = 0) -> np.ndarray:
        """Flows for (from_idx, to_idx) frame pairs of one sequence.

        ``frames``: optional preloaded [T, H, W, C] stack (raw range);
        otherwise frames are read from ``frame_paths``.  When ``frames`` is
        a window of the video rather than the whole clip, ``frame_offset``
        is the absolute index of ``frames[0]`` (pair indices are absolute).
        Returns [len(pairs), H, W, 2] float32.
        """
        fdir = self.seq_dir(seq_name)
        out: List[Optional[np.ndarray]] = [None] * len(pairs)
        missing = []
        for k, (i, j) in enumerate(pairs):
            f = flow_filename(fdir, frame_code(frame_paths[i]), frame_code(frame_paths[j]))
            if isfile(f):
                out[k] = imread(f).astype(np.float32)
            else:
                missing.append(k)
        if missing:
            def gray(idx):
                img = (frames[idx - frame_offset] if frames is not None
                       else imread(frame_paths[idx]).astype(np.float32))
                return to_gray(torch.from_numpy(np.asarray(img, np.float32)).to(self.device))

            g0 = [gray(pairs[k][1]) for k in missing]  # I0 = target
            g1 = [gray(pairs[k][0]) for k in missing]  # I1 = source
            flows = self._flow_batch(g0, g1)
            for n, k in enumerate(missing):
                out[k] = flows[n]
                if self.persist:
                    i, j = pairs[k]
                    os.makedirs(fdir, exist_ok=True)
                    self._persist(flow_filename(fdir, frame_code(frame_paths[i]),
                                                frame_code(frame_paths[j])), flows[n])
        return np.stack(out)

    @staticmethod
    def _persist(path: str, flow: np.ndarray) -> None:
        """Write through a temporary file and rename it into place, so that
        a reader (another process of a data-parallel run) finds the whole
        file or none."""
        tmp = f"{path[:-4]}.tmp{os.getpid()}.tif"
        imwrite(tmp, flow.astype(np.float32))
        os.replace(tmp, path)

    def window_pairs(self, t0: int, patch_depth: int, future_patch_depth: int):
        """(from, to) indices for one window whose current frame is
        t0 + patch_depth - 1 (reference: data/base_dataset.py:74-132)."""
        cur = t0 + patch_depth - 1
        pairs = [(t0 + n, cur) for n in range(patch_depth - 1)]
        pairs += [(cur + n + 1, cur) for n in range(future_patch_depth)]
        return pairs
