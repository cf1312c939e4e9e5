"""The model's work, counted from the layer shapes of the plain reference
net: each multiply-add of a conv or a 1x1 product once, as 2 FLOP, whatever
computes it and in however many passes.  The reference runs on the ``meta``
device under PyTorch's FLOP counter, so nothing is computed or allocated."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench.reference import nets

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


@functools.lru_cache(maxsize=32)
def _module_flops(cfg_json: str, batch: int, height: int, width: int) -> tuple:
    cfg = json.loads(cfg_json)
    net = nets.build(cfg, device="meta")
    x = torch.zeros(batch, height, width, cfg["net"]["in_channels"], device="meta")
    feat = torch.zeros(batch, height, width, net.filters, device="meta")
    with FlopCounterMode(display=False) as counter:
        net(x, feat)
    top = type(net).__name__
    per_module = {}
    for name, ops in counter.get_flop_counts().items():
        if name.startswith(top + "."):
            per_module[name[len(top) + 1:]] = sum(ops.values())
    return counter.get_total_flops(), tuple(sorted(per_module.items()))


def forward_flops(cfg: dict, batch: int, height: int, width: int, exclude=()) -> int:
    """FLOP of one forward of the configuration's net on NHWC inputs of
    ``batch`` x ``height`` x ``width``, less those of the top-level modules
    named in ``exclude``."""
    total, per_module = _module_flops(json.dumps(cfg, sort_keys=True), batch, height, width)
    return total - sum(dict(per_module).get(name, 0) for name in exclude)


def weight_count(cfg: dict, exclude=()) -> int:
    """Parameters of the configuration's net, less the top-level modules
    named in ``exclude``."""
    net = nets.build(cfg, device="meta")
    return sum(p.numel() for name, p in net.named_parameters()
               if name.split(".")[0] not in exclude)


def rgb_size(mix: dict) -> tuple:
    """(height, width) of the RGB frames a mix's raw frames demosaic to."""
    return 2 * mix["raw_height"], 2 * mix["raw_width"]
