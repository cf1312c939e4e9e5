"""Bytes a net's forward must move at the least: its inputs (the frame
stack and the warped features, in the glue dtype the configuration
states) read once, its outputs (the frame and the next features, fp32)
written once, and its weights read once in the configuration's weight
dtype."""

from __future__ import annotations

from h100_bench.work.model import DTYPE_BYTES, weight_count


def net_bytes(cfg: dict, pixels: int, exclude=()) -> int:
    net = cfg["net"]
    glue = DTYPE_BYTES[cfg["dtypes"]["glue"]]
    feat = net.get("filters", 48)
    per_pixel = (net["in_channels"] + feat) * glue + (net["out_channels"] + feat) * 4
    return pixels * per_pixel + weight_count(cfg, exclude) * DTYPE_BYTES[cfg["dtypes"]["weights"]]
