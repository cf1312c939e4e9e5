"""``convnext_chain``: every ConvNeXt block of the net and its 1x1 head.

The program runs the whole net in this kernel, so all of the net's
products are its work: the projections, the 7x7 depthwise taps and the two
1x1 products of each block, and the head.  The bytes are the net's input
and output at full resolution and its weights."""

from __future__ import annotations

from h100_bench.work._net_io import net_bytes
from h100_bench.work.model import forward_flops, rgb_size

#: substrings of the kernel's device names in a profiler trace
KERNELS = ("convnext_block_kernel",)


def per_frame(cfg: dict, mix: dict) -> tuple:
    """(FLOP, bytes) a frame of one stream."""
    h, w = rgb_size(mix)
    return forward_flops(cfg, 1, h, w), net_bytes(cfg, h * w)
