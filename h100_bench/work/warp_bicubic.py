"""``warp_bicubic``: the bicubic warps of a streamed frame, which do no
products: the bound is bytes alone.

Two warps a frame: the carried state (the last output and the last
features, fp32) and the future frame (in the glue dtype), each to the
current frame by its own flow (fp32, two channels).  Each input byte is
read once, each output byte written once, the outputs in the glue dtype."""

from __future__ import annotations

from h100_bench.work.model import DTYPE_BYTES, rgb_size

#: substrings of the kernel's device names in a profiler trace
KERNELS = ("warp_bicubic_kernel",)


def per_frame(cfg: dict, mix: dict) -> tuple:
    """(FLOP, bytes) a frame of one stream."""
    h, w = rgb_size(mix)
    net = cfg["net"]
    glue = DTYPE_BYTES[cfg["dtypes"]["glue"]]
    state_c = net["out_channels"] + net.get("filters", 48)
    frame_c = cfg["engine"]["input_nc"]
    flow = 2 * 4
    per_pixel = state_c * (4 + glue) + flow + frame_c * 2 * glue + flow
    return 0, h * w * per_pixel
