"""``conv_chain``: ConvUNet's convs at full, half and quarter resolution.

The program runs the net's eighth-resolution core (the deepest encoder
level and the bottleneck) outside this kernel, so those layers are left
out of its work; everything else of the net is its work.  The bytes are
the net's input and output at full resolution and the weights: the least
any implementation of these layers must move."""

from __future__ import annotations

from h100_bench.work._net_io import net_bytes
from h100_bench.work.model import forward_flops, rgb_size

#: substrings of the kernel's device names in a profiler trace
KERNELS = ("conv_layer_kernel", "ws_layer_kernel")


def core(cfg: dict) -> tuple:
    """The top-level modules of the eighth-resolution core."""
    net = cfg["net"]
    depth = net.get("depth", 4)
    return (f"enc_conv{depth - 1}",) + tuple(
        f"bottleneck{i}" for i in range(net.get("bottleneck_depth", 2)))


def per_frame(cfg: dict, mix: dict) -> tuple:
    """(FLOP, bytes) a frame of one stream."""
    h, w = rgb_size(mix)
    return (forward_flops(cfg, 1, h, w, exclude=core(cfg)),
            net_bytes(cfg, h * w, exclude=core(cfg)))
