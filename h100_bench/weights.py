"""Seeded weights for both sides of the check, made on the device.

One normal draw for the whole net from the run's generator, carved into
the reference net's parameters in their order: conv and 1x1 kernels normal
with std sqrt(gain / fan_in), the configuration's ``init.kernel_gain``;
biases N(0, 0.02), LayerNorm weights 1 + N(0, 0.1), LayerScale 0.1 +
N(0, 0.02).  Nothing is zero, so every leaf of the net carries signal.  The
gain keeps a stream's recurrence bounded: with kaiming's 2, ConvUNet's
carried state grew about 1.26x a frame (fp32 overflows after some 370
frames) and ConvNeXt's about 3x (NaN after some 70); ConvNeXt at 1.0 still
grew on one seed in four.  At ConvUNet's 1.5 and ConvNeXt's 0.7 the state
held steady over 400 frames on every seed tried (8 and 12).  The same
tensors are loaded into the program's net and into the reference."""

from __future__ import annotations

import math

import torch

from h100_bench.reference import nets


def make(cfg: dict, gen: torch.Generator, device) -> dict:
    """name -> fp32 tensor on ``device`` for every parameter of the
    configuration's net."""
    specs = [(name, tuple(p.shape)) for name, p in nets.build(cfg, "meta").named_parameters()]
    flat = torch.randn(sum(math.prod(s) for _, s in specs), generator=gen, device=device)
    out, off = {}, 0
    gain = cfg["init"]["kernel_gain"]
    for name, shape in specs:
        z = flat[off:off + math.prod(shape)].view(shape)
        off += math.prod(shape)
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) == 4:
            w = z * math.sqrt(gain / (shape[1] * shape[2] * shape[3]))
        elif name.endswith("ln.weight"):
            w = 1.0 + 0.1 * z
        elif leaf == "layerscale":
            w = 0.1 + 0.02 * z
        else:
            w = 0.02 * z
        out[name] = w
    return out
