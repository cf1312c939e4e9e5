"""Streaming 1080p throughput of the port's main paths on one card.

Port of bench.py's inference mode for two models:

* ``convunet+feat`` (the default): recurrent convunet+feat;
* ``convnext+feat+future``: the ConvNeXt flagship ``newunet-mode=feat``
  with the future frame (a window of 3 raw frames and 2 flows a step).

One stream, packed GBRG raw 540x960x4 in and RGB 1080x1920x3 out, with the
smooth seeded flow of bench.py (a TV-L1-like field, flows given, as the
reference precomputes them).  Per frame: Hamilton-Adams demosaic of the
current (and future) frame and the flow upsample (plain PyTorch), then the
fused step: the CUDA warp of the fp32 recurrence state (and of the future
frame) and the CUDA chains of the model's family (six ``conv_chain``, or
seven ``convnext_chain``).  The first frame runs with ``state=None``; then
warm-up frames; then ``frames`` timed frames ending in
``torch.cuda.synchronize()``.  Weights are seeded kaiming.

    python -m rvdd_tpu_torch.bench [--model convunet+feat] [--frames 30]
                                   [--height 540] [--width 960] [--profile]

Prints one JSON line: metric, value (frames/s), unit, and the card's name
and power limit.  Without a card it raises; it never reports a CPU number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.models import build_network
from rvdd_tpu_torch.recurrent.engine import (
    EngineConfig,
    fused_pack,
    inference_step,
    prepare_frames,
    step,
)

#: --model -> (architecture string, future_patch_depth), as bench.py:144-151
MODELS = {
    "convunet+feat": ("convunet-mode=fixedfeatures+feat", 0),
    "convnext+feat+future": ("newunet-mode=feat", 1),
}


def make_inputs(height: int = 540, width: int = 960, seed: int = 0, device="cuda",
                model: str = "convunet+feat"):
    """A raw window [1, 2 + fD, h, w, 4] uniform in [-1, 1] and the smooth
    flow [1, 1, 1 + fD, h, w, 2] of bench.py (gaussian-filtered noise, sigma
    40 px, x25, offset (+2, -1) px at raw resolution, the same field for
    every flow), from numpy seed ``seed``."""
    from scipy.ndimage import gaussian_filter

    fd = MODELS[model][1]
    rng = np.random.default_rng(seed)
    raw = rng.uniform(-1, 1, (1, 2 + fd, height, width, 4)).astype(np.float32)
    fl = np.stack([
        gaussian_filter(rng.standard_normal((height, width)), 40) * 25 + 2,
        gaussian_filter(rng.standard_normal((height, width)), 40) * 25 - 1,
    ], -1).astype(np.float32)
    flows = np.broadcast_to(fl, (1, 1, 1 + fd, height, width, 2)).copy()
    dev = torch.device(device)
    return torch.from_numpy(raw).to(dev), torch.from_numpy(flows).to(dev)


def make_model(net_impl: str = "fused", seed: int = 0, device="cuda",
               model: str = "convunet+feat"):
    """(cfg, net, packed) for ``model`` with seeded kaiming weights.  The
    ConvNeXt module path runs the exact GELU; the fused path runs the tanh
    GELU of the 'fast' preset."""
    arch, fd = MODELS[model]
    cfg = EngineConfig(model_patch_depth=2, future_patch_depth=fd, feature_rec=True,
                       warp_impl="kernel" if net_impl == "fused" else "plain",
                       net_impl=net_impl)
    net = build_network(arch, cfg.network_input_nc, 3, True, seed=seed, device=device)
    packed = fused_pack(cfg, net) if net_impl == "fused" else None
    return cfg, net, packed


def step_fn(cfg, net, packed, state, raw_window, flows):
    """One streamed frame from raw: demosaic + flow upsample + step.  With a
    carried state the step reads only the window's current and future
    frames, so only those are demosaicked."""
    if state is None:
        frames, flows2 = prepare_frames(cfg, raw_window, flows)
        b, _, h, w, _ = frames.shape
        nil = net.nil_features(b, h, w) if cfg.feature_rec else None
        return inference_step(cfg, net, None, frames, flows2[:, 0], nil, packed)
    frames, flows2 = prepare_frames(cfg, raw_window[:, cfg.d:], flows)
    future = frames[:, 1:] if cfg.future_patch_depth else None
    with torch.no_grad():
        return step(cfg, net, state, frames[:, 0], future, flows2[:, 0], packed)


def card_info() -> str:
    """`name, power limit` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


WARMUP_FRAMES = 2  # streamed frames before timing: the allocator settles


def _warm_stream(height, width, seed, device, model):
    """The fused main path on the card after the first frame (state=None)
    and the warm-up frames: (dev, frame, state)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; it has no CPU mode")
    cfg, net, packed = make_model("fused", seed, dev, model)
    raw, flows = make_inputs(height, width, seed, dev, model)

    def frame(state):
        return step_fn(cfg, net, packed, state, raw, flows)

    _, state = frame(None)
    for _ in range(WARMUP_FRAMES):
        _, state = frame(state)
    torch.cuda.synchronize(dev)
    return dev, frame, state


def run(frames: int = 30, height: int = 540, width: int = 960, seed: int = 0,
        device="cuda", model: str = "convunet+feat") -> dict:
    """Time ``frames`` streamed frames on the card; returns the JSON record."""
    dev, frame, state = _warm_stream(height, width, seed, device, model)
    t0 = time.perf_counter()
    for _ in range(frames):
        den, state = frame(state)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if not torch.isfinite(den).all():
        raise RuntimeError("non-finite output")
    res = f"{2 * height}p" if (height, width) == (540, 960) else f"{2 * height}x{2 * width}"
    return {
        "metric": f"{res}_fps_per_chip_{model.replace('+', '_')}",
        "value": frames / dt,
        "unit": "frames/sec",
        "ms_per_frame": 1e3 * dt / frames,
        "device": torch.cuda.get_device_name(dev),
        "card": card_info(),
    }


def _kernel_group(name: str) -> str:
    if "conv_layer_kernel" in name:
        return "conv_chain (CUDA)"
    if "convnext_block_kernel" in name:
        return "convnext_chain (CUDA)"
    if "warp_bicubic_kernel" in name:
        return "warp_bicubic (CUDA)"
    return name[:90]


def profile(frames: int = 5, height: int = 540, width: int = 960, seed: int = 0,
            device="cuda", model: str = "convunet+feat") -> dict:
    """Device time by kernel over ``frames`` streamed frames (torch.profiler,
    CUDA activity), per frame; busy = the sum of kernel durations (one
    stream, so they do not overlap), idle share = 1 - busy / wall."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev, frame, state = _warm_stream(height, width, seed, device, model)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            _, state = frame(state)
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / frames
    groups: dict = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        g = groups.setdefault(_kernel_group(evt.name), [0.0, 0])
        g[0] += evt.time_range.elapsed_us() / 1e3 / frames
        g[1] += 1
    busy = sum(v[0] for v in groups.values())
    rows = sorted(((k, v[0], v[1] / frames) for k, v in groups.items()),
                  key=lambda r: -r[1])
    return {"wall_ms_per_frame": wall_ms, "busy_ms_per_frame": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "kernels": [{"name": k, "ms_per_frame": ms, "launches_per_frame": n}
                        for k, ms, n in rows],
            "device": torch.cuda.get_device_name(dev), "card": card_info()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="convunet+feat", choices=list(MODELS))
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--height", type=int, default=540, help="raw (half-res) height")
    ap.add_argument("--width", type=int, default=960, help="raw (half-res) width")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="print device time by kernel (torch.profiler) instead of fps")
    args = ap.parse_args(argv)
    if args.profile:
        rec = profile(min(args.frames, 10), args.height, args.width, args.seed,
                      model=args.model)
        for k in rec["kernels"]:
            print(f"{k['ms_per_frame']:9.3f} ms/frame {k['launches_per_frame']:6.1f} x  {k['name']}")
        print(json.dumps({k: v for k, v in rec.items() if k != "kernels"}))
        return
    print(json.dumps(run(args.frames, args.height, args.width, args.seed, model=args.model)))


if __name__ == "__main__":
    main()
