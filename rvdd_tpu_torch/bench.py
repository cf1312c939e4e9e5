"""Streaming 1080p throughput of the port's main paths on one card.

Port of bench.py's inference mode for three models:

* ``convunet+feat`` (the default): recurrent convunet+feat;
* ``convunet+feat+future``: the same net with the future frame (a window
  of 3 raw frames and 2 flows a step, 9 input channels);
* ``convnext+feat+future``: the ConvNeXt flagship ``newunet-mode=feat``
  with the future frame.

``--precision`` picks the fused-path preset of the model's family
(ConvUNet: models/fast_unet.py:FUSED_PRECISIONS, or ``hybrid:<chains>``;
the ConvNeXt flagship: models/fast_convnext.py:CNX_PRECISIONS, ``fast``,
``mixed``, ``accurate``, ``wsplit`` or ``wf32``); the default ``auto``
resolves as bench.py:152-156 does: ``hybrid:glue+A+dec2`` for
convunet+feat+future (chains A and dec2 in the kernel's fp32 mode, fp32
warps), ``fast`` for the others.

One stream, packed GBRG raw 540x960x4 in and RGB 1080x1920x3 out.  Per
frame: Hamilton-Adams demosaic of the current (and future) frame and the
flow upsample (plain PyTorch), then the fused step: the CUDA warp of the
fp32 recurrence state (and of the future frame) and the CUDA chains of the
model's family (six ``conv_chain``, or seven ``convnext_chain``).  The
first frame runs with ``state=None``; then warm-up frames; then ``frames``
timed frames ending in ``torch.cuda.synchronize()``.  Weights are seeded
kaiming.

Flows come in one of two ways:

* cached (the default): the smooth seeded flow of bench.py (a TV-L1-like
  field), given, as the reference precomputes flows offline; the raw frames
  are uniform noise;
* online (``--with_flow``, self-contained streaming): every frame first
  computes its window's flows on the card with the TV-L1 solver
  (``compute_window_flows``: 1 flow a frame for convunet+feat, 2 for the
  flagship), whose warp is the CUDA kernel ``warp_catmull_zero``.  The
  default preset is the C library's (5 warps, at most 300 iterations a
  stage), ``--fast_flow`` the fast one (2 warps, at most 75).  The frames
  have real motion: the current frame is a seeded smooth texture, the
  others that texture displaced by the smooth field, all with noise.  The
  solver is launch-bound plain PyTorch around its kernel (PERF.md).

    python -m rvdd_tpu_torch.bench [--model convunet+feat] [--frames 30]
                                   [--precision auto]
                                   [--with_flow [--fast_flow]]
                                   [--height 540] [--width 960] [--profile]

Prints one JSON line: metric (``1080p_fps_per_chip_<model>``, with
``_online_flow`` or ``_online_flow_fast`` appended for online flows, and
``_<preset>`` for a ``--precision`` other than ``auto``), value
(frames/s), unit, ms per frame, the resolved preset, with online flows
``flow_ms_per_frame``
(CUDA events around compute_window_flows) and
``flow_iterations_per_frame``, and the card's name and power limit.
``--profile`` prints device time by kernel instead, the solver's launches
as groups of their own.  Without a card it raises; it never reports a CPU
number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.models import build_network
from rvdd_tpu_torch.models.fast_convnext import cnx_precision
from rvdd_tpu_torch.models.fast_unet import resolve_fused_precision
from rvdd_tpu_torch.recurrent.engine import (
    EngineConfig,
    compute_window_flows,
    fused_pack,
    inference_step,
    prepare_frames,
    step,
)

#: --model -> (architecture string, future_patch_depth), as bench.py:144-151
MODELS = {
    "convunet+feat": ("convunet-mode=fixedfeatures+feat", 0),
    "convunet+feat+future": ("convunet-mode=fixedfeatures+feat", 1),
    "convnext+feat+future": ("newunet-mode=feat", 1),
}


def resolve_precision(model: str, precision: str = "auto") -> str:
    """The fused preset ``model`` runs under ``precision`` ('auto' resolves
    as bench.py:152-156), checked against the presets of its family."""
    arch, fd = MODELS[model]
    name = resolve_fused_precision(precision, arch=arch, feature_rec=True, future=fd > 0) \
        if precision == "auto" else precision
    if arch.startswith("newunet"):
        cnx_precision(name)
        return name
    return resolve_fused_precision(name, arch=arch, feature_rec=True, future=fd > 0)


def make_inputs(height: int = 540, width: int = 960, seed: int = 0, device="cuda",
                model: str = "convunet+feat", with_flow: bool = False):
    """A raw window [1, 2 + fD, h, w, 4] and flows [1, 1, 1 + fD, h, w, 2]
    from numpy seed ``seed``.

    The flow field is bench.py's smooth one (gaussian-filtered noise, sigma
    40 px, x25, offset (+2, -1) px at raw resolution).  Cached mode: the raw
    frames are uniform in [-1, 1] and every flow is that field.  With
    ``with_flow`` the window has real motion for the online solver: the
    current frame is a smooth texture (gaussian-filtered noise, sigma 2 px,
    std 0.25, per-channel gains), frame i is that texture sampled at
    x - k * field(x) with k = 1 before the current frame and -1 after it,
    and every frame gets noise of sigma 0.02; the returned flows are the
    true ones, k * field (up to the field's second-order change over k px).
    """
    from scipy.ndimage import gaussian_filter, map_coordinates

    fd = MODELS[model][1]
    rng = np.random.default_rng(seed)
    raw = rng.uniform(-1, 1, (1, 2 + fd, height, width, 4)).astype(np.float32)
    fl = np.stack([
        gaussian_filter(rng.standard_normal((height, width)), 40) * 25 + 2,
        gaussian_filter(rng.standard_normal((height, width)), 40) * 25 - 1,
    ], -1).astype(np.float32)
    if with_flow:
        tex = gaussian_filter(rng.standard_normal((height, width)), 2)
        tex *= 0.25 / tex.std()
        gains = np.array([1.0, 0.9, 1.1, 0.95])
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
        ks = [1] + [0] + [-1] * fd  # frame displacement in fields, current = 0
        for i, k in enumerate(ks):
            img = tex if k == 0 else map_coordinates(
                tex, [yy - k * fl[..., 1], xx - k * fl[..., 0]], order=3, mode="mirror")
            raw[0, i] = (img[..., None] * gains
                         + 0.02 * rng.standard_normal((height, width, 4)))
        flows = np.stack([k * fl for k in ks if k != 0])[None, None]
    else:
        flows = np.broadcast_to(fl, (1, 1, 1 + fd, height, width, 2)).copy()
    dev = torch.device(device)
    return (torch.from_numpy(raw).to(dev),
            torch.from_numpy(flows.astype(np.float32)).to(dev))


def make_model(net_impl: str = "fused", seed: int = 0, device="cuda",
               model: str = "convunet+feat", precision: str = "auto"):
    """(cfg, net, packed) for ``model`` with seeded kaiming weights, the
    fused path in the preset ``precision`` resolves to.  The ConvNeXt
    module path runs the exact GELU; its fused path runs the tanh GELU of
    'fast' in its bf16 chains and the exact one in its fp32 chains."""
    arch, fd = MODELS[model]
    cfg = EngineConfig(model_patch_depth=2, future_patch_depth=fd, feature_rec=True,
                       warp_impl="kernel" if net_impl == "fused" else "plain",
                       net_impl=net_impl, fused_precision=resolve_precision(model, precision))
    net = build_network(arch, cfg.network_input_nc, 3, True, seed=seed, device=device)
    packed = fused_pack(cfg, net) if net_impl == "fused" else None
    return cfg, net, packed


#: torch.profiler range around the online flows of a frame
SOLVER_RANGE = "tvl1_flows"


@dataclasses.dataclass
class FlowLog:
    """What a stream's online flows cost and gave: the duality iterations
    of every warp stage of every flow (ops/tvl1.py's order), one CUDA-event
    pair around each frame's compute_window_flows, and the last frame's
    flows [B, 1, D+fD, h, w, 2]."""

    iterations: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    flows: Optional[torch.Tensor] = None

    def ms(self) -> list:
        """Device ms of each logged frame's flows (after a synchronize)."""
        return [a.elapsed_time(b) for a, b in self.events]


def online_flows(cfg, raw_window, flow_params, flow_log: Optional[FlowLog] = None):
    """The window's flows [B, 1, D+fD, h, w, 2] from the TV-L1 solver, under
    the profiler range SOLVER_RANGE; logged (CUDA tensors only) if
    ``flow_log`` is given."""
    with torch.profiler.record_function(SOLVER_RANGE):
        if flow_log is None:
            return compute_window_flows(cfg, raw_window, flow_params)[:, None]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        flows = compute_window_flows(cfg, raw_window, flow_params, flow_log.iterations)[:, None]
        end.record()
        flow_log.events.append((start, end))
        flow_log.flows = flows
        return flows


def step_fn(cfg, net, packed, state, raw_window, flows, flow_params=None,
            flow_log: Optional[FlowLog] = None):
    """One streamed frame from raw: [online flows +] demosaic + flow
    upsample + step.  With ``flow_params`` (a preset name of
    ops/tvl1.py:FLOW_PRESETS or a TVL1Params) the flows are computed from
    the whole raw window first (:func:`online_flows`) and ``flows`` is not
    read.  With a carried state the step reads only the window's current
    and future frames, so only those are demosaicked."""
    if flow_params is not None:
        flows = online_flows(cfg, raw_window, flow_params, flow_log)
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


def metric_name(height: int, width: int, model: str, flow: Optional[str] = None,
                precision: str = "auto") -> str:
    res = f"{2 * height}p" if (height, width) == (540, 960) else f"{2 * height}x{2 * width}"
    suffix = {None: "", "default": "_online_flow", "fast": "_online_flow_fast"}[flow]
    if precision != "auto":
        suffix += f"_{resolve_precision(model, precision)}"
    return f"{res}_fps_per_chip_{model.replace('+', '_')}{suffix}"


def _warm_stream(height, width, seed, device, model, flow, precision="auto"):
    """The fused main path on the card after the first frame (state=None)
    and the warm-up frames: (dev, frame, state, flow_log)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; it has no CPU mode")
    cfg, net, packed = make_model("fused", seed, dev, model, precision)
    raw, flows = make_inputs(height, width, seed, dev, model, with_flow=flow is not None)
    log = FlowLog() if flow is not None else None

    def frame(state):
        return step_fn(cfg, net, packed, state, raw, flows, flow, log)

    _, state = frame(None)
    for _ in range(WARMUP_FRAMES):
        _, state = frame(state)
    torch.cuda.synchronize(dev)
    if log is not None:
        log.iterations.clear()
        log.events.clear()
    return dev, frame, state, log


def run(frames: int = 30, height: int = 540, width: int = 960, seed: int = 0,
        device="cuda", model: str = "convunet+feat", flow: Optional[str] = None,
        precision: str = "auto") -> dict:
    """Time ``frames`` streamed frames on the card; returns the JSON record.
    ``flow``: None (cached flows) or a preset name for online flows;
    ``precision``: the fused preset ('auto': the model's own)."""
    dev, frame, state, log = _warm_stream(height, width, seed, device, model, flow, precision)
    t0 = time.perf_counter()
    for _ in range(frames):
        den, state = frame(state)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if not torch.isfinite(den).all():
        raise RuntimeError("non-finite output")
    rec = {
        "metric": metric_name(height, width, model, flow, precision),
        "value": frames / dt,
        "unit": "frames/sec",
        "ms_per_frame": 1e3 * dt / frames,
        "precision": resolve_precision(model, precision),
    }
    if log is not None:
        rec["flow_ms_per_frame"] = sum(log.ms()) / frames
        rec["flow_iterations_per_frame"] = sum(log.iterations) / frames
    rec["device"] = torch.cuda.get_device_name(dev)
    rec["card"] = card_info()
    return rec


def _kernel_group(name: str, in_solver: bool) -> str:
    if in_solver:
        if "warp_bicubic_kernel" in name:
            return "tvl1 solver: warp_catmull_zero (CUDA)"
        return "tvl1 solver: plain torch"
    if "conv_layer_kernel" in name or "ws_layer_kernel" in name:
        return "conv_chain (CUDA)"
    if "convnext_block_kernel" in name:
        return "convnext_chain (CUDA)"
    if "warp_bicubic_kernel" in name:
        return "warp_bicubic (CUDA)"
    return name[:90]


def _device_events(events):
    """(kernels, solver spans): the device events of a trace without the
    profiler's own device-timeline copies of record_function ranges, and
    the device-time spans of the SOLVER_RANGE copies, inside which every
    kernel the solver launched ran (one stream)."""
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in dev if e.name == SOLVER_RANGE]
    kernels = [e for e in dev if e.name != SOLVER_RANGE and not e.is_user_annotation]
    return kernels, spans


def profile(frames: int = 5, height: int = 540, width: int = 960, seed: int = 0,
            device="cuda", model: str = "convunet+feat", flow: Optional[str] = None,
            precision: str = "auto") -> dict:
    """Device time by kernel over ``frames`` streamed frames (torch.profiler,
    CUDA activity), per frame; busy = the sum of kernel durations (one
    stream, so they do not overlap), idle share = 1 - busy / wall.  With
    online flows the solver's launches form groups of their own."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev, frame, state, _ = _warm_stream(height, width, seed, device, model, flow, precision)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            _, state = frame(state)
        torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0) / frames
    kernels, spans = _device_events(prof.events())
    groups: dict = {}
    for evt in kernels:
        in_solver = any(a <= evt.time_range.start < b for a, b in spans)
        g = groups.setdefault(_kernel_group(evt.name, in_solver), [0.0, 0])
        g[0] += evt.time_range.elapsed_us() / 1e3 / frames
        g[1] += 1
    busy = sum(v[0] for v in groups.values())
    rows = sorted(((k, v[0], v[1] / frames) for k, v in groups.items()),
                  key=lambda r: -r[1])
    return {"metric": metric_name(height, width, model, flow, precision),
            "wall_ms_per_frame": wall_ms, "busy_ms_per_frame": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "solver_busy_ms_per_frame": sum(ms for k, ms, _ in rows if k.startswith("tvl1")),
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
    ap.add_argument("--precision", default="auto",
                    help="fused-path preset of the model's family (convunet: fast, mixed, "
                         "accurate, wsplit, wf32 or hybrid:<chain>+...; convnext: fast, mixed, "
                         "accurate, wsplit or wf32); auto: hybrid:glue+A+dec2 for "
                         "convunet+feat+future, fast for the others")
    ap.add_argument("--with_flow", action="store_true",
                    help="self-contained mode: compute TV-L1 flows on the card every frame")
    ap.add_argument("--fast_flow", action="store_true",
                    help="with --with_flow: the fast solver preset (2 warps, 75 iterations)")
    ap.add_argument("--profile", action="store_true",
                    help="print device time by kernel (torch.profiler) instead of fps")
    args = ap.parse_args(argv)
    if args.fast_flow and not args.with_flow:
        ap.error("--fast_flow needs --with_flow")
    flow = ("fast" if args.fast_flow else "default") if args.with_flow else None
    if args.profile:
        rec = profile(min(args.frames, 10), args.height, args.width, args.seed,
                      model=args.model, flow=flow, precision=args.precision)
        for k in rec["kernels"]:
            print(f"{k['ms_per_frame']:9.3f} ms/frame {k['launches_per_frame']:8.1f} x  "
                  f"{k['name']}")
        print(json.dumps({k: v for k, v in rec.items() if k != "kernels"}))
        return
    print(json.dumps(run(args.frames, args.height, args.width, args.seed, model=args.model,
                         flow=flow, precision=args.precision)))


if __name__ == "__main__":
    main()
