"""Streaming 1080p throughput of the port's main paths on one card.

Port of bench.py's inference mode for four models:

* ``convunet``: recurrent convunet without feature recurrence
  (``convunet-mode=fixedfeatures``);
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

``--streams N`` batches N independent streams into each step (the kernels
take the batch in one launch a layer); ``--scan`` times a whole clip of
``frames`` frames through ``engine.scan_video`` (the clip's demosaic and
flow upsample included, the weights packed once) after one untimed pass of
it; ``--exact`` runs the fp32 module path with TF32 off and the kernel warp
(the validate CLI's parity configuration, bench.py:127-137);
``--state_dtype`` picks the carry's dtype; ``--no_split`` drops the dec2
split from the 'fast' preset for the run; ``--trace_dir DIR`` exports a
torch.profiler trace of 5 streamed steps there as a Chrome trace.

``--train`` times the train step instead (bench.py:175-241, :func:`run_train`):
the model's module path under autograd with AdamW, batch ``--batch_size``
(2) of ``--train_patch`` (136) raw patches and ``--train_unrollings`` (4)
unrollings on seeded uniform draws, at ``--train_precision`` (highest), for
``--frames`` steps; it prints ``train_samples_per_sec_<model>`` in
samples/s with ms a step and the card.  ``--train_remat`` recomputes each
unrolling in the backward (always on for the flagship).

One stream by default, packed GBRG raw 540x960x4 in and RGB 1080x1920x3 out.  Per
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
                                   [--precision auto] [--streams 1]
                                   [--with_flow [--fast_flow]] [--scan]
                                   [--exact] [--state_dtype float32]
                                   [--no_split] [--trace_dir DIR]
                                   [--height 540] [--width 960] [--profile]
    python -m rvdd_tpu_torch.bench --train [--model convunet+feat] [--frames 30]
                                   [--batch_size 2] [--train_patch 136]
                                   [--train_unrollings 4] [--train_precision highest]
                                   [--train_radius 8] [--train_remat]

Prints one JSON line: metric (built from its parts as bench.py builds it:
``1080p_fps_per_chip_<model>``, then ``_scan``, then ``_x<N>streams`` for
N > 1, then ``_online_flow`` or ``_online_flow_fast`` for online flows,
then ``_exact``, or else ``_<preset>`` for a ``--precision`` other than
``auto``), value (frames/s: frames x streams / time), unit, ms per step,
the resolved preset, with online flows
``flow_ms_per_frame``
(CUDA events around compute_window_flows) and
``flow_iterations_per_frame``, and the card's name and power limit.
``--profile`` prints device time by kernel instead, the solver's launches
as groups of their own.  Without a card it raises; it never reports a CPU
number.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.models import build_network
from rvdd_tpu_torch.models.fast_convnext import cnx_precision
from rvdd_tpu_torch.models.fast_unet import FUSED_PRECISIONS, resolve_fused_precision
from rvdd_tpu_torch.precision import exact_precision, fast_precision
from rvdd_tpu_torch.recurrent.engine import (
    EngineConfig,
    compute_window_flows,
    fused_pack,
    inference_step,
    prepare_frames,
    scan_video,
    step,
)

#: --model -> (architecture string, future_patch_depth, feature recurrence),
#: as bench.py:144-151
MODELS = {
    "convunet": ("convunet-mode=fixedfeatures", 0, False),
    "convunet+feat": ("convunet-mode=fixedfeatures+feat", 0, True),
    "convunet+feat+future": ("convunet-mode=fixedfeatures+feat", 1, True),
    "convnext+feat+future": ("newunet-mode=feat", 1, True),
}


def resolve_precision(model: str, precision: str = "auto") -> str:
    """The fused preset ``model`` runs under ``precision`` ('auto' resolves
    as bench.py:152-156), checked against the presets of its family."""
    arch, fd, feat = MODELS[model]
    name = resolve_fused_precision(precision, arch=arch, feature_rec=feat, future=fd > 0) \
        if precision == "auto" else precision
    if arch.startswith("newunet"):
        cnx_precision(name)
        return name
    return resolve_fused_precision(name, arch=arch, feature_rec=feat, future=fd > 0)


@contextlib.contextmanager
def no_split():
    """bench.py's --no_split (bench.py:157-159): the 'fast' preset without
    its dec2 weight split, for the scope (chains packed inside it keep it)."""
    saved = FUSED_PRECISIONS["fast"]
    FUSED_PRECISIONS["fast"] = dict(saved, weight_split={})
    try:
        yield
    finally:
        FUSED_PRECISIONS["fast"] = saved


def make_inputs(height: int = 540, width: int = 960, seed: int = 0, device="cuda",
                model: str = "convunet+feat", with_flow: bool = False, streams: int = 1):
    """A raw window [N, 2 + fD, h, w, 4] and flows [N, 1, 1 + fD, h, w, 2]
    for N = ``streams`` independent streams, from numpy seed ``seed`` (one
    stream draws what it drew before streams existed).

    The flow field is bench.py's smooth one (gaussian-filtered noise, sigma
    40 px, x25, offset (+2, -1) px at raw resolution).  Cached mode: the raw
    frames are uniform in [-1, 1] and every flow is that field.  With
    ``with_flow`` the window has real motion for the online solver: the
    current frame is a smooth texture (gaussian-filtered noise, sigma 2 px,
    std 0.25, per-channel gains), frame i is that texture sampled at
    x - k * field(x) with k = 1 before the current frame and -1 after it,
    and every frame gets noise of sigma 0.02; the returned flows are the
    true ones, k * field (up to the field's second-order change over k px).
    Each stream has frames of its own (with ``with_flow`` a texture of its
    own) and the same field.
    """
    from scipy.ndimage import gaussian_filter, map_coordinates

    fd = MODELS[model][1]
    rng = np.random.default_rng(seed)
    raw = rng.uniform(-1, 1, (streams, 2 + fd, height, width, 4)).astype(np.float32)
    fl = np.stack([
        gaussian_filter(rng.standard_normal((height, width)), 40) * 25 + 2,
        gaussian_filter(rng.standard_normal((height, width)), 40) * 25 - 1,
    ], -1).astype(np.float32)
    ks = [1] + [0] + [-1] * fd  # frame displacement in fields, current = 0
    if with_flow:
        gains = np.array([1.0, 0.9, 1.1, 0.95])
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
        for n in range(streams):
            tex = gaussian_filter(rng.standard_normal((height, width)), 2)
            tex *= 0.25 / tex.std()
            for i, k in enumerate(ks):
                img = tex if k == 0 else map_coordinates(
                    tex, [yy - k * fl[..., 1], xx - k * fl[..., 0]], order=3, mode="mirror")
                raw[n, i] = (img[..., None] * gains
                             + 0.02 * rng.standard_normal((height, width, 4)))
        flows = np.stack([k * fl for k in ks if k != 0])[None, None]
    else:
        flows = np.broadcast_to(fl, (1, 1, 1 + fd, height, width, 2))
    flows = np.broadcast_to(flows, (streams,) + flows.shape[1:]).copy()
    dev = torch.device(device)
    return (torch.from_numpy(raw).to(dev),
            torch.from_numpy(flows.astype(np.float32)).to(dev))


def make_model(net_impl: str = "fused", seed: int = 0, device="cuda",
               model: str = "convunet+feat", precision: str = "auto",
               warp_impl: Optional[str] = None, state_dtype: str = "float32"):
    """(cfg, net, packed) for ``model`` with seeded kaiming weights, the
    fused path in the preset ``precision`` resolves to.  The state warp is
    the kernel on the fused path and the plain warp on the module path
    unless ``warp_impl`` says otherwise.  The ConvNeXt module path runs the
    exact GELU; its fused path runs the tanh GELU of 'fast' in its bf16
    chains and the exact one in its fp32 chains."""
    arch, fd, feat = MODELS[model]
    if warp_impl is None:
        warp_impl = "kernel" if net_impl == "fused" else "plain"
    cfg = EngineConfig(model_patch_depth=2, future_patch_depth=fd, feature_rec=feat,
                       warp_impl=warp_impl, net_impl=net_impl, state_dtype=state_dtype,
                       fused_precision=resolve_precision(model, precision))
    net = build_network(arch, cfg.network_input_nc, 3, feat, seed=seed, device=device)
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
                precision: str = "auto", streams: int = 1, scan: bool = False,
                exact: bool = False) -> str:
    """The metric's name from its parts, in bench.py's order
    (bench.py:316, :353): the model, ``_scan``, ``_x<N>streams``, the
    online flow, then ``_exact`` or else a preset other than 'auto'."""
    res = f"{2 * height}p" if (height, width) == (540, 960) else f"{2 * height}x{2 * width}"
    name = f"{res}_fps_per_chip_{model.replace('+', '_')}"
    if scan:
        name += "_scan"
    if streams != 1:
        name += f"_x{streams}streams"
    name += {None: "", "default": "_online_flow", "fast": "_online_flow_fast"}[flow]
    if exact:
        name += "_exact"
    elif precision != "auto":
        name += f"_{resolve_precision(model, precision)}"
    return name


@dataclasses.dataclass(frozen=True)
class Mode:
    """What a run streams besides its model: ``streams`` batched streams;
    ``exact``: the fp32 module path with TF32 off and the kernel warp
    (bench.py:127-137, the validate CLI's parity configuration);
    ``state_dtype`` of the carry; ``no_split``: 'fast' without its dec2
    split."""

    streams: int = 1
    exact: bool = False
    state_dtype: str = "float32"
    no_split: bool = False

    def model(self, seed, dev, model, precision):
        """(cfg, net, packed) of the run."""
        if self.exact:
            return make_model("module", seed, dev, model, precision, warp_impl="kernel",
                              state_dtype=self.state_dtype)
        return make_model("fused", seed, dev, model, precision, state_dtype=self.state_dtype)

    @contextlib.contextmanager
    def numerics(self):
        """TF32 off for ``exact`` (precision.py), 'fast' without its split
        for ``no_split``; as before after the scope."""
        with contextlib.ExitStack() as stack:
            if self.exact:
                stack.enter_context(exact_precision())
            if self.no_split:
                stack.enter_context(no_split())
            yield


def _card(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the benchmark measures the card; it has no CPU mode")
    return dev


def _warm_stream(height, width, seed, device, model, flow, precision="auto", mode=Mode()):
    """The main path on the card after the first frame (state=None) and the
    warm-up frames: (dev, frame, state, flow_log).  Call inside
    ``mode.numerics()``."""
    dev = _card(device)
    cfg, net, packed = mode.model(seed, dev, model, precision)
    raw, flows = make_inputs(height, width, seed, dev, model, with_flow=flow is not None,
                             streams=mode.streams)
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


def _scan_clip(frames, height, width, seed, device, model, precision, mode):
    """The whole-clip mode (bench.py:286-318): raw clip [N, T, h, w, 4] with
    bench's flow field on every frame; returns (dev, clip), where clip()
    demosaics the clip, upsamples its flows and streams it through
    ``scan_video`` (the weights packed once a call), returning the outputs
    [T, N, 2h, 2w, 3]."""
    dev = _card(device)
    cfg, net, _ = mode.model(seed, dev, model, precision)
    fd = cfg.future_patch_depth
    rng = np.random.default_rng(seed)
    raw = torch.from_numpy(rng.uniform(-1, 1, (mode.streams, frames, height, width, 4))
                           .astype(np.float32)).to(dev)
    _, window_flows = make_inputs(height, width, seed, dev, model, streams=mode.streams)
    flows = window_flows.expand(mode.streams, frames, 1 + fd, height, width, 2)
    nil = (net.nil_features(mode.streams, 2 * height, 2 * width) if cfg.feature_rec
           else None)

    def clip():
        rgb, flows2 = prepare_frames(cfg, raw, flows)
        return scan_video(cfg, net, rgb.transpose(0, 1), flows2.transpose(0, 1), nil)

    return dev, clip


def run(frames: int = 30, height: int = 540, width: int = 960, seed: int = 0,
        device="cuda", model: str = "convunet+feat", flow: Optional[str] = None,
        precision: str = "auto", streams: int = 1, scan: bool = False, exact: bool = False,
        state_dtype: str = "float32", no_split: bool = False,
        trace_dir: Optional[str] = None) -> dict:
    """Time ``frames`` streamed frames (``scan``: a clip of ``frames``
    frames through scan_video) of ``streams`` streams on the card; returns
    the JSON record.  ``flow``: None (cached flows) or a preset name for
    online flows; ``precision``: the fused preset ('auto': the model's
    own); ``exact``, ``state_dtype``, ``no_split``: see :class:`Mode`;
    ``trace_dir``: export a torch.profiler trace of 5 streamed steps
    there first."""
    if scan and (flow is not None or trace_dir):
        raise ValueError("scan streams a clip with cached flows, untraced (as bench.py)")
    mode = Mode(streams, exact, state_dtype, no_split)
    with mode.numerics():
        if scan:
            dev, clip = _scan_clip(frames, height, width, seed, device, model, precision, mode)
            clip()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            den = clip()
        else:
            dev, frame, state, log = _warm_stream(height, width, seed, device, model, flow,
                                                  precision, mode)
            if trace_dir:
                trace_file = export_trace(trace_dir, frame, state,
                                          metric_name(height, width, model, flow, precision,
                                                      streams, exact=exact))
            t0 = time.perf_counter()
            for _ in range(frames):
                den, state = frame(state)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    if not torch.isfinite(den).all():
        raise RuntimeError("non-finite output")
    rec = {
        "metric": metric_name(height, width, model, flow, precision, streams, scan, exact),
        "value": frames * streams / dt,
        "unit": "frames/sec",
        "ms_per_frame": 1e3 * dt / frames,
        "precision": "exact" if exact else resolve_precision(model, precision),
        "streams": streams,
        "state_dtype": state_dtype,
    }
    if no_split:
        rec["no_split"] = True
    if not scan and log is not None:
        rec["flow_ms_per_frame"] = sum(log.ms()) / frames
        rec["flow_iterations_per_frame"] = sum(log.iterations) / frames
    if trace_dir:
        rec["trace"] = trace_file
    rec["device"] = torch.cuda.get_device_name(dev)
    rec["card"] = card_info()
    return rec


#: streamed steps a --trace_dir trace holds (bench.py:335-337)
TRACE_STEPS = 5


def export_trace(trace_dir: str, frame, state, name: str) -> str:
    """A torch.profiler trace (CPU and CUDA activity) of TRACE_STEPS
    streamed steps, exported as ``<trace_dir>/<name>.json`` (Chrome trace
    format); returns the path.  The stream goes on from the state it had."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.json")
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_STEPS):
            _, state = frame(state)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    return path


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
            precision: str = "auto", streams: int = 1, exact: bool = False,
            state_dtype: str = "float32", no_split: bool = False) -> dict:
    """Device time by kernel over ``frames`` streamed frames (torch.profiler,
    CUDA activity), per frame; busy = the sum of kernel durations (one
    stream, so they do not overlap), idle share = 1 - busy / wall.  With
    online flows the solver's launches form groups of their own."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    mode = Mode(streams, exact, state_dtype, no_split)
    with mode.numerics():
        dev, frame, state, _ = _warm_stream(height, width, seed, device, model, flow,
                                            precision, mode)
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
    return {"metric": metric_name(height, width, model, flow, precision, streams, exact=exact),
            "wall_ms_per_frame": wall_ms, "busy_ms_per_frame": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "solver_busy_ms_per_frame": sum(ms for k, ms, _ in rows if k.startswith("tvl1")),
            "kernels": [{"name": k, "ms_per_frame": ms, "launches_per_frame": n}
                        for k, ms, n in rows],
            "device": torch.cuda.get_device_name(dev), "card": card_info()}


# ---------------------------------------------------------------- train


def train_metric_name(model: str) -> str:
    """The --train record's name (bench.py:229-230)."""
    return f"train_samples_per_sec_{model.replace('+', '_')}"


def train_setup(model: str = "convunet+feat", batch_size: int = 2, patch: int = 136,
                unrollings: int = 4, precision: str = "highest", radius: int = 8,
                remat: bool = False, seed: int = 0, device="cuda"):
    """bench.py:191-221's train step on ``device``: (cfg, state, step,
    inputs).  The module path with seeded kaiming weights, AdamW at lr 1e-4,
    the port's train warp (the exact plain warp; ``radius`` only sets
    ``shift_warp_radius``), remat forced for the ConvNeXt flagship;
    ``inputs`` are bench.py's seeded uniform draws, frames [B, td+1+fD, p,
    p, 4], flows [B, td, 1+fD, p, p, 2] and gt [B, td+1+fD, 2p, 2p, 3], and
    the unrolling weights 1/td."""
    from rvdd_tpu_torch.training.train_state import (
        create_train_state,
        make_train_step,
        set_learning_rate,
    )

    arch, fd, feat = MODELS[model]
    td = unrollings
    cfg = EngineConfig(model_patch_depth=2, patch_depth=td + 1, future_patch_depth=fd,
                       feature_rec=feat, warp_impl="plain", net_impl="module",
                       shift_warp_radius=radius,
                       remat=remat or arch.startswith("newunet"))
    dev = torch.device(device)
    net = build_network(arch, cfg.network_input_nc, 3, feat, seed=seed, device=dev)
    state = set_learning_rate(create_train_state(net, "adamw"), 1e-4)
    rng = np.random.default_rng(seed)
    t = cfg.patch_depth + fd
    draws = [rng.uniform(-1, 1, (batch_size, t, patch, patch, 4)),
             rng.uniform(-1, 1, (batch_size, td, cfg.d + fd, patch, patch, 2)),
             rng.uniform(-1, 1, (batch_size, t, 2 * patch, 2 * patch, 3)),
             np.full(td, 1.0 / td)]
    inputs = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in draws]
    return cfg, state, make_train_step(cfg, precision), inputs


def run_train(steps: int = 10, model: str = "convunet+feat", batch_size: int = 2,
              patch: int = 136, unrollings: int = 4, precision: str = "highest",
              radius: int = 8, remat: bool = False, seed: int = 0, device="cuda") -> dict:
    """bench.py's --train mode on the card: :func:`train_setup`'s step, one
    untimed step and one warm step, then ``steps`` timed steps ended by
    reading a loss back; returns the JSON record.  ``precision`` 'highest'
    turns TF32 off for the run, 'high' and 'default' turn it on ('default'
    also runs the forward under bf16 autocast)."""
    dev = _card(device)
    with exact_precision() if precision == "highest" else fast_precision():
        cfg, state, step, inputs = train_setup(model, batch_size, patch, unrollings,
                                               precision, radius, remat, seed, dev)
        for _ in range(2):
            _, losses = step(state, *inputs)
            float(losses["Denoiser"])
        t0 = time.perf_counter()
        for _ in range(steps):
            _, losses = step(state, *inputs)
        loss = float(losses["Denoiser"])
        dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite training loss {loss}")
    return {"metric": train_metric_name(model), "value": steps * batch_size / dt,
            "unit": "samples/sec", "ms_per_step": 1e3 * dt / steps, "batch_size": batch_size,
            "patch": patch, "unrollings": unrollings, "precision": precision,
            "remat": cfg.remat, "loss": loss, "device": torch.cuda.get_device_name(dev),
            "card": card_info()}


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
    ap.add_argument("--streams", type=int, default=1,
                    help="batched independent video streams (throughput mode)")
    ap.add_argument("--scan", action="store_true",
                    help="time a whole clip of --frames frames through scan_video")
    ap.add_argument("--exact", action="store_true",
                    help="the fp32 module path, TF32 off, with the kernel warp (the validate "
                         "CLI's parity configuration)")
    ap.add_argument("--state_dtype", default="float32", choices=["float32", "bfloat16"],
                    help="recurrence-carry dtype (float32 is the production default)")
    ap.add_argument("--no_split", action="store_true",
                    help="drop the dec2 weight split from the 'fast' preset")
    ap.add_argument("--trace_dir", default=None,
                    help="export a torch.profiler trace of 5 streamed steps here (Chrome "
                         "trace JSON)")
    ap.add_argument("--profile", action="store_true",
                    help="print device time by kernel (torch.profiler) instead of fps")
    ap.add_argument("--train", action="store_true",
                    help="time the train step instead of inference (--frames steps)")
    ap.add_argument("--batch_size", type=int, default=2, help="--train: batch size")
    ap.add_argument("--train_patch", type=int, default=136, help="--train: raw patch width")
    ap.add_argument("--train_unrollings", type=int, default=4, help="--train: unrollings")
    ap.add_argument("--train_precision", default="highest",
                    choices=["highest", "high", "default"],
                    help="--train: matmul precision (highest: TF32 off; high: TF32; "
                         "default: TF32 and a bf16 autocast forward)")
    ap.add_argument("--train_radius", type=int, default=8,
                    help="--train: shift_warp_radius (the port trains with the exact warp)")
    ap.add_argument("--train_remat", action="store_true",
                    help="--train: recompute each unrolling in the backward (always on for "
                         "convnext+feat+future)")
    args = ap.parse_args(argv)
    if args.train:
        inference_only = {"--streams": args.streams != 1, "--scan": args.scan,
                          "--with_flow": args.with_flow, "--exact": args.exact,
                          "--profile": args.profile, "--trace_dir": bool(args.trace_dir)}
        refused = [k for k, v in inference_only.items() if v]
        if refused:
            ap.error(f"--train times the train step: not with {', '.join(refused)}")
        print(json.dumps(run_train(args.frames, args.model, args.batch_size, args.train_patch,
                                   args.train_unrollings, args.train_precision,
                                   args.train_radius, args.train_remat, args.seed)))
        return
    if args.fast_flow and not args.with_flow:
        ap.error("--fast_flow needs --with_flow")
    if args.streams < 1:
        ap.error("--streams must be at least 1")
    if args.scan and (args.with_flow or args.trace_dir or args.profile):
        ap.error("--scan streams a clip with cached flows: not with --with_flow, --trace_dir "
                 "or --profile")
    flow = ("fast" if args.fast_flow else "default") if args.with_flow else None
    mode = dict(streams=args.streams, exact=args.exact, state_dtype=args.state_dtype,
                no_split=args.no_split)
    if args.profile:
        rec = profile(min(args.frames, 10), args.height, args.width, args.seed,
                      model=args.model, flow=flow, precision=args.precision, **mode)
        for k in rec["kernels"]:
            print(f"{k['ms_per_frame']:9.3f} ms/frame {k['launches_per_frame']:8.1f} x  "
                  f"{k['name']}")
        print(json.dumps({k: v for k, v in rec.items() if k != "kernels"}))
        return
    print(json.dumps(run(args.frames, args.height, args.width, args.seed, model=args.model,
                         flow=flow, precision=args.precision, scan=args.scan,
                         trace_dir=args.trace_dir, **mode)))


if __name__ == "__main__":
    main()
