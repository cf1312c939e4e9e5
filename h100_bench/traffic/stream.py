"""The ``stream`` generator: one video stream through the recurrent engine,
closed loop, one frame in flight.

Set-up makes a clip of ``windows`` raw windows (previous, current, future
frame) with their flows on the device from the seed: a smooth texture per
window, its previous and future frames that texture displaced by a smooth
flow field (one shift of a fixed set a window, in an order drawn from the
seed, plus a smooth field of ``flow_std_px``), and sensor noise.  The stream
cycles the clip and carries its state across the cycle.

Each frame: ``prepare_frames`` (demosaic, flow upsample), then the fused
``step`` (the first frame of the stream ``inference_step`` from no state),
then the output to a pinned host buffer, synchronized, before the next
frame is handed over.  The frame's latency is the host time from the
hand-over to the output in the host buffer.

The check: the first ``start_frames`` frames (made in set-up, from no
state) against the reference run from the same start, and for each range
of ``pairs`` two consecutive frames of the window at a position drawn from
the seed, against the reference run from the program's own state before
the first of them (the reference forms the state between the two itself).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench import compare, harness, program, weights
from h100_bench.reference import nets
from h100_bench.reference import tf32 as reference_precision
from h100_bench.reference.recurrent import frame_step


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of [N, 1, H, W], edges reflected."""
    r = int(math.ceil(3 * sigma))
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    return F.conv2d(F.pad(x, (0, 0, r, r), mode="reflect"), k.view(1, 1, -1, 1))


def make_clip(mix: dict, seed: int, gen: torch.Generator, device):
    """(raw [N, 3, h, w, 4], flows [N, 2, h, w, 2]) of the mix's N windows."""
    n, h, w = mix["windows"], mix["raw_height"], mix["raw_width"]
    tex = _blur(torch.randn(n, 1, h, w, generator=gen, device=device), mix["texture_sigma_px"])
    tex = tex * (mix["texture_std"] / tex.std(dim=(1, 2, 3), keepdim=True))
    cell = mix["flow_cell_px"]
    coarse = torch.randn(n, 2, h // cell + 2, w // cell + 2, generator=gen, device=device)
    field = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=True)
    field = field * (mix["flow_std_px"] / field.std(dim=(2, 3), keepdim=True))
    order = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    shifts = torch.tensor(mix["shifts_px"], dtype=torch.float32)[order]
    field = field + shifts.to(device)[:, :, None, None]  # [N, 2 (u, v), h, w]

    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")

    def displaced(k):  # the texture at x + k * field
        gx = (xs + k * field[:, 0]) * (2.0 / (w - 1)) - 1.0
        gy = (ys + k * field[:, 1]) * (2.0 / (h - 1)) - 1.0
        return F.grid_sample(tex, torch.stack([gx, gy], -1), mode="bicubic",
                             padding_mode="reflection", align_corners=True)

    frames = torch.stack([displaced(-1.0), tex, displaced(1.0)], 1)[:, :, 0]  # [N, 3, h, w]
    gains = torch.tensor(mix["channel_gains"], dtype=torch.float32, device=device)
    raw = frames[..., None] * gains + mix["noise_sigma"] * torch.randn(
        n, 3, h, w, 4, generator=gen, device=device)
    flows = torch.stack([field, -field], 1).permute(0, 1, 3, 4, 2).contiguous()
    return raw.contiguous(), flows


def check_positions(mix: dict, seed: int) -> list:
    """The first window frame of each checked pair, one in each range."""
    rng = np.random.default_rng(seed)
    return [int(rng.integers(lo, hi)) for lo, hi in mix["pairs"]]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def run(r: harness.Run) -> harness.Outcome:
    from torch.profiler import record_function

    from rvdd_tpu_torch.recurrent.engine import (
        STATE_DEN,
        STATE_FEAT,
        STATE_FEAT_OFF,
        fused_pack,
        inference_step,
        prepare_frames,
        step,
    )

    dev = torch.device(r.device)
    mix, cfg = r.mix, r.cfg
    control = cfg["control"]["stream"] if r.variant == "control" else None
    preset = control["preset"] if control and control["kind"] == "preset" else cfg["preset"]
    gen = torch.Generator(device=dev).manual_seed(r.seed)
    r.log(f"stream: imports and the card ready at {time.perf_counter() - r.t_start:.2f} s")
    params = weights.make(cfg, gen, dev)
    raw, flows = make_clip(mix, r.seed, gen, dev)
    n_win = mix["windows"]
    ecfg = program.engine_config(cfg, warp_impl="kernel", net_impl="fused",
                                 fused_precision=program.resolve_preset(cfg, preset))
    net = program.build_net(cfg, params, dev)
    _sync(dev)
    r.log(f"stream: weights, clip and net ready at {time.perf_counter() - r.t_start:.2f} s")
    packed = fused_pack(ecfg, net)
    r.log(f"stream: weights, clip and packing ready at {time.perf_counter() - r.t_start:.2f} s")
    pin = dev.type == "cuda"
    hh, ww = 2 * mix["raw_height"], 2 * mix["raw_width"]

    def host_buffer():
        return torch.empty(hh, ww, 3, pin_memory=pin)

    out_buf = host_buffer()
    warm, n_start = mix["warmup_frames"], mix["start_frames"]
    starts = check_positions(mix, r.seed)
    saved = {}  # window frame -> its host buffer, and the state before it
    snaps = {}
    finite = []  # per window frame: its output is finite (a device flag)

    def frame(state, k: int, buf: torch.Tensor):
        """Frame k of the stream (the clip's window k mod N)."""
        i = k % n_win
        window, fl = raw[i:i + 1], flows[i:i + 1, None]
        with record_function(harness.SPAN + "prepare"):
            frames, fl2 = prepare_frames(ecfg, window if state is None else window[:, 1:], fl)
        with record_function(harness.SPAN + "step"), torch.no_grad():
            if state is None:
                nil = net.nil_features(1, hh, ww)
                den, nxt = inference_step(ecfg, net, None, frames, fl2[:, 0], nil, packed)
            else:
                den, nxt = step(ecfg, net, state, frames[:, 0], frames[:, 1:], fl2[:, 0],
                                packed)
            if r.variant == "fault:state" and state is not None:
                nxt = state
            if r.variant == "fault:output":
                den[0, hh // 2, ww // 2, 0] += 1.0
        with record_function(harness.SPAN + "copy_out"):
            buf.copy_(den[0], non_blocking=pin)
            if k >= warm:
                finite.append(torch.isfinite(den).all())
            _sync(dev)
        return nxt

    state = None
    for k in range(warm):
        buf = host_buffer() if k < n_start else out_buf
        state = frame(state, k, buf)
        if k < n_start:
            saved[("start", k)] = buf
    _sync(dev)
    setup_s = time.perf_counter() - r.t_start

    lat = []
    need = max(p + 1 for p in starts)

    def window_frames(limit_frames=None):
        nonlocal state
        t0 = time.perf_counter()
        j = 0
        while True:
            done = time.perf_counter() - t0
            if limit_frames is None:
                if done >= r.seconds and j > need:
                    break
            elif j >= limit_frames:
                break
            buf = out_buf
            if j in starts or j - 1 in starts:
                buf = host_buffer()
                saved[("pair", j)] = buf
            if j in starts:
                snaps[j] = state.lastden.clone()
            t = time.perf_counter()
            state = frame(state, warm + j, buf)
            lat.append(time.perf_counter() - t)
            j += 1
        return j, time.perf_counter() - t0

    trace = None
    if r.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(harness.SPAN + "window"):
                frames_done, elapsed = window_frames(max(mix["trace_frames"], need + 1))
                _sync(dev)
        trace = harness.trace_from_profile(prof, frames_done, cfg, mix)
    else:
        frames_done, elapsed = window_frames()
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {"fps": frames_done / elapsed,
               "frame_p95_ms": 1e3 * float(np.percentile(lat, 95)),
               "setup_s": setup_s}
    r.log("stream: frame ms p50 %.3f p90 %.3f p99 %.3f max %.3f over %d frames" % tuple(
        [1e3 * float(np.percentile(lat, q)) for q in (50, 90, 99, 100)] + [frames_done]))
    del state, packed, net
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check, after the window
    ref = nets.build(cfg, dev)
    ref.load_state_dict(params)
    c = cfg["net"]["out_channels"]

    def from_program(snap):
        return (snap[..., :STATE_DEN].float(),
                snap[..., STATE_FEAT_OFF:STATE_FEAT_OFF + STATE_FEAT].float())

    def reference(frames_k, st, tf32_on=False):
        outs = []
        with torch.no_grad(), reference_precision(tf32_on):
            for k in frames_k:
                i = k % n_win
                out, st = frame_step(ref, raw[i:i + 1], flows[i:i + 1], st)
                outs.append(out[0, ..., :c])
        return outs

    as_control = control is not None and control["kind"] == "reference"
    errs = {"start": [], "pair": []}
    ref_start = reference(range(n_start), None)
    prog_start = (reference(range(n_start), None, tf32_on=True) if as_control
                  else [saved[("start", k)].to(dev) for k in range(n_start)])
    for p, q in zip(prog_start, ref_start):
        errs["start"].append(compare.frame_errors(p, q))
    for j in starts:
        st = from_program(snaps[j])
        ks = [warm + j, warm + j + 1]
        ref_pair = reference(ks, st)
        prog_pair = (reference(ks, st, tf32_on=True) if as_control
                     else [saved[("pair", j)].to(dev), saved[("pair", j + 1)].to(dev)])
        for p, q in zip(prog_pair, ref_pair):
            errs["pair"].append(compare.frame_errors(p, q))
    bad = [k for k, ok in enumerate(torch.stack(finite).tolist()) if not ok]
    if bad:
        r.log(f"stream: {len(bad)} window frame(s) with a non-finite output, first {bad[:8]}")
    readings = compare.worst(errs["start"] + errs["pair"])
    readings["nonfinite_frames"] = float(len(bad))
    readings.update(compare.worst(errs["start"], "start_"))
    readings.update(compare.worst(errs["pair"], "pair_"))
    for k, e in enumerate(errs["start"]):
        readings.update(compare.worst([e], f"start{k}_"))
    return harness.Outcome(metrics, attempted=frames_done, failed=len(bad),
                           checks=harness.judge(readings, r.cell), readings=readings,
                           memory_peak_bytes=peak, trace=trace)
