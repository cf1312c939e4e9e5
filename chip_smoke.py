"""Smoke run of rvdd_tpu_torch on one CUDA card: build, check, drive.

    python3 chip_smoke.py [--warp-source DIR] [--cnx-source DIR] [--conv-source DIR]

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions.
2. Builds every kernel of the main paths from rvdd_tpu_torch/csrc with nvcc,
   and the host decode pool csrc/rvdd_io.cpp with g++ (one process per
   source, started together), and prints each build's time, ptxas
   register, shared-memory and spill lines, and the C75xx notes ("wgmma ...
   serialized" and the like) by kernel.
3. Holds each kernel against its plain PyTorch version at the main paths'
   shapes (1080p; the TV-L1 solver's warp at its finest level, 540x960),
   TF32 off on the plain side, and times the kernel, the plain version and
   a PyTorch library yardstick (F.grid_sample for the warps, cuDNN F.conv2d
   per conv layer, and for a ConvNeXt chain its blocks as cuDNN depthwise
   conv, F.layer_norm, matmuls and F.gelu in the chain's dtype), beside
   the bound computed from the inputs, and the share of the bound.
   convnext_chain is checked in both its modes on the flagship's seven
   chains: bf16 (the 'fast' packing) and fp32 (the 'mixed' packing: erf
   GELU, fp32 bands, six bf16 products a MAC, held to 2^-14 of max|out|).
   conv_chain is checked in its four modes: the bf16 chains of
   convunet+feat, the 'high' (bf16_3x) chains A and dec2 of
   convunet+feat+future's 'auto' preset (hybrid:glue+A+dec2) and the other
   four of its 'mixed' preset (printed, not in the kernels line), and the
   six chains of the 'accurate' ('highest': fp32 bands and weights, six
   bf16 products a MAC) and 'wf32' ('w32': bf16 bands, fp32 weights,
   three) packings, each with its layers' launch plans (resident,
   streamed or upsample form); each bound counts its mode's bf16 products
   a MAC.  Each 'w32'
   chain is also run with its weights rounded to bf16 (the control), which
   must fail the mode's mean limit.  The warp is timed at its
   three shapes (the 56-ch state, the 3-ch bf16 future frame, the solver's
   stack) and prints, per flow, the share of output tiles that staged their
   source window in shared memory, gathered directly or were all zeroed
   (the kernel's counter, held equal to ``tile_paths``).  With
   ``--warp-source DIR`` it also times the warp kernel of another checkout
   (e.g. the parent commit's tree) against this one, in turns; with
   ``--cnx-source DIR`` the other checkout's convnext_chain kernel against
   this one's on the flagship's seven chains at 1080p, in both modes; with
   ``--conv-source DIR`` its conv_chain kernel against this one's on the
   chains of each ConvUNet packing at 1080p (every mode), where the
   'bf16', 'high' and 'highest' outputs must be bit-identical and the
   'w32' ones (this tree's changed mode, CONV_CHANGED) within its limits
   of the other's.
   The demosaic kernel is held bitwise equal to its plain version on the
   stream's window (two 540x960 packed frames) and timed beside it.
4. Runs the TV-L1 solver on a 540x960 pair with a known flow, once per
   preset, through the kernel route and the plain route: the two agree
   within tests/test_tvl1.py's limits and both find the known flow.
5. Drives the main paths through the port's entry points
   (rvdd_tpu_torch.bench's make_inputs / make_model / step_fn), each at
   1080p and full width with seeded kaiming weights, a first frame with
   state=None and streamed frames with the carried fp32 state:
   - convunet+feat (cached flows): the warp and six conv_chain chains;
   - convnext+feat+future (the ConvNeXt flagship, cached flows): the state
     and future-frame warps and seven convnext_chain chains;
   - online flows (self-contained streaming): convunet+feat with the fast
     and the default solver preset, and the flagship with the fast preset;
     each frame first computes its window's flows with the TV-L1 solver,
     whose warp is warp_catmull_zero (nwarps x nscales launches a flow);
   - convunet+feat+future (cached flows) under 'auto', which resolves to
     hybrid:glue+A+dec2: the state and future-frame warps in fp32 and six
     conv_chain chains, A and dec2 (9 of the 21 launches) in the fp32 mode;
   - the flagship (cached flows) under 'mixed': fp32 warps and all seven
     convnext_chain chains (25 launches) in the fp32 mode;
   - convunet+feat+future (cached flows) under 'accurate': fp32 warps, all
     21 conv_chain launches in the 'highest' mode and an fp32 eighth-res
     core; and convunet+feat under 'wf32': all 21 in the 'w32' mode.
   Each path checks every output is finite, that its first two frames
   agree with the port's plain module path (fp32, TF32 off) fed the same
   flows within its preset's envelope (normalized max error < 0.2 at step
   1 and < 0.3 at step 2 for 'fast', tests/test_fast_step.py; half that for
   the hybrid; 2e-3 and 3e-3 for 'mixed', 2e-4 and 3e-4 for 'accurate';
   see ENVELOPE), and that it
   launched its kernels the expected number of times (launch counts set to
   0 just before the path and read just after; the demosaic kernel once a
   frame, and no CUDA demosaic through the plain version).  The two frames of a path
   in another preset than 'fast' are also run under 'fast' and compared the
   same way: its max and mean errors must be below fast's at both steps
   (BEATS_FAST; 'wf32''s are printed only).
   The ``streams`` paths run convunet+feat and the flagship under 'fast'
   with two batched streams (bench's make_inputs(streams=2)) for 5 frames:
   the kernels' launches a step must equal one stream's (the kernels take
   the batch in one launch a layer), each stream's first two frames must
   be within 'fast''s envelope of the plain module path, and each stream's
   largest difference from its own single-stream run is printed.  Then one
   short ``bench.run`` record each of convunet+feat with ``streams=2``,
   ``scan=True`` and ``exact=True`` is printed (``{"bench": ...}``).
6. The ``serve`` phase drives the port's serving entry points through their
   ``main(argv)``s, on the card: ``cli.generate_data`` writes a 1080p clip
   of 7 frames at ISO 3200 (a moving sRGB texture,
   tools/make_tiny_dataset.py:synth_video's 'rich' one, written as PNG by
   the port) into
   a temporary directory; ``cli.validate`` runs the repo's trained
   convunet+feat net (trained-nets/, 48 filters, full width) four ways:
   ``--net_impl fused`` per frame (its FlowCache computes the flows on the
   card and persists them), ``--net_impl fused --val_scan``, and the
   port's fp32 module path (``--net_impl xla``, TF32 off) in both
   protocols; ``cli.score`` scores each output in sRGB.  It checks that
   the fused PSNR is within 0.05 dB of the module path's (PARITY.md's
   budget) in each protocol, that the denoised PSNR is at least 1 dB above
   the noisy input's (Hamilton-Adams demosaicked) on the same frames, and
   that PSNR.txt and SSIM.txt hold their averages; it prints the fps of
   each run (host clock, synchronized; the flow solver's time taken out),
   the flow seconds, the seconds of one pass of the per-frame dataset's
   reads (TIFFs through the host decode pool, and cached flows) and of
   each score, and the kernels' launches in each run, on one line.  Its
   ``native`` entry loads the clip's noisy and ground-truth stacks by the
   decode pool and by the numpy reader, which must be bit-equal, and gives
   the seconds of each and the pool's threads.
7. The ``train`` phase drives the port's trainer through
   ``cli.train.main(argv)`` on the card, in the same temporary directory:
   ``cli.generate_data`` writes the clip's train split; the trainer runs
   convunet+feat with its production flags (48 filters, depth 4, batch 2,
   272x272 RGB patches, 4 unrollings; TRAIN_ARGV) on one window of 5
   frames, 21 keys or 10 steps an epoch, with its flows computed by the
   FlowCache on the card (``warp_catmull_zero``) and in-loop validation on
   serve's split with the kernel warp (``warp_bicubic``); a second run
   ``--autoresume``s into epoch 2 with the optimizer state.  It checks
   that every loss is finite, that the '0', '1', '2', 'latest' and
   'latest_val' nets and status.json exist, that the optimizer's step
   count carried on, and that the warps launched once a validation frame
   and nwarps x nscales times a flow computed; then that 30 AdamW steps
   on one fixed batch lower the loss as on the CPU (overfit_clip), that
   one full-width step on the card gives the CPU's loss and gradients
   (card_against_cpu, TF32 off), that the flagship's step gives the same
   gradients with and without ``remat`` (printing each one's peak
   memory), and that the epoch-2 net served by ``cli.validate --net_impl
   fused`` is finite with 21 ``conv_chain`` launches a frame.  It
   profiles three production steps (train_profile: wall and busy ms, the
   kernels of most device time) and prints one ``{"train": ...}`` line:
   ms a step and samples/s (synchronized, the first step of each epoch
   left out), data, flow and validation seconds, peak memory, the first
   and last loss and the launches.
8. The ``dist`` phase runs the trainer's data-parallel path on the card:
   ``cli.train.main`` with ``--distributed --profile_dir`` in torchrun's
   environment of a one-process job (NCCL at world size 1, a free
   ``MASTER_PORT``), one epoch of the train phase's flags on its data and
   persisted flows.  It checks the backend and world size, 10 finite
   steps, the first loss within 1e-4 relative of the train phase's first
   (same seed, data and flags), the '0', '1', 'latest' and 'latest_val'
   nets and status.json, one ``warp_bicubic`` launch a validation frame
   and no ``conv_chain``, and that the profile (``rank0.json``) holds the
   device span of NCCL's all-reduce with NCCL's kernel in it and the
   kernels of the conv ops; it prints one ``{"dist": ...}`` line (ms a
   step and samples/s beside the train phase's, the trace's size and its
   kernels of most device time).
9. The ``space`` phase runs the mesh's space axis through
   ``cli.train.main --distributed --mesh_shape data1xspace2`` in a
   two-process torchrun (``python -m torch.distributed.run --standalone``).
   With two cards or more: NCCL, a card a rank, one epoch of the train
   phase's flags on its data; it checks 10 finite steps, the first loss
   within 1e-4 relative of the train phase's and the files of one writer.
   With one card (two NCCL ranks cannot share it) the same command runs
   as two gloo processes on the CPU at a 16-row raw patch without
   validation, held to a one-process CPU run of the same flags; its line
   says so (backend, device, cards) and is never the card's result.  It
   prints one ``{"space": ...}`` line: backend, device, cards, world size,
   mesh, steps, ms a step, peak memory a rank (on cards), the first and
   last loss beside the unsharded run's, the card.  ``--space-only``
   runs this phase alone (its data and its one-process reference first,
   with ``--space-meshes`` listing the meshes, e.g.
   ``data1xspace2,data2xspace2`` on four cards) and prints no result line.
10. Prints two ``{"bench": ...}`` records of ``bench.run_train``:
   convunet+feat at the production patch (batch 2, 136 raw, 4 unrollings,
   highest) and the flagship with remat, 10 timed steps each.
11. Prints a ``{"kernels": [...]}`` JSON line (the conv_chain entry adds
   the ``fp32_*`` ('high'), ``highest_*`` and ``w32_*`` times, bounds and
   errors of its other modes, the convnext_chain entry its fp32 mode's
   ``fp32_*``), the card line and,
   last, ``{"ok": true, "device": {...}}``.  Every time and fps line
   carries the card's name and power limit.

Any failed check raises, so the script exits non-zero and prints no result.
It needs a card: without one it exits 2 before doing anything.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(2)

import torch.nn.functional as F  # noqa: E402

from rvdd_tpu_torch import _build  # noqa: E402
from rvdd_tpu_torch.bench import (  # noqa: E402
    MODELS,
    FlowLog,
    card_info,
    make_inputs,
    make_model,
    resolve_precision,
    step_fn,
)
from rvdd_tpu_torch.bench import run as bench_run  # noqa: E402
from rvdd_tpu_torch.bench import run_train  # noqa: E402
from rvdd_tpu_torch.models.fast_unet import CHAINS  # noqa: E402
from rvdd_tpu_torch.ops.cuda.conv_chain import (  # noqa: E402
    MODES,
    conv_chain,
    conv_chain_plain,
    layer_plan,
    pack_chain,
)
from rvdd_tpu_torch.ops.cuda.convnext_chain import (  # noqa: E402
    HIDDEN,
    KSIZE,
    WIDTH,
    convnext_chain,
    convnext_chain_plain,
)
from rvdd_tpu_torch.ops.cuda.warp_bicubic import (  # noqa: E402
    tile_paths,
    warp_bicubic,
    warp_bicubic_plain,
    warp_catmull_zero,
    warp_catmull_zero_plain,
)
from rvdd_tpu_torch.ops.tvl1 import (  # noqa: E402
    FLOW_PRESETS,
    _centered_gradient,
    _num_scales,
    gaussian_smooth,
    to_gray,
    tvl1_flow,
)
from rvdd_tpu_torch.ops.warp import flow_upsample_2x  # noqa: E402
from rvdd_tpu_torch.cli import generate_data, score, train, validate  # noqa: E402
from rvdd_tpu_torch.data.datasets import InferenceDataset  # noqa: E402
from rvdd_tpu_torch.data.flow_cache import FlowCache  # noqa: E402
from rvdd_tpu_torch.data.io import (  # noqa: E402
    NATIVE_WORKERS,
    imwrite,
    list_video_files,
    load_image,
    load_image_stack,
    native_shape,
)
from rvdd_tpu_torch.ops.cuda.demosaic import hamilton_adams_cuda  # noqa: E402
from rvdd_tpu_torch.ops.demosaic import hamilton_adams, hamilton_adams_plain  # noqa: E402
from rvdd_tpu_torch.ops.metrics import psnr  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.ops.bayer import remosaic  # noqa: E402
from rvdd_tpu_torch.precision import exact_precision  # noqa: E402
from rvdd_tpu_torch.recurrent.engine import EngineConfig  # noqa: E402
from rvdd_tpu_torch.training.checkpoints import flax_params, state_dict_from_flax  # noqa: E402
from rvdd_tpu_torch.training.train_state import (  # noqa: E402
    create_train_state,
    loss_and_grads,
    make_train_step,
    set_learning_rate,
)

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
HBM_BPS = 3.35e12   # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
H, W = 1080, 1920   # main-path output resolution (raw 540x960)
def mode_counts() -> dict:
    """The launches by mode besides each kernel's: conv_chain's in each of
    its modes and convnext_chain's in its fp32 mode."""
    return dict({f"conv_chain_{m}": n for m, n in conv_chain.mode_launches.items()},
                convnext_chain_fp32=convnext_chain.fp32_launches)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    hamilton_adams.plain_cuda_calls = 0
    conv_chain.mode_launches = dict.fromkeys(MODES, 0)
    convnext_chain.fp32_launches = 0


def net_launches(warps, conv=0, cnx=0, **modes):
    """A frame's net launches: the warp, the chain kernels, the demosaic
    (one a window) and each mode count (mode_counts), zero where not
    given."""
    zero = dict.fromkeys([f"conv_chain_{m}" for m in MODES] + ["convnext_chain_fp32"], 0)
    return dict(zero, warp_bicubic=warps, conv_chain=conv, convnext_chain=cnx,
                hamilton_adams_cuda=1, **modes)


def check_no_plain_demosaic(name: str) -> None:
    """Every demosaic of a main path ran the kernel: none of its CUDA raw
    took the plain version (ops/demosaic.py:hamilton_adams)."""
    if hamilton_adams.plain_cuda_calls:
        raise AssertionError(f"{name}: {hamilton_adams.plain_cuda_calls} CUDA demosaics took "
                             "the plain version")


#: net launches per frame of each model under each preset it runs here
NET_LAUNCHES = {
    ("convunet+feat", "fast"): net_launches(1, conv=21, conv_chain_bf16=21),
    ("convnext+feat+future", "fast"): net_launches(2, cnx=25),
    ("convunet+feat+future", "hybrid:glue+A+dec2"): net_launches(
        2, conv=21, conv_chain_bf16=12, conv_chain_high=9),
    ("convnext+feat+future", "mixed"): net_launches(2, cnx=25, convnext_chain_fp32=25),
    ("convunet+feat+future", "accurate"): net_launches(2, conv=21, conv_chain_highest=21),
    ("convunet+feat", "wf32"): net_launches(1, conv=21, conv_chain_w32=21),
}
#: the main paths: model, flow preset (None: cached flows), frames (the
#: state=None frame and the streamed ones), the frames before timing and
#: the fused preset ('auto': the model's own)
PATHS = (
    ("convunet+feat", None, 13, 3, "auto"),
    ("convnext+feat+future", None, 13, 3, "auto"),
    ("convunet+feat", "fast", 5, 2, "auto"),
    ("convunet+feat", "default", 3, 1, "auto"),
    ("convnext+feat+future", "fast", 3, 1, "auto"),
    ("convunet+feat+future", None, 13, 3, "auto"),
    ("convnext+feat+future", None, 8, 2, "mixed"),
    ("convunet+feat+future", None, 8, 2, "accurate"),
    ("convunet+feat", None, 3, 1, "wf32"),
)
#: normalized max error of a path's first two frames against the plain
#: module path, by preset: tests/test_fast_step.py's envelope for 'fast';
#: half of it for the hybrid, whose full-res cycle is fp32.  The hybrid
#: must also beat 'fast' on the same frames at both steps.  (The limit of
#: tests/test_hybrid_precision.py:72, 0.05 at step 1 on its 32x32 inputs,
#: sits inside the bf16 noise of the chains the hybrid keeps in bf16:
#: rvdd_tpu's own hybrid:glue+A+dec2 gives 0.041-0.062 at step 1 and
#: 0.054-0.062 at step 2 on three seeds of those inputs, the port's
#: 0.038-0.050 and 0.055-0.057, with the same mean errors; at 1080p the
#: port's step 1 gave 0.0593.  tests/test_torch_presets.py holds the port
#: to rvdd_tpu there.)  'mixed' (the flagship, every chain in the fp32
#: mode) is held to the limits of tests/test_torch_presets.py's
#: test_mixed_step_near_exact, and 'accurate' (ConvUNet, every chain in the
#: HIGHEST mode) to those of its test_accurate_step_near_exact; both must
#: beat 'fast' too.  'wf32' (bf16 bands, fp32 weights) is held to 'fast''s
#: envelope, and its errors are printed beside 'fast''s but not compared:
#: the bf16 band rounding that both keep dominates both, so exact weights
#: need not make it the closer one on given frames.
ENVELOPE = {"fast": (0.2, 0.3), "hybrid:glue+A+dec2": (0.1, 0.15), "mixed": (2e-3, 3e-3),
            "accurate": (2e-4, 3e-4), "wf32": (0.2, 0.3)}
#: the presets whose first two frames must be closer than 'fast''s
BEATS_FAST = ("hybrid:glue+A+dec2", "mixed", "accurate")
KERNELS = (warp_bicubic, conv_chain, convnext_chain, warp_catmull_zero, hamilton_adams_cuda)
BF16 = torch.bfloat16
DEV = torch.device("cuda")
CARD = ""  # nvidia-smi's name and power limit, set by main()


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, arg_sets, reps: int) -> float:
    """Mean device time in ms of fn(*args) for a call too short to time from
    the host: ``reps`` calls captured in one CUDA graph, replayed and timed
    with CUDA events, so the host's launch cost leaves no gaps.  The calls
    cycle through ``arg_sets`` and every output is kept, so with enough sets
    a call reads and writes memory that no call since its set's last use
    has left in the 50 MB L2: the time is HBM's, as the bytes bound is."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for i in range(reps):
            outs.append(fn(*arg_sets[i % len(arg_sets)]))
    ms = time_ms(graph.replay, reps=5) / reps
    del graph, outs
    return ms


@contextlib.contextmanager
def plain_mode():
    """The plain side of every comparison runs in full fp32 (no TF32).  The
    flags are restored after: the main path runs with PyTorch's defaults, as
    a user runs it (its eighth-res convs are cuDNN fp32 convs, far slower
    with TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ------------------------------------------------------------------ warp


def tile_shares(name: str, kernel, x, fl, zero_outside: bool = False, **kw) -> list:
    """One launch with the kernel's tile counter: the tiles that staged
    their window, gathered directly and were all zeroed; they must equal
    tile_paths' plain count.  Prints the shares; returns the counts."""
    counts = torch.zeros(3, dtype=torch.int32, device=DEV)
    kernel(x, fl, tile_counts=counts, **kw)
    got = counts.cpu().tolist()
    want = tile_paths(fl, x.shape[-1], x.dtype, zero_outside=zero_outside).tolist()
    n = sum(got)
    log(f"{name} tile paths of {n} tiles: window {100 * got[0] / n:.2f}%, direct "
        f"{100 * got[1] / n:.2f}%, all zeroed {100 * got[2] / n:.2f}% (plain rule: {want})")
    if got != want:
        raise AssertionError(f"{name}: the kernel's tile paths {got} differ from the rule's {want}")
    return got


def grid_of(fl, h, w):
    """F.grid_sample's normalized grid (align_corners=True) of flow [1, h, w, 2]."""
    yy, xx = torch.meshgrid(torch.arange(h, device=DEV, dtype=torch.float32),
                            torch.arange(w, device=DEV, dtype=torch.float32), indexing="ij")
    return torch.stack([(xx + fl[0, ..., 0]) * (2.0 / (w - 1)) - 1,
                        (yy + fl[0, ..., 1]) * (2.0 / (h - 1)) - 1], -1)[None]


def check_warp(gen) -> dict:
    """The 56-ch fp32 state at 1080p, warped to bf16 as on the main path,
    by the bench's smooth flow and by a flow far beyond +-48 px; and the
    flagship's future frame (3-ch bf16 to bf16) by the smooth flow."""
    c = 56
    state = torch.rand(1, H, W, c, device=DEV, generator=gen) * 2 - 1
    _, raw_flow = make_inputs(H // 2, W // 2, seed=0, device=DEV)
    smooth = flow_upsample_2x(raw_flow[:, 0, 0]).contiguous()
    yy, xx = torch.meshgrid(torch.arange(H, device=DEV, dtype=torch.float32),
                            torch.arange(W, device=DEV, dtype=torch.float32), indexing="ij")
    large = torch.stack([120 * torch.sin(xx / 97 + yy / 61), -90 * torch.cos(yy / 53)],
                        -1)[None].contiguous()
    errs = []
    for name, fl in (("smooth", smooth), ("large", large)):
        got = warp_bicubic(state, fl, out_dtype=BF16).float()
        got32 = warp_bicubic(state, fl, out_dtype=torch.float32)
        want = warp_bicubic_plain(state, fl, out_dtype=torch.float32)
        err = float((got - want).abs().max())
        err32 = float((got32 - want).abs().max())
        log(f"warp[{name}] max|flow| {float(fl.abs().max()):.1f} px: bf16-out max_abs_err "
            f"{err:.3e} (tol 1e-2, one bf16 ulp below 2), fp32-out max_abs_err {err32:.3e} "
            f"(tol 1e-5, fp32 FMA order)")
        if not (err <= 1e-2 and err32 <= 1e-5):
            raise AssertionError(f"warp_bicubic disagrees with its plain version ({name})")
        errs.append(err)
        del got, got32, want
        tile_shares(f"warp[{name}]", warp_bicubic, state, fl, out_dtype=BF16)
    # the flagship's future frame: 3-channel bf16 in, bf16 out
    frame = (torch.rand(1, H, W, 3, device=DEV, generator=gen) * 2 - 1).to(BF16)
    err = float((warp_bicubic(frame, smooth, out_dtype=BF16).float()
                 - warp_bicubic_plain(frame, smooth, out_dtype=torch.float32)).abs().max())
    log(f"warp[future frame, 3-ch bf16] bf16-out max_abs_err {err:.3e} (tol 1e-2)")
    if not err <= 1e-2:
        raise AssertionError("warp_bicubic disagrees with its plain version (future frame)")
    errs.append(err)
    tile_shares("warp[future frame]", warp_bicubic, frame, smooth, out_dtype=BF16)
    fl = smooth
    ms = time_ms(lambda: warp_bicubic(state, fl, out_dtype=BF16), reps=20)
    plain_ms = time_ms(lambda: warp_bicubic_plain(state, fl, out_dtype=BF16), reps=2)
    # library yardstick: torch's bicubic grid_sample (same semantics), NCHW
    x_nchw = state.permute(0, 3, 1, 2).contiguous()
    grid = grid_of(fl, H, W)
    lib_ms = time_ms(lambda: F.grid_sample(x_nchw, grid, mode="bicubic",
                                           padding_mode="border", align_corners=True),
                     reps=5)
    nbytes = H * W * (4 * c + 2 * 4 + 2 * c)  # fp32 state + flow in, bf16 out
    bound = nbytes / HBM_BPS * 1e3
    log(f"warp timing [state, 56-ch fp32 -> bf16]: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"F.grid_sample {lib_ms:.3f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.0f} MB), "
        f"{100 * bound / ms:.1f}% of the bound, card {CARD}")
    del x_nchw, grid, large
    # the future frame is short: timed from a CUDA graph over 4 input sets
    # (166 MB with their outputs), so its inputs come from HBM
    sets = [(frame.clone(), fl.clone()) for _ in range(4)]
    fut_ms = graph_ms(lambda a, f: warp_bicubic(a, f, out_dtype=BF16), sets, reps=96)
    fut_plain_ms = time_ms(lambda: warp_bicubic_plain(frame, fl, out_dtype=BF16), reps=2)
    lib_sets = [(a.float().permute(0, 3, 1, 2).contiguous(), grid_of(f, H, W)) for a, f in sets]
    fut_lib_ms = graph_ms(lambda a, g: F.grid_sample(a, g, mode="bicubic", padding_mode="border",
                                                     align_corners=True), lib_sets, reps=96)
    fut_bytes = H * W * (2 * 3 + 2 * 4 + 2 * 3)  # bf16 frame + flow in, bf16 out
    fut_bound = fut_bytes / HBM_BPS * 1e3
    log(f"warp timing [future frame, 3-ch bf16 -> bf16]: kernel {fut_ms:.4f} ms, plain "
        f"{fut_plain_ms:.3f} ms, F.grid_sample (fp32 NCHW copy of the frame) {fut_lib_ms:.4f} ms, "
        f"bound {fut_bound:.4f} ms ({fut_bytes / 1e6:.1f} MB), "
        f"{100 * fut_bound / fut_ms:.1f}% of the bound, card {CARD}")
    del state, sets, lib_sets
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=lib_ms, future_ms=fut_ms,
                future_plain_ms=fut_plain_ms, future_bound_ms=fut_bound,
                future_library_ms=fut_lib_ms)


# ----------------------------------------------------------- conv chains


def chain_specs(packed, gen, names=CHAINS):
    """The named chains with main-path-shaped random inputs in each chain's
    band dtype: A reads the model's input (6 or 9 channels) and the
    56-channel state's feature window, the others 48-channel bands."""
    def rnd(dt, *shape, relu=True):
        t = torch.randn(*shape, device=DEV, generator=gen)
        return (t.relu() if relu else t).to(dt)

    def spec(name, dt):
        if name == "A":
            x = rnd(dt, 1, H, W, packed["A"].layers[0].cin0, relu=False)
            return x, dict(aux=rnd(dt, 1, H, W, 56, relu=False), aux_channels=(8, 48),
                           emit=packed["A_emit"], pool=packed["A_pool"])
        if name in ("B", "C"):
            r = 2 if name == "B" else 4
            return rnd(dt, 1, H // r, W // r, 48), dict(emit=(1, 2), pool=(2,))
        r = {"dec0": 8, "dec1": 4, "dec2": 2}[name]
        kw = dict(aux=rnd(dt, 1, 2 * H // r, 2 * W // r, 48), upsample_input=True)
        if name == "dec2":
            kw["state_out"] = (56, ((4, 0), (3, 8)))
        else:
            kw["emit"] = (2,)
        return rnd(dt, 1, H // r, W // r, 48), kw

    return [(name, *spec(name, packed[name].dtype)) for name in names]


#: bf16 products a MAC of each conv_chain mode (a bf16 chain: 2 for a split
#: layer), and the prefix of its fields in the kernels line
PRODUCTS = {"bf16": 1, "high": 3, "highest": 6, "w32": 3}
FIELDS = {"bf16": "", "high": "fp32_", "highest": "highest_", "w32": "w32_"}


def chain_work(chain, x, kw, outs):
    """(flops, bytes) the chain must do and move: each input read once (the
    aux window only, in the band dtype), each output written once and the
    packed weights read once; each MAC counted at its mode's bf16 products
    (PRODUCTS)."""
    hh, ww = x.shape[1:3]
    if kw.get("upsample_input"):
        hh, ww = 2 * hh, 2 * ww
    flops = 0
    nbytes = x.numel() * x.element_size() + sum(o.numel() * o.element_size() for o in outs)
    if kw.get("aux") is not None:
        nbytes += hh * ww * chain.layers[1].aux_c * kw["aux"].element_size()
    for layer in chain.layers:
        cin = layer.cin0 + layer.aux_c
        f = 2 * hh * ww * layer.cout * layer.ks * layer.ks * cin
        flops += f * (2 if chain.mode == "bf16" and layer.split else PRODUCTS[chain.mode])
        nbytes += layer.w_pack.numel() * 2 + layer.bias.numel() * 4
    return flops, nbytes


def library_layers_ms(chain, x, kw) -> float:
    """cuDNN F.conv2d (channels_last), one call per layer at the layer's
    shape: bf16 for a bf16 chain, fp32 (TF32 off under plain_mode) for the
    modes with fp32 bands or weights.  A yardstick, not used by the port."""
    hh, ww = x.shape[1:3]
    if kw.get("upsample_input"):
        hh, ww = 2 * hh, 2 * ww
    dt = BF16 if chain.mode == "bf16" else torch.float32
    total = 0.0
    for layer in chain.layers:
        cin = layer.cin0 + layer.aux_c
        inp = torch.randn(1, cin, hh, ww, device=DEV).to(dt).to(memory_format=torch.channels_last)
        wgt = torch.randn(layer.cout, cin, layer.ks, layer.ks, device=DEV).to(dt).to(
            memory_format=torch.channels_last)
        b = torch.zeros(layer.cout, device=DEV, dtype=dt)
        total += time_ms(lambda: F.conv2d(inp, wgt, b, padding=layer.ks // 2), reps=5)
        del inp, wgt
    return total


#: mean error over std a 'w32' chain's output is held to against its
#: plain version (see chain_tolerance).  At 1080p on an H100 the kernel read
#: 1.1e-5 to 3.2e-4 and the bf16-weight control 1.9e-3 to 4.3e-3
W32_MEAN = 8e-4


def chain_tolerance(mode, want):
    """(max error, mean error over std, rule) a chain's output is held to
    against its plain version, by mode.  bf16 bands ('bf16', 'w32'): 4 bf16
    ulps of max|out| (both sides round every band after fp32 sums in other
    orders).  'w32' also a mean of W32_MEAN x std: the two differ only in
    summation order, where a band rounds the other way now and then and the
    next layers carry it, while rounding the weights to bf16 (the 'fast'
    function, which a kernel that lost the mid and lo weight planes would
    come close to) flips a large share of the bands; check_conv_chains
    runs that control on every 'w32' chain and requires it to fail the
    mean limit.  'high': 2^-12 of max|out| and a mean of 1e-4 x std (the two
    sum the same split products in different orders; where a band's sums
    differ by an ulp its lo half's bf16 rounding can flip, 2^-15 of the
    value at most, and the next layers carry it: the means seen are 5e-6 to
    1e-5; a lo half lost to zero would give about 2^-9 of the value).
    'highest': 2^-14 of max|out| and a mean of 1e-5 x std (convnext_chain's
    fp32 bounds: the dropped products are below 2^-24 of each product, and
    no band is rounded)."""
    top = float(want.abs().max())
    if mode == "high":
        return 2.0 ** -12 * top, 1e-4, "2^-12 x max|out|, mean 1e-4 x std"
    if mode == "highest":
        return 2.0 ** -14 * top, 1e-5, "2^-14 x max|out|, mean 1e-5 x std"
    if mode == "w32":
        return 2.0 ** -6 * top, W32_MEAN, f"4 bf16 ulps of max|out|, mean {W32_MEAN} x std"
    return 2.0 ** -6 * top, None, "4 bf16 ulps of max|out|"


def bf16_weight_chain(chain):
    """The chain's weights packed in the 'bf16' mode (rounded to bf16): the
    control of a 'w32' chain's check."""
    return pack_chain([layer.w_plain.permute(2, 3, 1, 0) for layer in chain.layers],
                      [layer.bias for layer in chain.layers],
                      ["relu" if layer.relu else "none" for layer in chain.layers],
                      [layer.ks for layer in chain.layers])


def mean_err(got, want) -> float:
    """Mean absolute error over the plain output's std."""
    return float((got.float() - want.float()).abs().mean()) / float(want.float().std())


def check_conv_chains(packed, gen, names=CHAINS) -> dict:
    """conv_chain on the named chains of a packing at 1080p, in the mode
    each was packed in (one mode for all of them), against conv_chain_plain
    with TF32 off (chain_tolerance); prints each layer's launch plan in the
    modes that may stream their weights.  A 'w32' chain is also run with
    its weights rounded to bf16 (bf16_weight_chain, through the kernel),
    which must fail the mean limit.  Every output is checked before a
    failure raises.  Times the chains, their TFLOP/s
    at their mode's bf16 products a MAC, and their share of the bound: the
    larger of those products at the bf16 peak and the bytes at the HBM
    rate.  Returns the kernels line's fields for that mode (FIELDS)."""
    mode = packed[names[0]].mode
    tag = "conv_chain" if mode == "bf16" else f"conv_chain {mode}"
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    flops_all = bytes_all = 0
    failed = []
    for name, x, kw in chain_specs(packed, gen, names):
        chain = packed[name]
        assert chain.mode == mode, name
        if mode != "bf16":
            log(f"{tag}[{name}] launch plans: " + "; ".join(
                f"layer {i} K={layer.ks ** 2 * (layer.cin0_pad + layer.aux_c)}: {p['mode']}, "
                f"{p['trw']} rows x {p['nwg']} warpgroups, {p['smem']} B"
                for i, (layer, p) in enumerate(
                    (layer, layer_plan(layer, mode, upsample=(k == 0 and kw.get("upsample_input"))))
                    for k, layer in enumerate(chain.layers))))
        got = conv_chain(x, chain, **kw)
        want = conv_chain_plain(x, chain, **kw)
        control = conv_chain(x, bf16_weight_chain(chain), **kw) if mode == "w32" else ()
        for i, (g, wv) in enumerate(zip(got, want)):
            ok_dtype = g.dtype == wv.dtype
            g, wv = g.float(), wv.float()
            err = float((g - wv).abs().max())
            mean = mean_err(g, wv)
            tol, tol_mean, rule = chain_tolerance(mode, wv)
            log(f"{tag}[{name}] out {i} {tuple(g.shape)}: max_abs_err {err:.3e} (tol {tol:.3e} = "
                f"{rule}; max|out| {float(wv.abs().max()):.3f}), normalized "
                f"{err / float(wv.std()):.3e}, mean {mean:.2e} x std, finite "
                f"{bool(torch.isfinite(g).all())}")
            if not (ok_dtype and err <= tol and (tol_mean is None or mean < tol_mean)
                    and torch.isfinite(g).all()):
                failed.append(f"{tag}[{name}] out {i} disagrees with its plain version")
            if control:
                c_mean = mean_err(control[i], wv)
                log(f"{tag}[{name}] out {i}: control with bf16 weights, mean {c_mean:.2e} x std "
                    f"(must fail the limit {tol_mean})")
                if not c_mean >= tol_mean:
                    failed.append(f"{tag}[{name}] out {i}: the mean limit passes bf16 weights")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
        flops, nbytes = chain_work(chain, x, kw, got)
        del got, want, control
        ms = time_ms(lambda: conv_chain(x, chain, **kw), reps=10)
        plain_ms = time_ms(lambda: conv_chain_plain(x, chain, **kw), reps=2)
        lib_ms = library_layers_ms(chain, x, kw)
        t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / HBM_BPS * 1e3
        bound = max(t_ops, t_bytes)
        lib = "cuDNN bf16" if mode == "bf16" else "cuDNN fp32 (TF32 off)"
        log(f"{tag}[{name}] {len(chain.layers)} launches: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, {lib} per layer {lib_ms:.3f} ms, bound {bound:.4f} ms "
            f"({PRODUCTS[mode]} bf16 products a MAC: {flops / 1e9:.1f} GFLOP -> {t_ops:.4f} ms; "
            f"{nbytes / 1e6:.0f} MB -> {t_bytes:.4f} ms), {flops / (ms * 1e-3) / 1e12:.1f} "
            f"TFLOP/s, {100 * bound / ms:.1f}% of the bound, card {CARD}")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        tot["library_ms"] += lib_ms
        flops_all += flops
        bytes_all += nbytes
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"{tag} chains {'+'.join(names)} per frame: {flops_all / 1e12:.3f} TFLOP, kernel "
        f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms, "
        f"{flops_all / (tot['ms'] * 1e-3) / 1e12:.1f} TFLOP/s, "
        f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of the bound; plain {tot['plain_ms']:.3f} ms, "
        f"{'cuDNN bf16' if mode == 'bf16' else 'cuDNN fp32'} per layer "
        f"{tot['library_ms']:.3f} ms, card {CARD}")
    if mode == "bf16":
        tot["bound_by"] = "operations" if flops_all / PEAK_BF16 > bytes_all / HBM_BPS else "bytes"
    return {FIELDS[mode] + k: v for k, v in tot.items()}


# ------------------------------------------------------- convnext chains


def cnx_chain_specs(packed, gen, dtype=BF16):
    """The flagship's seven chains with main-path-shaped random inputs of
    ``dtype`` (the chains' dtype)."""
    def rnd(*shape):
        return torch.randn(*shape, device=DEV, generator=gen).to(dtype)

    return [
        ("A", rnd(1, H, W, 9), dict(aux=rnd(1, H, W, 56), aux_channels=(8, 48), emit=(2,),
                                    pool=(2,))),
        ("B", rnd(1, H // 2, W // 2, 48), dict(emit=(2,), pool=(2,))),
        ("C", rnd(1, H // 4, W // 4, 48), dict(emit=(2,), pool=(2,))),
        ("mid", rnd(1, H // 8, W // 8, 48), dict()),
        ("dec0", rnd(1, H // 8, W // 8, 48), dict(aux=rnd(1, H // 4, W // 4, 48),
                                                  upsample_input=True)),
        ("dec1", rnd(1, H // 4, W // 4, 48), dict(aux=rnd(1, H // 2, W // 2, 48),
                                                  upsample_input=True)),
        ("dec2", rnd(1, H // 2, W // 2, 48), dict(aux=rnd(1, H, W, 48), upsample_input=True,
                                                  state_out=(56, 8))),
    ]


def _full_res(x, kw):
    hh, ww = x.shape[1:3]
    return (2 * hh, 2 * ww) if kw.get("upsample_input") else (hh, ww)


def with_random_affine(chain, gen):
    """A copy of a packed chain whose biases, LayerNorm affine and
    layerscale are seeded random values, drawn as the card tests'
    block_params draws them.  The seeded kaiming flagship has 0, 1 and 0.1
    there in every channel, which would hide a kernel that drops or
    mis-indexes one of them."""
    def rnd(t, mean=0.0, scale=0.1):
        if t is None:
            return None
        return (mean + scale * torch.randn(t.shape, device=DEV, generator=gen)).contiguous()

    blocks = tuple(dataclasses.replace(
        b, proj_b=rnd(b.proj_b), dw_b=rnd(b.dw_b), ln_g=rnd(b.ln_g, 1.0), ln_b=rnd(b.ln_b),
        pw1_b=rnd(b.pw1_b), pw2_b=rnd(b.pw2_b), ls=rnd(b.ls, 0.1, 0.05)) for b in chain.blocks)
    return dataclasses.replace(chain, blocks=blocks, head_b=rnd(chain.head_b))


def cnx_chain_work(chain, x, kw, outs):
    """(tensor-core FLOP, depthwise FLOP, bytes) the chain must do and move:
    the 1x1 products (proj over the real input channels, pw1, pw2, head),
    the 49 depthwise taps, each input read once (the aux window only) and
    each output written once, weights included.  In the bf16 mode both
    kinds of FLOP are bf16 products with fp32 sums, so the bound counts
    both at the bf16 tensor-core peak (rvdd_tpu's production engine runs
    the depthwise on its matrix unit too).  In the fp32 mode the 1x1 FLOP
    count six bf16 products a MAC (HIGHEST's three-way split) and the
    depthwise FLOP are fp32 (check_cnx_chains puts them at their peaks)."""
    hh, ww = _full_res(x, kw)
    px = x.shape[0] * hh * ww
    tensor = dw = 0
    nbytes = x.numel() * x.element_size() + sum(o.numel() * o.element_size() for o in outs)
    for i, blk in enumerate(chain.blocks):
        if blk.proj_w is not None:
            tensor += 2 * px * (blk.cin0 + blk.aux_c) * WIDTH
        tensor += 2 * px * 2 * WIDTH * HIDDEN
        dw += 2 * px * KSIZE * KSIZE * WIDTH
        if i == 1 and blk.aux_c:
            nbytes += px * blk.aux_c * x.element_size()
        nbytes += sum(t.numel() * t.element_size() for t in (
            blk.proj_w, blk.proj_b, blk.dw_w, blk.dw_b, blk.ln_g, blk.ln_b, blk.pw1,
            blk.pw1_b, blk.pw2, blk.pw2_b, blk.ls) if t is not None)
    if chain.head_w is not None:
        tensor += 2 * px * WIDTH * chain.n_head
        nbytes += chain.head_w.numel() * chain.head_w.element_size() + chain.head_b.numel() * 4
    return tensor * (6 if chain.band_fp32 else 1), dw, nbytes


def cnx_library_ms(chain, x, kw) -> float:
    """The chain's blocks as a sequence of library calls at its shapes, in
    the chain's dtype: torch.matmul for proj/pw1/pw2 (TF32 off under
    plain_mode), cuDNN depthwise F.conv2d (groups=48, channels_last),
    F.layer_norm and F.gelu (tanh in the bf16 mode, exact in the fp32
    mode); timed and summed.  A yardstick, not used by the port."""
    hh, ww = _full_res(x, kw)
    dt = chain.dtype
    approx = "none" if chain.band_fp32 else "tanh"
    total = 0.0
    for blk in chain.blocks:
        cin = blk.cin0 + blk.aux_c
        inp = torch.randn(1, hh, ww, cin, device=DEV).to(dt)
        pw = torch.randn(cin, WIDTH, device=DEV).to(dt) if blk.proj_w is not None else None
        taps = torch.randn(WIDTH, 1, KSIZE, KSIZE, device=DEV).to(dt)
        w1 = torch.randn(WIDTH, HIDDEN, device=DEV).to(dt)
        w2 = torch.randn(HIDDEN, WIDTH, device=DEV).to(dt)
        g = torch.ones(WIDTH, device=DEV, dtype=dt)

        def run():
            h = inp @ pw if pw is not None else inp
            d = F.conv2d(h.permute(0, 3, 1, 2), taps, padding=KSIZE // 2, groups=WIDTH)
            d = F.layer_norm(d.permute(0, 2, 3, 1), (WIDTH,), g, g)
            return h + F.gelu(d @ w1, approximate=approx) @ w2

        total += time_ms(run, reps=3)
        del inp, pw
    return total


#: peak fp32 FLOP/s of the H100 SXM's CUDA cores (NVIDIA data sheet)
PEAK_FP32 = 67e12


def check_cnx_chains(packed, gen) -> dict:
    """convnext_chain on the flagship's seven chains at 1080p in the mode
    they were packed in, against convnext_chain_plain with TF32 off, and
    timed beside the bound and the library sequence.  bf16 mode: max error
    at most 4 bf16 ulps of max|out| (both sides round LN and GELU outputs
    and bands to bf16 after sums in other orders).  fp32 mode (the 'mixed'
    packing): max error at most 2^-14 of max|out| and mean below 1e-5 x
    std (the split drops products below 2^-24 of each product, and the
    sums run in other orders); its bound is the largest of the 1x1 work at
    six bf16 products a MAC at the tensor-core peak, the depthwise in fp32
    at the CUDA cores' peak and the fp32 bytes at the HBM rate.  Returns
    the kernels line's fields, ``fp32_``-prefixed in the fp32 mode."""
    fp32 = packed["A"].band_fp32
    tag = "convnext_chain fp32" if fp32 else "convnext_chain"
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    terms = [0.0, 0.0, 0.0]
    for name, x, kw in cnx_chain_specs(packed, gen, packed["A"].dtype):
        chain = with_random_affine(packed[name], gen)
        assert chain.band_fp32 == fp32, name
        got = convnext_chain(x, chain, **kw)
        want = convnext_chain_plain(x, chain, **kw)
        for i, (g, wv) in enumerate(zip(got, want)):
            g, wv = g.float(), wv.float()
            err = float((g - wv).abs().max())
            mean = float((g - wv).abs().mean()) / float(wv.std())
            if fp32:
                tol, rule, ok_mean = 2.0 ** -14 * float(wv.abs().max()), "2^-14 x", mean < 1e-5
            else:
                tol, rule, ok_mean = 2.0 ** -6 * float(wv.abs().max()), "4 bf16 ulps of", True
            log(f"{tag}[{name}] out {i} {tuple(g.shape)} {got[i].dtype}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e} = {rule} max|out| {float(wv.abs().max()):.3f}), "
                f"normalized {err / float(wv.std()):.3e}, mean {mean:.2e} x std"
                f"{' (tol 1e-5)' if fp32 else ''}, finite {bool(torch.isfinite(g).all())}")
            if not (err <= tol and ok_mean and torch.isfinite(g).all()
                    and got[i].dtype == want[i].dtype):
                raise AssertionError(f"{tag}[{name}] disagrees with its plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tensor, dw, nbytes = cnx_chain_work(chain, x, kw, got)
        del got, want
        ms = time_ms(lambda: convnext_chain(x, chain, **kw), reps=5)
        plain_ms = time_ms(lambda: convnext_chain_plain(x, chain, **kw), reps=2)
        lib_ms = cnx_library_ms(chain, x, kw)
        if fp32:
            t_tc, t_dw = tensor / PEAK_BF16 * 1e3, dw / PEAK_FP32 * 1e3
            t_b = nbytes / HBM_BPS * 1e3
            bound = max(t_tc, t_dw, t_b)
            how = (f"1x1 products {tensor / 1e9:.1f} GFLOP of bf16 (6 a MAC) -> {t_tc:.4f} ms, "
                   f"depthwise {dw / 1e9:.1f} GFLOP of fp32 -> {t_dw:.4f} ms")
        else:
            t_tc, t_dw, t_b = (tensor / PEAK_BF16 * 1e3, dw / PEAK_BF16 * 1e3,
                               nbytes / HBM_BPS * 1e3)
            bound = max(t_tc + t_dw, t_b)
            how = (f"1x1 products {tensor / 1e9:.1f} GFLOP -> {t_tc:.4f} ms plus depthwise "
                   f"{dw / 1e9:.1f} GFLOP -> {t_dw:.4f} ms at the bf16 peak")
        log(f"{tag}[{name}] {len(chain.blocks)} launches: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, library sequence {lib_ms:.3f} ms, bound {bound:.4f} ms "
            f"({how}; {nbytes / 1e6:.0f} MB -> {t_b:.4f} ms), "
            f"{(tensor + dw) / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {100 * bound / ms:.1f}% of the "
            f"bound, card {CARD}")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        tot["library_ms"] += lib_ms
        for k, v in enumerate((t_tc, t_dw, t_b)):
            terms[k] += v
    ops = max(terms[0], terms[1]) if fp32 else terms[0] + terms[1]
    tot["bound_by"] = "operations" if ops > terms[2] else "bytes"
    log(f"{tag} per frame: bound terms 1x1 products {terms[0]:.4f} ms, depthwise "
        f"{terms[1]:.4f} ms, bytes {terms[2]:.4f} ms; kernel {tot['ms']:.3f} ms, "
        f"bound {tot['bound_ms']:.4f} ms, {100 * tot['bound_ms'] / tot['ms']:.1f}% of the bound; "
        f"plain {tot['plain_ms']:.3f} ms, library sequence {tot['library_ms']:.3f} ms, "
        f"card {CARD}")
    if fp32:
        return {f"fp32_{k}": v for k, v in tot.items() if k != "bound_by"}
    return tot


# ------------------------------------------------------- solver warp


def solver_stack(frame: torch.Tensor) -> torch.Tensor:
    """[1, h, w, 4] = [i1 | i1x | i1y | 0] as the solver builds it at its
    finest level: the frame's gray, scaled to [0, 255], presmoothed."""
    g = to_gray(frame)
    g = (g - g.min()) * (255.0 / (g.max() - g.min()))
    g = gaussian_smooth(g, 0.8)
    gx, gy = _centered_gradient(g)
    return torch.stack([g, gx, gy, torch.zeros_like(g)], -1)[None].contiguous()


def check_catmull_warp() -> dict:
    """The solver-mode warp on the [1, 540, 960, 4] stack, fp32 out, by the
    bench's TV-L1-like field and by a field that pushes many taps outside
    the frame (so the zeroing is exercised)."""
    h, w = H // 2, W // 2
    raw, true = make_inputs(h, w, seed=0, device=DEV, with_flow=True)
    x = solver_stack(raw[0, 0])
    smooth = true[0, 0, 0].contiguous()[None]
    yy, xx = torch.meshgrid(torch.arange(h, device=DEV, dtype=torch.float32),
                            torch.arange(w, device=DEV, dtype=torch.float32), indexing="ij")
    outside = torch.stack([400 * torch.sin(xx / 37 + yy / 23), -250 * torch.cos(yy / 19)],
                          -1)[None].contiguous()
    tol = 1e-5 * float(x.abs().max())
    errs = []
    for name, fl in (("tvl1-like", smooth), ("taps outside", outside)):
        gx = xx + fl[0, ..., 0]
        gy = yy + fl[0, ..., 1]
        kept = (gx >= 1) & (gx < w - 2) & (gy >= 1) & (gy < h - 2)
        got = warp_catmull_zero(x, fl)
        want = warp_catmull_zero_plain(x, fl)
        err = float((got - want).abs().max())
        zeros_ok = bool((got[0][~kept] == 0).all())
        log(f"warp_catmull_zero[{name}] max|flow| {float(fl.abs().max()):.1f} px, "
            f"{100 * (1 - float(kept.float().mean())):.1f}% of pixels zeroed: max_abs_err "
            f"{err:.3e} (tol {tol:.3e} = 1e-5 x max|x| {float(x.abs().max()):.1f}: fp32 FMA "
            f"order of 16 taps), zeroed pixels exactly 0: {zeros_ok}")
        if not (err <= tol and zeros_ok):
            raise AssertionError(f"warp_catmull_zero disagrees with its plain version ({name})")
        errs.append(err)
        tile_shares(f"warp_catmull_zero[{name}]", warp_catmull_zero, x, fl, zero_outside=True)
    fl = smooth
    # The kernel takes about as long as its wrapper's host work, so it and
    # the yardstick are timed from a CUDA graph.  One call's 20.7 MB fit in
    # the L2, so the graph cycles through 8 copies of the inputs (100 MB)
    # and keeps every output: the times are against HBM, like the bound.
    sets = [(x.clone(), fl.clone()) for _ in range(8)]
    ms = graph_ms(warp_catmull_zero, sets, reps=96)
    hot_ms = graph_ms(warp_catmull_zero, [(x, fl)], reps=96)
    plain_ms = time_ms(lambda: warp_catmull_zero_plain(x, fl), reps=5)
    # yardstick, NOT the same function: torch's bicubic is a = -0.75, and
    # zero padding is not the solver's zero-outside rule
    grid = torch.stack([(xx + fl[0, ..., 0]) * (2.0 / (w - 1)) - 1,
                        (yy + fl[0, ..., 1]) * (2.0 / (h - 1)) - 1], -1)[None]
    lib_sets = [(xs.permute(0, 3, 1, 2).contiguous(), grid.clone()) for xs, _ in sets]
    lib_ms = graph_ms(lambda a, g: F.grid_sample(a, g, mode="bicubic", padding_mode="zeros",
                                                 align_corners=True), lib_sets, reps=96)
    nbytes = h * w * (16 + 8 + 16)  # 4 fp32 planes + fp32 flow in, 4 fp32 planes out
    bound = nbytes / HBM_BPS * 1e3
    log(f"warp_catmull_zero timing at [1, {h}, {w}, 4]: kernel {ms:.4f} ms (inputs from HBM; "
        f"{hot_ms:.4f} ms with one input set, L2-resident), plain {plain_ms:.3f} ms, "
        f"F.grid_sample bicubic/zeros (a yardstick of another function: a = -0.75) "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at the HBM rate), "
        f"{100 * bound / ms:.1f}% of the bound, card {CARD}")
    del sets, lib_sets
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=lib_ms)


def check_demosaic() -> dict:
    """The demosaic kernel on the stream's window, two [540, 960, 4] packed
    frames: bitwise equal to the plain version (fp32 raw with negative
    samples, so masked products give -0), and its time from a CUDA graph
    that cycles 4 input sets (66 MB) and keeps every output, so each call
    reads and writes HBM, as the bound counts."""
    h, w = H // 2, W // 2
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    raw = torch.randn((1, 2, h, w, 4), generator=gen, device=DEV)
    got = hamilton_adams_cuda(raw)
    want = hamilton_adams_plain(raw)
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    log(f"hamilton_adams_cuda at [1, 2, {h}, {w}, 4]: {differ} of {got.numel()} values differ "
        "in their bits from the plain version")
    if differ:
        raise AssertionError("the demosaic kernel is not bitwise equal to its plain version")
    sets = [(raw.clone(),) for _ in range(4)]
    ms = graph_ms(hamilton_adams_cuda, sets, reps=48)
    plain_ms = time_ms(lambda: hamilton_adams_plain(raw), reps=5)
    nbytes = 2 * h * w * (16 + 48)  # two frames: 4 fp32 packed in, 4 x 3 fp32 RGB out
    bound = nbytes / HBM_BPS * 1e3
    log(f"hamilton_adams_cuda timing at [1, 2, {h}, {w}, 4]: kernel {ms:.4f} ms (inputs from "
        f"HBM), plain {plain_ms:.3f} ms, bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at the HBM rate), {100 * bound / ms:.1f}% of "
        f"the bound, card {CARD}")
    del sets
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes")


def compare_warp_source(src_dir: str) -> None:
    """The warp kernel of another checkout (``src_dir``, e.g. the parent
    commit's tree) against this one, at the three shapes and in one process:
    both built with _build's nvcc flags and launched through the C entry
    ``rvdd_warp_bicubic`` (12 arguments, the same in both), timed in turns
    (other, this, this, other) as check_warp and check_catmull_warp time
    them.  These launches go around the wrappers and their counts."""
    so = _build.BUILD_DIR / "libwarp_bicubic_other.so"
    src = Path(src_dir) / "rvdd_tpu_torch" / "csrc" / "warp_bicubic.cu"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True)
    libs = {"other": ctypes.CDLL(str(so)), "this": _build.load_library("warp_bicubic")}
    for lib in libs.values():
        lib.rvdd_warp_bicubic.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p, *[ctypes.c_int] * 5, ctypes.c_float,
                                          ctypes.c_int, ctypes.c_void_p]
        lib.rvdd_warp_bicubic.restype = ctypes.c_int

    def launcher(lib, out_dtype, a, zero):
        def run(x, fl):
            out = torch.empty(x.shape, dtype=out_dtype, device=DEV)
            rc = lib.rvdd_warp_bicubic(
                x.data_ptr(), int(x.dtype == BF16), fl.data_ptr(), out.data_ptr(),
                int(out_dtype == BF16), *x.shape, a, int(zero),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"warp launch failed: CUDA error {rc}")
            return out
        return run

    _, raw_flow = make_inputs(H // 2, W // 2, seed=0, device=DEV)
    smooth = flow_upsample_2x(raw_flow[:, 0, 0]).contiguous()
    state = torch.rand(1, H, W, 56, device=DEV) * 2 - 1
    frame = (torch.rand(1, H, W, 3, device=DEV) * 2 - 1).to(BF16)
    raw, true = make_inputs(H // 2, W // 2, seed=0, device=DEV, with_flow=True)
    stack = solver_stack(raw[0, 0])
    solver_fl = true[0, 0, 0].contiguous()[None]
    shapes = {
        "state_ms": (BF16, -0.75, False, [(state, smooth)], "time"),
        "future_frame_ms": (BF16, -0.75, False,
                            [(frame.clone(), smooth.clone()) for _ in range(4)], "graph"),
        "solver_ms": (torch.float32, -0.5, True,
                      [(stack.clone(), solver_fl.clone()) for _ in range(8)], "graph"),
    }
    rec = {"other": src_dir}
    for key, (out_dtype, a, zero, sets, how) in shapes.items():
        times = []
        for which in ("other", "this", "this", "other"):
            fn = launcher(libs[which], out_dtype, a, zero)
            if how == "time":
                times.append(time_ms(lambda: fn(*sets[0]), reps=20))
            else:
                times.append(graph_ms(fn, sets, reps=96))
        ref = launcher(libs["other"], out_dtype, a, zero)(*sets[0])
        got = launcher(libs["this"], out_dtype, a, zero)(*sets[0])
        diff = float((ref.float() - got.float()).abs().max())
        rec[key] = times
        log(f"warp source comparison [{key}] other, this, this, other: "
            f"{', '.join(f'{t:.4f}' for t in times)} ms; max |other - this| {diff:.3e}, "
            f"card {CARD}")
    del state, frame, shapes
    log(json.dumps({"warp_source_comparison": rec}))


def compare_cnx_source(src_dir: str, gen) -> None:
    """The convnext_chain kernel of another checkout (``src_dir``, e.g. the
    parent commit's tree) against this one on the flagship's seven chains
    at 1080p, in both modes (the 'fast' and the 'mixed' packings), in one
    process: both built with _build's nvcc flags and launched by the
    wrapper through the C entry ``rvdd_convnext_block`` (35 arguments, the
    same in both), timed in turns (other, this, this, other) as
    check_cnx_chains times them.  The wrapper counts these launches; the
    main paths reset the counts before they run."""
    so = _build.BUILD_DIR / "libconvnext_chain_other.so"
    src = Path(src_dir) / "rvdd_tpu_torch" / "csrc" / "convnext_chain.cu"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                         check=True, capture_output=True, text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if "Used" in line or "spill" in line:
            log(f"  other convnext_chain.cu: {line.strip().replace('ptxas info    : ', '')}")
    libs = {"other": ctypes.CDLL(str(so)), "this": _build.load_library("convnext_chain")}
    rec = {"other": src_dir}
    try:
        for precision, key in (("fast", "bf16"), ("mixed", "fp32")):
            _, _, packed = make_model("fused", seed=0, device=DEV, model="convnext+feat+future",
                                      precision=precision)
            total = [0.0] * 4
            for name, x, kw in cnx_chain_specs(packed, gen, packed["A"].dtype):
                chain = packed[name]
                times = []
                for k, which in enumerate(("other", "this", "this", "other")):
                    _build._LIBS["convnext_chain"] = libs[which]
                    times.append(time_ms(lambda: convnext_chain(x, chain, **kw), reps=5))
                    total[k] += times[-1]
                outs = {}
                for which in ("other", "this"):
                    _build._LIBS["convnext_chain"] = libs[which]
                    outs[which] = convnext_chain(x, chain, **kw)
                diff = max(float((o.float() - t.float()).abs().max())
                           for o, t in zip(outs["other"], outs["this"]))
                log(f"cnx source comparison [{key} {name}] other, this, this, other: "
                    f"{', '.join(f'{t:.3f}' for t in times)} ms; max |other - this| {diff:.3e}, "
                    f"card {CARD}")
                del outs
            rec[f"{key}_ms"] = total
            log(f"cnx source comparison [{key}] seven chains a frame, other, this, this, other: "
                f"{', '.join(f'{t:.3f}' for t in total)} ms, card {CARD}")
            del packed
    finally:
        _build._LIBS["convnext_chain"] = libs["this"]
    log(json.dumps({"cnx_source_comparison": rec}))


#: the packings --conv-source compares: (model, preset, chains), one per
#: conv_chain mode: 'fast' (bf16), 'auto''s fp32 chains of
#: convunet+feat+future ('high'), 'accurate' ('highest'), 'wf32' ('w32')
CONV_PACKINGS = (("convunet+feat", "fast", CHAINS), ("convunet+feat+future", "auto", ("A", "dec2")),
                 ("convunet+feat+future", "accurate", CHAINS), ("convunet+feat", "wf32", CHAINS))
#: the conv_chain mode this tree changed: --conv-source holds it to the
#: other checkout's outputs within its limits, the others bit for bit
CONV_CHANGED = "w32"


def compare_conv_source(src_dir: str, gen) -> None:
    """The conv_chain kernel of another checkout (``src_dir``, e.g. the
    parent commit's tree) against this one on the chains of each packing
    (CONV_PACKINGS) at 1080p, in one process: both built with _build's nvcc
    flags (the other's ptxas lines are printed) and launched by the wrapper
    through the C entry ``rvdd_conv_layer`` (28 arguments, the same in
    both), timed in turns (other, this, this, other) as check_conv_chains
    times them.  Prints max |other - this| per chain, which must be 0 in
    the modes this tree did not change ('bf16', 'high', 'highest'); the
    changed mode ('w32') is held to the other's outputs within its limits
    against the plain version (chain_tolerance).  The wrapper counts these
    launches; the main paths reset the counts before they run."""
    so = _build.BUILD_DIR / "libconv_chain_other.so"
    src = Path(src_dir) / "rvdd_tpu_torch" / "csrc" / "conv_chain.cu"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                         check=True, capture_output=True, text=True)
    for line in ptxas_lines((out.stdout + out.stderr).splitlines()):
        log(f"  other conv_chain.cu: {line}")
    libs = {"other": ctypes.CDLL(str(so)), "this": _build.load_library("conv_chain")}
    rec = {"other": src_dir}
    failed = []
    try:
        for model, preset, names in CONV_PACKINGS:
            _, _, packed = make_model("fused", seed=0, device=DEV, model=model, precision=preset)
            mode = packed[names[0]].mode
            total = [0.0] * 4
            for name, x, kw in chain_specs(packed, gen, names):
                chain = packed[name]
                times = []
                for k, which in enumerate(("other", "this", "this", "other")):
                    _build._LIBS["conv_chain"] = libs[which]
                    times.append(time_ms(lambda: conv_chain(x, chain, **kw), reps=5))
                    total[k] += times[-1]
                outs = {}
                for which in ("other", "this"):
                    _build._LIBS["conv_chain"] = libs[which]
                    outs[which] = conv_chain(x, chain, **kw)
                diff = max(float((o.float() - t.float()).abs().max())
                           for o, t in zip(outs["other"], outs["this"]))
                log(f"conv source comparison [{mode} {name}] other, this, this, other: "
                    f"{', '.join(f'{t:.3f}' for t in times)} ms; max |other - this| {diff:.3e}, "
                    f"card {CARD}")
                if mode == CONV_CHANGED:
                    for i, (o, t) in enumerate(zip(outs["other"], outs["this"])):
                        tol, tol_mean, rule = chain_tolerance(mode, o.float())
                        err, mean = float((o.float() - t.float()).abs().max()), mean_err(t, o)
                        log(f"conv source comparison [{mode} {name}] out {i}: max |other - this| "
                            f"{err:.3e} (tol {tol:.3e} = {rule}), mean {mean:.2e} x std")
                        if not (err <= tol and mean < tol_mean):
                            failed.append(f"{mode} {name} out {i}: {err} / {mean} from the other's")
                elif diff != 0:
                    failed.append(f"{mode} {name}: max |other - this| {diff}")
                del outs
            rec[f"{mode}_ms"] = total
            log(f"conv source comparison [{mode}] chains {'+'.join(names)} a frame, other, this, "
                f"this, other: {', '.join(f'{t:.3f}' for t in total)} ms, card {CARD}")
            del packed
    finally:
        _build._LIBS["conv_chain"] = libs["this"]
    log(json.dumps({"conv_source_comparison": rec}))
    if failed:
        raise AssertionError("conv_chain outputs differ from the other checkout's: "
                             + "; ".join(failed))


def check_tvl1() -> None:
    """One 540x960 flow per preset through the kernel route and the plain
    route: the two agree within tests/test_tvl1.py's limits (median |d| <
    0.02 px, mean < 0.05, p95 < 0.12) and both find the known flow (median
    endpoint error < 0.25 px over the interior, 10 px margin)."""
    h, w = H // 2, W // 2
    raw, true = make_inputs(h, w, seed=0, device=DEV, with_flow=True)
    gray = to_gray(raw[0])
    cur, prev, truth = gray[1], gray[0], true[0, 0, 0]
    m = 10
    tvl1_flow(cur, prev, "fast")  # first use: tables, allocator
    torch.cuda.synchronize()
    for preset, p in FLOW_PRESETS.items():
        flows = {}
        for route, warp in (("kernel", None), ("plain", warp_catmull_zero_plain)):
            its = []
            warp_catmull_zero.launches = 0
            t0 = time.perf_counter()
            fl = tvl1_flow(cur, prev, preset, iterations=its, _warp=warp)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launches = warp_catmull_zero.launches
            epe = float((fl - truth).norm(dim=-1)[m:-m, m:-m].median())
            log(f"tvl1[{preset}, {route} route] {ms:.1f} ms a flow (host clock, card {CARD}), "
                f"{sum(its)} iterations over {len(its)} stages {its}, warp_catmull_zero "
                f"launches {launches}, median endpoint error {epe:.4f} px (limit 0.25)")
            want = p.nwarps * _num_scales(w, h, p) if route == "kernel" else 0
            if launches != want or not epe < 0.25 or not torch.isfinite(fl).all():
                raise AssertionError(f"tvl1 {preset}/{route}: launches {launches} (want {want}), "
                                     f"endpoint error {epe}")
            flows[route] = fl
        d = (flows["kernel"] - flows["plain"]).abs().flatten()
        med, mean, p95 = float(d.median()), float(d.mean()), float(d.quantile(0.95))
        log(f"tvl1[{preset}] kernel vs plain route: median |d| {med:.2e} (limit 0.02), mean "
            f"{mean:.2e} (0.05), p95 {p95:.2e} (0.12), max {float(d.max()):.2e} px")
        if not (med < 0.02 and mean < 0.05 and p95 < 0.12):
            raise AssertionError(f"tvl1 {preset}: the kernel and plain routes disagree")


# -------------------------------------------------------------- main path


def first_two(model, precision, raw, flows, net_impl="fused"):
    """The first two frames of ``model`` (state None, then carried) in the
    given preset, fed the flows the main path used."""
    cfg, net, packed = make_model(net_impl, seed=0, device=DEV, model=model, precision=precision)
    d0, st = step_fn(cfg, net, packed, None, raw, flows[0])
    d1, _ = step_fn(cfg, net, packed, st, raw, flows[1])
    return d0, d1


def main_path(model: str, flow, n_frames: int, warm: int, precision: str) -> dict:
    """Drive one main path under ``precision`` ('auto': its model's own
    preset); returns its launch counts."""
    fd = MODELS[model][1]
    preset = resolve_precision(model, precision)
    cfg, net, packed = make_model("fused", seed=0, device=DEV, model=model, precision=precision)
    raw, flows = make_inputs(H // 2, W // 2, seed=0, device=DEV, model=model,
                             with_flow=flow is not None)
    flow_log = FlowLog() if flow is not None else None
    name = model + (f" online flow ({flow})" if flow else "") + f" [{preset}]"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # the first frames warm the allocator; the rest are timed as bench.py
    # times them: host clock, one synchronize.  Only the first two outputs
    # (and, online, their flows) are kept, so the loop allocates as a
    # stream does; finiteness of every frame is gathered on the device.
    dens, used_flows, state = [], [], None
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    for i in range(n_frames):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_logged = len(flow_log.events) if flow_log else 0
        den, state = step_fn(cfg, net, packed, state, raw, flows, flow, flow_log)
        if tuple(den.shape) != (1, H, W, 3):
            raise AssertionError(f"{name} frame {i}: output shape {tuple(den.shape)}")
        finite &= torch.isfinite(den).all()
        if flow_log is not None:
            finite &= torch.isfinite(flow_log.flows).all()
        if i < 2:
            dens.append(den)
            used_flows.append(flow_log.flows if flow_log else flows)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (n_frames - warm)
    launches = {k.__name__: k.launches for k in KERNELS}
    launches.update(mode_counts())
    if not bool(finite):
        raise AssertionError(f"a {name} main-path output is not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path {name}: {n_frames} frames, all finite, launches {launches}")
    log(f"main path {name}: {1e3 / ms:.2f} fps, {ms:.2f} ms/frame over {n_frames - warm} "
        f"frames (host clock), peak memory {peak:.2f} GiB, card {card_info()}")
    want = {k: n * n_frames for k, n in NET_LAUNCHES[model, preset].items()}
    want["warp_catmull_zero"] = 0
    if flow is not None:
        p = FLOW_PRESETS[flow]
        want["warp_catmull_zero"] = (1 + fd) * p.nwarps * _num_scales(W // 2, H // 2, p) * n_frames
        flow_ms = flow_log.ms()[n_logged:]
        its = len(flow_log.iterations) // n_frames
        log(f"main path {name}: flows {sum(flow_ms) / len(flow_ms):.1f} ms a frame (CUDA "
            f"events, card {CARD}), {1 + fd} flows and {sum(flow_log.iterations) / n_frames:.0f} duality "
            f"iterations a frame, the last frame's stages {flow_log.iterations[-its:]}")
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, expected {want}")
    check_no_plain_demosaic(name)
    del state, packed

    with plain_mode():
        refs = first_two(model, "auto", raw, used_flows, net_impl="module")

    def errs(outs):
        """(max, mean) normalized error of each of two frames."""
        return [(float((g - r).abs().max()) / (float(r.std()) + 1e-6),
                 float((g - r).abs().mean()) / (float(r.std()) + 1e-6))
                for g, r in zip(outs, refs)]

    err = errs(dens)
    for i, lim in enumerate(ENVELOPE[preset]):
        log(f"main path {name} step {i + 1} vs plain module path (same flows): normalized "
            f"max err {err[i][0]:.4g} (limit {lim}), mean {err[i][1]:.4g}")
        if not err[i][0] < lim:
            raise AssertionError(f"{name} step {i + 1} outside the envelope")
    if preset != "fast":
        # the same two frames under 'fast': fp32 chains whose lo halves were
        # lost would leave the preset no closer to fp32 than 'fast' is
        err_fast = errs(first_two(model, "fast", raw, used_flows))
        for i in range(2):
            log(f"main path {name} step {i + 1}: the same frames under 'fast': normalized max "
                f"err {err_fast[i][0]:.4g}, mean {err_fast[i][1]:.4g}; {preset} "
                f"{err[i][0]:.4g}, {err[i][1]:.4g}")
            if preset in BEATS_FAST and not (err[i][0] < err_fast[i][0]
                                             and err[i][1] < err_fast[i][1]):
                raise AssertionError(f"{name} step {i + 1}: no closer to the module path than "
                                     "'fast'")
    del refs, dens, used_flows
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- streams

STREAMS, STREAM_FRAMES = 2, 5
#: the streams paths: the models bench batches most often, under 'fast'
STREAM_MODELS = ("convunet+feat", "convnext+feat+future")


def streams_path(model: str) -> dict:
    """Drive ``model`` under 'fast' with STREAMS batched streams for
    STREAM_FRAMES frames; returns its launch counts, which must be one
    stream's a step (NET_LAUNCHES).  Each stream's first two frames are
    held to 'fast''s envelope of the plain module path (fed the same
    flows), and each stream's largest difference from its own
    single-stream run is printed."""
    preset = resolve_precision(model)
    cfg, net, packed = make_model("fused", seed=0, device=DEV, model=model)
    raw, flows = make_inputs(H // 2, W // 2, seed=0, device=DEV, model=model, streams=STREAMS)
    name = f"{model} x{STREAMS} streams [{preset}]"
    torch.cuda.synchronize()
    reset_counts()
    dens, state = [], None
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    for i in range(STREAM_FRAMES):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        den, state = step_fn(cfg, net, packed, state, raw, flows)
        if tuple(den.shape) != (STREAMS, H, W, 3):
            raise AssertionError(f"{name} frame {i}: output shape {tuple(den.shape)}")
        finite &= torch.isfinite(den).all()
        if i < 2:
            dens.append(den)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (STREAM_FRAMES - 1)
    launches = {k.__name__: k.launches for k in KERNELS}
    launches.update(mode_counts())
    if not bool(finite):
        raise AssertionError(f"a {name} output is not finite")
    want = {k: n * STREAM_FRAMES for k, n in NET_LAUNCHES[model, preset].items()}
    want["warp_catmull_zero"] = 0
    log(f"main path {name}: {STREAM_FRAMES} steps, all finite, launches {launches} (one "
        f"stream's a step: {NET_LAUNCHES[model, preset]})")
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, expected {want}")
    check_no_plain_demosaic(name)
    alone = []
    for b in range(STREAMS):
        d0, st = step_fn(cfg, net, packed, None, raw[b:b + 1], flows[b:b + 1])
        d1, _ = step_fn(cfg, net, packed, st, raw[b:b + 1], flows[b:b + 1])
        alone.append(max(float((dens[0][b] - d0[0]).abs().max()),
                         float((dens[1][b] - d1[0]).abs().max())))
    del state, packed
    with plain_mode():
        refs = first_two(model, "auto", raw, [flows, flows], net_impl="module")
    errs = [[float((g[b] - r[b]).abs().max()) / (float(r[b].std()) + 1e-6)
             for g, r in zip(dens, refs)] for b in range(STREAMS)]
    log(f"main path {name}: {STREAMS * 1e3 / ms:.2f} frames/s ({ms:.2f} ms a step of "
        f"{STREAMS} frames, host clock, card {CARD}); each stream's largest difference from "
        f"its own single-stream run over two steps: {alone}; normalized max err against the "
        f"plain module path by stream (steps 1, 2): {errs} (limits {ENVELOPE[preset]})")
    for b in range(STREAMS):
        for i, lim in enumerate(ENVELOPE[preset]):
            if not errs[b][i] < lim:
                raise AssertionError(f"{name} stream {b} step {i + 1} outside the envelope")
    del refs, dens
    torch.cuda.empty_cache()
    return launches


#: bench.run's modes of this slice, on convunet+feat at 1080p: (keyword
#: arguments, the kernels each must launch, those it must not)
BENCH_MODES = ((dict(streams=2, frames=5), ("warp_bicubic", "conv_chain"), ()),
               (dict(scan=True, frames=6), ("warp_bicubic", "conv_chain"), ()),
               (dict(exact=True, frames=3), ("warp_bicubic",), ("conv_chain",)))


def bench_modes() -> list:
    """One short bench.run record of each of BENCH_MODES, printed with the
    kernels it launched (warm-up included)."""
    recs = []
    for kw, launched, not_launched in BENCH_MODES:
        reset_counts()
        with saved_precision():
            rec = bench_run(model="convunet+feat", **kw)
        rec["launches"] = {k.__name__: k.launches for k in KERNELS}
        log(json.dumps({"bench": rec}))
        if not (rec["value"] > 0 and all(rec["launches"][k] for k in launched)
                and not any(rec["launches"][k] for k in not_launched)):
            raise AssertionError(f"bench {kw}: {rec}")
        recs.append(rec)
    return recs


# ---------------------------------------------------------------- serve


TRAINED = "trained-nets/recurrent-convunet+feat-tinyconv-iso3200.msgpack"
SERVE_FRAMES, SERVE_ISO = 7, 3200
#: the validate runs of the serve phase: (name, extra flags); the fused
#: runs are each held to the module run of their protocol
SERVE_RUNS = (("fused", ["--net_impl", "fused"]),
              ("fused_scan", ["--net_impl", "fused", "--val_scan"]),
              ("module", ["--net_impl", "xla"]),
              ("module_scan", ["--net_impl", "xla", "--val_scan"]))
SERVE_PARITY_DB = 0.05  # PARITY.md's budget, fused against the fp32 module path
SERVE_GAIN_DB = 1.0  # denoised above the noisy input


def synth_clip(root: str) -> None:
    """tools/make_tiny_dataset.py:synth_video(0, SERVE_FRAMES, H, W, 'rich')
    as 8-bit PNGs <root>/srgb/000/<t>.png: a smooth texture with four blobs
    and multi-octave detail, under a window moving 1.5 px right and 1 px
    down a frame.  The detail puts the denoised operating point near 40 dB,
    the regime PARITY.md measures its fused-path budget in; on the plain
    smooth texture (near 44 dB) bf16 deltas read about twice as large, in
    rvdd_tpu as in the port (tools/serve_parity.py)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    pad = max(32, int(1.5 * SERVE_FRAMES) + 8)
    yy, xx = np.mgrid[0:H + pad, 0:W + pad].astype(np.float32)
    base = 110 + 70 * np.sin(xx / 6) * np.cos(yy / 8) + 40 * np.sin((xx + yy) / 17)
    for _ in range(4):
        cx = rng.uniform(20, W)
        cy = rng.uniform(20, H)
        base = base + 120 * np.exp(-(((xx - cx) / 12) ** 2 + ((yy - cy) / 12) ** 2))
    detail = np.zeros((H + pad, W + pad), np.float32)
    for sigma, amp in ((1.0, 28.0), (2.5, 22.0), (6.0, 18.0), (14.0, 14.0)):
        f = gaussian_filter(rng.standard_normal((H + pad, W + pad)).astype(np.float32), sigma)
        detail += amp * f / (np.std(f) + 1e-8)
    base = 0.6 * base + 55 + detail
    for t in range(SERVE_FRAMES):
        win = base[t:t + H, int(1.5 * t):int(1.5 * t) + W]
        rgb = np.stack([win, 0.85 * win + 15, 0.7 * win + 8], -1)
        imwrite(os.path.join(root, "srgb", "000", f"{t:08d}.png"),
                np.clip(rgb, 0, 255).astype(np.uint8))


def noisy_input_psnr(val: str, frames) -> float:
    """The validate metric (PSNR in the network domain, peak 2) of the noisy
    raw, Hamilton-Adams demosaicked, against the linear RGB ground truth,
    averaged over ``frames``."""
    n_paths = list_video_files(os.path.join(val, f"noisy_iso{SERVE_ISO}", "000"))
    gt_paths = list_video_files(os.path.join(val, f"gt_raw_linear_RGB_iso{SERVE_ISO}", "000"))
    out = []
    for t in frames:
        raw = torch.from_numpy(load_image_stack([n_paths[t]])).to(DEV) * 2 - 1
        gt = torch.from_numpy(load_image_stack([gt_paths[t]])).to(DEV) * 2 - 1
        out.append(float(psnr(hamilton_adams(raw), gt, 2.0)))
    return sum(out) / len(out)


def native_check(val: str) -> dict:
    """The clip's noisy and ground-truth stacks, read by the host decode
    pool (load_image_stack's route for them: their headers are in its
    subset) and by the numpy reader: bit-equal; the seconds of each."""
    out = {"workers": NATIVE_WORKERS}
    for folder in (f"noisy_iso{SERVE_ISO}", f"gt_raw_linear_RGB_iso{SERVE_ISO}"):
        paths = list_video_files(os.path.join(val, folder, "000"))
        if native_shape(paths[0]) is None:
            raise AssertionError(f"native: {paths[0]} is outside the pool's subset")
        t0 = time.perf_counter()
        pool = load_image_stack(paths)
        t1 = time.perf_counter()
        ref = np.stack([load_image(p) for p in paths])
        t2 = time.perf_counter()
        if pool.dtype != ref.dtype or pool.shape != ref.shape or not np.array_equal(
                pool.view(np.uint32), ref.view(np.uint32)):
            raise AssertionError(f"native: the pool's {folder} differs from the numpy reader's")
        out[folder] = {"files": len(paths), "shape": list(ref.shape[1:]), "pool_s": t1 - t0,
                       "numpy_s": t2 - t1}
    log(f"native: the decode pool ({NATIVE_WORKERS} threads) equals the numpy reader bit for "
        f"bit: {out}")
    return out


@contextlib.contextmanager
def saved_precision():
    """The entry points set the TF32 flags process-wide (their
    --exact_precision and --train_matmul_precision): restore them after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def serve_phase(root: str) -> dict:
    """generate_data -> validate (four runs) -> score, each through its
    main(argv), in ``root``, on synth_clip's clip; checks and prints one
    line."""
    frames, sync = SERVE_FRAMES, torch.cuda.synchronize
    rec = {"frames": frames, "height": H, "width": W, "iso": SERVE_ISO, "texture": "rich",
           "card": CARD}
    t_phase = time.perf_counter()
    with saved_precision():
        synth_clip(root)
        val = os.path.join(root, "validation")
        reset_counts()
        sync()
        t0 = time.perf_counter()
        generate_data.main(["--input_val_dataset", os.path.join(root, "srgb", "%03d", "%08d.png"),
                            "--output_val_dataset", val, "--nb_seq_val", "1", "--first", "0",
                            "--last", str(frames - 1), "--step", "1", "--ISO", str(SERVE_ISO),
                            "--device", "cuda"])
        sync()
        rec["generate_s"] = time.perf_counter() - t0
        common = ["--netDenoiser", "convunet-mode=fixedfeatures+feat", "--feature_rec",
                  "--path2epoch", TRAINED, "--val_dataroot", val,
                  "--gtFolder", f"gt_iso{SERVE_ISO}", "--nFolder", f"noisy_iso{SERVE_ISO}",
                  "--gt_linear_RGB_Folder", f"gt_raw_linear_RGB_iso{SERVE_ISO}",
                  "--val_videos", "000", "--name", "serve", "--device", "cuda"]
        runs = {}
        for name, extra in SERVE_RUNS:
            reset_counts()
            ckpt = os.path.join(root, name)
            r = validate.main(common + ["--checkpoints_dir", ckpt] + extra)
            launches = {k.__name__: k.launches for k in KERNELS}
            launches.update({k: v for k, v in mode_counts().items() if v})
            result = os.path.join(ckpt, "serve", "val_visuals")
            t0 = time.perf_counter()
            sc = score.main(["--validation_path", val, "--result_folder", result,
                             "--videos", "0", "--first", "1", "--last", str(frames - 1),
                             "--step", "1", "--ISO", str(SERVE_ISO), "--device", "cuda"])
            for f in ("PSNR.txt", "SSIM.txt"):
                with open(os.path.join(result, f)) as fh:
                    if "###  Average:" not in fh.read():
                        raise AssertionError(f"serve {name}: {f} holds no average")
            runs[name] = dict(
                psnr=r["losses"]["PSNR_valLoss"], l1=r["losses"]["L1_valLoss"],
                srgb_psnr=sc["psnr"], srgb_ssim=sc["ssim"], frames=r["frames"],
                seconds=r["seconds"], flow_seconds=r["flow_seconds"],
                flows_computed=r["flows_computed"], score_s=time.perf_counter() - t0,
                fps=r["frames"] / (r["seconds"] - r["flow_seconds"]), launches=launches)
        t0 = time.perf_counter()
        for _ in InferenceDataset(val, f"gt_raw_linear_RGB_iso{SERVE_ISO}",
                                  f"noisy_iso{SERVE_ISO}", videos="000",
                                  flow_cache=FlowCache(val, f"noisy_iso{SERVE_ISO}",
                                                       device="cuda")):
            pass
        rec["read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["native"] = native_check(val)
        rec["native"]["seconds"] = time.perf_counter() - t0
        rec["noisy_psnr"] = noisy_input_psnr(val, range(1, frames))
    rec["runs"] = runs
    rec["flow_seconds"] = sum(r["flow_seconds"] for r in runs.values())
    rec["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"serve": rec}))
    for fused, module in (("fused", "module"), ("fused_scan", "module_scan")):
        d = runs[fused]["psnr"] - runs[module]["psnr"]
        log(f"serve: {fused} {runs[fused]['psnr']:.4f} dB against {module} "
            f"{runs[module]['psnr']:.4f} dB: {d:+.4f} dB (limit {SERVE_PARITY_DB})")
        if not abs(d) < SERVE_PARITY_DB:
            raise AssertionError(f"serve: {fused} is {d:+.4f} dB from the module path")
    for name, r in runs.items():
        if not r["psnr"] >= rec["noisy_psnr"] + SERVE_GAIN_DB:
            raise AssertionError(f"serve {name}: {r['psnr']:.3f} dB, the noisy input "
                                 f"{rec['noisy_psnr']:.3f} dB")
    fused_kernels = ("warp_bicubic", "conv_chain")
    if runs["fused"]["flows_computed"] != frames - 1 or not runs["fused"]["launches"][
            "warp_catmull_zero"] or any(not runs[n]["launches"][k] for n in ("fused", "fused_scan")
                                        for k in fused_kernels):
        raise AssertionError(f"serve: the fused runs did not go through the kernels: {runs}")
    return rec


#: the production convunet+feat training flags
#: (scripts/train-recurrent-convunet-feat.sh: 48 filters, depth 4, batch 2,
#: 136x136 raw = 272x272 RGB patches, patch_depth 5 = 4 unrollings), with
#: every unrolling from epoch 1, one window of 5 frames an epoch and a
#: stride of a patch: 21 keys, 10 steps an epoch on 540x960 raw
TRAIN_ARCH = "convunet-mode=fixedfeatures+feat"
TRAIN_ARGV = ["--netDenoiser", TRAIN_ARCH, "--feature_rec", "--batch_size", "2",
              "--patch_width", "136", "--patch_depth", "5", "--unroll_focus", "all",
              "--frames2load", "5", "--patch_stride", "136", "--warp_impl", "pallas",
              "--print_freq", "2"]
FLAGSHIP_ARCH = "newunet-mode=feat"
OVERFIT_STEPS, OVERFIT_LR = 30, 1e-3
#: the limits of overfit_clip, tests/test_overfit.py's: the last loss below
#: 0.2 x the first, PSNR up by more than 10 dB.  Calibrated on the CPU
#: (the same function, torch 2.13 on x86): 203.34 -> 7.74 (0.038), PSNR
#: -0.13 -> 25.14 dB
OVERFIT_RATIO, OVERFIT_GAIN_DB = 0.2, 10.0


def overfit_clip(dev) -> tuple:
    """OVERFIT_STEPS AdamW steps at OVERFIT_LR of the full-width
    convunet+feat (48 filters, 4 unrollings, seeded kaiming weights, TF32
    off) on one fixed batch: tests/test_overfit.py's static clip at 32x32
    raw (a smooth texture, raw = its mosaic plus noise, zero flows).
    Returns (first loss, last loss, first PSNR, last PSNR)."""
    cfg = EngineConfig(patch_depth=5, feature_rec=True, warp_impl="plain")
    net = build_network(TRAIN_ARCH, 6, 3, True, seed=0, device=dev)
    state = set_learning_rate(create_train_state(net, "adamw"), OVERFIT_LR)
    step = make_train_step(cfg)
    h = w = 32
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:2 * h, 0:2 * w]
    gt1 = np.stack([0.6 * np.sin(xx / 3 + k) * np.cos(yy / 4 - k / 2)
                    + 0.2 * np.sin((xx + yy) / 7) for k in range(3)], -1).astype(np.float32)
    t = cfg.patch_depth
    gt = torch.from_numpy(np.broadcast_to(gt1, (1, t, 2 * h, 2 * w, 3)).copy()).to(dev)
    raw = (remosaic(torch.from_numpy(gt1))[None, None]
           + torch.from_numpy(rng.normal(0, 0.08, (1, t, h, w, 4)).astype(np.float32))).to(dev)
    flows = torch.zeros(1, cfg.train_unrollings, cfg.d, h, w, 2, device=dev)
    weights = torch.full((cfg.train_unrollings,), 1.0 / cfg.train_unrollings)
    with exact_precision():
        seen = [step(state, raw, flows, gt, weights)[1] for _ in range(OVERFIT_STEPS)]
    return (float(seen[0]["Denoiser"]), float(seen[-1]["Denoiser"]), float(seen[0]["PSNR"]),
            float(seen[-1]["PSNR"]))


def train_inputs(cfg: EngineConfig, b: int, h: int, w: int, seed: int = 0) -> list:
    """Seeded raw frames, smooth flows of a few pixels, a linear RGB ground
    truth and uniform unrolling weights, as CPU tensors."""
    rng = np.random.default_rng(seed)
    t = cfg.patch_depth + cfg.future_patch_depth
    raw = rng.uniform(-0.9, 0.9, (b, t, h, w, 4)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    nf = cfg.d + cfg.future_patch_depth
    flows = np.zeros((b, cfg.train_unrollings, nf, h, w, 2), np.float32)
    for a in range(cfg.train_unrollings):
        flows[:, a, ..., 0] = 2.5 * np.sin(xx / 19 + a) + 1.0
        flows[:, a, ..., 1] = 1.5 * np.cos(yy / 13 - a) - 0.5
    gt = rng.uniform(-0.9, 0.9, (b, t, 2 * h, 2 * w, 3)).astype(np.float32)
    weights = np.full(cfg.train_unrollings, 1.0 / cfg.train_unrollings, np.float32)
    return [torch.from_numpy(a) for a in (raw, flows, gt, weights)]


def grad_errors(got: dict, want: dict) -> tuple:
    """(max over leaves of max|got - want| / the largest |want|, cosine of
    the two gradient vectors), in float64 on the CPU."""
    got = {k: v.double().cpu() for k, v in got.items()}
    want = {k: v.double().cpu() for k, v in want.items()}
    gscale = max(float(v.abs().max()) for v in want.values())
    err = max(float((got[k] - want[k]).abs().max()) for k in want) / gscale
    a = torch.cat([got[k].ravel() for k in sorted(want)])
    b = torch.cat([want[k].ravel() for k in sorted(want)])
    return err, float(a @ b / (a.norm() * b.norm()))


def card_against_cpu() -> dict:
    """One step of the full-width convunet+feat (batch 1, 2 unrollings,
    272x272 RGB) on the card and on the CPU: the same seeded inputs, the
    card net's weights through the flax layout into the CPU net, TF32 off.
    The loss within 1e-5 relative, each gradient leaf within 2e-3 x the
    largest CPU gradient, the cosine above 1 - 1e-6."""
    cfg = EngineConfig(patch_depth=3, feature_rec=True, warp_impl="plain")
    inputs = train_inputs(cfg, 1, 136, 136, seed=2)
    net = build_network(TRAIN_ARCH, 6, 3, True, seed=3, device=DEV)
    cpu_net = build_network(TRAIN_ARCH, 6, 3, True, seed=4, device="cpu")
    cpu_net.load_state_dict(state_dict_from_flax(flax_params(net), cpu_net))
    out = {}
    with exact_precision():
        t0 = time.perf_counter()
        l_cpu, g_cpu = loss_and_grads(cfg, cpu_net, *inputs)
        out["cpu_s"] = time.perf_counter() - t0
        l_card, g_card = loss_and_grads(cfg, net, *[x.to(DEV) for x in inputs])
    out["loss_card"], out["loss_cpu"] = float(l_card["Denoiser"]), float(l_cpu["Denoiser"])
    out["grad_err"], out["cosine"] = grad_errors(g_card, g_cpu)
    rel = abs(out["loss_card"] - out["loss_cpu"]) / abs(out["loss_cpu"])
    if not (rel <= 1e-5 and out["grad_err"] <= 2e-3 and out["cosine"] > 1 - 1e-6):
        raise AssertionError(f"train: the card's step is not the CPU's: {out}")
    return out


def flagship_remat() -> dict:
    """The flagship's step (newunet-mode=feat, the future frame, batch 2,
    272x272 RGB, 4 unrollings, TF32 off) without and with remat: gradients
    within 1e-5 x the largest; each run's peak memory and seconds."""
    cfg = EngineConfig(patch_depth=5, future_patch_depth=1, feature_rec=True, warp_impl="plain")
    inputs = [x.to(DEV) for x in train_inputs(cfg, 2, 136, 136, seed=6)]
    net = build_network(FLAGSHIP_ARCH, cfg.network_input_nc, 3, True, seed=0, device=DEV)
    out, grads = {}, []
    with exact_precision():
        loss_and_grads(cfg, net, *inputs)  # warm-up (cuDNN's algorithm choices), not timed
        for remat in (False, True):
            c = dataclasses.replace(cfg, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses, g = loss_and_grads(c, net, *inputs)
            torch.cuda.synchronize()
            key = "remat" if remat else "plain"
            out[f"{key}_s"] = time.perf_counter() - t0
            out[f"{key}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            out[f"{key}_loss"] = float(losses["Denoiser"])
            grads.append(g)
    out["grad_err"], out["cosine"] = grad_errors(grads[1], grads[0])
    if not out["grad_err"] <= 1e-5:
        raise AssertionError(f"train: remat changed the flagship's gradients: {out}")
    return out


def train_profile(steps: int = 3) -> dict:
    """Where a production train step's time goes: the trainer's step
    (convunet+feat, batch 2, 272x272 RGB, 4 unrollings, AdamW, TF32 off) on
    seeded inputs, two steps to warm up, then ``steps`` under torch.profiler:
    wall and device-busy ms a step (busy = the sum of kernel durations, one
    stream), kernel launches a step and the ten kernels of most device
    time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cfg = EngineConfig(patch_depth=5, feature_rec=True, warp_impl="plain")
    inputs = [x.to(DEV) for x in train_inputs(cfg, 2, 136, 136, seed=7)]
    net = build_network(TRAIN_ARCH, 6, 3, True, seed=0, device=DEV)
    state = set_learning_rate(create_train_state(net, "adamw"), 1e-4)
    step = make_train_step(cfg)
    with exact_precision():
        for _ in range(2):
            step(state, *inputs)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, *inputs)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_name: dict = {}
    for e in kernels:
        g = by_name.setdefault(e.name[:80], [0.0, 0])
        g[0] += e.time_range.elapsed_us() / 1e3 / steps
        g[1] += 1
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1.0 - busy / wall,
                launches=len(kernels) / steps,
                top=[dict(name=k, ms=v[0], launches=v[1] / steps) for k, v in top])


def train_data_flags(root: str, name: str) -> list:
    """The trainer's data flags in ``root``: the clip's train split,
    serve's validation split, checkpoints under ckpt/<name>, the card."""
    return ["--dataroot", os.path.join(root, "train"), "--gtFolder", f"gt_iso{SERVE_ISO}",
            "--nFolder", f"noisy_iso{SERVE_ISO}",
            "--gt_linear_RGB_Folder", f"gt_raw_linear_RGB_iso{SERVE_ISO}",
            "--val_dataroot", os.path.join(root, "validation"), "--val_videos", "000",
            "--checkpoints_dir", os.path.join(root, "ckpt"), "--name", name, "--device", "cuda"]


def train_phase(root: str) -> dict:
    """The port's trainer through cli.train.main on the card: the clip's
    train split (generate_data), one epoch, then --autoresume into epoch 2,
    in-loop validation on serve's validation split; then the overfit, the
    card-against-CPU step, the flagship with and without remat, and the
    epoch-2 net served by cli.validate --net_impl fused.  Checks and prints
    one line."""
    frames, sync = SERVE_FRAMES, torch.cuda.synchronize
    rec = {"frames": frames, "height": H, "width": W, "iso": SERVE_ISO, "card": CARD}
    t_phase = time.perf_counter()
    train_root, ckpt = os.path.join(root, "train"), os.path.join(root, "ckpt")
    data = train_data_flags(root, "train")
    with saved_precision():
        t0 = time.perf_counter()
        generate_data.main(["--input_train_dataset", os.path.join(root, "srgb", "%03d", "%08d.png"),
                            "--output_train_dataset", train_root, "--nb_seq_train", "1",
                            "--first", "0", "--last", str(frames - 1), "--step", "1",
                            "--ISO", str(SERVE_ISO), "--device", "cuda"])
        sync()
        rec["generate_s"] = time.perf_counter() - t0
        runs = []
        for extra in (["--niter", "1", "--niter_decay", "0"],
                      ["--niter", "1", "--niter_decay", "1", "--autoresume"]):
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            sync()
            t0 = time.perf_counter()
            r = train.main(TRAIN_ARGV + data + extra)
            sync()
            r["seconds"] = time.perf_counter() - t0
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            r["launches"] = {k.__name__: k.launches for k in KERNELS}
            runs.append(r)
        save_dir = os.path.join(ckpt, "train")
        steps = [float(torch.load(os.path.join(save_dir, f"{e}_optim_Denoise.pt"))
                       ["state"][0]["step"]) for e in (1, 2)]
        reset_counts()
        served = validate.main(["--netDenoiser", TRAIN_ARCH, "--feature_rec", "--epoch", "2",
                                "--net_impl", "fused"] + data)
        served_launches = {k.__name__: k.launches for k in KERNELS}
        rec["overfit"] = overfit_clip(DEV)
        rec["card_cpu"] = card_against_cpu()
        rec["flagship_remat"] = flagship_remat()
        rec["profile"] = train_profile()
    epochs = [e for r in runs for e in r["epochs"]]
    rec["epochs"] = [e["epoch"] for e in epochs]
    rec["steps"] = [e["steps"] for e in epochs]
    rec["ms_per_step"] = [e["step_ms"] for e in epochs]
    rec["samples_per_s"] = [2e3 / e["step_ms"] for e in epochs]
    rec["data_s"] = [e["data_s"] for e in epochs]
    rec["val_s"] = [e["val_s"] for e in epochs]
    rec["flow_s"] = [r["flow_seconds"] for r in runs]
    rec["flows_computed"] = [r["flows_computed"] for r in runs]
    rec["run_s"] = [r["seconds"] for r in runs]
    rec["peak_gib"] = [r["peak_gib"] for r in runs]
    rec["first_loss"] = epochs[0]["first"]["Denoiser"]
    rec["last_loss"] = epochs[-1]["last"]["Denoiser"]
    rec["last_losses"] = [e["last"]["Denoiser"] for e in epochs]
    rec["val_psnr"] = [e["val"]["PSNR_valLoss"] for e in epochs]
    rec["launches"] = [r["launches"] for r in runs]
    rec["optimizer_steps"] = steps
    rec["served"] = dict(psnr=served["losses"]["PSNR_valLoss"], frames=served["frames"],
                         launches=served_launches)
    rec["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"train": rec}))

    if rec["epochs"] != [1, 2] or rec["steps"] != [10, 10] or steps != [10.0, 20.0]:
        raise AssertionError(f"train: expected epochs 1 and 2 of 10 steps, the optimizer "
                             f"state carried on: {rec['epochs']} {rec['steps']} {steps}")
    if not all(e["finite"] for e in epochs) or not all(
            np.isfinite(list(e["val"].values())).all() for e in epochs):
        raise AssertionError("train: a loss is not finite")
    names = set(os.listdir(save_dir))
    want = {f"{e}_net_Denoise.msgpack" for e in ("0", "1", "2", "latest", "latest_val")}
    if not want | {"status.json"} <= names:
        raise AssertionError(f"train: missing {sorted(want | {'status.json'} - names)}")
    p = FLOW_PRESETS["default"]
    per_flow = p.nwarps * _num_scales(W // 2, H // 2, p)
    for r in runs:
        n = r["launches"]
        if not (n["warp_catmull_zero"] == per_flow * r["flows_computed"] and n["warp_bicubic"]
                == frames - 1 and n["warp_bicubic"] > 0 and n["conv_chain"] == 0):
            raise AssertionError(f"train: launches {n}, flows {r['flows_computed']}")
    if not runs[0]["launches"]["warp_catmull_zero"] > 0:
        raise AssertionError("train: the training flows were not computed on the card")
    first, last, p0, p1 = rec["overfit"]
    if not (last <= OVERFIT_RATIO * first and p1 - p0 > OVERFIT_GAIN_DB):
        raise AssertionError(f"train: {OVERFIT_STEPS} steps on one batch took the loss from "
                             f"{first} to {last} and PSNR from {p0} to {p1} dB")
    if not (np.isfinite(rec["served"]["psnr"]) and served_launches["conv_chain"]
            == 21 * served["frames"]):
        raise AssertionError(f"train: the epoch-2 net's fused serving: {rec['served']}")
    return rec


# ---------------------------------------------------------------- dist


#: the trace's conv ops, whose kernels are the step's convolutions
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def trace_kernels(path: str) -> dict:
    """What a torch.profiler Chrome trace shows of the device: its kernel
    events, the device-side spans of NCCL collectives (gpu_user_annotation
    'nccl:...') with the kernels inside them, and the kernels launched by
    the conv ops (by the trace's External id)."""
    events = json.load(open(path))["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [e for e in events if e.get("cat") == "gpu_user_annotation"
            and "nccl" in e.get("name", "").lower()]
    in_nccl = [k for k in kernels for n in nccl
               if n["ts"] <= k["ts"] and k["ts"] + k["dur"] <= n["ts"] + n["dur"]]
    conv_ids = {e["args"]["External id"] for e in events if e.get("cat") == "cpu_op"
                and e.get("name") in CONV_OPS and "External id" in e.get("args", {})}
    conv = [k for k in kernels if k.get("args", {}).get("External id") in conv_ids]
    by_name: dict = {}
    for k in kernels:
        by_name[k["name"][:80]] = by_name.get(k["name"][:80], 0.0) + k["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(kernels=len(kernels), nccl_spans=len(nccl),
                nccl_kernels=sorted({k["name"][:120] for k in in_nccl}),
                conv_kernels=len(conv), top_ms=[dict(name=n, ms=ms) for n, ms in top])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_phase(root: str, train_rec: dict) -> dict:
    """The trainer's data-parallel path on the card: cli.train.main with
    --distributed in torchrun's environment of a one-process job (NCCL,
    world size 1) and --profile_dir, one epoch on the train phase's data
    (its persisted flows) with TRAIN_ARGV.  Checks the backend, the steps,
    the first loss against the train phase's (same seed, data and flags),
    the files, the launches and that the trace holds NCCL's all-reduce on
    the device and the step's convolutions; prints one line."""
    sync = torch.cuda.synchronize
    prof_dir = os.path.join(root, "dist_profile")
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with saved_precision():
            reset_counts()
            sync()
            t0 = time.perf_counter()
            r = train.main(TRAIN_ARGV + train_data_flags(root, "dist")
                           + ["--distributed", "--profile_dir", prof_dir, "--niter", "1",
                              "--niter_decay", "0"])
            sync()
            seconds = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = {k.__name__: k.launches for k in KERNELS}
    (epoch,) = r["epochs"]
    trace = os.path.join(prof_dir, "rank0.json")
    rec = dict(backend=r["backend"], world_size=r["world_size"], steps=epoch["steps"],
               ms_per_step=epoch["step_ms"], samples_per_s=2e3 / epoch["step_ms"],
               train_ms_per_step=train_rec["ms_per_step"],
               train_samples_per_s=train_rec["samples_per_s"],
               first_loss=epoch["first"]["Denoiser"], train_first_loss=train_rec["first_loss"],
               last_loss=epoch["last"]["Denoiser"], val_psnr=epoch["val"]["PSNR_valLoss"],
               flows_computed=r["flows_computed"], launches=launches, run_s=seconds,
               trace_s=epoch.get("trace_s"),
               trace_bytes=os.path.getsize(trace) if os.path.exists(trace) else None,
               card=CARD)
    if rec["trace_bytes"]:
        rec["trace"] = trace_kernels(trace)
    log(json.dumps({"dist": rec}))

    if not (r["backend"] == "nccl" and r["world_size"] == 1 and r["trace"] == trace):
        raise AssertionError(f"dist: backend {r['backend']}, world {r['world_size']}, "
                             f"trace {r['trace']}")
    if not (epoch["steps"] == 10 and epoch["finite"]):
        raise AssertionError(f"dist: expected 10 finite steps: {epoch}")
    rel = abs(rec["first_loss"] - rec["train_first_loss"]) / abs(rec["train_first_loss"])
    if not rel <= 1e-4:
        raise AssertionError(f"dist: the first loss {rec['first_loss']} is {rel:.2e} from the "
                             f"train phase's {rec['train_first_loss']}")
    want = {f"{e}_net_Denoise.msgpack" for e in ("0", "1", "latest", "latest_val")}
    names = set(os.listdir(os.path.join(root, "ckpt", "dist")))
    if not want | {"status.json"} <= names:
        raise AssertionError(f"dist: missing {sorted(want | {'status.json'} - names)}")
    p = FLOW_PRESETS["default"]
    per_flow = p.nwarps * _num_scales(W // 2, H // 2, p)
    if not (launches["warp_bicubic"] == SERVE_FRAMES - 1 and launches["conv_chain"] == 0
            and launches["warp_catmull_zero"] == per_flow * r["flows_computed"]):
        raise AssertionError(f"dist: launches {launches}, flows {r['flows_computed']}")
    t = rec.get("trace", {})
    if not (t.get("nccl_spans") and t.get("nccl_kernels") and t.get("conv_kernels")):
        raise AssertionError(f"dist: the trace shows no NCCL all-reduce kernel on the device "
                             f"or no convolution kernel: {t}")
    return rec


# ---------------------------------------------------------------- space


#: the meshes of the space phase in a run without arguments
SPACE_MESHES = ("data1xspace2",)
#: the one-card fallback's size: a 16-row raw patch (two blocks of 8 for
#: depth 4), the train phase's stride, no validation (whole 1080p frames
#: through 48 filters on the CPU would dominate the phase)
SPACE_CPU_ARGV = ["--patch_width", "16", "--no_val", "--device", "cpu"]
SPACE_TIMEOUT = 900  # seconds a torchrun of the phase may take
#: a rank of the phase: cli.train.main, then what it returned (and its
#: card's peak memory) in <out>/rank<r>.json
SPACE_WORKER = """import json, os, sys
import torch
from rvdd_tpu_torch.cli import train
from rvdd_tpu_torch.config import parse_options
cuda = parse_options(sys.argv[2:], train=True).device != "cpu"
if cuda:
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    torch.cuda.reset_peak_memory_stats()
res = train.main(sys.argv[2:])
res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
with open(os.path.join(sys.argv[1], "rank%d.json" % res["rank"]), "w") as f:
    json.dump(res, f)
"""


#: ``--space-flagship``: the flagship's train step with remat on whole
#: 1080p frames (raw 540x960, batch 2, 4 unrollings, seeded draws), a size
#: whose step no card holds alone (4.35 GiB with remat at 272x272 on one
#: card, 28x fewer pixels; PERF.md), over ``data1xspace<M>``
SPACE_FLAGSHIP_WORKER = """import json, os, sys, time
import torch
from rvdd_tpu_torch.models import build_network
from rvdd_tpu_torch.parallel.mesh import init_distributed, make_mesh, replicate, shard_batch
from rvdd_tpu_torch.precision import exact_precision
from rvdd_tpu_torch.recurrent.engine import EngineConfig
from rvdd_tpu_torch.training.train_state import (create_train_state, make_train_step,
                                                 set_learning_rate)
out, spec, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
dev = init_distributed("cuda")
cfg = EngineConfig(model_patch_depth=2, patch_depth=5, future_patch_depth=1, feature_rec=True,
                   warp_impl="plain", remat=True)
net = build_network("newunet-mode=feat", cfg.network_input_nc, 3, True, seed=0, device=dev)
mesh = make_mesh(spec, batch_size=2, row_align=2 ** (net.depth - 1))
replicate(mesh, net)
state = set_learning_rate(create_train_state(net, "adamw"), 1e-4)
g = torch.Generator().manual_seed(0)
b, t, h, w, td = 2, 6, 540, 960, 4
batch = {"n": torch.rand(b, t, h, w, 4, generator=g) * 2 - 1,
         "flow": torch.rand(b, td, 2, h, w, 2, generator=g) * 4 - 2,
         "gt": torch.rand(b, t, 2 * h, 2 * w, 3, generator=g) * 2 - 1}
sh = {k: v.to(dev) for k, v in shard_batch(mesh, batch, spatial_axis=-3).items()}
weights = torch.full((td,), 1.0 / td)
step = make_train_step(cfg, "highest", mesh)
torch.cuda.reset_peak_memory_stats()
times, losses = [], []
with exact_precision():
    for i in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, l = step(state, sh["n"], sh["flow"], sh["gt"], weights, height=h)
        losses.append(float(l["Denoiser"]))
        times.append(time.perf_counter() - t0)
rows = mesh.space_rows(h).scale(2)
rec = dict(rank=mesh.rank, mesh=spec, rows=[rows.start, rows.stop],
           ms_per_step=[1e3 * x for x in times[1:]], first_step_ms=1e3 * times[0], losses=losses,
           peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
with open(os.path.join(out, "rank%d.json" % mesh.rank), "w") as f:
    json.dump(rec, f)
torch.distributed.destroy_process_group()
"""


def space_flagship(root: str, spec: str, steps: int = 2) -> dict:
    """SPACE_FLAGSHIP_WORKER in a torchrun of the mesh's processes, a card
    a rank; checks finite losses equal on every rank and prints one line."""
    nproc = mesh_processes(spec)
    out = os.path.join(root, f"flagship_{spec}")
    os.makedirs(out)
    script = os.path.join(root, "space_flagship.py")
    with open(script, "w") as f:
        f.write(SPACE_FLAGSHIP_WORKER)
    seconds = run_torchrun(root, f"flagship {spec}", nproc, [script, out, spec, str(steps)], 4)
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(nproc)]
    rec = dict(mesh=spec, backend="nccl", cards=torch.cuda.device_count(), batch=2,
               raw=[540, 960], unrollings=4, remat=True,
               rows=[r["rows"] for r in ranks], ms_per_step=[r["ms_per_step"] for r in ranks],
               first_step_ms=[r["first_step_ms"] for r in ranks],
               peak_gib=[r["peak_gib"] for r in ranks], losses=ranks[0]["losses"],
               run_s=seconds, card=CARD)
    log(json.dumps({"space_flagship": rec}))
    if not (np.isfinite(rec["losses"]).all() and all(r["losses"] == rec["losses"] for r in ranks)):
        raise AssertionError(f"space flagship {spec}: losses {[r['losses'] for r in ranks]}")
    return rec


def mesh_processes(spec: str) -> int:
    m = re.fullmatch(r"data(\d+)xspace(\d+)", spec)
    return int(m.group(1)) * int(m.group(2))


def run_torchrun(root: str, name: str, nproc: int, args: list, threads: int) -> float:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc args...`` from the repo's root, in a process group of its own
    killed whole after SPACE_TIMEOUT; raises if it fails; returns its
    seconds."""
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")])))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=SPACE_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise AssertionError(f"space: {name} did not finish in {SPACE_TIMEOUT} s")
    if proc.returncode:
        raise AssertionError(f"space: {name} exited {proc.returncode}:\n{text[-6000:]}")
    return time.perf_counter() - t0


def torchrun_train(root: str, name: str, nproc: int, argv: list, threads: int) -> tuple:
    """``cli.train.main(argv)`` in a torchrun of ``nproc`` processes
    (SPACE_WORKER); returns each rank's result and the seconds."""
    out = os.path.join(root, f"{name}_ranks")
    os.makedirs(out)
    script = os.path.join(root, "space_worker.py")
    with open(script, "w") as f:
        f.write(SPACE_WORKER)
    seconds = run_torchrun(root, name, nproc, [script, out, *argv], threads)
    return [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(nproc)], seconds


def train_once(argv: list, cuda: bool) -> dict:
    """One process of ``cli.train.main(argv)``: its epoch, seconds and the
    card's peak memory."""
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = train.main(argv)
    if cuda:
        torch.cuda.synchronize()
    (epoch,) = r["epochs"]
    return dict(epoch=epoch, seconds=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None)


def space_phase(root: str, ref: dict, meshes=SPACE_MESHES) -> list:
    """The mesh's space axis through cli.train.main --distributed
    --mesh_shape <mesh> in a torchrun: NCCL with a card a rank where the
    machine has the cards, against ``ref`` (the one-process run of the
    same flags on the card: its epoch and peak memory); else gloo on the
    CPU at SPACE_CPU_ARGV's size against a one-process CPU run.  Checks
    the steps, the first loss within 1e-4 relative and the files of one
    writer; prints one line a mesh."""
    cards = torch.cuda.device_count()
    recs = []
    for spec in meshes:
        nproc = mesh_processes(spec)
        on_cards = cards >= nproc
        name = f"space_{spec}" + ("" if on_cards else "_cpu")
        argv = TRAIN_ARGV + train_data_flags(root, name) + ["--niter", "1", "--niter_decay", "0"]
        if on_cards:
            want = ref
        else:
            argv += SPACE_CPU_ARGV
            want = train_once(TRAIN_ARGV + train_data_flags(root, name + "_one")
                              + ["--niter", "1", "--niter_decay", "0"] + SPACE_CPU_ARGV,
                              cuda=False)
        torch.cuda.empty_cache()
        ranks, seconds = torchrun_train(root, name, nproc,
                                        argv + ["--distributed", "--mesh_shape", spec],
                                        threads=4 if on_cards else max(1, 8 // nproc))
        epochs = [r["epochs"][0] for r in ranks]
        e0, w = epochs[0], want["epoch"]
        rec = dict(backend=ranks[0]["backend"], device="cuda" if on_cards else "cpu",
                   cards=cards, world_size=ranks[0]["world_size"], mesh=spec,
                   steps=e0["steps"], ms_per_step=[e["step_ms"] for e in epochs],
                   peak_gib=[r["peak_gib"] for r in ranks], first_loss=e0["first"]["Denoiser"],
                   last_loss=e0["last"]["Denoiser"], one_process_first_loss=w["first"]["Denoiser"],
                   one_process_last_loss=w["last"]["Denoiser"],
                   one_process_ms_per_step=w["step_ms"], one_process_peak_gib=want["peak_gib"],
                   run_s=seconds, card=CARD if on_cards else None)
        if not on_cards:
            rec["note"] = (f"gloo on the CPU: {cards} card(s) here, two NCCL ranks need a card "
                           "each; not the card's result")
        log(json.dumps({"space": rec}))

        if [r["rank"] for r in ranks] != list(range(nproc)) or {
                (r["world_size"], r["backend"]) for r in ranks} != {
                (nproc, "nccl" if on_cards else "gloo")}:
            seen = [(r["rank"], r["world_size"], r["backend"]) for r in ranks]
            raise AssertionError(f"space {spec}: ranks {seen}")
        if not all(e["steps"] == w["steps"] and e["steps"] >= 2 and e["finite"]
                   for e in epochs) or (on_cards and w["steps"] != 10):
            raise AssertionError(f"space {spec}: steps {[e['steps'] for e in epochs]}, "
                                 f"one process {w['steps']}")
        rel = abs(rec["first_loss"] - rec["one_process_first_loss"]) / abs(
            rec["one_process_first_loss"])
        if not rel <= 1e-4:
            raise AssertionError(f"space {spec}: the first loss {rec['first_loss']} is "
                                 f"{rel:.2e} from one process's {rec['one_process_first_loss']}")
        save_dir = os.path.join(root, "ckpt", name)
        nets = {f"{e}_net_Denoise.msgpack" for e in ("0", "1", "latest")}
        if on_cards:
            nets.add("latest_val_net_Denoise.msgpack")
        names = set(os.listdir(save_dir))
        log_text = open(os.path.join(save_dir, "loss_log.txt")).read()
        if not (nets | {"status.json"} <= names
                and log_text.count("================ Training Loss") == 1
                and f"(mesh {spec}: each patch's rows in blocks of" in log_text):
            raise AssertionError(f"space {spec}: the files of one writer: {sorted(names)}")
        recs.append(rec)
    return recs


def space_only(meshes, flagship=None) -> None:
    """``--space-only``: the clip's train and validation splits, the
    one-process reference epoch on the card (which computes and persists
    the flows), then :func:`space_phase`, and with ``flagship`` (a mesh)
    :func:`space_flagship`."""
    with tempfile.TemporaryDirectory(prefix="rvdd_space_") as root, saved_precision():
        synth_clip(root)
        src = os.path.join(root, "srgb", "%03d", "%08d.png")
        generate_data.main(["--input_train_dataset", src, "--input_val_dataset", src,
                            "--output_train_dataset", os.path.join(root, "train"),
                            "--output_val_dataset", os.path.join(root, "validation"),
                            "--nb_seq_train", "1", "--nb_seq_val", "1", "--first", "0",
                            "--last", str(SERVE_FRAMES - 1), "--step", "1",
                            "--ISO", str(SERVE_ISO), "--device", "cuda"])
        ref = train_once(TRAIN_ARGV + train_data_flags(root, "train")
                         + ["--niter", "1", "--niter_decay", "0"], cuda=True)
        log(json.dumps({"space_reference": dict(steps=ref["epoch"]["steps"],
                                                ms_per_step=ref["epoch"]["step_ms"],
                                                peak_gib=ref["peak_gib"],
                                                first_loss=ref["epoch"]["first"]["Denoiser"],
                                                card=CARD)}))
        space_phase(root, ref, meshes)
        if flagship:
            torch.cuda.empty_cache()
            space_flagship(root, flagship)
    log(CARD)


#: bench --train records: the production convunet+feat (batch 2, patch 136,
#: 4 unrollings, highest) and the flagship (remat forced)
TRAIN_BENCH = ("convunet+feat", "convnext+feat+future")


def bench_train() -> list:
    """One bench.run_train record of each of TRAIN_BENCH, 10 timed steps."""
    recs = []
    for model in TRAIN_BENCH:
        with saved_precision():
            rec = run_train(steps=10, model=model)
        log(json.dumps({"bench": rec}))
        if not (np.isfinite(rec["value"]) and rec["value"] > 0
                and rec["remat"] == model.startswith("convnext")):
            raise AssertionError(f"bench --train {model}: {rec}")
        recs.append(rec)
    return recs


#: conv_chain's warp-specialized numerics (ws::HighNum, ...) by mode
WS_NUMERICS = {"HighNum": "high", "HighestNum": "highest", "W32Num": "w32"}


def _kernel_label(text: str) -> str:
    """The instantiation a ptxas line names, where the name tells it:
    conv_chain's conv_layer_kernel<N, tile rows, mode (enum Mode)> and
    ws_layer_kernel<N, form, numerics>, convnext_chain's block kernel by
    mode; else ''."""
    m = re.search(r"conv_layer_kernelILi(\d+)ELi(\d+)ELi(\d+)E", text)
    mf = re.search(r"ws_layer_kernelILi(\d+)ELi(\d)E\w*?(HighestNum|HighNum|W32Num)", text)
    mc = re.search(r"convnext_block_kernelILb([01])E", text)
    if m:
        return f"conv_layer_kernel<{m[1]}, {m[2]}, {m[3]}>"
    if mf:
        forms = ("resident", "streamed", "upsample")
        return f"ws_layer_kernel<{mf[1]}, {forms[int(mf[2])]}, {WS_NUMERICS[mf[3]]}>"
    if mc:
        return f"convnext_block_kernel<{'fp32' if mc[1] == '1' else 'bf16'}>"
    return ""


def ptxas_lines(lines) -> list:
    """nvcc's ptxas register, shared-memory and spill lines, each labelled
    with its kernel (_kernel_label), then one line per kernel that drew
    ptxas's C75xx notes ("wgmma ... serialized" and the like, which ptxas
    prints as info) other than C7519 (the warpgroup.arrive every wgmma
    kernel draws), and the count of kernels by code."""
    kernel, out, notes = "", [], {}
    for line in lines:
        if "(C75" in line:
            code = re.search(r"\((C75\d\d)\)", line)[1]
            notes.setdefault(_kernel_label(line) or "?", set()).add(code)
        elif "Compiling entry" in line:
            label = _kernel_label(line)
            kernel = f"{label}: " if label else ""
        elif "Used" in line or "spill" in line:
            out.append(kernel + line.strip().replace("ptxas info    : ", ""))
    for label, codes in sorted(notes.items()):
        if codes - {"C7519"}:
            out.append(f"{label}: ptxas notes {', '.join(sorted(codes))}")
    counts = Counter(c for codes in notes.values() for c in codes)
    out.append(f"ptxas C75xx notes, kernels by code: {dict(counts)}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke run of rvdd_tpu_torch on one CUDA card.")
    ap.add_argument("--warp-source", metavar="DIR",
                    help="also time the warp kernel of the checkout at DIR against this one")
    ap.add_argument("--cnx-source", metavar="DIR",
                    help="also time the convnext_chain kernel of the checkout at DIR against "
                         "this one")
    ap.add_argument("--conv-source", metavar="DIR",
                    help="also time the conv_chain kernel of the checkout at DIR against this "
                         "one (bit-identical outputs in the unchanged modes)")
    ap.add_argument("--space-only", action="store_true",
                    help="run the space phase alone (its data and one-process reference "
                         "first); prints no result line")
    ap.add_argument("--space-meshes", default=",".join(SPACE_MESHES),
                    help="the space phase's meshes, comma-separated")
    ap.add_argument("--space-flagship", metavar="MESH",
                    help="with --space-only, also the flagship's step with remat on whole "
                         "1080p frames over MESH (e.g. data1xspace4)")
    args = ap.parse_args(argv)
    meshes = tuple(args.space_meshes.split(","))
    global CARD
    card = CARD = card_info()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    if args.space_only:
        return space_only(meshes, args.space_flagship)
    t0 = time.perf_counter()
    info = _build.build(_build.SOURCES + _build.HOST_SOURCES)
    log(f"build: {time.perf_counter() - t0:.1f} s wall for {len(info)} sources")
    for name, rec in info.items():
        log(f"  {_build.source_path(name).name}: {rec['seconds']:.1f} s")
        for line in ptxas_lines(rec["ptxas"]):
            log(f"    {line}")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    with plain_mode():
        warp_rec = check_warp(gen)
        _, _, packed = make_model("fused", seed=0, device=DEV)
        conv_rec = check_conv_chains(packed, gen)
        _, _, packed = make_model("fused", seed=0, device=DEV, model="convunet+feat+future")
        conv_rec.update(check_conv_chains(packed, gen, ("A", "dec2")))
        # the other four chains in 'high' (ConvUNet's 'mixed'): every 1080p
        # shape the mode takes; checked and printed, not in the kernels line
        _, _, packed = make_model("fused", seed=0, device=DEV, model="convunet+feat+future",
                                  precision="mixed")
        check_conv_chains(packed, gen, ("B", "C", "dec0", "dec1"))
        _, _, packed = make_model("fused", seed=0, device=DEV, model="convunet+feat+future",
                                  precision="accurate")
        conv_rec.update(check_conv_chains(packed, gen))
        _, _, packed = make_model("fused", seed=0, device=DEV, precision="wf32")
        conv_rec.update(check_conv_chains(packed, gen))
        _, _, packed = make_model("fused", seed=0, device=DEV, model="convnext+feat+future")
        cnx_rec = check_cnx_chains(packed, gen)
        _, _, packed = make_model("fused", seed=0, device=DEV, model="convnext+feat+future",
                                  precision="mixed")
        cnx_rec.update(check_cnx_chains(packed, gen))
        catmull_rec = check_catmull_warp()
        demosaic_rec = check_demosaic()
        if args.warp_source:
            compare_warp_source(args.warp_source)
        if args.cnx_source:
            compare_cnx_source(args.cnx_source, gen)
        if args.conv_source:
            compare_conv_source(args.conv_source, gen)
        check_tvl1()
    del packed
    torch.cuda.empty_cache()

    runs = [main_path(*path) for path in PATHS]
    t0 = time.perf_counter()
    runs += [streams_path(model) for model in STREAM_MODELS]
    t1 = time.perf_counter()
    total = {k.__name__: sum(r[k.__name__] for r in runs) for k in KERNELS}
    bench_modes()
    log(f"streams paths {t1 - t0:.1f} s, bench records {time.perf_counter() - t1:.1f} s "
        "(host clock)")
    with tempfile.TemporaryDirectory(prefix="rvdd_smoke_") as root:
        serve_phase(root)
        train_rec = train_phase(root)
        t0 = time.perf_counter()
        dist_phase(root, train_rec)
        t1 = time.perf_counter()
        space_phase(root, dict(epoch=dict(steps=train_rec["steps"][0],
                                          first=dict(Denoiser=train_rec["first_loss"]),
                                          last=dict(Denoiser=train_rec["last_losses"][0]),
                                          step_ms=train_rec["ms_per_step"][0]),
                               peak_gib=train_rec["peak_gib"][0]), meshes)
        t2 = time.perf_counter()
        bench_train()
        log(f"dist phase {t1 - t0:.1f} s, space phase {t2 - t1:.1f} s, bench train records "
            f"{time.perf_counter() - t2:.1f} s (host clock)")

    kernels = [
        dict(name="warp_bicubic", route="cuda", source="rvdd_tpu_torch/csrc/warp_bicubic.cu",
             replaces="rvdd_tpu/ops/pallas/warp_rowmajor.py:311",
             launches=total["warp_bicubic"], **warp_rec),
        dict(name="conv_chain", route="cuda", source="rvdd_tpu_torch/csrc/conv_chain.cu",
             replaces="rvdd_tpu/ops/pallas/conv_pallas.py:465",
             launches=total["conv_chain"], **conv_rec),
        dict(name="convnext_chain", route="cuda", source="rvdd_tpu_torch/csrc/convnext_chain.cu",
             replaces="rvdd_tpu/ops/pallas/convnext_pallas.py:658",
             launches=total["convnext_chain"], **cnx_rec),
        dict(name="warp_catmull_zero", route="cuda", source="rvdd_tpu_torch/csrc/warp_bicubic.cu",
             replaces="rvdd_tpu/ops/pallas/warp_pallas.py:166",
             launches=total["warp_catmull_zero"], **catmull_rec),
        dict(name="hamilton_adams_cuda", route="cuda", source="rvdd_tpu_torch/csrc/demosaic.cu",
             replaces="none (rvdd_tpu/ops/demosaic.py:hamilton_adams, in XLA)",
             launches=total["hamilton_adams_cuda"], **demosaic_rec),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "future_ms", "future_plain_ms",
            "future_bound_ms", "future_library_ms") + tuple(
                f"{m}{k}" for m in ("fp32_", "highest_", "w32_")
                for k in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err"))
    log(json.dumps({"kernels": [{k: kr[k] for k in keys if k in kr} for kr in kernels]}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
