"""Smoke run of rvdd_tpu_torch on one CUDA card: build, check, drive.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions.
2. Builds every kernel of the main path from rvdd_tpu_torch/csrc with nvcc
   (one process per source, started together) and prints each build's time
   and ptxas register/shared-memory lines.
3. Holds each kernel against its plain PyTorch version at the main path's
   shapes (1080p), TF32 off on the plain side, and times the kernel, the
   plain version and one PyTorch library call doing the same work
   (F.grid_sample for the warp, cuDNN F.conv2d per conv layer) as a
   yardstick.
4. Drives the main path through the port's entry points: 1080p
   convunet+feat streaming inference at full width with seeded kaiming
   weights, a first frame with state=None and 12 streamed frames with the
   carried fp32 state; checks every output is finite and that the first
   two frames agree with the port's plain module path (fp32, TF32 off)
   within tests/test_fast_step.py's envelope (normalized max error < 0.2 at
   step 1, < 0.3 at step 2), and that the path launched both kernels.
5. Prints a ``{"kernels": [...]}`` JSON line, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It needs a card: without one it exits 2 before doing anything.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(2)

import torch.nn.functional as F  # noqa: E402

from rvdd_tpu_torch import _build  # noqa: E402
from rvdd_tpu_torch.bench import card_info, make_inputs, make_model, step_fn  # noqa: E402
from rvdd_tpu_torch.ops.cuda.conv_chain import conv_chain, conv_chain_plain  # noqa: E402
from rvdd_tpu_torch.ops.cuda.warp_bicubic import (  # noqa: E402
    warp_bicubic,
    warp_bicubic_plain,
)
from rvdd_tpu_torch.ops.warp import flow_upsample_2x  # noqa: E402

PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
HBM_BPS = 3.35e12   # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
H, W = 1080, 1920   # main-path output resolution (raw 540x960)
STREAM_FRAMES = 12  # streamed frames after the state=None frame
BF16 = torch.bfloat16
DEV = torch.device("cuda")


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


def check_warp(gen) -> dict:
    """The 56-ch fp32 state at 1080p, warped to bf16 as on the main path,
    by the bench's smooth flow and by a flow far beyond +-48 px."""
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
    fl = smooth
    ms = time_ms(lambda: warp_bicubic(state, fl, out_dtype=BF16), reps=20)
    plain_ms = time_ms(lambda: warp_bicubic_plain(state, fl, out_dtype=BF16), reps=2)
    # library yardstick: torch's bicubic grid_sample (same semantics), NCHW
    x_nchw = state.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([(xx + fl[0, ..., 0]) * (2.0 / (W - 1)) - 1,
                        (yy + fl[0, ..., 1]) * (2.0 / (H - 1)) - 1], -1)[None]
    lib_ms = time_ms(lambda: F.grid_sample(x_nchw, grid, mode="bicubic",
                                           padding_mode="border", align_corners=True),
                     reps=5)
    nbytes = H * W * (4 * c + 2 * 4 + 2 * c)  # fp32 state + flow in, bf16 out
    bound = nbytes / HBM_BPS * 1e3
    log(f"warp timing: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, F.grid_sample "
        f"{lib_ms:.3f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.0f} MB)")
    del state, x_nchw, grid, large
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=lib_ms)


# ----------------------------------------------------------- conv chains


def chain_specs(packed, gen):
    """The six chains with main-path-shaped random bf16 inputs."""
    def rnd(*shape, relu=True):
        t = torch.randn(*shape, device=DEV, generator=gen)
        return (t.relu() if relu else t).to(BF16)

    warped = rnd(1, H, W, 56, relu=False)
    x = rnd(1, H, W, 6, relu=False)
    return [
        ("A", x, dict(aux=warped, aux_channels=(8, 48), emit=packed["A_emit"],
                      pool=packed["A_pool"])),
        ("B", rnd(1, H // 2, W // 2, 48), dict(emit=(1, 2), pool=(2,))),
        ("C", rnd(1, H // 4, W // 4, 48), dict(emit=(1, 2), pool=(2,))),
        ("dec0", rnd(1, H // 8, W // 8, 48),
         dict(aux=rnd(1, H // 4, W // 4, 48), emit=(2,), upsample_input=True)),
        ("dec1", rnd(1, H // 4, W // 4, 48),
         dict(aux=rnd(1, H // 2, W // 2, 48), emit=(2,), upsample_input=True)),
        ("dec2", rnd(1, H // 2, W // 2, 48),
         dict(aux=rnd(1, H, W, 48), upsample_input=True,
              state_out=(56, ((4, 0), (3, 8))))),
    ]


def chain_work(chain, x, kw, outs):
    """(flops, bytes) the chain must do and move: each input read once,
    each output written once, split layers counted as two products."""
    hh, ww = x.shape[1:3]
    if kw.get("upsample_input"):
        hh, ww = 2 * hh, 2 * ww
    flops = 0
    nbytes = x.numel() * x.element_size() + sum(o.numel() * o.element_size() for o in outs)
    if kw.get("aux") is not None:
        nbytes += hh * ww * chain.layers[1].aux_c * 2
    for layer in chain.layers:
        cin = layer.cin0 + layer.aux_c
        f = 2 * hh * ww * layer.cout * layer.ks * layer.ks * cin
        flops += 2 * f if layer.split else f
        nbytes += layer.w_hi.numel() * 2 * (2 if layer.split else 1) + layer.bias.numel() * 4
    return flops, nbytes


def library_layers_ms(chain, x, kw) -> float:
    """cuDNN bf16 F.conv2d (channels_last), one call per layer at the
    layer's shape: a yardstick, not used by the port."""
    hh, ww = x.shape[1:3]
    if kw.get("upsample_input"):
        hh, ww = 2 * hh, 2 * ww
    total = 0.0
    for layer in chain.layers:
        cin = layer.cin0 + layer.aux_c
        inp = torch.randn(1, cin, hh, ww, device=DEV).to(BF16).to(
            memory_format=torch.channels_last)
        wgt = torch.randn(layer.cout, cin, layer.ks, layer.ks, device=DEV).to(BF16).to(
            memory_format=torch.channels_last)
        b = torch.zeros(layer.cout, device=DEV, dtype=BF16)
        total += time_ms(lambda: F.conv2d(inp, wgt, b, padding=layer.ks // 2), reps=5)
        del inp, wgt
    return total


def check_chains(packed, gen) -> dict:
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    flops_all = bytes_all = 0
    for name, x, kw in chain_specs(packed, gen):
        chain = packed[name]
        got = conv_chain(x, chain, **kw)
        want = conv_chain_plain(x, chain, **kw)
        for i, (g, wv) in enumerate(zip(got, want)):
            g, wv = g.float(), wv.float()
            err = float((g - wv).abs().max())
            tol = 2.0 ** -6 * float(wv.abs().max())
            log(f"conv_chain[{name}] out {i} {tuple(g.shape)}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e} = 4 bf16 ulps of max|out| {float(wv.abs().max()):.3f}), "
                f"normalized {err / float(wv.std()):.3e}, finite {bool(torch.isfinite(g).all())}")
            if not (err <= tol and torch.isfinite(g).all()):
                raise AssertionError(f"conv_chain[{name}] disagrees with its plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
        flops, nbytes = chain_work(chain, x, kw, got)
        del got, want
        ms = time_ms(lambda: conv_chain(x, chain, **kw), reps=10)
        plain_ms = time_ms(lambda: conv_chain_plain(x, chain, **kw), reps=2)
        lib_ms = library_layers_ms(chain, x, kw)
        bound = max(flops / PEAK_BF16, nbytes / HBM_BPS) * 1e3
        log(f"conv_chain[{name}] {len(chain.layers)} launches: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, cuDNN per layer {lib_ms:.3f} ms, bound {bound:.4f} ms "
            f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB), "
            f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        tot["library_ms"] += lib_ms
        flops_all += flops
        bytes_all += nbytes
    tot["bound_by"] = "operations" if flops_all / PEAK_BF16 > bytes_all / HBM_BPS else "bytes"
    log(f"conv_chain per frame: {flops_all / 1e12:.3f} TFLOP, kernel {tot['ms']:.3f} ms, "
        f"bound {tot['bound_ms']:.4f} ms")
    return tot


# -------------------------------------------------------------- main path


def main_path():
    cfg, net, packed = make_model("fused", seed=0, device=DEV)
    raw, flows = make_inputs(H // 2, W // 2, seed=0, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warp_bicubic.launches = 0
    conv_chain.launches = 0
    # frame 1 (state=None) and two streamed frames warm the allocator; the
    # rest are timed as bench.py times them: host clock, one synchronize.
    # Only the first two outputs are kept, so the loop allocates as a
    # stream does; finiteness of every frame is gathered on the device.
    n_frames = 1 + STREAM_FRAMES
    warm = 3
    dens, state = [], None
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    for i in range(n_frames):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        den, state = step_fn(cfg, net, packed, state, raw, flows)
        if tuple(den.shape) != (1, H, W, 3):
            raise AssertionError(f"frame {i}: output shape {tuple(den.shape)}")
        finite &= torch.isfinite(den).all()
        if i < 2:
            dens.append(den)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (n_frames - warm)
    if not bool(finite):
        raise AssertionError("a main-path output is not finite")
    launches = {"warp_bicubic": warp_bicubic.launches, "conv_chain": conv_chain.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path: {n_frames} frames, all finite, launches {launches}")
    log(f"main path: {1e3 / ms:.2f} fps, {ms:.2f} ms/frame over {n_frames - warm} "
        f"frames (host clock), peak memory {peak:.2f} GiB, card {card_info()}")
    if launches["warp_bicubic"] != n_frames or launches["conv_chain"] != 21 * n_frames:
        raise AssertionError(f"unexpected launch counts {launches} for {n_frames} frames")
    del state, packed

    with plain_mode():
        cfg_m, net_m, _ = make_model("module", seed=0, device=DEV)
        ref0, st = step_fn(cfg_m, net_m, None, None, raw, flows)
        ref1, _ = step_fn(cfg_m, net_m, None, st, raw, flows)
    for i, (got, want, lim) in enumerate(((dens[0], ref0, 0.2), (dens[1], ref1, 0.3))):
        err = float((got - want).abs().max()) / (float(want.std()) + 1e-6)
        log(f"main path step {i + 1} vs plain module path: normalized max err {err:.4f} "
            f"(limit {lim})")
        if not err < lim:
            raise AssertionError(f"step {i + 1} outside the envelope")
    return launches


def main():
    card = card_info()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    info = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall for {len(info)} sources")
    for name, rec in info.items():
        log(f"  {name}.cu: nvcc {rec['seconds']:.1f} s")
        for line in rec["ptxas"]:
            if "Used" in line:
                log(f"    {line.replace('ptxas info    : ', '')}")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    with plain_mode():
        warp_rec = check_warp(gen)
        _, _, packed = make_model("fused", seed=0, device=DEV)
        conv_rec = check_chains(packed, gen)
    del packed
    torch.cuda.empty_cache()

    launches = main_path()

    kernels = [
        dict(name="warp_bicubic", route="cuda", source="rvdd_tpu_torch/csrc/warp_bicubic.cu",
             replaces="rvdd_tpu/ops/pallas/warp_rowmajor.py:311",
             launches=launches["warp_bicubic"], **warp_rec),
        dict(name="conv_chain", route="cuda", source="rvdd_tpu_torch/csrc/conv_chain.cu",
             replaces="rvdd_tpu/ops/pallas/conv_pallas.py:465",
             launches=launches["conv_chain"], **conv_rec),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kr[k] for k in keys} for kr in kernels]}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
