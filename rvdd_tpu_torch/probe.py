"""Where a kernel's time goes: per-phase cycle counts of the chain kernels
and the warp.

    python -m rvdd_tpu_torch.probe [--reps 10] [--kernels conv_chain,...]
        [--cases "w32,high"] [--conv-source DIR]

Needs a CUDA card.  Builds conv_chain.cu, convnext_chain.cu and
warp_bicubic.cu a second time with ``-DRVDD_PHASE_CLOCKS`` (into
``_build/lib<name>_phases.so``), in which thread 0 of each CTA adds the
``clock64`` cycles of each phase of its tiles to a device counter, and runs
single launches at 1080p:

- ``conv_chain``: a 3x3 48->48 layer (K = 432), and a chain of that layer
  and a 3x3 96->48 layer reading an aux tensor (K = 864), each with bf16
  bands, in the 'high' (bf16_3x) mode and in the 'highest' mode, whose
  chains stream the K = 864 layer's weights a tap of a channel slab at a
  time; both fp32-band modes also on dec2's first layer (3x3 48->48 on the
  2x upsample of a half-res input); the 'w32' mode (bf16 bands, fp32
  weights) on the K = 432 layer, the K = 432 then 864 chain (and the K =
  864 layer alone: the chain less the K = 432 case, time and phase sums),
  dec2's first layer and chain A's 9-channel first layer (K = 144).  Phases
  of the serial body (bf16): waiting for the tile, the products, the
  epilogue with the next tile's staging.  The warp-specialized body
  ('high', 'highest', 'w32') reports by role: the producer's (waiting for
  an empty region or weight stage, or an upsample layer's window; staging
  the tile: issuing its TMA copies, or its share of an upsample layer's
  interpolation; issuing the weight stages) and the consumers' (waiting for
  a full region or stage, or interpolating an upsample layer's tile, and of
  that the weight stages' share; the products, with the split on fp32
  bands; the epilogue).  A case whose layer streams its weights also prints
  the bytes of weights a pixel its tiles read from L2.  ``--conv-source
  DIR`` probes another checkout's conv_chain.cu (e.g. the parent commit's)
  with this tree's cases;
- ``convnext_chain``: a plain block, a proj block (96 input channels) and
  an upsample block, each in the bf16 and the fp32 mode.  bf16 phases: the
  halo tile (staging, projection or interpolation), the depthwise and
  LayerNorm, the 1x1 products with the GELU and the epilogue.  The fp32
  mode is warp-specialized, so its phases are by role: the producer's
  (waiting for the consumers' release, staging or projection of the new
  halo rows, depthwise and LayerNorm) and the consumers' (waiting for the
  LN output, the products with the GELU, the epilogue);
- ``warp_bicubic``: the 56-channel fp32 state to bf16 (the wide kernel),
  the 3-channel bf16 future frame (narrow) and the solver's [1, 540, 960,
  4] fp32 stack (narrow), by bench's smooth flow and the solver's known
  flow; phases of a tile that stages its window: flow, weights and
  footprint, the window copy, the gather and stores.  Timed from a CUDA
  graph of ``--reps`` launches, since the small shapes are shorter than
  their wrapper's host work.

For each it prints the time (CUDA events, the build without clocks) and the
mean cycles per tile and phase, as thread 0 of each CTA sees them (in
conv_chain, the first warpgroup's tiles; in convnext_chain's fp32 mode the
producer's first thread and the first consumer's; the phases of a chain's
layers are pooled).  Random weights from a seed; the outputs are not checked here
(chip_smoke.py and the card tests do that).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
from pathlib import Path

import torch

from rvdd_tpu_torch import _build
from rvdd_tpu_torch.bench import card_info, make_inputs
from rvdd_tpu_torch.ops.cuda import conv_chain as cc
from rvdd_tpu_torch.ops.cuda import convnext_chain as cx
from rvdd_tpu_torch.ops.cuda import warp_bicubic as wb
from rvdd_tpu_torch.ops.warp import flow_upsample_2x

H, W = 1080, 1920


def build_phases(name: str, src=None) -> ctypes.CDLL:
    """lib<name>_phases.so: the source (``src``, or csrc/<name>.cu) built
    with the phase clocks."""
    _build.BUILD_DIR.mkdir(exist_ok=True)
    tag = "_other" if src is not None else ""
    out = _build.BUILD_DIR / f"lib{name}{tag}_phases.so"
    tmp = _build.BUILD_DIR / f"lib{name}{tag}_phases.so.{os.getpid()}.tmp"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DRVDD_PHASE_CLOCKS", "-o", str(tmp),
           str(src or _build.CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name} with phase clocks failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def build_other(src: Path) -> ctypes.CDLL:
    """Another checkout's conv_chain.cu, built without the phase clocks."""
    out = _build.BUILD_DIR / "libconv_chain_other.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over ``reps`` calls captured in one CUDA
    graph (no host gaps between launches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, 3) / reps
    del graph
    return ms


#: phase-clock slots of csrc/wgmma.cuh: phases in 0-5, the warp-specialized
#: conv_chain body's consumer waits for weight stages in 6 (a part of slot
#: 3), the tile count in 7
SLOTS = 8


def phase_sums(lib: ctypes.CDLL, fn) -> list:
    """The cycle sums of the seven phase slots over one run of fn, and the
    tile count last."""
    buf = (ctypes.c_ulonglong * SLOTS)()
    lib.rvdd_phase_clocks.argtypes = [ctypes.c_void_p]
    _build.check(lib, lib.rvdd_phase_clocks(ctypes.addressof(buf)), "phase clocks")
    fn()
    torch.cuda.synchronize()
    _build.check(lib, lib.rvdd_phase_clocks(ctypes.addressof(buf)), "phase clocks")
    return [int(buf[i]) for i in range(SLOTS)]


def per_tile(sums: list) -> list:
    """Mean cycles per tile of each phase slot, and the tile count last."""
    tiles = max(sums[-1], 1)
    return [v / tiles for v in sums[:-1]] + [sums[-1]]


#: the fp32 convnext_chain's phases by role (slots 0-2 the producer's, 3-5
#: the consumers')
CNX_F32_PHASES = ("producer: wait for release", "stage or project new rows", "depthwise + LN",
                  "consumers: wait for LN", "products + GELU", "epilogue")
#: conv_chain's phases: the serial body's, and the warp-specialized body's
#: by role (it fills slots 3-5, the serial body does not; slot 6 is the
#: part of the consumers' wait spent on weight stages)
CONV_PHASES = ("wait for tile", "products", "epilogue + staging")
CONV_WS_PHASES = ("producer: wait for empty", "stage tile", "issue weight stages",
                  "consumers: wait for full", "products", "epilogue",
                  "(of the wait: weight stages)")


def conv_labels(ph: list) -> tuple:
    """The labels of a conv_chain case's phase slots: by role where the
    consumers' slots 3-5 were written."""
    return CONV_WS_PHASES if any(ph[3:6]) else CONV_PHASES


def weight_bytes_a_pixel(chain, mode: str, upsample: bool) -> str:
    """For each layer whose plan streams its weights: the bytes of weights
    a tile reads from L2 over its output pixels (every tile reads the
    layer's planes once)."""
    out = []
    for i, layer in enumerate(chain.layers):
        p = cc.layer_plan(layer, mode, upsample=upsample and i == 0)
        if "streamed" in p["mode"]:
            wbytes = layer.ks ** 2 * (layer.cin0_pad + layer.aux_c) * layer.cout_pad * 2 * len(
                layer.planes)
            out.append(f"layer {i} ({p['mode']}, {p['trw']}-row tiles): "
                       f"{wbytes / (p['trw'] * 64):.0f} B of weights a pixel")
    return "; ".join(out)


def conv_cases(dev, gen):
    """(label, fn, flops, extra): extra may name the case whose phases and
    time are subtracted (``minus``: the layer of a chain alone) and the
    chain whose streamed weights are counted (``streams``)."""
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    x = rnd(1, H, W, 48)
    aux = rnd(1, H, W, 48)
    zero = torch.zeros(48, device=dev)
    w0, w1 = rnd(3, 3, 48, 48, scale=0.07), rnd(3, 3, 96, 48, scale=0.05)
    w9 = rnd(3, 3, 9, 48, scale=0.15)
    k432, k864 = (cc.pack_chain(ws, [zero] * len(ws), ["relu"] * len(ws), [3] * len(ws))
                  for ws in ([w0], [w0, w1]))
    f432, f864 = (cc.pack_chain(ws, [zero] * len(ws), ["relu"] * len(ws), [3] * len(ws),
                                band_fp32=True) for ws in ([w0], [w0, w1]))
    h432, h864 = (cc.pack_chain(ws, [zero] * len(ws), ["relu"] * len(ws), [3] * len(ws),
                                band_fp32=True, mxu_precision="highest")
                  for ws in ([w0], [w0, w1]))
    w144, w432, w864 = (cc.pack_chain(ws, [zero] * len(ws), ["relu"] * len(ws), [3] * len(ws),
                                      mxu_precision="highest", weight_fp32=True)
                        for ws in ([w9], [w0], [w0, w1]))
    xb, auxb = x.to(torch.bfloat16), aux.to(torch.bfloat16)
    xh = rnd(1, H // 2, W // 2, 48)
    xhb, x9b = xh.to(torch.bfloat16), rnd(1, H, W, 9).to(torch.bfloat16)
    mac = 2 * H * W * 48
    return [
        ("3x3 48->48 (K=432)", lambda: cc.conv_chain(xb, k432), mac * 432, {}),
        ("3x3 48->48 then 3x3 96->48 with aux (K=432, 864)",
         lambda: cc.conv_chain(xb, k864, aux=auxb), mac * 1296, {}),
        # 'high' (fp32 bands, bf16_3x): three bf16 products a MAC
        ("high, 3x3 48->48 (K=432, weights resident)",
         lambda: cc.conv_chain(x, f432), 3 * mac * 432, {}),
        ("high, 3x3 48->48 then 3x3 96->48 with aux (K=432 resident, 864 streamed)",
         lambda: cc.conv_chain(x, f864, aux=aux), 3 * mac * 1296, {}),
        ("high, dec2's first layer: 3x3 48->48 on the 2x upsample (K=432)",
         lambda: cc.conv_chain(xh, f432, upsample_input=True), 3 * mac * 432, {}),
        # HIGHEST: six bf16 products a MAC
        ("highest, 3x3 48->48 (K=432, weights resident)",
         lambda: cc.conv_chain(x, h432), 6 * mac * 432, {}),
        ("highest, 3x3 48->48 then 3x3 96->48 with aux (K=432 resident, 864 streamed)",
         lambda: cc.conv_chain(x, h864, aux=aux), 6 * mac * 1296, {}),
        ("highest, dec2's first layer: 3x3 48->48 on the 2x upsample (K=432)",
         lambda: cc.conv_chain(xh, h432, upsample_input=True), 6 * mac * 432, {}),
        # 'w32': fp32 weights on bf16 bands, three products a MAC; the K =
        # 864 layer (chain A's layer 1, 48 + 48 aux channels) is the
        # two-layer chain less the K = 432 case
        ("w32, 3x3 48->48 (K=432, weights resident)",
         lambda: cc.conv_chain(xb, w432), 3 * mac * 432, {}),
        ("w32, 3x3 48->48 then 3x3 96->48 with aux (K=432, 864)",
         lambda: cc.conv_chain(xb, w864, aux=auxb), 3 * mac * 1296,
         dict(streams=(w864, "w32", False))),
        ("w32, the K=864 layer alone (3x3 96->48 with aux)", None, 3 * mac * 864,
         dict(minus=("w32, 3x3 48->48 then 3x3 96->48 with aux (K=432, 864)",
                     "w32, 3x3 48->48 (K=432, weights resident)"))),
        ("w32, dec2's first layer: 3x3 48->48 on the 2x upsample (K=432)",
         lambda: cc.conv_chain(xhb, w432, upsample_input=True), 3 * mac * 432, {}),
        ("w32, chain A's first layer: 3x3 9->48 (K=144)",
         lambda: cc.conv_chain(x9b, w144), 3 * mac * 81, {}),
    ]


def cnx_cases(dev, gen):
    def sd(cin):
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, device=dev, generator=gen) * scale

        d = {"dw.weight": rnd(48, 1, 7, 7, scale=0.2), "dw.bias": rnd(48, scale=0.1),
             "ln.weight": 1 + rnd(48, scale=0.1), "ln.bias": rnd(48, scale=0.1),
             "pw1.weight": rnd(192, 48, 1, 1, scale=0.2), "pw1.bias": rnd(192, scale=0.1),
             "pw2.weight": rnd(48, 192, 1, 1, scale=0.1), "pw2.bias": rnd(48, scale=0.1),
             "layerscale.layerscale": 0.1 + rnd(48, scale=0.05)}
        if cin != 48:
            d["proj.weight"] = rnd(48, cin, 1, 1, scale=0.1)
            d["proj.bias"] = rnd(48, scale=0.1)
        return d

    cases = []
    for fp32 in (False, True):
        dt, tag = (torch.float32, ", fp32") if fp32 else (torch.bfloat16, "")
        x = torch.randn(1, H, W, 48, device=dev, generator=gen).to(dt)
        x96 = torch.randn(1, H, W, 96, device=dev, generator=gen).to(dt)
        xh = torch.randn(1, H // 2, W // 2, 48, device=dev, generator=gen).to(dt)
        plain = cx.pack_chain([sd(48)], 48, band_fp32=fp32)
        proj = cx.pack_chain([sd(96)], 96, band_fp32=fp32)
        labels = CNX_F32_PHASES if fp32 else ("halo tile", "depthwise + LN",
                                              "1x1 + GELU + epilogue")
        cases += [
            (f"plain block{tag}", lambda x=x, c=plain: cx.convnext_chain(x, c), labels),
            (f"proj block (96 -> 48){tag}", lambda x=x96, c=proj: cx.convnext_chain(x, c), labels),
            (f"upsample block{tag}",
             lambda x=xh, c=plain: cx.convnext_chain(x, c, upsample_input=True), labels),
        ]
    return cases


def warp_cases(dev, gen):
    _, raw = make_inputs(H // 2, W // 2, seed=0, device=dev)
    smooth = flow_upsample_2x(raw[:, 0, 0]).contiguous()
    state = torch.rand(1, H, W, 56, device=dev, generator=gen) * 2 - 1
    frame = (torch.rand(1, H, W, 3, device=dev, generator=gen) * 2 - 1).to(torch.bfloat16)
    _, true = make_inputs(H // 2, W // 2, seed=0, device=dev, with_flow=True)
    stack = torch.rand(1, H // 2, W // 2, 4, device=dev, generator=gen) * 255
    solver_flow = true[0, 0, 0].contiguous()[None]
    return [
        ("state 56-ch fp32 -> bf16 (wide)",
         lambda: wb.warp_bicubic(state, smooth, out_dtype=torch.bfloat16)),
        ("future frame 3-ch bf16 (narrow)",
         lambda: wb.warp_bicubic(frame, smooth, out_dtype=torch.bfloat16)),
        ("solver [1, 540, 960, 4] fp32 (narrow)", lambda: wb.warp_catmull_zero(stack, solver_flow)),
    ]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernels", default="conv_chain,convnext_chain,warp_bicubic",
                    help="comma-separated sources to probe")
    ap.add_argument("--cases", default="",
                    help="comma-separated label prefixes: probe only the cases that start "
                         "with one of them")
    ap.add_argument("--conv-source", metavar="DIR",
                    help="probe the conv_chain.cu of the checkout at DIR instead of this one's")
    args = ap.parse_args()
    names = args.kernels.split(",")
    prefixes = tuple(p for p in args.cases.split(",") if p)
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    print(f"card: {card_info()}", flush=True)
    _build.build(tuple(names))
    warp_labels = ("flow + footprint", "window copy", "gather + store")
    groups = [
        ("conv_chain", lambda: conv_cases(dev, gen)),
        ("convnext_chain", lambda: [(n, f, None, dict(labels=lab))
                                    for n, f, lab in cnx_cases(dev, gen)]),
        ("warp_bicubic", lambda: [(n, f, None, dict(labels=warp_labels))
                                  for n, f in warp_cases(dev, gen)]),
    ]
    for name, make_cases in groups:
        if name not in names:
            continue
        src = None
        if name == "conv_chain" and args.conv_source:
            src = Path(args.conv_source) / "rvdd_tpu_torch" / "csrc" / "conv_chain.cu"
            base = build_other(src)
            print(f"conv_chain source: {src}", flush=True)
        else:
            base = _build._LIBS.get(name) or _build.load_library(name)
        clocked = build_phases(name, src)
        timer = graph_time_ms if name == "warp_bicubic" else time_ms
        seen = {}
        for label, fn, flops, extra in make_cases():
            if prefixes and not label.startswith(prefixes):
                continue
            _build._LIBS[name] = base
            if "minus" in extra:
                (ms_a, sums_a), (ms_b, sums_b) = (seen[k] for k in extra["minus"])
                ms, sums = ms_a - ms_b, [a - b for a, b in zip(sums_a, sums_b)]
            else:
                ms = timer(fn, args.reps)
                _build._LIBS[name] = clocked
                sums = phase_sums(clocked, fn)
            seen[label] = ms, sums
            ph = per_tile(sums)
            labels = extra.get("labels") or conv_labels(ph)
            rate = f", {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s" if flops else ""
            print(f"{name} {label}: {ms:.3f} ms{rate}; cycles per tile ({ph[-1]} tiles seen): "
                  + ", ".join(f"{lab} {v:.0f}" for lab, v in zip(labels, ph)), flush=True)
            if "streams" in extra:
                _build._LIBS[name] = base
                print(f"{name} {label}: {weight_bytes_a_pixel(*extra['streams'])}", flush=True)
        _build._LIBS[name] = base


if __name__ == "__main__":
    main()
