"""Fused U-Net conv chain: wrapper of csrc/conv_chain.cu.

Replaces rvdd_tpu/ops/pallas/conv_pallas.py:fused_conv_chain together with
its XLA glue: ``pool`` is the whole 2x2 max pool of an emitted layer (the
TPU kernel pools rows and rvdd_tpu/models/fast_unet.py:185-188 the lanes)
and ``upsample_input`` the whole bilinear 2x align_corners=False upsample
of a half-res input (rows at conv_pallas.py:193-227, lanes at
fast_unet.py:191-209).  A chain runs as one launch of the layer kernel per
conv; the kernel reads an aux channel window as the second half of layer
1's input, pools in its epilogue, upsamples in its prologue and writes the
combined fp32 recurrence state straight from its accumulator.

What bounds it on the H100 is operations (~1.07 TFLOP a 1080p frame,
~1.0 ms at the bf16 tensor-core peak; ~3.0 ms with fp32 weights and ~5.9
ms in the HIGHEST mode, which count three and six bf16 products a MAC);
see the kernel's source note for what its design (wgmma with the packed
weights resident in shared memory; in the 'high', 'highest' and 'w32'
modes a producer warpgroup staging the next tile with TMA, and streaming
the weights of the layers whose planes do not fit, while two consumer
warpgroups issue register-A wgmma on the current one) does about it.

A chain runs in one of four numerics (``Chain.mode``), fixed when it is
packed:

* ``bf16`` bands (rvdd_tpu's ``fast`` preset): bf16 activations and weights,
  fp32 accumulation and bias, bf16 bands between layers, and for the
  layers marked split, weights split by mantissa masking into w_hi + w_lo
  (conv_pallas.py:654-669) and accumulated as two products;
* ``high``, fp32 bands (``pack_chain(..., band_fp32=True)``; rvdd_tpu's
  ``band_dtype=float32, mxu_precision='high'``): inputs, bands and outputs
  are fp32, every layer's weights are split, and each layer's input is
  split the same way (hi by the mantissa mask, lo = bf16(a - hi); the
  kernel does it in registers, a k16 step at a time), so a product is
  w_hi a_hi + w_hi a_lo + w_lo a_hi summed in fp32 (the manual bf16_3x of
  conv_pallas.py:306-327);
* ``highest``, fp32 bands and fp32 weights (``band_fp32=True,
  mxu_precision='highest'``; rvdd_tpu's 'accurate', conv_pallas.py:288-304):
  the kernel splits the weights and each layer's input into three bf16
  planes (:func:`split3`, exact; the input in registers, a k16 step at a
  time) and sums the six products HIGHEST keeps;
  the dropped ones are below 2^-24 of each product, so the plain version is
  the plain fp32 conv;
* ``w32``, bf16 bands and fp32 weights (``mxu_precision='highest',
  weight_fp32=True``; rvdd_tpu's 'wf32', conv_pallas.py:295-296): the
  weights in three planes, three products a k-step on one bf16 A
  fragment, exact in the weights; the plain version convolves the
  bf16-valued bands with the fp32 weights in fp32.

The plain version repeats those rounding points with F.conv2d in fp32 and
is what a CPU tensor runs.  The wrapper takes tensors of the chain's band
dtype only and raises TypeError on any other; the caller rounds (as
rvdd_tpu's ``x.astype(band_dtype)``, conv_pallas.py:610-612).  A chain
runs in the mode it was packed in and in no other.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rvdd_tpu_torch import _build
from rvdd_tpu_torch.ops.resize import maxpool2x2, upsample2x_bilinear

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [
    _P, _I, _I, _I, _I, _I, _I,      # in0, c, stride, off, h, w, upsample
    _P, _I, _I, _I,                  # aux, c, stride, off
    _P, _I, _P,                      # w_pack, prec, bias
    _I, _I, _I, _I, _I,              # ks, cin0_pad, cout, cout_pad, relu
    _I, _I, _I,                      # B, H, W
    _P, _P,                          # out, pooled
    _P, _I, _I, _I,                  # state, stride, off, zero
    _P,                              # stream
]
#: rvdd_conv_layer_grid's: rvdd_conv_layer's with n_cta before the stream
_GRID_ARGTYPES = _ARGTYPES[:-1] + [_I, _P]
MAX_COUT = 48  # the kernel holds at most three 16-channel output fragments
#: a chain's numerics
MODES = ("bf16", "high", "highest", "w32")
#: a layer's numerics, as the C entry points number them (enum Prec): a
#: chain's mode, where a bf16 chain's split layers run 'bf16 split'
PRECS = ("bf16", "bf16 split", "high", "highest", "w32")


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def pack_kmajor(m: torch.Tensor) -> torch.Tensor:
    """[K, N] -> [K/8, N, 8]: the wgmma B operand in shared memory, K-major
    and unswizzled (csrc/wgmma.cuh), so 8 consecutive N rows of 8 K values
    form one 128-byte core matrix."""
    k, n = m.shape
    if k % 8:
        raise ValueError(f"pack_kmajor: K {k} is not a multiple of 8")
    return m.reshape(k // 8, 8, n).permute(0, 2, 1).contiguous()


def unpack_kmajor(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_kmajor`: [K/8, N, 8] -> [K, N]."""
    return p.permute(0, 2, 1).reshape(-1, p.shape[1])


def split_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w = hi + lo as a bf16 pair: hi by masking the low 16 mantissa bits
    (exact in bf16), lo = bf16(w - hi).  A cast round trip would not do:
    bf16(w) rounds to nearest, and rvdd_tpu found XLA could fold its
    ``w - f32(bf16(w))`` to zero (conv_pallas.py:654-669)."""
    wf = w.float().contiguous()
    hi = (wf.view(torch.int32) & -65536).view(torch.float32)
    return hi.to(torch.bfloat16), (wf - hi).to(torch.bfloat16)


def split3(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """w = hi + mid + lo exactly, as three bf16 tensors: hi keeps the top 16
    bits of each fp32 value (mantissa mask), mid the top 16 bits of the
    rest, lo the rest (at most 8 significant bits, so exact in bf16).  The
    kernels split their activations the same way in registers."""
    wf = w.float().contiguous()
    hi = (wf.view(torch.int32) & -65536).view(torch.float32)
    mid, lo = split_weight(wf - hi)
    return hi.to(torch.bfloat16), mid, lo


def sum_planes(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 value of split planes (hi first), summed so that it is
    exact: (hi + mid) + lo, or hi + lo."""
    out = planes[0].float()
    for p in planes[1:]:
        out = out + p.float()
    return out


@dataclasses.dataclass(frozen=True)
class ChainLayer:
    """One packed conv layer.  Kernel matrix row k = (dy, dx, ci) over
    ci in [conv input padded to cin0_pad | aux channels], columns = output
    channels padded to cout_pad."""

    ks: int
    cin0: int
    cin0_pad: int
    aux_c: int
    cout: int
    cout_pad: int
    relu: bool
    split: bool            # weights as a hi + lo pair (the split bf16 layers, 'high')
    w_plain: torch.Tensor  # OIHW fp32 holding the weights the kernel multiplies by
    w_hi: torch.Tensor     # [ks*ks*(cin0_pad+aux_c), cout_pad] bf16
    w_mid: Optional[torch.Tensor]  # the middle plane of fp32 weights ('highest', 'w32')
    w_lo: Optional[torch.Tensor]
    bias: torch.Tensor     # [cout] fp32
    w_pack: torch.Tensor   # the kernel's copy: pack_kmajor of each plane, hi, (mid,) lo

    @property
    def planes(self) -> Tuple[torch.Tensor, ...]:
        """The weight planes, hi first, that sum to the weights."""
        return tuple(p for p in (self.w_hi, self.w_mid, self.w_lo) if p is not None)


@dataclasses.dataclass(frozen=True)
class Chain:
    layers: Tuple[ChainLayer, ...]
    #: the numerics (MODES): 'bf16' bands; fp32 bands with bf16_3x ('high')
    #: or HIGHEST ('highest') products; bf16 bands with fp32 weights ('w32')
    mode: str = "bf16"

    @property
    def band_fp32(self) -> bool:
        return self.mode in ("high", "highest")

    @property
    def dtype(self) -> torch.dtype:
        """The band dtype: of the inputs the chain takes and the outputs it
        emits (the combined state is fp32 in every mode)."""
        return torch.float32 if self.band_fp32 else torch.bfloat16


def chain_mode(band_fp32: bool = False, mxu_precision: Optional[str] = None,
               weight_fp32: bool = False) -> str:
    """The kernel mode (MODES) of rvdd_tpu's fused_conv_chain options:
    bf16 bands at 'default' ('bf16'); fp32 bands at 'high' ('high', the
    default for fp32 bands); fp32 bands at 'highest', whose weights are the
    band dtype, fp32 ('highest'); bf16 bands with fp32 weights at 'highest'
    ('w32').  Other combinations have no kernel mode and raise."""
    mp = mxu_precision or ("high" if band_fp32 else "default")
    modes = {(False, "default", False): "bf16", (True, "high", False): "high",
             (True, "highest", False): "highest", (False, "highest", True): "w32"}
    key = (bool(band_fp32), mp, bool(weight_fp32))
    if key not in modes:
        raise NotImplementedError(f"conv_chain: no kernel mode for band_fp32={band_fp32}, "
                                  f"mxu_precision={mxu_precision!r}, weight_fp32={weight_fp32}")
    return modes[key]


def pack_chain(ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
               acts: Sequence[str], ks: Sequence[int], *,
               weight_split: Optional[Sequence[bool]] = None,
               band_fp32: bool = False, mxu_precision: Optional[str] = None,
               weight_fp32: bool = False) -> Chain:
    """Pack HWIO fp32 weights ``ws[l]`` [k, k, cin, cout] and biases for
    :func:`conv_chain`, once per set of weights.  Layer 1's cin may exceed
    layer 0's cout: the excess is the aux channels concatenated after the
    conv output.  ``band_fp32``, ``mxu_precision`` and ``weight_fp32`` are
    rvdd_tpu's band dtype, MXU precision and weight dtype, and pick the
    chain's mode (:func:`chain_mode`).  ``weight_split[l]`` marks the layers
    of a bf16 chain with hi/lo weights; the other modes fix every layer's
    weights: the 'high' mode splits them into hi + lo (as
    ``mxu_precision='high'`` forces ``weight_dtype='split'``,
    conv_pallas.py:574-580), 'highest' and 'w32' keep them fp32, as three
    bf16 planes (:func:`split3`)."""
    mode = chain_mode(band_fp32, mxu_precision, weight_fp32)
    nl = len(ws)
    if mode == "bf16":
        split = tuple(weight_split) if weight_split is not None else (False,) * nl
    else:
        split = (mode == "high",) * nl
    if not (len(bs) == len(acts) == len(ks) == len(split) == nl):
        raise ValueError("pack_chain: ws, bs, acts, ks and weight_split differ in length")
    layers = []
    prev = None
    for l in range(nl):
        w = ws[l].float()
        k, k2, cin, cout = w.shape
        if k != k2 or k != ks[l] or k not in (1, 3):
            raise NotImplementedError(f"layer {l}: kernel {tuple(w.shape)} (3x3 or 1x1 only)")
        if acts[l] not in ("relu", "none"):
            raise NotImplementedError(f"layer {l}: activation {acts[l]!r}")
        if cout > MAX_COUT:
            raise NotImplementedError(f"layer {l}: cout {cout} > {MAX_COUT}")
        cin0 = cin if prev is None else prev
        aux_c = cin - cin0
        if aux_c and l != 1:
            raise ValueError(f"layer {l}: cin {cin} != previous cout {cin0}")
        if aux_c < 0 or aux_c % 16:
            raise NotImplementedError(f"layer {l}: aux channels {aux_c} (want a multiple of 16)")
        cin0_pad, cout_pad = _ceil16(cin0), _ceil16(cout)
        if mode in ("highest", "w32"):
            planes = split3(w)
        elif split[l]:
            planes = split_weight(w)
        else:
            planes = (w.to(torch.bfloat16),)

        def kmat(m):
            m0 = F.pad(m[:, :, :cin0], (0, 0, 0, cin0_pad - cin0))
            m = torch.cat([m0, m[:, :, cin0:]], dim=2)
            m = F.pad(m, (0, cout_pad - cout))
            return m.reshape(k * k * (cin0_pad + aux_c), cout_pad).contiguous()

        mats = [kmat(p) for p in planes]
        w_mid = mats[1] if len(mats) == 3 else None
        w_lo = mats[-1] if len(mats) > 1 else None
        layers.append(ChainLayer(
            ks=k, cin0=cin0, cin0_pad=cin0_pad, aux_c=aux_c, cout=cout,
            cout_pad=cout_pad, relu=acts[l] == "relu", split=bool(split[l]),
            w_plain=sum_planes(planes).permute(3, 2, 0, 1).contiguous(), w_hi=mats[0],
            w_mid=w_mid, w_lo=w_lo, bias=bs[l].float().contiguous(),
            w_pack=torch.cat([pack_kmajor(m) for m in mats]).contiguous(),
        ))
        prev = cout
    return Chain(tuple(layers), mode=mode)


def _oihw(layer: ChainLayer, m: torch.Tensor) -> torch.Tensor:
    """A kernel matrix [ks*ks*(cin0_pad+aux_c), cout_pad] of the layer as
    OIHW fp32, pad rows and columns dropped."""
    k = layer.ks
    m = m.float().reshape(k, k, layer.cin0_pad + layer.aux_c, layer.cout_pad)
    m = torch.cat([m[:, :, :layer.cin0], m[:, :, layer.cin0_pad:]], dim=2)[..., :layer.cout]
    return m.permute(3, 2, 0, 1).contiguous()


def layer_weight_from_pack(layer: ChainLayer) -> torch.Tensor:
    """The OIHW fp32 weights the kernel multiplies by, rebuilt from
    ``layer.w_pack`` alone (the sum of its planes, pad rows and columns
    dropped): equals ``layer.w_plain``."""
    planes = unpack_kmajor(layer.w_pack.float()).reshape(len(layer.planes), -1, layer.cout_pad)
    return _oihw(layer, sum_planes(planes))


def _state_plan(state_out, chain: Chain):
    """(n_channels, {layer: (offset, zero_fill)}): every state channel no
    layer writes must directly follow one that does, which then zero-fills
    it."""
    n, offs = state_out[0], dict(state_out[1])
    spans = sorted((off, off + chain.layers[l].cout, l) for l, off in offs.items())
    plan = {}
    pos = 0
    for i, (lo, hi, l) in enumerate(spans):
        if lo != pos:
            raise NotImplementedError(f"state channels [{pos}, {lo}) are written by no layer")
        nxt = spans[i + 1][0] if i + 1 < len(spans) else n
        if nxt < hi:
            raise ValueError("state_out layers overlap or exceed the state width")
        plan[l] = (lo, nxt - hi)
        pos = nxt
    return n, plan


def _conv_nhwc(x, w_oihw, bias, ks):
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias, padding=ks // 2)
    return y.permute(0, 2, 3, 1)


def _layer_plain(inp, layer: ChainLayer, mode: str):
    """One layer: bias, act.  'high': the three bf16_3x convs, w_hi a_hi +
    w_hi a_lo + w_lo a_hi, summed in fp32 as rvdd_tpu sums its three dots.
    The other modes: one fp32 conv of the input (bf16-valued in 'bf16' and
    'w32', fp32 in 'highest') with the weights the kernel multiplies by
    (fp32 in 'highest' and 'w32')."""
    if mode == "high":
        a_hi, a_lo = (t.float() for t in split_weight(inp))  # as the kernel splits its tile
        k = layer.ks
        w_hi, w_lo = _oihw(layer, layer.w_hi), _oihw(layer, layer.w_lo)
        y = (_conv_nhwc(a_hi, w_hi, None, k) + _conv_nhwc(a_lo, w_hi, None, k)
             + _conv_nhwc(a_hi, w_lo, None, k)) + layer.bias
    else:
        y = _conv_nhwc(inp, layer.w_plain, layer.bias, layer.ks)
    return torch.relu(y) if layer.relu else y


def conv_chain_plain(x, chain: Chain, *, aux=None, aux_channels=None, emit=(),
                     pool=(), upsample_input=False, state_out=None):
    """Plain PyTorch version of :func:`conv_chain`, same rounding points."""
    nl = len(chain.layers)
    emit = tuple(emit) or (nl - 1,)
    bd = chain.dtype
    h = x.float()
    if upsample_input:
        h = upsample2x_bilinear(h, align_corners=False).to(bd).float()
    b, hh, ww, _ = h.shape
    auxw = None
    if aux is not None:
        off, n = aux_channels if aux_channels else (0, aux.shape[-1])
        auxw = aux[..., off:off + n].float()
    state = plan = None
    if state_out is not None:
        n_state, plan = _state_plan(state_out, chain)
        state = torch.zeros(b, hh, ww, n_state, dtype=torch.float32, device=x.device)
    outs = {}
    for l, layer in enumerate(chain.layers):
        inp = torch.cat([h, auxw], dim=-1) if (l == 1 and layer.aux_c) else h
        y = _layer_plain(inp, layer, chain.mode)
        band = y.to(bd)
        if plan is not None and l in plan:
            off = plan[l][0]
            state[..., off:off + layer.cout] = y
        elif state_out is None and l in emit:
            outs[l] = maxpool2x2(band) if l in pool else band
        h = band.float()
    return (state,) if state_out is not None else tuple(outs[l] for l in emit)


#: the kernel's launch modes, as rvdd_conv_layer_plan numbers them (enum
#: Mode): the 'bf16' chains run the serial body; the 'high', 'highest' and
#: 'w32' ones the warp-specialized body (see ws_plan), with each layer's
#: weights resident beside its tile, streamed a tap of a channel slab at a
#: time, or (an upsample layer) resident beside windows of its half-res input
PLAN_MODES = ("bf16", "bf16 split", "high resident", "high streamed",
              "highest resident", "highest streamed", "w32 resident", "w32 streamed",
              "highest upsample", "high upsample", "w32 upsample")

#: shared memory a CTA may have on the H100
SMEM_MAX = 232448
#: the warp-specialized body's geometry (csrc/conv_chain.cu, namespace ws):
#: tiles of 64 columns, a CTA of two consumer warpgroups and a producer, a
#: streamed layer's ring of weight stages, and the columns of an upsample
#: layer's window of its half-res input
WS_COLS, WS_WARPGROUPS, WS_STAGES, WS_SRC_COLS = 64, 3, 4, 36
#: its numerics by mode (ws::HighNum, HighestNum, W32Num): bytes of an
#: 8-channel pixel group of the band (fp32 32, bf16 16), bf16 weight
#: planes, output rows of a tile, and whether each consumer stages its
#: band in shared memory for a TMA store
WS_NUMERICS = {"high": (32, 2, 2, False), "highest": (32, 3, 2, False),
               "w32": (16, 3, 4, True)}


def ws_rows(mode: str) -> int:
    """The output rows of a tile of the warp-specialized body in ``mode``."""
    return WS_NUMERICS[mode][2]


def ws_src_rows(rows: int) -> int:
    """The half-res rows an upsample layer's tile of ``rows`` rows reads,
    with its halo (ws::src_rows)."""
    return rows // 2 + 2


def _align128(n: int) -> int:
    return (n + 127) & ~127


def ws_layout(ks: int, cin_tot: int, cout_pad: int, mode: str, form: str, nslab: int) -> dict:
    """The warp-specialized body's shared memory in one of its forms
    (mirror of ws::layout) for a layer in ``mode`` ('high': fp32 tile, two
    weight planes; 'highest': fp32, three; 'w32': bf16 tile, three):
    'resident', 'streamed' or 'upsample' (an upsample layer's weights
    resident beside one region and two windows of its half-res input).  The
    weights at 0 (resident: every tap of the planes; streamed: WS_STAGES
    stages of one tap of one channel slab, the planes each), then one
    (upsample) or two regions of one slab of a tile's input in the band
    dtype, [slab / 8][rows + halo][64 + halo][8] (a TMA box per 8-channel
    group, each at a 128-byte boundary), an upsample layer's two source windows
    [ws_src_rows(rows)][WS_SRC_COLS][cin] (one TMA box), the two consumers'
    staged bands [rows][32][cout_pad] in bf16 ('w32': a TMA store's box),
    then 128 bytes of mbarriers.  Offsets and sizes in bytes."""
    pg, planes, rows, staged = WS_NUMERICS[mode]
    halo = ks // 2
    slab_c = cin_tot // nslab
    plane = _align128((rows + 2 * halo) * (WS_COLS + 2 * halo) * pg)  # a TMA box at 128 B
    region = _align128(slab_c // 8 * plane)
    nreg = 1 if form == "upsample" else 2
    stage = slab_c * cout_pad * 2 * planes
    weights = (WS_STAGES * stage if form == "streamed"
               else ks * ks * cin_tot * cout_pad * 2 * planes)
    r0 = _align128(weights)
    src = r0 + nreg * region
    window = ws_src_rows(rows) * WS_SRC_COLS * cin_tot * pg // 8 if form == "upsample" else 0
    stg = src + 2 * window
    band = rows * WS_COLS // 2 * cout_pad * 2 if staged else 0
    bars = stg + 2 * band
    return dict(slab_c=slab_c, weights=(0, weights), stage=stage if form == "streamed" else 0,
                regions=tuple((r0 + k * region, region) for k in range(nreg)),
                windows=tuple((src + k * window, window) for k in range(2)) if window else (),
                bands=tuple((stg + k * band, band) for k in range(2)) if band else (),
                barriers=(bars, 128), total=bars + 128)


def ws_plan(ks: int, cin_tot: int, cout_pad: int, mode: str, upsample: bool = False) -> dict:
    """How the kernel runs a 'high', 'highest' or 'w32' layer of that shape
    (mirror of ws::plan_form and ws_plan; ``upsample``: its input is
    upsampled in the kernel, and is cin_tot channels with no aux): a 3x3
    upsample layer takes the upsample form where it fits; else its weights
    stay resident beside the two tile regions where that fits, else they
    stream with the fewest channel slabs (dividing the 16-channel groups)
    that fit.  Returns the keys of :func:`layer_plan` (``trw``: the tile
    rows) and the ``layout`` (:func:`ws_layout`); raises ValueError where
    nothing fits, as the kernel's launch fails with cudaErrorInvalidValue."""
    groups = cin_tot // 16
    forms = [("upsample", 1)] if upsample and ks == 3 and cin_tot <= 256 else []
    forms += [("resident", 1)] + [("streamed", n) for n in range(2, groups + 1) if groups % n == 0]
    for form, nslab in forms:
        lay = ws_layout(ks, cin_tot, cout_pad, mode, form, nslab)
        if lay["total"] <= SMEM_MAX:
            return dict(mode=f"{mode} {form}", trw=ws_rows(mode), nwg=WS_WARPGROUPS,
                        smem=lay["total"], slabs=nslab,
                        stages=WS_STAGES if form == "streamed" else 0, layout=lay)
    raise ValueError(f"{mode}: no plan fits a {ks}x{ks} layer of {cin_tot} -> {cout_pad}")


def ws_tiles(b: int, h: int, w: int, rows: int, n_cta: int = 132) -> list:
    """The warp-specialized body's schedule (mirror of ws::Sched): the grid
    is min(tiles, n_cta) persistent CTAs, and CTA c takes tiles c, c + grid,
    c + 2 grid, ... in that order, of the b x ceil(h / rows) x ceil(w / 64)
    tiles numbered (image, row, column).  Returns each CTA's list."""
    n = b * -(-h // rows) * -(-w // WS_COLS)
    grid = min(n, n_cta)
    return [list(range(c, n, grid)) for c in range(grid)]


def _prec(layer: ChainLayer, mode: str) -> int:
    """The layer's numerics (PRECS) in a chain of that mode."""
    return PRECS.index("bf16 split" if mode == "bf16" and layer.split else mode)


def layer_plan(layer: ChainLayer, mode: str, upsample: bool = False) -> dict:
    """How the kernel runs ``layer`` in a chain of that mode (MODES), as
    its first layer on an upsampled input where ``upsample``: the launch
    mode (PLAN_MODES), tile rows, warpgroups a CTA, shared memory a CTA, and
    the warp-specialized body's channel slabs a tile and weight stages (0
    on the serial body; :func:`ws_plan` mirrors them).  The rule lives in the
    CUDA source, so this builds and loads the library (a machine with the
    CUDA toolkit); raises for a layer no configuration fits."""
    lib = _build.load_library("conv_chain")
    fn = lib.rvdd_conv_layer_plan
    fn.argtypes = [_I] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    up = bool(upsample) and layer.aux_c == 0 and layer.cin0 == layer.cin0_pad
    rc = fn(layer.ks, layer.cin0_pad + layer.aux_c, layer.cout_pad, _prec(layer, mode), int(up), out)
    _build.check(lib, rc, "conv_chain plan")
    return dict(mode=PLAN_MODES[out[0]], trw=out[1], nwg=out[2], smem=out[3], slabs=out[4],
                stages=out[5])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_dtype(name, t, chain: Chain):
    if t.dtype != chain.dtype:
        raise TypeError(f"conv_chain: {name} must be {chain.dtype} for a chain in the "
                        f"{chain.mode!r} mode, got {t.dtype}")


def _check(name, t, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"conv_chain: {name} must be on {device}")
    if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"conv_chain: {name} must be a contiguous, 16-byte aligned "
                         f"[B, H, W, C] tensor, got {tuple(t.shape)}")


def conv_chain(x: torch.Tensor, chain: Chain, *, aux: Optional[torch.Tensor] = None,
               aux_channels: Optional[Tuple[int, int]] = None,
               emit: Sequence[int] = (), pool: Sequence[int] = (),
               upsample_input: bool = False, state_out=None,
               n_cta: Optional[int] = None):
    """Run a packed conv chain (see :func:`pack_chain`) on NHWC input of
    the chain's band dtype (``chain.dtype``: fp32 for the 'high' and
    'highest' modes, else bf16; any other dtype raises TypeError).

    x: [B, H, W, Cx], or [B, H/2, W/2, Cx] with ``upsample_input``.
    aux: [B, H, W, Ca] joined to layer 1's input after layer 0's output;
    ``aux_channels=(offset, n)`` reads a channel window of it.
    emit: layers returned in the band dtype as [B, H, W, Cout] (default:
    the last); those in ``pool`` are returned 2x2 max-pooled.
    state_out: ``(n_channels, ((layer, offset), ...))`` makes the chain
    return only ``(state,)``, a fresh [B, H, W, n_channels] fp32 tensor the
    named layers write from their fp32 accumulators (channels no layer
    writes must follow one that does and are zero).

    CUDA tensors launch one kernel per layer in the chain's mode, counted
    in ``conv_chain.launches`` and by mode in
    ``conv_chain.mode_launches[chain.mode]``; CPU tensors run
    :func:`conv_chain_plain`.  ``n_cta`` (for tests) caps each launch's
    grid, so that few CTAs walk many tiles (:func:`ws_tiles`).
    """
    _check_dtype("x", x, chain)
    if aux is not None:
        _check_dtype("aux", aux, chain)
    if x.device.type == "cpu":
        return conv_chain_plain(x, chain, aux=aux, aux_channels=aux_channels,
                                emit=emit, pool=pool,
                                upsample_input=upsample_input, state_out=state_out)
    dev = x.device
    _check("x", x, dev)
    nl = len(chain.layers)
    emit = tuple(emit) or (nl - 1,)
    pool = tuple(pool)
    if not set(pool) <= set(emit):
        raise ValueError("conv_chain: pool layers must be emitted")
    b, hx, wx, cx = x.shape
    hh, ww = (2 * hx, 2 * wx) if upsample_input else (hx, wx)
    if cx != chain.layers[0].cin0:
        raise ValueError(f"conv_chain: x has {cx} channels, layer 0 wants {chain.layers[0].cin0}")
    aux_off = aux_stride = 0
    if nl > 1 and chain.layers[1].aux_c:
        if aux is None:
            raise ValueError("conv_chain: layer 1 reads aux channels but aux is None")
        _check("aux", aux, dev)
        aux_off, n = aux_channels if aux_channels else (0, aux.shape[-1])
        aux_stride = aux.shape[-1]
        if tuple(aux.shape[:3]) != (b, hh, ww) or n != chain.layers[1].aux_c \
                or aux_off < 0 or aux_off + n > aux_stride:
            raise ValueError(f"conv_chain: aux {tuple(aux.shape)} window {aux_channels} "
                             f"does not fit [{b}, {hh}, {ww}, *] with {chain.layers[1].aux_c} channels")
    elif aux is not None:
        raise ValueError("conv_chain: aux given but layer 1 reads no aux channels")
    for layer in chain.layers:
        if layer.w_pack.device != dev:
            raise ValueError("conv_chain: the packed chain lies on another device")

    state, plan, n_state = None, {}, 0
    if state_out is not None:
        n_state, plan = _state_plan(state_out, chain)
        state = torch.empty(b, hh, ww, n_state, dtype=torch.float32, device=dev)

    lib = _build.load_library("conv_chain")
    if n_cta is None:
        fn = lib.rvdd_conv_layer
        fn.argtypes = _ARGTYPES
        grid = ()
    else:
        fn = lib.rvdd_conv_layer_grid
        fn.argtypes = _GRID_ARGTYPES
        grid = (int(n_cta),)
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    cur, ch, cw = x, hx, wx
    outs = {}
    for l, layer in enumerate(chain.layers):
        emitted = state_out is None and l in emit
        band = l < nl - 1 or (emitted and l not in pool)
        out = torch.empty(b, hh, ww, layer.cout, dtype=chain.dtype, device=dev) if band else None
        pooled = (torch.empty(b, hh // 2, ww // 2, layer.cout, dtype=chain.dtype, device=dev)
                  if emitted and l in pool else None)
        st_off, st_zero = plan.get(l, (0, 0))
        use_aux = l == 1 and layer.aux_c > 0
        rc = fn(cur.data_ptr(), cur.shape[-1], cur.shape[-1], 0, ch, cw,
                int(l == 0 and upsample_input),
                aux.data_ptr() if use_aux else None, layer.aux_c if use_aux else 0,
                aux_stride, aux_off,
                layer.w_pack.data_ptr(), _prec(layer, chain.mode), layer.bias.data_ptr(),
                layer.ks, layer.cin0_pad, layer.cout, layer.cout_pad, int(layer.relu),
                b, hh, ww, _ptr(out), _ptr(pooled),
                state.data_ptr() if l in plan else None, n_state, st_off, st_zero,
                *grid, stream)
        conv_chain.launches += 1
        conv_chain.mode_launches[chain.mode] += 1
        _build.check(lib, rc, f"conv_chain layer {l}")
        if emitted:
            outs[l] = pooled if l in pool else out
        cur, ch, cw = out, hh, ww
    return (state,) if state_out is not None else tuple(outs[l] for l in emit)


conv_chain.launches = 0
conv_chain.mode_launches = dict.fromkeys(MODES, 0)
