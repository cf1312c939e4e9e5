"""Fused ConvNeXt block chain: wrapper of csrc/convnext_chain.cu.

Replaces rvdd_tpu/ops/pallas/convnext_pallas.py:fused_convnext_chain
together with its XLA glue: ``pool`` is the whole 2x2 max pool of an
emitted block (rvdd_tpu pools in XLA, ``maxpool2x2_planar``) and
``upsample_input`` the whole bilinear 2x align_corners=True upsample of a
half-res input (rows in the TPU kernel, lanes by an XLA matmul in
rvdd_tpu/models/fast_convnext.py:lane_resize2x_ac).  A chain runs as one
launch of the block kernel per block; the kernel reads an aux channel
window as the second half of block 1's proj input, upsamples in its
prologue, pools in its epilogue, and writes the combined fp32 recurrence
state ``[head | zeros | features]`` from the last block.

What bounds it on the H100 is operations: a 1080p frame's seven chains do
~0.81 TFLOP of 1x1 products and ~0.10 TFLOP of depthwise taps, all bf16
products with fp32 sums, ~0.91 ms at the 989 TFLOP/s bf16 tensor-core
peak, ahead of ~0.45 ms of bytes; in the fp32 mode the 1x1 products count
six bf16 products a MAC, ~4.9 ms.  See the kernel's source note for what
its design (wgmma with resident weights, the hidden kept in registers)
does about it and for the floor that its CUDA-core depthwise and GELU set.

A chain runs in one of two numerics, fixed when it is packed:

* bf16 (rvdd_tpu's ``fast`` preset in its production depthwise mode,
  'mxu2'): bf16 depthwise taps, bf16 1x1 and head weights, fp32 biases,
  LayerNorm and layerscale, fp32 accumulation, the LN and GELU (tanh)
  outputs rounded to bf16 before their products, and bf16 bands between
  blocks;
* fp32 (``pack_chain(..., band_fp32=True)``; rvdd_tpu's
  ``band_dtype=float32, mxu_precision='highest', gelu_exact=True``): fp32
  inputs, bands, outputs, taps and weights, nothing rounded, the erf GELU
  (the kernel's erf is rvdd_tpu's kernel's Abramowitz-Stegun polynomial,
  1.5e-7 abs; the plain version's is torch's exact one), and fp32-faithful
  1x1 products.  The kernel splits each operand of proj, pw1 and pw2 by
  mantissa masks into three bf16 planes (``split3``) and sums six bf16
  products (what HIGHEST does on the TPU); its head runs in fp32 on the
  CUDA cores.  Its CTAs are warp-specialized and walk runs of 4x32 tiles
  down 32-column strips (:func:`tile_runs`).

The plain version repeats the bf16 mode's rounding points in fp32
PyTorch, and is the plain fp32 function (exact ``F.gelu``) in the fp32
mode; it is what a CPU tensor runs.  The wrapper takes tensors of the
chain's dtype only (``chain.dtype``) and raises TypeError on any other:
the caller rounds or widens in the open.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rvdd_tpu_torch import _build
from rvdd_tpu_torch.ops.cuda.conv_chain import pack_kmajor, split3, unpack_kmajor
from rvdd_tpu_torch.ops.resize import maxpool2x2, upsample2x_bilinear

WIDTH = 48       # the architecture's block width
HIDDEN = 4 * WIDTH
KSIZE = 7
MAX_CIN = 96     # proj input channels the kernel stages (padded input + aux)
MAX_HEAD = 8
TILE_COLS = 32   # the kernel's output tile: 32 columns,
F32_TILE_ROWS = 4  # by 4 rows in the fp32 mode
BF16 = torch.bfloat16

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [
    _P, _I, _I, _I, _I,              # in0, c, h, w, upsample
    _P, _I, _I, _I,                  # aux, c, stride, off
    _I, _P, _P,                      # cin0_pad, proj_w, proj_b
    _P, _P, _P, _P,                  # dw_w, dw_b, ln_g, ln_b
    _P, _P, _P, _P, _P,              # pw1, pw1_b, pw2, pw2_b, ls
    _P, _P, _I,                      # head_w, head_b, n_head
    _I, _I, _I,                      # B, H, W
    _P, _P, _P,                      # out, pooled, head_out
    _P, _I, _I,                      # state, stride, feat_off
    _I, _P,                          # f32, stream
]
# rvdd_convnext_block_grid: the same with n_cta before the stream
_GRID_ARGTYPES = _ARGTYPES[:-1] + [_I, _P]


def tile_runs(B: int, H: int, W: int, n_cta: int) -> list:
    """The fp32 mode's schedule, as the kernel computes it
    (csrc/convnext_chain.cu, ``f32m::Sched``): for each of the
    ``min(T, n_cta)`` CTAs of a launch, its runs ``(image, strip, first
    tile row, tiles)``.

    The T output tiles of [B, H, W] (4 rows by 32 columns) are numbered
    image by image, strip (32 columns) by strip, top to bottom; CTA c of n
    takes tiles [c T / n, (c + 1) T / n), so no CTA takes more than
    ceil(T / n).  Its consecutive tiles of one strip form a run, down which
    the kernel's halo ring carries over (a run's first tile stages its
    whole halo, the others their 4 new rows)."""
    S, R = -(-W // TILE_COLS), -(-H // F32_TILE_ROWS)
    T = B * S * R
    n = min(T, n_cta)
    out = []
    for c in range(n):
        i, hi = T * c // n, T * (c + 1) // n
        runs = []
        while i < hi:
            b, rem = divmod(i, S * R)
            s, r = divmod(rem, R)
            cnt = min(hi - i, R - r)
            runs.append((b, s, r, cnt))
            i += cnt
        out.append(runs)
    return out


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def _pack3(m: torch.Tensor) -> torch.Tensor:
    """[K, N] fp32 -> [3, K/8, N, 8] bf16: the hi, mid and lo planes, each
    in the wgmma B layout (pack_kmajor)."""
    return torch.stack([pack_kmajor(p) for p in split3(m)]).contiguous()


@dataclasses.dataclass(frozen=True)
class CnxBlock:
    """One packed ConvNeXt block.  Its input is ``cin0`` channels (block 0:
    the chain input; later blocks: 48), and block 1 may join ``aux_c`` aux
    channels after them, which needs a proj."""

    cin0: int
    cin0_pad: int
    aux_c: int
    # the weights the block multiplies by: bf16 in the bf16 mode, fp32 in
    # the fp32 mode (band_fp32)
    proj_w: Optional[torch.Tensor]      # [cin0_pad + aux_c, 48], zero pad rows
    proj_b: Optional[torch.Tensor]      # [48] fp32
    dw_w: torch.Tensor                  # [49, 48] fp32 (bf16-rounded taps in the bf16 mode)
    dw_b: torch.Tensor
    ln_g: torch.Tensor
    ln_b: torch.Tensor
    pw1: torch.Tensor                   # [48, 192]
    pw1_b: torch.Tensor
    pw2: torch.Tensor                   # [192, 48]
    pw2_b: torch.Tensor
    ls: torch.Tensor
    # the kernel's copies, K-major for wgmma (pack_kmajor), [K/8, N, 8]
    # bf16; in the fp32 mode three such planes (hi, mid, lo: _pack3),
    # [3, K/8, N, 8]
    proj_pack: Optional[torch.Tensor]   # [(cin0_pad + aux_c)/8, 48, 8]
    pw1_pack: torch.Tensor              # [6, 192, 8]
    pw2_pack: torch.Tensor              # [24, 48, 8]
    band_fp32: bool = False


@dataclasses.dataclass(frozen=True)
class CnxChain:
    blocks: Tuple[CnxBlock, ...]
    head_w: Optional[torch.Tensor] = None  # [48, n_head] (chain dtype): a 1x1 after the last block
    head_b: Optional[torch.Tensor] = None  # [n_head] fp32
    #: the fp32 mode (fp32 bands, erf GELU, fp32-faithful products); else bf16
    band_fp32: bool = False

    @property
    def n_head(self) -> int:
        return 0 if self.head_w is None else self.head_w.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        """Of the inputs the chain takes and the outputs it emits (the
        combined state is fp32 in both modes)."""
        return torch.float32 if self.band_fp32 else BF16


def _mat1x1(w: torch.Tensor, dtype: torch.dtype = BF16) -> torch.Tensor:
    """[cout, cin, 1, 1] conv weight -> [cin, cout] of ``dtype``."""
    return w.detach().float()[:, :, 0, 0].t().to(dtype).contiguous()


def pack_block(sd: Mapping[str, torch.Tensor], cin0: int, aux_c: int = 0, *,
               band_fp32: bool = False) -> CnxBlock:
    """Pack one ConvNeXtBlock's parameters, named as in the port's module
    (``proj.weight``, ``dw.weight``, ``ln.weight``, ``pw1.weight``, ...,
    ``layerscale.layerscale``), for an input of ``cin0`` channels plus
    ``aux_c`` aux channels, in the bf16 or (``band_fp32``) the fp32 mode."""
    f32 = {k: v.detach().float().contiguous() for k, v in sd.items()}
    wdt = torch.float32 if band_fp32 else BF16
    if "proj.weight" in f32:
        wb = _mat1x1(f32["proj.weight"], wdt)
        if wb.shape != (cin0 + aux_c, WIDTH):
            raise ValueError(f"proj weight {tuple(wb.shape)} != ({cin0} + {aux_c}, {WIDTH})")
        cin0_pad = _ceil16(cin0)
        if aux_c % 16 or cin0_pad + aux_c > MAX_CIN:
            raise NotImplementedError(f"proj input {cin0} + aux {aux_c} channels")
        proj_w = torch.cat([F.pad(wb[:cin0], (0, 0, 0, cin0_pad - cin0)), wb[cin0:]]).contiguous()
        proj_b = f32["proj.bias"]
    else:
        if cin0 != WIDTH or aux_c:
            raise ValueError(f"a block without proj takes {WIDTH} channels, got {cin0} + {aux_c}")
        cin0_pad, proj_w, proj_b = cin0, None, None
    dw = f32["dw.weight"]
    if tuple(dw.shape) != (WIDTH, 1, KSIZE, KSIZE):
        raise NotImplementedError(f"depthwise weight {tuple(dw.shape)}")
    pw1, pw2 = _mat1x1(f32["pw1.weight"], wdt), _mat1x1(f32["pw2.weight"], wdt)
    taps = dw.reshape(WIDTH, KSIZE * KSIZE).t()
    pack = _pack3 if band_fp32 else pack_kmajor
    if not band_fp32:
        taps = taps.to(BF16)
    return CnxBlock(
        cin0=cin0, cin0_pad=cin0_pad, aux_c=aux_c, proj_w=proj_w, proj_b=proj_b,
        dw_w=taps.float().contiguous(),
        dw_b=f32["dw.bias"], ln_g=f32["ln.weight"], ln_b=f32["ln.bias"],
        pw1=pw1, pw1_b=f32["pw1.bias"], pw2=pw2, pw2_b=f32["pw2.bias"],
        ls=f32["layerscale.layerscale"],
        proj_pack=pack(proj_w) if proj_w is not None else None,
        pw1_pack=pack(pw1), pw2_pack=pack(pw2), band_fp32=band_fp32,
    )


def _unpack(p: torch.Tensor) -> torch.Tensor:
    """A packed 1x1 matrix -> [K, N] fp32: one K-major plane, or the sum
    hi + mid + lo of three (exact: the planes hold disjoint bits)."""
    if p.dim() == 4:
        hi, mid, lo = (unpack_kmajor(q).float() for q in p)
        return hi + mid + lo
    return unpack_kmajor(p).float()


def block_mats_from_pack(blk: CnxBlock) -> dict:
    """The fp32 matrices the plain version multiplies by, rebuilt from the
    kernel's packed copies alone: ``proj`` [cin0 + aux_c, 48] (pad rows
    dropped), ``pw1`` [48, 192] and ``pw2`` [192, 48]."""
    mats = {"pw1": _unpack(blk.pw1_pack), "pw2": _unpack(blk.pw2_pack)}
    if blk.proj_pack is not None:
        m = _unpack(blk.proj_pack)
        mats["proj"] = torch.cat([m[:blk.cin0], m[blk.cin0_pad:]])
    return mats


def pack_chain(blocks: Sequence[Mapping[str, torch.Tensor]], cin0: int, *, aux_c: int = 0,
               head: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               band_fp32: bool = False) -> CnxChain:
    """Pack a chain of blocks (each a block's parameters, see
    :func:`pack_block`): block 0 takes ``cin0`` channels, block 1 joins
    ``aux_c`` aux channels, ``head=(weight [n, 48, 1, 1], bias [n])`` is a
    1x1 conv after the last block.  ``band_fp32`` packs the fp32 mode."""
    packed = tuple(pack_block(sd, cin0 if i == 0 else WIDTH, aux_c if i == 1 else 0,
                              band_fp32=band_fp32)
                   for i, sd in enumerate(blocks))
    if head is None:
        return CnxChain(packed, band_fp32=band_fp32)
    hw, hb = head
    if hw.shape[0] > MAX_HEAD:
        raise NotImplementedError(f"head of {hw.shape[0]} outputs (at most {MAX_HEAD})")
    wdt = torch.float32 if band_fp32 else BF16
    return CnxChain(packed, _mat1x1(hw, wdt), hb.detach().float().contiguous(),
                    band_fp32=band_fp32)


# ------------------------------------------------------------------- plain


def block_plain(blk: CnxBlock, x: torch.Tensor) -> torch.Tensor:
    """One block in fp32 PyTorch; x [B, H, W, cin0 (+aux_c)] fp32; returns
    the fp32 y.  bf16 mode: x holds bf16 values and the kernel's rounding
    points are repeated (proj, LN and GELU outputs to bf16, tanh GELU).
    fp32 mode: nothing is rounded and the GELU is the exact erf one."""
    rnd = (lambda t: t) if blk.band_fp32 else (lambda t: t.to(BF16).float())
    if blk.proj_w is not None:
        w = torch.cat([blk.proj_w[:blk.cin0], blk.proj_w[blk.cin0_pad:]]).float()
        x = rnd(x @ w + blk.proj_b)
    taps = blk.dw_w.t().reshape(WIDTH, 1, KSIZE, KSIZE)
    d = F.conv2d(x.permute(0, 3, 1, 2), taps, blk.dw_b, padding=KSIZE // 2,
                 groups=WIDTH).permute(0, 2, 3, 1)
    u = d.mean(-1, keepdim=True)
    d = d - u
    s2 = (d * d).mean(-1, keepdim=True)
    hn = rnd(d * torch.rsqrt(s2 + 1e-6) * blk.ln_g + blk.ln_b)
    h1 = rnd(F.gelu(hn @ blk.pw1.float() + blk.pw1_b,
                    approximate="none" if blk.band_fp32 else "tanh"))
    h2 = h1 @ blk.pw2.float() + blk.pw2_b
    return x + blk.ls * h2


def convnext_chain_plain(x, chain: CnxChain, *, aux=None, aux_channels=None, emit=(),
                         pool=(), upsample_input=False, state_out=None):
    """Plain PyTorch version of :func:`convnext_chain`, same rounding points
    (none in the fp32 mode)."""
    nb = len(chain.blocks)
    emit = _default_emit(emit, pool, nb, state_out)
    bd = chain.dtype
    h = x.float()
    if upsample_input:
        h = upsample2x_bilinear(h, align_corners=True).to(bd).float()
    auxw = None
    if aux is not None:
        off, n = aux_channels if aux_channels else (0, aux.shape[-1])
        auxw = aux[..., off:off + n].float()
    outs, pooled = {}, {}
    y = None
    for i, blk in enumerate(chain.blocks):
        inp = torch.cat([h, auxw], dim=-1) if (i == 1 and blk.aux_c) else h
        y = block_plain(blk, inp)
        band = y.to(bd)
        if i in emit:
            outs[i] = band
        if i in pool:
            pooled[i] = maxpool2x2(band)
        h = band.float()
    head = h @ chain.head_w.float() + chain.head_b if chain.head_w is not None else None
    if state_out is not None:
        n_state, feat_off = state_out
        state = torch.zeros(*h.shape[:3], n_state, dtype=torch.float32, device=h.device)
        state[..., :chain.n_head] = head
        if feat_off is not None:
            state[..., feat_off:feat_off + WIDTH] = y
        return (state,)
    res = [outs[i] for i in emit] + [pooled[i] for i in pool]
    if head is not None:
        res.append(head.to(bd))
    return tuple(res)


# ------------------------------------------------------------------ kernel


def _default_emit(emit, pool, nb, state_out):
    emit = tuple(emit)
    if not emit and not pool and state_out is None:
        emit = (nb - 1,)
    return emit


def _check_dtype(name, t, chain: CnxChain):
    if t.dtype != chain.dtype:
        mode = "fp32" if chain.band_fp32 else "bf16"
        raise TypeError(f"convnext_chain: {name} must be {chain.dtype} for a chain in the "
                        f"{mode} mode, got {t.dtype}")


def _check(name, t, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"convnext_chain: {name} must be on {device}")
    if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16 or t.numel() == 0:
        raise ValueError(f"convnext_chain: {name} must be a contiguous, 16-byte aligned, "
                         f"non-empty [B, H, W, C] tensor, got {tuple(t.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def convnext_chain(x: torch.Tensor, chain: CnxChain, *, aux: Optional[torch.Tensor] = None,
                   aux_channels: Optional[Tuple[int, int]] = None, emit: Sequence[int] = (),
                   pool: Sequence[int] = (), upsample_input: bool = False,
                   state_out: Optional[Tuple[int, Optional[int]]] = None,
                   n_cta: Optional[int] = None):
    """Run a packed ConvNeXt chain (see :func:`pack_chain`) on NHWC x of the
    chain's dtype (``chain.dtype``: bf16, or fp32 for a ``band_fp32``
    chain; x and aux of any other dtype raise TypeError).

    x: [B, H, W, Cx], or [B, H/2, W/2, Cx] with ``upsample_input``.
    aux: [B, H, W, Ca] joined to block 1's input after block 0's output;
    ``aux_channels=(offset, n)`` reads a channel window of it.
    Returns, in order, in the chain's dtype: the [B, H, W, 48] output of
    each block in ``emit`` (default: the last, unless ``pool`` or
    ``state_out`` is given), the 2x2 max pool of each block in ``pool``,
    and the head's [B, H, W, n_head] output if the chain has one.  With
    ``state_out=(n_channels, feat_off)`` it returns only ``(state,)``, a
    fresh fp32 [B, H, W, n_channels] tensor: the head in channels
    [0, n_head), the last block's fp32 output in [feat_off, feat_off + 48)
    (none if feat_off is None) and zeros between.

    CUDA tensors launch one kernel per block (counted in
    ``convnext_chain.launches``, and those of fp32 chains also in
    ``convnext_chain.fp32_launches``); CPU tensors run
    :func:`convnext_chain_plain`.  ``n_cta`` caps a launch's grid, which is
    one CTA an SM otherwise (tests use it to make one CTA walk a whole
    strip; see :func:`tile_runs`).
    """
    _check_dtype("x", x, chain)
    if aux is not None:
        _check_dtype("aux", aux, chain)
    if x.device.type == "cpu":
        return convnext_chain_plain(x, chain, aux=aux, aux_channels=aux_channels, emit=emit,
                                    pool=pool, upsample_input=upsample_input,
                                    state_out=state_out)
    dev = x.device
    _check("x", x, dev)
    nb = len(chain.blocks)
    emit, pool = _default_emit(emit, pool, nb, state_out), tuple(pool)
    if not set(emit) | set(pool) <= set(range(nb)):
        raise ValueError(f"convnext_chain: emit {emit} / pool {pool} outside {nb} blocks")
    b, hx, wx, cx = x.shape
    hh, ww = (2 * hx, 2 * wx) if upsample_input else (hx, wx)
    if cx != chain.blocks[0].cin0:
        raise ValueError(f"convnext_chain: x has {cx} channels, block 0 wants {chain.blocks[0].cin0}")
    aux_off = aux_stride = 0
    if nb > 1 and chain.blocks[1].aux_c:
        if aux is None:
            raise ValueError("convnext_chain: block 1 reads aux channels but aux is None")
        _check("aux", aux, dev)
        aux_off, n = aux_channels if aux_channels else (0, aux.shape[-1])
        aux_stride = aux.shape[-1]
        if tuple(aux.shape[:3]) != (b, hh, ww) or n != chain.blocks[1].aux_c \
                or aux_off < 0 or aux_off + n > aux_stride:
            raise ValueError(f"convnext_chain: aux {tuple(aux.shape)} window {aux_channels} "
                             f"does not fit [{b}, {hh}, {ww}, *] with {chain.blocks[1].aux_c} channels")
    elif aux is not None:
        raise ValueError("convnext_chain: aux given but block 1 reads no aux channels")
    if chain.blocks[0].dw_w.device != dev:
        raise ValueError("convnext_chain: the packed chain lies on another device")
    state = None
    n_state, feat_off = 0, -1
    if state_out is not None:
        n_state, fo = state_out
        feat_off = -1 if fo is None else fo
        if chain.head_w is None or n_state % 4 or feat_off % 4 or (
                feat_off >= 0 and feat_off + WIDTH != n_state) or (
                chain.n_head > (feat_off if feat_off >= 0 else n_state)):
            raise ValueError(f"convnext_chain: state_out {state_out} does not fit the chain")
        state = torch.empty(b, hh, ww, n_state, dtype=torch.float32, device=dev)

    if n_cta is not None and n_cta < 1:
        raise ValueError(f"convnext_chain: n_cta {n_cta} < 1")
    lib = _build.load_library("convnext_chain")
    if n_cta is None:
        fn = lib.rvdd_convnext_block
        fn.argtypes = _ARGTYPES
        grid = ()
    else:
        fn = lib.rvdd_convnext_block_grid
        fn.argtypes = _GRID_ARGTYPES
        grid = (n_cta,)
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    bd = chain.dtype
    cur, ch, cw = x, hx, wx
    outs, pooled = {}, {}
    head_out = None
    for i, blk in enumerate(chain.blocks):
        last = i == nb - 1
        out = (torch.empty(b, hh, ww, WIDTH, dtype=bd, device=dev)
               if (not last or i in emit) else None)
        pl = (torch.empty(b, hh // 2, ww // 2, WIDTH, dtype=bd, device=dev)
              if i in pool else None)
        head = last and chain.head_w is not None
        if head and state is None:
            head_out = torch.empty(b, hh, ww, chain.n_head, dtype=bd, device=dev)
        use_aux = i == 1 and blk.aux_c > 0
        rc = fn(cur.data_ptr(), cur.shape[-1], ch, cw, int(i == 0 and upsample_input),
                aux.data_ptr() if use_aux else None, blk.aux_c if use_aux else 0,
                aux_stride, aux_off,
                blk.cin0_pad, _ptr(blk.proj_pack), _ptr(blk.proj_b),
                blk.dw_w.data_ptr(), blk.dw_b.data_ptr(), blk.ln_g.data_ptr(),
                blk.ln_b.data_ptr(), blk.pw1_pack.data_ptr(), blk.pw1_b.data_ptr(),
                blk.pw2_pack.data_ptr(), blk.pw2_b.data_ptr(), blk.ls.data_ptr(),
                _ptr(chain.head_w) if head else None, _ptr(chain.head_b) if head else None,
                chain.n_head if head else 0,
                b, hh, ww, _ptr(out), _ptr(pl), _ptr(head_out) if head else None,
                _ptr(state) if last else None, n_state, feat_off, int(chain.band_fp32),
                *grid, stream)
        convnext_chain.launches += 1
        convnext_chain.fp32_launches += chain.band_fp32
        _build.check(lib, rc, f"convnext_chain block {i}")
        if i in emit:
            outs[i] = out
        if i in pool:
            pooled[i] = pl
        cur, ch, cw = out, hh, ww
    if state is not None:
        return (state,)
    res = [outs[i] for i in emit] + [pooled[i] for i in pool]
    if head_out is not None:
        res.append(head_out)
    return tuple(res)


convnext_chain.launches = 0
convnext_chain.fp32_launches = 0
