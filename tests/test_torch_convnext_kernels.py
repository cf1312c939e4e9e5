"""The port's ConvNeXt chain kernel (rvdd_tpu_torch/ops/cuda/convnext_chain)
against rvdd_tpu's Pallas ``fused_convnext_chain`` and against its own plain
version.

On the CPU the wrapper runs ``convnext_chain_plain``, which is held against
``fused_convnext_chain`` in interpret mode, in the production depthwise
configuration (``dw_impl='mxu2', dw_group=8``) at 16x40 with 8-row tiles,
in both modes: bf16 (tanh GELU, bf16 bands) and fp32 (``band_dtype=float32,
mxu_precision='highest', gelu_exact=True``).  The tests marked ``gpu`` launch the CUDA kernel and
hold it against the plain version; they skip without a card.  Block
parameters are drawn with numpy, given to rvdd_tpu as flax params and to the
port through models/convert.py.
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rvdd_tpu_torch.models.convert import convnext_from_flax  # noqa: E402
from rvdd_tpu_torch.ops.cuda.convnext_chain import (  # noqa: E402
    block_mats_from_pack,
    convnext_chain,
    convnext_chain_plain,
    pack_block,
    pack_chain,
    split3,
    tile_runs,
)
from rvdd_tpu_torch.ops.resize import upsample2x_bilinear  # noqa: E402

BF16 = torch.bfloat16
H, W = 16, 40

# cin: chain input channels; aux = (full width, offset, n) joins block 1;
# head: 1x1 outputs after the last block (rvdd_tpu pads them to 8)
CASES = {
    "block": dict(cin=48, n=1),
    "proj16": dict(cin=16, n=1),
    "aux_tail": dict(cin=16, n=3, aux=(56, 8, 48), head=8, emit=(2,)),
    "upsample_aux": dict(cin=48, n=2, aux=(48, 0, 48), upsample=True, emit=(0, 1)),
    "combine": dict(cin=48, n=2, aux=(48, 0, 48), upsample=True, head=3, state=(56, 8)),
}
# card-only: rvdd_tpu's kernel wants channel counts divisible by 8; the
# port takes the flagship's 9-channel chain-A input and pools the emit, and
# runs the eighth-res core as a chain of five blocks
CARD_CASES = dict(CASES, chain_a=dict(cin=9, n=3, aux=(56, 8, 48), emit=(2,), pool=(2,)),
                  mid=dict(cin=48, n=5), proj96=dict(cin=96, n=1, pool=(0,)))


@pytest.fixture(scope="module")
def tpu():
    """rvdd_tpu's kernel and glue (skips where JAX is absent)."""
    jax = pytest.importorskip("jax")
    from rvdd_tpu.models import fast_convnext
    from rvdd_tpu.ops.pallas import convnext_pallas, warp_rowmajor

    return SimpleNamespace(jnp=jax.numpy, cnx=convnext_pallas, fc=fast_convnext,
                           warp=warp_rowmajor)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: see README)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(a):
    """numpy fp32 rounded to bf16 values (kept in fp32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def block_params(rng, cin):
    """Flax ConvNeXtBlock params (numpy): kaiming-scale kernels, and LN,
    biases and layerscale (around its init, 0.1) drawn at random."""
    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {}
    if cin != 48:
        p["proj"] = {"kernel": n(1, 1, cin, 48, scale=np.sqrt(1 / cin)), "bias": n(48, scale=0.1)}
    p["dw"] = {"kernel": n(7, 7, 1, 48, scale=np.sqrt(2 / 49)), "bias": n(48, scale=0.1)}
    p["ln"] = {"weight": 1 + n(48, scale=0.1), "bias": n(48, scale=0.1)}
    p["pw1"] = {"kernel": n(1, 1, 48, 192, scale=np.sqrt(2 / 48)), "bias": n(192, scale=0.1)}
    p["pw2"] = {"kernel": n(1, 1, 192, 48, scale=np.sqrt(2 / 192)), "bias": n(48, scale=0.1)}
    p["layerscale"] = {"layerscale": 0.1 + n(48, scale=0.05)}
    return p


def make_case(case, seed=0, h=H, w=W, batch=1, fp32=False):
    """(x, aux, block params, head) from numpy seed ``seed``; x and aux
    hold bf16 values unless ``fp32``."""
    rng = np.random.default_rng(seed)
    rnd = (lambda a: a.astype(np.float32)) if fp32 else _bf16
    hx, wx = (h // 2, w // 2) if case.get("upsample") else (h, w)
    x = rnd(rng.standard_normal((batch, hx, wx, case["cin"])))
    aux = rnd(rng.standard_normal((batch, h, w, case["aux"][0]))) if "aux" in case else None
    cins = [case["cin"]] + [96 if (j == 1 and "aux" in case) else 48 for j in range(1, case["n"])]
    blocks = [block_params(rng, c) for c in cins]
    head = None
    if "head" in case:
        head = (_bf16(rng.standard_normal((case["head"], 48)) * 0.2),
                (rng.standard_normal(case["head"]) * 0.1).astype(np.float32))
    return x, aux, blocks, head


def run_port(case, x, aux, blocks, head, device, plain=False, fp32=False, n_cta=None):
    """The port's chain (``fp32``: in the fp32 mode) on the case; x and aux
    are given in the chain's dtype; ``n_cta`` caps the kernel's grid."""
    sds = [{k: v.to(device) for k, v in convnext_from_flax(p).items()} for p in blocks]
    hd = None
    if head is not None:
        hd = (torch.from_numpy(head[0])[:, :, None, None].to(device),
              torch.from_numpy(head[1]).to(device))
    chain = pack_chain(sds, case["cin"], aux_c=case["aux"][2] if "aux" in case else 0, head=hd,
                       band_fp32=fp32)
    kw = dict(emit=case.get("emit", ()), pool=case.get("pool", ()),
              upsample_input=case.get("upsample", False), state_out=case.get("state"))
    if aux is not None:
        kw["aux"] = torch.from_numpy(aux).to(device).to(chain.dtype)
        kw["aux_channels"] = case["aux"][1:]
    if n_cta is not None:
        kw["n_cta"] = n_cta
    fn = convnext_chain_plain if plain else convnext_chain
    outs = fn(torch.from_numpy(x).to(device).to(chain.dtype), chain, **kw)
    return [o.float().cpu().numpy() for o in outs]


def _planar(jnp, x, wl, dtype=None):
    """[1, H, W, C] numpy -> [(H*C), WL] of ``dtype`` (bf16 by default),
    zero lanes >= W."""
    _, h, w, c = x.shape
    p = np.zeros((h, c, wl), np.float32)
    p[:, :, :w] = x[0].transpose(0, 2, 1)
    return jnp.asarray(p.reshape(h * c, wl)).astype(dtype or jnp.bfloat16)


def _unplanar(p, h, w, c=None):
    p = np.asarray(p, np.float32)
    p = p.reshape(h, p.shape[0] // h, -1)[:, :, :w].transpose(0, 2, 1)[None]
    return p[..., :c] if c else p


def run_tpu(tpu, case, x, aux, blocks, head, h=H, w=W, fp32=False):
    """rvdd_tpu's fused_convnext_chain (interpret mode, production dw
    engine) plus its lane upsample glue; ``fp32``: fp32 bands, HIGHEST
    products and the erf GELU (its 'mixed'/'accurate' chains) on fp32
    input."""
    jnp = tpu.jnp
    dt = jnp.float32 if fp32 else jnp.bfloat16
    wl = -(-(w + 1) // 128) * 128
    packed, hps = [], []
    cins = [case["cin"]] + [96 if (j == 1 and "aux" in case) else 48 for j in range(1, case["n"])]
    for p, cin in zip(blocks, cins):
        arrs, hp = tpu.cnx.pack_block(p, cin)
        packed.append(tuple(arrs))
        hps.append(hp)
    if case.get("upsample"):
        xp = tpu.fc.lane_resize2x_ac(_planar(jnp, x, wl // 2, dt), w // 2, dt)
    else:
        xp = _planar(jnp, x, wl, dt)
    # 8-row tiles; a 3-block chain's 9-row halo needs the whole height
    tile_h = 8 if 3 * case["n"] < 8 else h
    kw = dict(h_img=h, w_img=w, tile_h=tile_h, interpret=True,
              upsample_input=case.get("upsample", False), dw_impl="mxu2", dw_rows=12,
              dw_group=8)
    if fp32:
        kw.update(band_dtype=jnp.float32, mxu_precision="highest", gelu_exact=True,
                  out_dtype=jnp.float32)
    if aux is not None:
        kw["aux"] = _planar(jnp, aux, wl, dt)
        kw["aux_channels"] = case["aux"][1:]
    if head is not None:
        hw = np.zeros((8, 48), np.float32)
        hb = np.zeros(8, np.float32)
        hw[:len(head[1])], hb[:len(head[1])] = head
        kw["tail"], kw["tail_couts"] = ((jnp.asarray(hw), jnp.asarray(hb)),), (8,)
    if "state" in case:
        pad_l = tpu.warp.STATE_PAD_LEFT
        kw["out_dtype"] = jnp.float32
        (st,) = tpu.cnx.fused_convnext_chain(
            xp, tuple(packed), tuple(hps), emit=(case["n"] - 1,),
            combine=(case["state"][0], pad_l, wl + tpu.warp.STATE_LANE_EXTRA), **kw)
        return [np.asarray(st, np.float32)[:, :, pad_l:pad_l + w].transpose(0, 2, 1)[None]]
    emit = case.get("emit", (case["n"] - 1,))
    outs = tpu.cnx.fused_convnext_chain(xp, tuple(packed), tuple(hps), emit=emit, **kw)
    res = [_unplanar(o, h, w) for o in outs[:len(emit)]]
    if head is not None:
        res.append(_unplanar(outs[len(emit)], h, w, c=len(head[1])))
    return res


def _norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_convnext_chain_plain_matches_fused_convnext_chain(tpu, name):
    """Max error 2e-2 x std: both sides round the LN output, the GELU output
    and every band to bf16 after fp32 sums taken in different orders (the
    TPU's depthwise runs as a dy-contraction dot plus dx rotate-adds), so a
    rounding can flip by one bf16 ulp (~0.4%) and feed the next products.
    With an upsampled input the bound is 5e-2 x std: rvdd_tpu computes the
    lane half of the upsample as a bf16 matmul and rounds it before the row
    half, the port rounds the fp32 upsample once (see
    test_upsample_rounding_difference).  The mean error is held to 5e-4 x
    std, and 5e-3 x std with an upsampled input (measured: 1.5e-2 max and
    4e-5 mean without, 3.5e-2 and 1.8e-3 with)."""
    case = CASES[name]
    x, aux, blocks, head = make_case(case)
    got = run_port(case, x, aux, blocks, head, "cpu")
    want = run_tpu(tpu, case, x, aux, blocks, head)
    assert len(got) == len(want)
    tol, mean_tol = (5e-2, 5e-3) if case.get("upsample") else (2e-2, 5e-4)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape, (g.shape, wv.shape)
        assert _norm_err(g, wv) < tol, (name, _norm_err(g, wv))
        assert np.mean(np.abs(g - wv)) < mean_tol * np.std(wv), name
    if "state" in case:
        st = got[0]
        assert not st[..., case["head"]:8].any()


_FP32_REF = {}


def fp32_reference(tpu, name):
    """(case inputs, rvdd_tpu's fp32-mode outputs) of a case, computed once
    for the module."""
    if name not in _FP32_REF:
        case = CASES[name]
        inputs = make_case(case, fp32=True)
        _FP32_REF[name] = inputs, run_tpu(tpu, case, *inputs, fp32=True)
    return _FP32_REF[name]


@pytest.mark.parametrize("name", list(CASES))
def test_convnext_chain_plain_fp32_matches_fused_convnext_chain(tpu, name):
    """The fp32 mode's plain version (fp32 bands, taps and weights, exact
    erf GELU, nothing rounded) against rvdd_tpu's fused_convnext_chain with
    band_dtype=float32, mxu_precision='highest' and gelu_exact=True on the
    same fp32 input: max error below 1e-5 x std, mean below 1e-6 x std
    (measured 0.5e-6 to 1.4e-6 max and 0.4e-7 to 1.3e-7 mean: fp32 sums in
    other orders, the Pallas kernel's polynomial erf, 1.5e-7 abs, and its
    depthwise as dots).  Both sides upsample in fp32, so an upsampled input
    has no exception here."""
    case = CASES[name]
    (x, aux, blocks, head), want = fp32_reference(tpu, name)
    got = run_port(case, x, aux, blocks, head, "cpu", fp32=True)
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape, (g.shape, wv.shape)
        assert _norm_err(g, wv) < 1e-5, (name, _norm_err(g, wv))
        assert np.mean(np.abs(g - wv)) < 1e-6 * np.std(wv), name


def test_fp32_mode_far_closer_than_bf16(tpu):
    """On the same inputs (rounded to bf16 for the bf16 chain), the fp32
    mode is at least 1000x closer to rvdd_tpu's fp32 chain than the bf16
    mode (measured: 8e-7 against 2.2e-2 to 2.7e-2)."""
    case = CASES["aux_tail"]
    (x, aux, blocks, head), want = fp32_reference(tpu, "aux_tail")
    got = run_port(case, x, aux, blocks, head, "cpu", fp32=True)
    bf = run_port(case, _bf16(x), _bf16(aux), blocks, head, "cpu")
    for g, b, wv in zip(got, bf, want):
        assert _norm_err(b, wv) > 1000 * _norm_err(g, wv), (_norm_err(b, wv), _norm_err(g, wv))


def test_split3_is_exact():
    """split3 gives three bf16 planes that sum back to every fp32 value bit
    for bit (hi + mid + lo, in that order, in fp32; -0 comes back as +0):
    random values over many binades, signs, zeros, powers of two and values
    with all 24 mantissa bits set.  The kernel splits its activations with the same
    masks in registers, and its weights come from this function."""
    rng = np.random.default_rng(21)
    vals = np.concatenate([
        rng.standard_normal(4096) * np.exp2(rng.integers(-60, 60, 4096)),
        [0.0, -0.0, 1.0, -2.0, 2.0 ** -100, 3.0 ** 20],
        np.float32(1 + (2 ** 23 - 1) * 2.0 ** -23) * np.exp2(np.arange(-20, 20)),
    ]).astype(np.float32)
    w = torch.from_numpy(vals)
    hi, mid, lo = split3(w)
    assert hi.dtype == mid.dtype == lo.dtype == BF16
    back = (hi.float() + mid.float()) + lo.float()
    nz = w != 0
    assert torch.equal(back[nz].view(torch.int32), w[nz].view(torch.int32))
    assert not back[~nz].any()
    # each plane carries at most 8 significant bits: none is rounded
    for p in (hi, mid, lo):
        assert torch.equal(p.float().to(BF16).float(), p.float())


@pytest.mark.parametrize("name", ["no_proj", "proj9", "proj48_aux48"])
def test_packed_fp32_block_gives_back_the_fp32_matrices(name):
    """In the fp32 mode the packed hi, mid and lo planes of proj, pw1 and
    pw2 unpack and sum to the block's fp32 matrices bit for bit, and the
    taps are not rounded."""
    cin0, aux_c = PACK_BLOCKS[name]
    rng = np.random.default_rng(13)
    sd = convnext_from_flax(block_params(rng, cin0 + aux_c))
    blk = pack_block(sd, cin0, aux_c, band_fp32=True)
    assert blk.band_fp32 and blk.pw1.dtype == torch.float32
    assert tuple(blk.pw1_pack.shape) == (3, 6, 192, 8) and blk.pw1_pack.dtype == BF16
    assert tuple(blk.pw2_pack.shape) == (3, 24, 48, 8)
    mats = block_mats_from_pack(blk)
    assert torch.equal(mats["pw1"], sd["pw1.weight"][:, :, 0, 0].t())
    assert torch.equal(mats["pw2"], sd["pw2.weight"][:, :, 0, 0].t())
    assert torch.equal(blk.dw_w, sd["dw.weight"].reshape(48, 49).t())
    if cin0 + aux_c != 48:
        assert tuple(blk.proj_pack.shape) == (3, (blk.cin0_pad + aux_c) // 8, 48, 8)
        assert torch.equal(mats["proj"], sd["proj.weight"][:, :, 0, 0].t())


def test_upsample_rounding_difference(tpu):
    """The one numerics difference from rvdd_tpu in a chain's input: the
    port builds the 2x align_corners=True upsample in fp32 and rounds it
    once to bf16.  rvdd_tpu does the lane half as a bf16 matmul, whose
    resize weights are bf16 too, rounds it to bf16, then interpolates rows
    in fp32 (its kernel's fp32 row positions, reproduced here).  Measured in
    bf16 ulps of the largest of each output's four source taps, the two
    differ by at most 1 ulp, on under half of the elements."""
    jnp = tpu.jnp
    rng = np.random.default_rng(5)
    hl, wlo = 8, 20
    x = _bf16(rng.standard_normal((1, hl, wlo, 48)))
    port = upsample2x_bilinear(torch.from_numpy(x), align_corners=True).to(BF16).float().numpy()
    lanes = _unplanar(tpu.fc.lane_resize2x_ac(_planar(jnp, x, 64), wlo), hl, 2 * wlo)
    scale = np.float32((hl - 1.0) / (2.0 * hl - 1.0))
    src = np.clip(np.arange(2 * hl, dtype=np.float32) * scale, 0, hl - 1)
    j0 = np.floor(src).astype(int)
    j1 = np.minimum(j0 + 1, hl - 1)
    t = (src - j0).astype(np.float32)[None, :, None, None]
    tpu_up = _bf16((1 - t) * lanes[:, j0] + t * lanes[:, j1])

    def taps(n):
        s = np.arange(2 * n) * (n - 1) / (2 * n - 1)
        i0 = np.floor(s).astype(int)
        return i0, np.minimum(i0 + 1, n - 1)

    (r0, r1), (c0, c1) = taps(hl), taps(wlo)
    ax = np.abs(x[0])
    big = np.maximum.reduce([ax[r][:, c] for r in (r0, r1) for c in (c0, c1)])[None]
    n_ulps = np.abs(port - tpu_up) / 2.0 ** (np.floor(np.log2(big)) - 7)
    assert n_ulps.max() <= 1.0, n_ulps.max()
    assert 0 < np.mean(n_ulps > 0) < 0.5, np.mean(n_ulps > 0)


def test_convnext_chain_wrapper_runs_plain_on_cpu():
    case = CASES["aux_tail"]
    x, aux, blocks, head = make_case(case, seed=3)
    before = convnext_chain.launches
    got = run_port(case, x, aux, blocks, head, "cpu")
    want = run_port(case, x, aux, blocks, head, "cpu", plain=True)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g, wv)
    assert convnext_chain.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_convnext_chain_kernel_matches_plain(cuda, name):
    """The CUDA kernel against its plain version on the card, at a size
    with ragged tiles (20 rows, 72 columns: neither divides the 8x16 tile).
    Max error at most 4 bf16 ulps of the largest output (2^-6 x max|out|),
    the rule chip_smoke.py applies at 1080p: both sides round the LN and
    GELU outputs and every band to bf16 after fp32 sums taken in different
    orders, so a value can land one ulp away and move the next products.
    The mean error is held to 1e-3 x std."""
    case = CARD_CASES[name]
    x, aux, blocks, head = make_case(case, seed=1, h=20, w=72)
    before = convnext_chain.launches
    got = run_port(case, x, aux, blocks, head, cuda)
    assert convnext_chain.launches == before + case["n"]
    want = run_port(case, x, aux, blocks, head, cuda, plain=True)
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape
        assert np.isfinite(g).all()
        err = float(np.max(np.abs(g - wv)))
        assert err <= 2.0 ** -6 * float(np.max(np.abs(wv))), (name, err)
        assert np.mean(np.abs(g - wv)) < 1e-3 * np.std(wv), name


# (chain input channels, aux channels) of a block: no proj, the flagship's
# 9-channel input (proj 16 after padding), a 16-channel input, block 1 of a
# chain with aux (proj 96), and a 96-channel input
PACK_BLOCKS = {"no_proj": (48, 0), "proj9": (9, 0), "proj16": (16, 0), "proj48_aux48": (48, 48),
               "proj96": (96, 0)}


@pytest.mark.parametrize("name", list(PACK_BLOCKS))
def test_packed_block_gives_back_the_plain_matrices(name):
    """The kernel's K-major copies of proj [cin, 48], pw1 [48, 192] and pw2
    [192, 48] unpack to exactly the matrices block_plain multiplies by
    (proj: without the pad rows between the input and the aux channels)."""
    cin0, aux_c = PACK_BLOCKS[name]
    rng = np.random.default_rng(12)
    sd = convnext_from_flax(block_params(rng, cin0 + aux_c))
    blk = pack_block(sd, cin0, aux_c)
    mats = block_mats_from_pack(blk)
    assert tuple(blk.pw1_pack.shape) == (6, 192, 8) and tuple(blk.pw2_pack.shape) == (24, 48, 8)
    assert torch.equal(mats["pw1"], blk.pw1.float())
    assert torch.equal(mats["pw2"], blk.pw2.float())
    if cin0 + aux_c == 48:
        assert blk.proj_pack is None and "proj" not in mats
    else:
        assert tuple(blk.proj_pack.shape) == ((blk.cin0_pad + aux_c) // 8, 48, 8)
        want = torch.cat([blk.proj_w[:blk.cin0], blk.proj_w[blk.cin0_pad:]]).float()
        assert torch.equal(mats["proj"], want)
        assert mats["proj"].shape == (cin0 + aux_c, 48)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [72, 200])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_convnext_chain_kernel_ragged_batch2(cuda, name, w):
    """Every card case (proj blocks with 16 and 96 input channels among
    them) at widths that are not multiples of the 32-column tile, 22 or 26
    rows (not multiples of the 12-row tile), batch 2; the bound of
    test_convnext_chain_kernel_matches_plain."""
    case = CARD_CASES[name]
    h = 22 if w == 72 else 26
    x, aux, blocks, head = make_case(case, seed=4, h=h, w=w, batch=2)
    got = run_port(case, x, aux, blocks, head, cuda)
    want = run_port(case, x, aux, blocks, head, cuda, plain=True)
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape and g.shape[0] == 2
        assert np.isfinite(g).all()
        err = float(np.max(np.abs(g - wv)))
        assert err <= 2.0 ** -6 * float(np.max(np.abs(wv))), (name, w, err)
        assert np.mean(np.abs(g - wv)) < 1e-3 * np.std(wv), (name, w)


def check_fp32_kernel(device, name, h, w, seed, batch=2, n_cta=None):
    """The fp32 mode of the kernel against its plain fp32 version (TF32
    off) on a card case: max error at most 2^-14 of max|out| and mean below
    1e-5 x std.  The two differ by the products the split drops (about
    2^-24 relative), fp32 sums in other orders and the kernel's polynomial
    erf (rvdd_tpu's kernel's, 1.5e-7 abs) against torch's; the kernel
    launches once a block, counted in fp32_launches."""
    case = CARD_CASES[name]
    x, aux, blocks, head = make_case(case, seed=seed, h=h, w=w, batch=batch, fp32=True)
    before = convnext_chain.launches, convnext_chain.fp32_launches
    got = run_port(case, x, aux, blocks, head, device, fp32=True, n_cta=n_cta)
    assert (convnext_chain.launches, convnext_chain.fp32_launches) == (
        before[0] + case["n"], before[1] + case["n"])
    want = run_port(case, x, aux, blocks, head, device, plain=True, fp32=True)
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape and g.shape[0] == batch
        assert np.isfinite(g).all()
        err = float(np.max(np.abs(g - wv)))
        assert err <= 2.0 ** -14 * float(np.max(np.abs(wv))), (name, h, w, err)
        assert np.mean(np.abs(g - wv)) < 1e-5 * np.std(wv), (name, h, w)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [72, 200])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_convnext_chain_fp32_kernel_matches_plain(cuda, name, w):
    """The fp32 mode on the card (three-plane split, six bf16 wgmma a
    k-step, erf GELU, fp32 bands) against its plain fp32 version on every
    card case, batch 2, at ragged sizes (check_fp32_kernel's limits)."""
    check_fp32_kernel(cuda, name, 22 if w == 72 else 26, w, seed=7)


# (h, w) that walk the fp32 kernel's halo ring: a tall strip (a CTA carries
# the ring down many tiles), images shorter than a tile's 10-row halo, and
# a strip narrower than the 32-column tile
RING_SHAPES = {"tall_h70_w40": (70, 40), "short_h6": (6, 72), "short_h3": (3, 72),
               "narrow_w20": (22, 20)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(RING_SHAPES))
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_convnext_chain_fp32_kernel_ring_edges(cuda, name, shape):
    """The fp32 mode on every card case at the shapes of RING_SHAPES, batch
    2: the runs of the tiles of image 0 end at its last tile row, and those
    of image 1 start with a whole halo (check_fp32_kernel's limits).  An
    upsampling case doubles its input, so an odd h becomes h - 1."""
    h, w = RING_SHAPES[shape]
    if CARD_CASES[name].get("upsample"):
        h -= h % 2
    check_fp32_kernel(cuda, name, h, w, seed=9)


@pytest.mark.gpu
@pytest.mark.parametrize("n_cta", [1, 5])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_convnext_chain_fp32_kernel_small_grid(cuda, name, n_cta):
    """The fp32 mode with the grid capped (n_cta): one CTA walks every
    strip of both images (n_cta = 1), or five CTAs take runs that start
    and end inside strips (tile_runs), at 70 x 72, batch 2."""
    runs = tile_runs(2, 70, 72, n_cta)
    assert len(runs) == n_cta
    assert n_cta == 1 or any(r[2] > 0 for cta in runs for r in cta[:1])
    check_fp32_kernel(cuda, name, 70, 72, seed=11, n_cta=n_cta)


@pytest.mark.parametrize("fp32", [False, True])
def test_convnext_chain_takes_its_own_dtype_only(fp32):
    """A chain takes x and aux of its own dtype only: an fp32 chain given
    bf16 raises TypeError, and a bf16 chain given fp32; nothing is cast
    quietly, on the CPU as on the card (the check comes first)."""
    case = CASES["aux_tail"]
    x, aux, blocks, _ = make_case(case)
    sds = [convnext_from_flax(p) for p in blocks]
    chain = pack_chain(sds, 16, aux_c=48, band_fp32=fp32)
    wrong = BF16 if fp32 else torch.float32
    xt, auxt = torch.from_numpy(x), torch.from_numpy(aux)
    with pytest.raises(TypeError):
        convnext_chain(xt.to(wrong), chain, aux=auxt.to(chain.dtype), aux_channels=(8, 48))
    with pytest.raises(TypeError):
        convnext_chain(xt.to(chain.dtype), chain, aux=auxt.to(wrong), aux_channels=(8, 48))
    (out,) = convnext_chain(xt.to(chain.dtype), chain, aux=auxt.to(chain.dtype),
                            aux_channels=(8, 48))
    assert out.dtype == chain.dtype


@pytest.mark.gpu
def test_convnext_chain_kernel_rejects_bad_input(cuda):
    case = CASES["aux_tail"]
    x, aux, blocks, head = make_case(case)
    sds = [{k: v.to(cuda) for k, v in convnext_from_flax(p).items()} for p in blocks]
    chain = pack_chain(sds, 16, aux_c=48)
    xt = torch.from_numpy(x).to(cuda)
    auxt = torch.from_numpy(aux).to(cuda).to(BF16)
    with pytest.raises(TypeError):
        convnext_chain(xt, chain, aux=auxt, aux_channels=(8, 48))  # fp32, not bf16
    with pytest.raises(ValueError):
        convnext_chain(xt.to(BF16).transpose(1, 2), chain, aux=auxt, aux_channels=(8, 48))
    with pytest.raises(ValueError):
        convnext_chain(xt.to(BF16), chain)  # block 1 needs aux
    with pytest.raises(ValueError):
        convnext_chain(xt.to(BF16), chain, aux=auxt, aux_channels=(16, 48))  # window overruns
    fp32_chain = pack_chain(sds, 16, aux_c=48, band_fp32=True)
    with pytest.raises(TypeError):
        convnext_chain(xt.to(BF16), fp32_chain, aux=auxt, aux_channels=(8, 48))  # bf16, not fp32
    with pytest.raises(TypeError):
        convnext_chain(xt, fp32_chain, aux=auxt, aux_channels=(8, 48))  # aux bf16


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2])
def test_fused_flagship_steps_on_card_match_plain_versions(cuda, batch):
    """Two fused flagship steps with the CUDA kernels against the same steps
    on the CPU, where the wrappers run their plain versions: within the
    fast path's envelope (0.2 / 0.3), since band-rounding flips over 20
    blocks move two bf16 runs about as far apart as either is from fp32."""
    from rvdd_tpu_torch.models import build_network
    from rvdd_tpu_torch.recurrent import engine

    rng = np.random.default_rng(6)
    h, w = 72, 80
    frames = rng.uniform(-1, 1, (batch, 3, h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    fl = np.stack([2.5 + np.sin(xx / 9), -1.5 + np.cos(yy / 7)], -1)
    flows = np.stack([np.stack([fl, -fl]), np.stack([-fl, fl])])[:batch].astype(np.float32)
    cfg = engine.EngineConfig(model_patch_depth=2, future_patch_depth=1, feature_rec=True,
                              net_impl="fused")
    outs = {}
    for dev in ("cpu", cuda):
        net = build_network("newunet-mode=feat", 9, 3, seed=5, device=dev)
        fr, fl = torch.from_numpy(frames).to(dev), torch.from_numpy(flows).to(dev)
        d1, s = engine.inference_step(cfg, net, None, fr, fl)
        d2, _ = engine.inference_step(cfg, net, s, fr, fl)
        outs[str(dev)] = (d1.cpu().numpy(), d2.cpu().numpy())
    for got, want, lim in zip(outs["cuda"], outs["cpu"], (0.2, 0.3)):
        assert np.isfinite(got).all()
        assert _norm_err(got, want) < lim, _norm_err(got, want)


@pytest.mark.gpu
def test_mixed_flagship_steps_on_card_match_plain_versions(cuda):
    """Two fused flagship steps under 'mixed' with the CUDA kernels (every
    chain in the fp32 mode, fp32 warps) against the same steps on the CPU,
    where the wrappers run their plain fp32 versions: normalized max error
    below 1e-4 at both steps (fp32 sums in other orders, the products the
    split drops and the kernel's polynomial erf against torch's, carried
    over 25 blocks and two steps)."""
    from rvdd_tpu_torch.models import build_network
    from rvdd_tpu_torch.recurrent import engine

    rng = np.random.default_rng(8)
    h, w = 72, 80
    frames = rng.uniform(-1, 1, (1, 3, h, w, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    fl = np.stack([2.5 + np.sin(xx / 9), -1.5 + np.cos(yy / 7)], -1)
    flows = np.stack([fl, -fl])[None].astype(np.float32)
    cfg = engine.EngineConfig(model_patch_depth=2, future_patch_depth=1, feature_rec=True,
                              net_impl="fused", fused_precision="mixed")
    outs = {}
    for dev in ("cpu", cuda):
        net = build_network("newunet-mode=feat", 9, 3, seed=5, device=dev)
        fr, fl = torch.from_numpy(frames).to(dev), torch.from_numpy(flows).to(dev)
        before = convnext_chain.fp32_launches
        d1, s = engine.inference_step(cfg, net, None, fr, fl)
        d2, _ = engine.inference_step(cfg, net, s, fr, fl)
        assert convnext_chain.fp32_launches - before == (50 if dev == cuda else 0)
        outs[str(dev)] = (d1.cpu().numpy(), d2.cpu().numpy())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert np.isfinite(got).all()
        assert _norm_err(got, want) < 1e-4, _norm_err(got, want)


# (B, H, W, n_cta): the flagship's chain resolutions at 1080p on the H100's
# 132 SMs (full, half, quarter and eighth: A and dec2, B and dec1, C and
# dec0, mid), the card tests' shapes, and edges: H not a multiple of 4, W
# not a multiple of 32, H below the 10-row halo, W below the tile, one CTA,
# more CTAs than tiles
TILE_RUNS_GRIDS = [
    (1, 1080, 1920, 132), (1, 540, 960, 132), (1, 270, 480, 132), (1, 135, 240, 132),
    (2, 70, 40, 132), (2, 70, 72, 1), (2, 70, 72, 5), (2, 6, 72, 132), (2, 3, 72, 132),
    (2, 22, 20, 132), (2, 26, 200, 132), (3, 37, 100, 7), (1, 1, 1, 4), (4, 9, 33, 5),
]


@pytest.mark.parametrize("grid", TILE_RUNS_GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_tile_runs_cover_every_tile_once(grid):
    """The fp32 kernel's schedule: every 4x32 tile of every image exactly
    once; each CTA's runs lie in one strip of one image and follow each
    other in the kernel's tile order (image, strip, tile row), so its tiles
    are one contiguous range; no CTA takes more than ceil(T / n) tiles, nor
    one more than another."""
    b, h, w, n = grid
    runs = tile_runs(b, h, w, n)
    strips, rows = -(-w // 32), -(-h // 4)
    total = b * strips * rows
    assert len(runs) == min(total, n)
    seen = Counter()
    order = []
    for cta in runs:
        assert cta, "every CTA of the grid has a tile"
        for img, s, r0, cnt in cta:
            assert 0 <= img < b and 0 <= s < strips and cnt >= 1 and 0 <= r0 and r0 + cnt <= rows
            for k in range(cnt):
                seen[(img, s, r0 + k)] += 1
                order.append((img * strips + s) * rows + r0 + k)
    assert len(seen) == total and set(seen.values()) == {1}
    assert order == list(range(total))
    counts = [sum(r[3] for r in cta) for cta in runs]
    assert max(counts) <= -(-total // len(runs)) and max(counts) - min(counts) <= 1


def test_tile_runs_balance_at_1080p():
    """At 1080p on 132 SMs (16,200 tiles of a full-res block) no CTA takes
    more than 1.05x the mean, in at most two runs (one strip change), so
    the kernel stages a whole halo at most twice a CTA."""
    runs = tile_runs(1, 1080, 1920, 132)
    counts = [sum(r[3] for r in cta) for cta in runs]
    assert sum(counts) == 60 * 270
    assert max(counts) <= 1.05 * sum(counts) / len(counts)
    assert max(len(cta) for cta in runs) <= 2
