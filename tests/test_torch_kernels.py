"""The port's kernels (rvdd_tpu_torch/ops/cuda) against rvdd_tpu's Pallas
kernels and against their own plain versions.

On the CPU the wrappers run their plain PyTorch versions, which are held
against rvdd_tpu's ``fused_conv_chain`` and ``warp_planar_pallas`` run in
interpret mode (as tests/test_conv_pallas.py and test_warp_rowmajor.py run
them).  The tests marked ``gpu`` launch the CUDA kernels and hold them
against the plain versions; they skip without a card.  Inputs come from
numpy seeds and go to both packages.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rvdd_tpu_torch.ops.cuda.conv_chain import (  # noqa: E402
    MODES,
    chain_mode,
    conv_chain,
    conv_chain_plain,
    layer_plan,
    layer_weight_from_pack,
    pack_chain,
    pack_kmajor,
    split3,
    unpack_kmajor,
    ws_plan,
    ws_rows,
)
from rvdd_tpu_torch.ops.cuda.warp_bicubic import (  # noqa: E402
    warp_bicubic,
    warp_bicubic_plain,
)

BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def tpu():
    """rvdd_tpu's kernels and glue (skips where JAX is absent)."""
    jax = pytest.importorskip("jax")
    from rvdd_tpu.models import fast_unet
    from rvdd_tpu.ops.pallas import conv_pallas, warp_rowmajor

    return SimpleNamespace(jnp=jax.numpy, conv=conv_pallas, warp=warp_rowmajor,
                           fu=fast_unet)


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


# ------------------------------------------------------------ conv chains

# chans[0] is the input width; aux = (full width, offset, n) joins layer 1
CASES = {
    "single": dict(h=16, w=40, chans=(8, 16), acts=("relu",), ks=(3,)),
    "aux_window": dict(h=16, w=40, chans=(8, 16, 16, 16),
                       acts=("none", "relu", "relu"), ks=(3, 3, 3), aux=(32, 8, 16)),
    "pool_emit": dict(h=16, w=40, chans=(16, 16, 16, 16),
                      acts=("relu", "relu", "none"), ks=(3, 3, 3),
                      emit=(1, 2), pool=(2,)),
    "upsample_input": dict(h=16, w=40, chans=(16, 16, 16, 16),
                           acts=("relu",) * 3, ks=(3, 3, 3), aux=(16, 0, 16),
                           upsample=True),
    "state_split": dict(h=16, w=40, chans=(16, 16, 16, 16, 16, 3),
                        acts=("relu",) * 4 + ("none",), ks=(3, 3, 3, 3, 1),
                        aux=(16, 0, 16), upsample=True,
                        split=(False, False, False, True, True),
                        state=(24, ((4, 0), (3, 8)))),
}

# card-only: rvdd_tpu's kernel needs channel counts divisible by 8, the
# port's takes the main path's 6-channel input and 56-channel state as is
CARD_CASES = dict(CASES, six_channel_input=dict(
    h=16, w=40, chans=(6, 16, 16), acts=("none", "relu"), ks=(3, 3), aux=(56, 8, 16)))


def make_case(case, seed=0, h=None, w=None, batch=1, fp32=False):
    """numpy inputs and HWIO weights (kaiming scale) for one chain case;
    the inputs are bf16 values, or with ``fp32`` any fp32 values (the fp32
    mode splits them)."""
    rng = np.random.default_rng(seed)
    h, w = h or case["h"], w or case["w"]
    hx, wx = (h // 2, w // 2) if case.get("upsample") else (h, w)
    rnd = (lambda a: np.asarray(a, np.float32)) if fp32 else _bf16
    x = rnd(rng.standard_normal((batch, hx, wx, case["chans"][0])))
    aux = None
    if "aux" in case:
        aux = rnd(rng.standard_normal((batch, h, w, case["aux"][0])))
    ws, bs = [], []
    for l in range(len(case["ks"])):
        cin = case["chans"][l] + (case["aux"][2] if (l == 1 and "aux" in case) else 0)
        k = case["ks"][l]
        ws.append((rng.standard_normal((k, k, cin, case["chans"][l + 1]))
                   * np.sqrt(2.0 / (k * k * cin))).astype(np.float32))
        bs.append((rng.standard_normal(case["chans"][l + 1]) * 0.1).astype(np.float32))
    return x, aux, ws, bs


#: the mean error over std the 'w32' kernel is held to against its plain
#: version on the card (chip_smoke.py holds the 1080p chains to the same)
W32_MEAN = 8e-4

#: pack_chain's options for each kernel mode (rvdd_tpu's names)
MODE_KW = {"bf16": {}, "high": dict(band_fp32=True),
           "highest": dict(band_fp32=True, mxu_precision="highest"),
           "w32": dict(mxu_precision="highest", weight_fp32=True)}


def run_port(case, x, aux, ws, bs, device, plain=False, mode="bf16", n_cta=None):
    """The port's chain on numpy inputs, packed in ``mode`` (MODE_KW), the
    inputs passed in the chain's band dtype (fp32 in 'high' and 'highest',
    else rounded to bf16); ``n_cta`` caps the kernel's grid."""
    chain = pack_chain([torch.from_numpy(a).to(device) for a in ws],
                       [torch.from_numpy(b).to(device) for b in bs],
                       case["acts"], case["ks"], weight_split=case.get("split"),
                       **MODE_KW[mode])
    fn = conv_chain_plain if plain else conv_chain
    kw = dict(emit=case.get("emit", ()), pool=case.get("pool", ()),
              upsample_input=case.get("upsample", False), state_out=case.get("state"))
    if aux is not None:
        kw["aux"] = torch.from_numpy(aux).to(device).to(chain.dtype)
        kw["aux_channels"] = case["aux"][1:]
    if n_cta is not None:
        kw["n_cta"] = n_cta
    outs = fn(torch.from_numpy(x).to(device).to(chain.dtype), chain, **kw)
    return [o.float().cpu().numpy() for o in outs]


def _planar(jnp, x, wl, dtype=None):
    """[1, H, W, C] numpy -> [(H*C), WL] bf16 (or ``dtype``; zero lanes >= W)."""
    _, h, w, c = x.shape
    p = np.zeros((h, c, wl), np.float32)
    p[:, :, :w] = x[0].transpose(0, 2, 1)
    return jnp.asarray(p.reshape(h * c, wl)).astype(dtype or jnp.bfloat16)


def _unplanar(p, h, w):
    p = np.asarray(p, np.float32)
    return p.reshape(h, p.shape[0] // h, -1)[:, :, :w].transpose(0, 2, 1)[None]


def run_tpu(tpu, case, x, aux, ws, bs, mode="bf16"):
    """rvdd_tpu's fused_conv_chain (interpret mode) plus the planar glue the
    port folds into its kernel (lane pool, lane upsample), with the options
    of the port's ``mode``: 'high', fp32 bands and outputs with
    mxu_precision='high' (the manual bf16_3x); 'highest', fp32 bands and
    weights at 'highest'; 'w32', bf16 bands with weight_dtype=float32 at
    'highest'.  The case's weight split applies to the bf16 modes."""
    jnp = tpu.jnp
    dt = jnp.float32 if mode in ("high", "highest") else jnp.bfloat16
    h, w = case["h"], case["w"]
    wl = tpu.conv.lane_width(w)
    packed, biases = [], []
    for wt, bt, k in zip(ws, bs, case["ks"]):
        cout = wt.shape[-1]
        m = wt.reshape(k * k * wt.shape[2], cout).T  # pack_weight order
        pad = -cout % 8  # the TPU kernel wants cout % 8 == 0
        packed.append(jnp.asarray(np.pad(m, ((0, pad), (0, 0)))))
        biases.append(jnp.asarray(np.pad(bt, (0, pad))))
    if case.get("upsample"):
        xp = tpu.fu.lane_upsample2x_planar(_planar(jnp, x, wl // 2, dt), h // 2, w // 2)
    else:
        xp = _planar(jnp, x, wl, dt)
    kw = dict(h_img=h, w_img=w, tile_h=8, interpret=True,
              upsample_input=case.get("upsample", False))
    if mode in ("high", "highest"):
        kw.update(band_dtype=jnp.float32, mxu_precision=mode)
    elif mode == "w32":
        kw.update(mxu_precision="highest", weight_dtype=jnp.float32)
    if aux is not None:
        kw["aux"] = _planar(jnp, aux, wl, dt)
        kw["aux_channels"] = case["aux"][1:]
    if case.get("split") and mode in ("bf16", "high"):
        kw["weight_dtype"] = tuple("split" if s else None for s in case["split"])
    if "state" in case:
        outs = tpu.conv.fused_conv_chain(
            xp, tuple(packed), tuple(biases), case["acts"], case["ks"],
            emit=tuple(l for l, _ in case["state"][1]), combine=case["state"],
            out_dtype=jnp.float32, **kw)
        st = np.asarray(outs[0], np.float32)  # [H, total_c, WL]
        return [st.transpose(0, 2, 1)[None, :, :w]]
    emit = case.get("emit", (len(ws) - 1,))
    outs = tpu.conv.fused_conv_chain(
        xp, tuple(packed), tuple(biases), case["acts"], case["ks"],
        emit=emit, pool_rows=case.get("pool", ()), out_dtype=dt, **kw)
    res = []
    for o, l in zip(outs, emit):
        cout = ws[l].shape[-1]
        if l in case.get("pool", ()):
            res.append(_unplanar(tpu.fu.lanepool2x_planar(o), h // 2, w // 2)[..., :cout])
        else:
            res.append(_unplanar(o, h, w)[..., :cout])
    return res


def _norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_conv_chain_plain_matches_fused_conv_chain(tpu, name):
    """Max error 2e-2 x std: both sides round every band to bf16 and
    accumulate bf16 products in fp32, in different orders; a rounding flip
    in one band (1 bf16 ulp, ~0.4% of the value) propagates to the next
    layers.  With an upsampled input the bound is 6e-2 x std: rvdd_tpu
    computes the lane half of the upsample in bf16 arithmetic (each product
    and sum rounds) before the row half, the port rounds the fp32 upsample
    once, so layer 0's input differs by 1-2 bf16 ulps (fed the same
    upsampled input, the two chains agree to ~1e-6).  The mean error is
    held to 5e-3 x std in every case."""
    case = CASES[name]
    x, aux, ws, bs = make_case(case)
    got = run_port(case, x, aux, ws, bs, "cpu")
    want = run_tpu(tpu, case, x, aux, ws, bs)
    assert len(got) == len(want)
    tol = 6e-2 if case.get("upsample") else 2e-2
    for g, wv in zip(got, want):
        assert g.shape == wv.shape, (g.shape, wv.shape)
        assert _norm_err(g, wv) < tol, (name, _norm_err(g, wv))
        assert np.mean(np.abs(g - wv)) < 5e-3 * np.std(wv)


@pytest.mark.parametrize("name", list(CASES))
def test_conv_chain_plain_fp32_matches_fused_conv_chain_high(tpu, name):
    """The fp32-band mode against rvdd_tpu's fused_conv_chain with
    band_dtype=float32 and mxu_precision='high' (the manual bf16_3x), fp32
    inputs: both sides split every band and every weight by the mantissa
    mask and sum the same three bf16 products in fp32, in different orders.
    Max error 2e-4 x std (up to 8e-5 seen, against 1.5-3.2e-4 for either
    side against the unsplit fp32 chain): where the two fp32 sums of a band
    differ by an ulp, the bf16 rounding of its lo half can flip (2^-15 of
    the value at most), and the next layers carry that; the upsample (lanes
    then rows in rvdd_tpu, rows then lanes here, both fp32) adds fp32
    rounding only.  The mean error is held to 1e-5 x std (up to 2.6e-6
    seen)."""
    case = CASES[name]
    x, aux, ws, bs = make_case(case, seed=4, fp32=True)
    got = run_port(case, x, aux, ws, bs, "cpu", mode="high")
    want = run_tpu(tpu, case, x, aux, ws, bs, mode="high")
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape, (g.shape, wv.shape)
        assert _norm_err(g, wv) < 2e-4, (name, _norm_err(g, wv))
        assert np.mean(np.abs(g - wv)) < 1e-5 * np.std(wv), name


def fp32_reference(case, x, aux, ws, bs):
    """The chain in plain fp32 with its unsplit weights: no rounding."""
    from rvdd_tpu_torch.ops.resize import maxpool2x2, upsample2x_bilinear

    h = torch.from_numpy(x)
    if case.get("upsample"):
        h = upsample2x_bilinear(h)
    auxw = None
    if aux is not None:
        off, n = case["aux"][1:]
        auxw = torch.from_numpy(aux)[..., off:off + n]
    outs = {}
    for l, (wt, bt, act, k) in enumerate(zip(ws, bs, case["acts"], case["ks"])):
        inp = torch.cat([h, auxw], -1) if (l == 1 and auxw is not None) else h
        y = torch.nn.functional.conv2d(inp.permute(0, 3, 1, 2),
                                       torch.from_numpy(wt).permute(3, 2, 0, 1),
                                       torch.from_numpy(bt), padding=k // 2).permute(0, 2, 3, 1)
        h = outs[l] = torch.relu(y) if act == "relu" else y
    if "state" in case:
        n, layers = case["state"]
        state = torch.zeros(*h.shape[:3], n)
        for l, off in layers:
            state[..., off:off + outs[l].shape[-1]] = outs[l]
        return [state.numpy()]
    pool = case.get("pool", ())
    return [(maxpool2x2(outs[l]) if l in pool else outs[l]).numpy()
            for l in case.get("emit", (len(ws) - 1,))]


@pytest.mark.parametrize("name", list(CASES))
def test_conv_chain_fp32_mode_is_closer_to_fp32(name):
    """Against the unsplit fp32 chain, the fp32-band mode (bf16_3x: about
    16 mantissa bits per operand, no band rounding) is at least 10x closer
    than the bf16-band mode (8 bits, every band rounded).  A split whose lo
    half went to zero would leave the fp32 mode at the bf16 mode's error."""
    case = CASES[name]
    x, aux, ws, bs = make_case(case, seed=5, fp32=True)
    want = fp32_reference(case, x, aux, ws, bs)
    f32 = run_port(case, x, aux, ws, bs, "cpu", mode="high")
    b16 = run_port(case, x, aux, ws, bs, "cpu")
    for a, b, wv in zip(f32, b16, want):
        e32, e16 = float(np.max(np.abs(a - wv))), float(np.max(np.abs(b - wv)))
        assert 10 * e32 < e16, (name, e32, e16)


def test_conv_chain_fp32_mode_packing_and_dtypes():
    """band_fp32 splits every layer whatever weight_split says, the chain
    takes and emits fp32 only, and the wrapper raises TypeError (never
    converts) on a tensor of the other dtype, for x and for aux."""
    case = CASES["aux_window"]
    x, aux, ws, bs = make_case(case, seed=6, fp32=True)
    tw = [torch.from_numpy(a) for a in ws]
    tb = [torch.from_numpy(b) for b in bs]
    chain = pack_chain(tw, tb, case["acts"], case["ks"], weight_split=(False,) * 3,
                       band_fp32=True)
    assert chain.band_fp32 and chain.dtype == torch.float32
    assert all(layer.split and layer.w_lo is not None for layer in chain.layers)
    xt, at = torch.from_numpy(x), torch.from_numpy(aux)
    kw = dict(aux_channels=case["aux"][1:])
    (out,) = conv_chain(xt, chain, aux=at, **kw)
    assert out.dtype == torch.float32
    with pytest.raises(TypeError):
        conv_chain(xt.to(BF16), chain, aux=at, **kw)
    with pytest.raises(TypeError):
        conv_chain(xt, chain, aux=at.to(BF16), **kw)
    bf = pack_chain(tw, tb, case["acts"], case["ks"])
    assert bf.dtype == BF16
    with pytest.raises(TypeError):
        conv_chain(xt, bf, aux=at.to(BF16), **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_conv_chain_plain_highest_matches_fused_conv_chain_highest(tpu, name):
    """The 'highest' mode (rvdd_tpu's 'accurate' chains) against
    fused_conv_chain with band_dtype=float32 and mxu_precision='highest',
    fp32 inputs: on the CPU both are the plain fp32 chain (the interpreter's
    HIGHEST dots are exact fp32), in different summation orders, and the
    upsample runs lanes then rows in rvdd_tpu, rows then lanes here.  Max
    error 1e-4 x std, mean 5e-6 x std (seen: max 0 to 2.3e-6, mean 0 to
    1.8e-7)."""
    case = CASES[name]
    x, aux, ws, bs = make_case(case, seed=9, fp32=True)
    got = run_port(case, x, aux, ws, bs, "cpu", mode="highest")
    want = run_tpu(tpu, case, x, aux, ws, bs, mode="highest")
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape, (g.shape, wv.shape)
        assert _norm_err(g, wv) < 1e-4, (name, _norm_err(g, wv))
        assert np.mean(np.abs(g - wv)) < 5e-6 * np.std(wv), name


@pytest.mark.parametrize("name", list(CASES))
def test_conv_chain_plain_w32_matches_fused_conv_chain_wf32(tpu, name):
    """The 'w32' mode (rvdd_tpu's 'wf32' chains) against fused_conv_chain
    with bf16 bands and weight_dtype=float32 at 'highest', bf16 inputs: both
    convolve bf16 bands with the fp32 weights exactly and round each band to
    bf16.  Without the upsample the two differ only in fp32 summation order
    and are held to a max error of 1e-5 x std (seen: 0), which the same
    chain with bf16 weights (the 'bf16' mode on the same inputs) fails
    (seen: 0.029 to 0.038).  With the upsample, whose lane half rvdd_tpu
    computes in bf16 arithmetic, a band can round one ulp the other way and
    the next layers carry it: max 6e-2 x std and mean 5e-3 x std, the bf16
    chains' bounds (seen: 3.0e-2 and 3.2e-2, means 1.7e-3 and 2.3e-3)."""
    case = CASES[name]
    x, aux, ws, bs = make_case(case, seed=10)
    got = run_port(case, x, aux, ws, bs, "cpu", mode="w32")
    want = run_tpu(tpu, case, x, aux, ws, bs, mode="w32")
    assert len(got) == len(want)
    tol = 6e-2 if case.get("upsample") else 1e-5
    for g, wv in zip(got, want):
        assert g.shape == wv.shape, (g.shape, wv.shape)
        assert _norm_err(g, wv) < tol, (name, _norm_err(g, wv))
        assert np.mean(np.abs(g - wv)) < 5e-3 * np.std(wv), name
    if not case.get("upsample"):
        bf = run_port(case, x, aux, ws, bs, "cpu", mode="bf16")
        assert max(_norm_err(g, wv) for g, wv in zip(bf, want)) >= tol, name


@pytest.mark.parametrize("mode", MODES)
def test_pack_chain_modes_mark_every_layer(mode):
    """Each mode packs every layer as the kernel reads it: 'bf16' one plane
    (two where the layer is split), 'high' two (every layer split), 'highest'
    and 'w32' three (split3), whatever weight_split says; the kernel's copy
    unpacks to the weights the plain version convolves with, which in the
    fp32-weight modes are the fp32 weights bit for bit (split3's planes sum
    back exactly).  The chain's dtype is its bands'.  Combinations with no
    kernel mode raise."""
    case = CASES["state_split"]
    _, _, ws, bs = make_case(case, seed=12)
    tw = [torch.from_numpy(a) for a in ws]
    chain = pack_chain(tw, [torch.from_numpy(b) for b in bs], case["acts"], case["ks"],
                       weight_split=case["split"], **MODE_KW[mode])
    assert chain.mode == mode == chain_mode(**MODE_KW[mode])
    assert chain.dtype == (torch.float32 if mode in ("high", "highest") else BF16)
    for l, (layer, w) in enumerate(zip(chain.layers, tw)):
        want = {"bf16": 2 if case["split"][l] else 1, "high": 2}.get(mode, 3)
        k = layer.ks ** 2 * (layer.cin0_pad + layer.aux_c)
        assert len(layer.planes) == want and layer.split == (want == 2)
        assert tuple(layer.w_pack.shape) == (want * k // 8, layer.cout_pad, 8)
        assert torch.equal(layer_weight_from_pack(layer), layer.w_plain)
        if want == 3:
            assert torch.equal(layer.w_plain, w.permute(3, 2, 0, 1))
            hi, mid, lo = split3(w)
            assert torch.equal((hi.float() + mid.float()) + lo.float(), w)
    for bad in (dict(band_fp32=True, mxu_precision="default"), dict(mxu_precision="high"),
                dict(weight_fp32=True), dict(mxu_precision="highest")):
        with pytest.raises(NotImplementedError):
            chain_mode(**bad)


def test_conv_chain_wrapper_runs_plain_on_cpu():
    case = CASES["aux_window"]
    x, aux, ws, bs = make_case(case, seed=3)
    before = conv_chain.launches
    got = run_port(case, x, aux, ws, bs, "cpu")
    want = run_port(case, x, aux, ws, bs, "cpu", plain=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert conv_chain.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_conv_chain_kernel_matches_plain(cuda, name):
    """The CUDA kernel against its plain version on the card, at a size
    with ragged tiles (20 rows, 72 columns: neither divides 8x32).  Max
    error at most 4 bf16 ulps of the largest output (2^-6 x max|out|), the
    rule chip_smoke.py applies at 1080p: both sides round every band to
    bf16 after fp32 sums taken in different orders, so an output can land
    one ulp away, and a flipped band rounding moves the next layer's sums.
    The mean error is held to 1e-3 x std."""
    case = CARD_CASES[name]
    x, aux, ws, bs = make_case(case, seed=1, h=20, w=72)
    before = conv_chain.launches
    got = run_port(case, x, aux, ws, bs, cuda)
    assert conv_chain.launches == before + len(case["ks"])
    want = run_port(case, x, aux, ws, bs, cuda, plain=True)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape
        assert np.isfinite(g).all()
        err = float(np.max(np.abs(g - wv)))
        assert err <= 2.0 ** -6 * float(np.max(np.abs(wv))), (name, err)
        assert np.mean(np.abs(g - wv)) < 1e-3 * np.std(wv), name


# fp32-band mode on the card: every card case, and the hybrid preset's two
# fp32 chains at their widths: A (the 9-channel input of convunet+feat+
# future, the state's 48-channel aux window, K = 864 at layer 1, the
# pooled emit) and dec2 (upsampled input, K = 864, the 56-channel state)
FP32_CARD_CASES = dict(
    CARD_CASES,
    chain_A=dict(h=16, w=40, chans=(9, 48, 48, 48, 48), acts=("none", "relu", "relu", "none"),
                 ks=(3, 3, 3, 3), aux=(56, 8, 48), emit=(2, 3), pool=(3,)),
    chain_dec2=dict(h=16, w=40, chans=(48, 48, 48, 48, 48, 3), acts=("relu",) * 4 + ("none",),
                    ks=(3, 3, 3, 3, 1), aux=(48, 0, 48), upsample=True,
                    state=(56, ((4, 0), (3, 8)))),
)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(20, 72, 1), (22, 72, 2), (26, 200, 2)],
                         ids=["20x72", "22x72_b2", "26x200_b2"])
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_fp32_kernel_matches_plain(cuda, name, shape):
    """The fp32-band kernel (three wgmma a k-step, fp32 bands and outputs)
    against its plain version with TF32 off, fp32 inputs, at widths and
    heights that are not multiples of the tiles, batch 1 and 2.  Both sides
    sum the same split products in fp32, in different orders; where a
    band's fp32 sums differ by an ulp, the bf16 rounding of its lo half can
    flip (2^-15 of the value at most), and the next layers carry it.  Max
    error 2^-12 of max|out| (16 times below one bf16 ulp there: a lo half
    lost to zero would give about 2^-9), mean 1e-4 x std (chip_smoke.py's
    bound: at 1080p the means are 5e-6 to 1e-5)."""
    case = FP32_CARD_CASES[name]
    h, w, batch = shape
    x, aux, ws, bs = make_case(case, seed=8, h=h, w=w, batch=batch, fp32=True)
    before = conv_chain.launches
    got = run_port(case, x, aux, ws, bs, cuda, mode="high")
    assert conv_chain.launches == before + len(case["ks"])
    want = run_port(case, x, aux, ws, bs, cuda, plain=True, mode="high")
    for g, wv in zip(got, want):
        assert g.shape == wv.shape and g.shape[0] == batch
        assert np.isfinite(g).all()
        err = float(np.max(np.abs(g - wv)))
        assert err <= 2.0 ** -12 * float(np.max(np.abs(wv))), (name, shape, err)
        assert np.mean(np.abs(g - wv)) < 1e-4 * np.std(wv), (name, shape)


@pytest.mark.gpu
def test_conv_chain_fp32_k864_layer_streams_its_weights(cuda):
    """The layer that reads 48 + 48 aux channels (K = 864) has 165,888
    bytes of split weights: beside two 2-row fp32 tiles of its 96 channels
    they do not fit, so in the 'high' mode it streams them a tap of a
    48-channel slab at a time through four stages, in the warp-specialized
    CTA of a producer and two consumer warpgroups; in the bf16 modes it
    stays resident.  The other 'high' layers of the path keep their
    weights resident beside two tiles.  Every plan fits the 232,448 bytes a
    block may have."""
    case = FP32_CARD_CASES["chain_A"]
    _, _, ws, bs = make_case(case)
    chain = pack_chain([torch.from_numpy(a) for a in ws], [torch.from_numpy(b) for b in bs],
                       case["acts"], case["ks"], band_fp32=True)
    plans = [layer_plan(layer, "high") for layer in chain.layers]
    assert [p["mode"] for p in plans] == ["high resident", "high streamed",
                                          "high resident", "high resident"], plans
    assert all(p["nwg"] == 3 and p["trw"] == 2 and p["smem"] <= 232448 for p in plans)
    assert (plans[1]["slabs"], plans[1]["stages"]) == (2, 4)
    assert layer_plan(chain.layers[1], "bf16")["mode"] == "bf16 split"
    bf = pack_chain([torch.from_numpy(a) for a in ws], [torch.from_numpy(b) for b in bs],
                    case["acts"], case["ks"])
    assert layer_plan(bf.layers[1], "bf16")["mode"] == "bf16"


@pytest.mark.gpu
def test_conv_chain_fp32_kernel_rejects_bf16(cuda):
    case = FP32_CARD_CASES["chain_A"]
    x, aux, ws, bs = make_case(case, fp32=True)
    chain = pack_chain([torch.from_numpy(a).to(cuda) for a in ws],
                       [torch.from_numpy(b).to(cuda) for b in bs],
                       case["acts"], case["ks"], band_fp32=True)
    xt, at = torch.from_numpy(x).to(cuda), torch.from_numpy(aux).to(cuda)
    before = conv_chain.launches
    with pytest.raises(TypeError):
        conv_chain(xt.to(BF16), chain, aux=at, aux_channels=(8, 48))
    with pytest.raises(TypeError):
        conv_chain(xt, chain, aux=at.to(BF16), aux_channels=(8, 48))
    assert conv_chain.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(20, 72, 1), (22, 72, 2), (26, 200, 2)],
                         ids=["20x72", "22x72_b2", "26x200_b2"])
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_highest_kernel_matches_plain(cuda, name, shape):
    """The 'highest' kernel (three-plane tile and weights, six wgmma a
    k-step) against its plain version, the fp32 chain, with TF32 off, fp32
    inputs, at ragged sizes, batch 1 and 2.  The kernel drops the products
    below 2^-24 of each product (mid lo, lo mid, lo lo) and both sum in
    fp32 in different orders; no band is rounded.  Max error 2^-14 of
    max|out| and mean 1e-5 x std (convnext_chain's fp32 bounds; a lost mid
    or lo plane gives 2^-9 or 2^-17 of the value, the 'high' mode about
    2^-17)."""
    case = FP32_CARD_CASES[name]
    h, w, batch = shape
    x, aux, ws, bs = make_case(case, seed=13, h=h, w=w, batch=batch, fp32=True)
    before, hb = conv_chain.launches, conv_chain.mode_launches["highest"]
    got = run_port(case, x, aux, ws, bs, cuda, mode="highest")
    assert (conv_chain.launches - before == conv_chain.mode_launches["highest"] - hb
            == len(case["ks"]))
    want = run_port(case, x, aux, ws, bs, cuda, plain=True, mode="highest")
    for g, wv in zip(got, want):
        assert g.shape == wv.shape and g.shape[0] == batch
        assert np.isfinite(g).all()
        err = float(np.max(np.abs(g - wv)))
        assert err <= 2.0 ** -14 * float(np.max(np.abs(wv))), (name, shape, err)
        assert np.mean(np.abs(g - wv)) < 1e-5 * np.std(wv), (name, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(20, 72, 1), (22, 72, 2), (26, 200, 2)],
                         ids=["20x72", "22x72_b2", "26x200_b2"])
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_w32_kernel_matches_plain(cuda, name, shape):
    """The 'w32' kernel (bf16 tile, three weight planes, three wgmma a
    k-step) against its plain version, the bf16-valued bands convolved with
    the fp32 weights in fp32 (TF32 off), at ragged sizes, batch 1 and 2.
    Both round every band to bf16 after sums in different orders: within 4
    bf16 ulps of max|out| (2^-6, the bf16 chains' bound) and a mean of
    W32_MEAN x std (seen on an H100: 1.6e-7 to 4.0e-4), which the same
    chain with bf16 weights fails
    (test_conv_chain_w32_mean_bound_fails_bf16_weights)."""
    case = FP32_CARD_CASES[name]
    h, w, batch = shape
    x, aux, ws, bs = make_case(case, seed=14, h=h, w=w, batch=batch)
    before, wb = conv_chain.launches, conv_chain.mode_launches["w32"]
    got = run_port(case, x, aux, ws, bs, cuda, mode="w32")
    assert conv_chain.launches - before == conv_chain.mode_launches["w32"] - wb == len(case["ks"])
    want = run_port(case, x, aux, ws, bs, cuda, plain=True, mode="w32")
    for g, wv in zip(got, want):
        assert g.shape == wv.shape and g.shape[0] == batch
        assert np.isfinite(g).all()
        err = float(np.max(np.abs(g - wv)))
        assert err <= 2.0 ** -6 * float(np.max(np.abs(wv))), (name, shape, err)
        assert np.mean(np.abs(g - wv)) < W32_MEAN * np.std(wv), (name, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_w32_mean_bound_fails_bf16_weights(cuda, name):
    """The control of the 'w32' kernel's mean bound: the same chain with its
    weights rounded to bf16 (the 'bf16' mode's packing, through the kernel),
    which a kernel that lost the mid and lo weight planes would come close
    to, held against the 'w32' plain version on the same inputs, reads a
    mean error of at least W32_MEAN x std on some output (seen on an H100:
    1.1e-3 to 5.0e-3)."""
    case = FP32_CARD_CASES[name]
    x, aux, ws, bs = make_case(case, seed=14, h=22, w=72, batch=2)
    got = run_port(dict(case, split=None), x, aux, ws, bs, cuda)
    want = run_port(case, x, aux, ws, bs, cuda, plain=True, mode="w32")
    means = [float(np.mean(np.abs(g - wv)) / np.std(wv)) for g, wv in zip(got, want)]
    assert max(means) >= W32_MEAN, (name, means)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["highest", "w32"])
def test_conv_chain_fp32_weight_modes_stream_k864(cuda, mode):
    """With three weight planes a K = 864 layer's weights (248,832 bytes)
    exceed shared memory, so chain A's layer 1 streams them in both
    fp32-weight modes, a tap of a 48-channel slab at a time through four
    stages, in the warp-specialized CTA of a producer and two consumer
    warpgroups ('highest': 2-row fp32 tiles; 'w32': 4-row bf16 tiles).
    The K = 144 and K = 432 layers keep them resident beside two tiles.
    Every plan fits the 232,448 bytes a block may have."""
    case = FP32_CARD_CASES["chain_A"]
    _, _, ws, bs = make_case(case)
    chain = pack_chain([torch.from_numpy(a) for a in ws], [torch.from_numpy(b) for b in bs],
                       case["acts"], case["ks"], **MODE_KW[mode])
    plans = [layer_plan(layer, mode) for layer in chain.layers]
    assert [p["mode"] for p in plans] == [f"{mode} resident", f"{mode} streamed",
                                          f"{mode} resident", f"{mode} resident"], plans
    assert all(p["smem"] <= 232448 for p in plans)
    assert all(p["nwg"] == 3 and p["trw"] == ws_rows(mode) for p in plans)
    assert (plans[1]["slabs"], plans[1]["stages"]) == (2, 4)
    assert [p["slabs"] for p in plans] == [2 if i == 1 else 1 for i in range(4)]


#: the layer shapes of the main path, and wider ones: (ks, cin_tot,
#: cout_pad, upsampled input)
HIGHEST_SHAPES = [(3, 16, 48, False), (3, 48, 48, False), (3, 48, 48, True), (3, 96, 48, False),
                  (1, 48, 16, False), (3, 64, 48, False), (3, 192, 48, False), (3, 96, 48, True),
                  (3, 32, 32, False), (1, 16, 16, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", HIGHEST_SHAPES,
                         ids=["k{}_c{}_n{}_up{:d}".format(*s) for s in HIGHEST_SHAPES])
def test_conv_chain_highest_plan_mirror_equals_layer_plan(cuda, shape):
    """The CUDA source's plan of a 'highest' layer (rvdd_conv_layer_plan)
    equals its Python mirror, ws_plan: mode, tile rows, warpgroups,
    shared memory, slabs and weight stages."""
    check_plan_mirror(shape, "highest")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", HIGHEST_SHAPES,
                         ids=["k{}_c{}_n{}_up{:d}".format(*s) for s in HIGHEST_SHAPES])
def test_conv_chain_high_plan_mirror_equals_layer_plan(cuda, shape):
    """The same for a 'high' layer: two weight planes, so other layers than
    in the 'highest' mode keep their weights resident."""
    check_plan_mirror(shape, "high")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", HIGHEST_SHAPES,
                         ids=["k{}_c{}_n{}_up{:d}".format(*s) for s in HIGHEST_SHAPES])
def test_conv_chain_w32_plan_mirror_equals_layer_plan(cuda, shape):
    """The same for a 'w32' layer: three weight planes beside 4-row bf16
    tiles."""
    check_plan_mirror(shape, "w32")


def check_plan_mirror(shape, mode):
    ks, cin, n, up = shape
    layer = SimpleNamespace(ks=ks, cin0=cin, cin0_pad=cin, aux_c=0, cout_pad=n, split=False)
    want = ws_plan(ks, cin, n, mode, up)
    assert layer_plan(layer, mode, upsample=up) == {
        k: want[k] for k in ("mode", "trw", "nwg", "smem", "slabs", "stages")}


#: max error over max|out| and mean error over std that a chain on the
#: warp-specialized body is held to against its plain version (the bounds
#: of test_conv_chain_fp32_kernel_matches_plain,
#: test_conv_chain_highest_kernel_matches_plain and
#: test_conv_chain_w32_kernel_matches_plain)
FP32_LIMITS = {"high": (2.0 ** -12, 1e-4), "highest": (2.0 ** -14, 1e-5),
               "w32": (2.0 ** -6, W32_MEAN)}


def check_fp32_kernel(device, name, h, w, batch, mode, n_cta=None, seed=15):
    """A FP32_CARD_CASES chain through the warp-specialized kernel in
    ``mode`` against its plain version at that size, grid capped at
    ``n_cta`` CTAs: one launch a layer, finite outputs within the mode's
    FP32_LIMITS (inputs of the chain's band dtype: fp32, or bf16 values in
    'w32')."""
    case = FP32_CARD_CASES[name]
    x, aux, ws, bs = make_case(case, seed=seed, h=h, w=w, batch=batch, fp32=mode != "w32")
    before = conv_chain.mode_launches[mode]
    got = run_port(case, x, aux, ws, bs, device, mode=mode, n_cta=n_cta)
    assert conv_chain.mode_launches[mode] - before == len(case["ks"])
    want = run_port(case, x, aux, ws, bs, device, plain=True, mode=mode)
    max_rel, mean_rel = FP32_LIMITS[mode]
    for g, wv in zip(got, want):
        assert g.shape == wv.shape and g.shape[0] == batch
        assert np.isfinite(g).all()
        err = float(np.max(np.abs(g - wv)))
        assert err <= max_rel * float(np.max(np.abs(wv))), (name, h, w, batch, n_cta, err)
        assert np.mean(np.abs(g - wv)) < mean_rel * np.std(wv), (name, h, w, batch, n_cta)


#: (rows, columns, batch): an image shorter than a tile (2 rows where the
#: chain pools or upsamples), widths that are not multiples of 64
HIGHEST_EDGES = [(1, 40, 1), (4, 100, 2), (6, 130, 1)]


def _edge_shape(name, shape):
    h, w, batch = shape
    case = FP32_CARD_CASES[name]
    if h % 2 and (case.get("upsample") or case.get("pool")):
        h += 1
    return h, w, batch


@pytest.mark.gpu
@pytest.mark.parametrize("shape", HIGHEST_EDGES, ids=["x".join(map(str, s)) for s in HIGHEST_EDGES])
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_highest_kernel_ragged_edges(cuda, name, shape):
    """The warp-specialized 'highest' body at the edges of its tiles: an
    image shorter than one 2-row tile, widths of 40, 100 and 130 columns
    (a partial 64-column tile, its halo past the image), batch 2."""
    check_fp32_kernel(cuda, name, *_edge_shape(name, shape), "highest")


@pytest.mark.gpu
@pytest.mark.parametrize("n_cta", [1, 5])
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_highest_kernel_small_grid(cuda, name, n_cta):
    """Grids of 1 and 5 persistent CTAs walk 88 tiles each launch, so the
    producer wraps both tile regions and every weight stage many times
    (ws_tiles is the schedule)."""
    check_fp32_kernel(cuda, name, 22, 200, 2, "highest", n_cta=n_cta)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", HIGHEST_EDGES, ids=["x".join(map(str, s)) for s in HIGHEST_EDGES])
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_high_kernel_ragged_edges(cuda, name, shape):
    """The warp-specialized body in the 'high' mode (two planes, three
    products a k-step) at the edges of its tiles, as
    test_conv_chain_highest_kernel_ragged_edges, within the 'high' limits
    of test_conv_chain_fp32_kernel_matches_plain."""
    check_fp32_kernel(cuda, name, *_edge_shape(name, shape), "high", seed=16)


@pytest.mark.gpu
@pytest.mark.parametrize("n_cta", [1, 5])
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_high_kernel_small_grid(cuda, name, n_cta):
    """The 'high' mode on grids of 1 and 5 persistent CTAs (88 tiles each
    launch): the regions and the streamed layer's weight stages wrap many
    times."""
    check_fp32_kernel(cuda, name, 22, 200, 2, "high", n_cta=n_cta, seed=16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", HIGHEST_EDGES, ids=["x".join(map(str, s)) for s in HIGHEST_EDGES])
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_w32_kernel_ragged_edges(cuda, name, shape):
    """The warp-specialized body in the 'w32' mode (bf16 tile, three
    weight planes, 4-row tiles) at the edges of its tiles, as
    test_conv_chain_highest_kernel_ragged_edges, within the 'w32' limits of
    test_conv_chain_w32_kernel_matches_plain."""
    check_fp32_kernel(cuda, name, *_edge_shape(name, shape), "w32", seed=17)


@pytest.mark.gpu
@pytest.mark.parametrize("n_cta", [1, 5])
@pytest.mark.parametrize("name", list(FP32_CARD_CASES))
def test_conv_chain_w32_kernel_small_grid(cuda, name, n_cta):
    """The 'w32' mode on grids of 1 and 5 persistent CTAs (48 tiles each
    launch): the regions, the streamed layer's weight stages and the
    stores deferred under the next tile's products wrap many times."""
    check_fp32_kernel(cuda, name, 22, 200, 2, "w32", n_cta=n_cta, seed=17)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [8, 4], ids=["tma", "registers"])
def test_conv_chain_w32_aux_window_offsets(cuda, offset):
    """Chain A in 'w32' reading its 48 aux channels from a 56-channel bf16
    tensor: at offset 8 the window starts 16 bytes into a pixel, so the
    producer stages it with TMA; at offset 4 (8 bytes) TMA cannot take it
    and it goes through registers.  Both within the 'w32' limits."""
    case = dict(FP32_CARD_CASES["chain_A"], aux=(56, offset, 48))
    x, aux, ws, bs = make_case(case, seed=18, h=22, w=72, batch=2)
    got = run_port(case, x, aux, ws, bs, cuda, mode="w32")
    want = run_port(case, x, aux, ws, bs, cuda, plain=True, mode="w32")
    max_rel, mean_rel = FP32_LIMITS["w32"]
    for g, wv in zip(got, want):
        assert g.shape == wv.shape and np.isfinite(g).all()
        assert float(np.max(np.abs(g - wv))) <= max_rel * float(np.max(np.abs(wv))), offset
        assert np.mean(np.abs(g - wv)) < mean_rel * np.std(wv), offset


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["highest", "w32"])
def test_conv_chain_fp32_weight_modes_reject_wrong_dtype(cuda, mode):
    """A 'highest' chain takes fp32 only and a 'w32' chain bf16 only: the
    wrapper raises TypeError on the other dtype, for x and for aux, before
    any launch."""
    case = FP32_CARD_CASES["chain_A"]
    x, aux, ws, bs = make_case(case, fp32=True)
    chain = pack_chain([torch.from_numpy(a).to(cuda) for a in ws],
                       [torch.from_numpy(b).to(cuda) for b in bs],
                       case["acts"], case["ks"], **MODE_KW[mode])
    other = BF16 if chain.dtype == torch.float32 else torch.float32
    xt, at = torch.from_numpy(x).to(cuda), torch.from_numpy(aux).to(cuda)
    before = conv_chain.launches
    with pytest.raises(TypeError):
        conv_chain(xt.to(other), chain, aux=at.to(chain.dtype), aux_channels=(8, 48))
    with pytest.raises(TypeError):
        conv_chain(xt.to(chain.dtype), chain, aux=at.to(other), aux_channels=(8, 48))
    assert conv_chain.launches == before


# the main path's layer shapes: (ks, layer-0 input, aux, cout, split);
# K = ks^2 * (cin0_pad + aux) is 144, 432, 864 or 48
PACK_SHAPES = {
    "K144_six_channel_input": (3, 6, 0, 48, False),
    "K432": (3, 48, 0, 48, False),
    "K432_split": (3, 48, 0, 48, True),
    "K864_aux": (3, 48, 48, 48, False),
    "K48_head_N16": (1, 48, 0, 3, False),
    "K48_head_N16_split": (1, 48, 0, 3, True),
    "K144_N16": (3, 16, 0, 16, False),
}


@pytest.mark.parametrize("name", list(PACK_SHAPES))
def test_packed_weights_give_back_the_plain_matrix(name):
    """The kernel's copy of a layer's weights (``w_pack``, [K/8, N, 8]
    K-major, the lo half after the hi half) unpacks to exactly the OIHW
    matrix the plain version convolves with, and each 8 x 8 core matrix
    holds rows [8 kg, 8 kg + 8) of w_hi for 8 output channels."""
    ks, cin, aux_c, cout, split = PACK_SHAPES[name]
    rng = np.random.default_rng(11)
    w0 = torch.from_numpy(rng.standard_normal((ks, ks, cin, 48)).astype(np.float32))
    ws, bs, acts, kss, sp = [w0], [torch.zeros(48)], ["relu"], [ks], [False]
    if aux_c:  # the layer under test reads layer 0's output and the aux channels
        ws.append(torch.from_numpy(rng.standard_normal((ks, ks, 48 + aux_c, cout)).astype(np.float32)))
        bs.append(torch.zeros(cout))
        acts.append("relu")
        kss.append(ks)
        sp.append(split)
    else:
        ws[0] = torch.from_numpy(rng.standard_normal((ks, ks, cin, cout)).astype(np.float32))
        bs[0], sp[0] = torch.zeros(cout), split
    layer = pack_chain(ws, bs, acts, kss, weight_split=sp).layers[-1]
    k = ks * ks * (layer.cin0_pad + layer.aux_c)
    assert layer.w_pack.dtype == BF16
    assert tuple(layer.w_pack.shape) == ((2 if split else 1) * k // 8, layer.cout_pad, 8)
    assert torch.equal(layer_weight_from_pack(layer), layer.w_plain)
    hi = unpack_kmajor(layer.w_pack[:k // 8])
    assert torch.equal(hi, layer.w_hi)
    assert torch.equal(layer.w_pack[1, 2], layer.w_hi[8:16, 2])
    if split:
        assert torch.equal(unpack_kmajor(layer.w_pack[k // 8:]), layer.w_lo)


def test_pack_kmajor_round_trip():
    m = torch.arange(48 * 16, dtype=torch.float32).reshape(48, 16)
    p = pack_kmajor(m)
    assert tuple(p.shape) == (6, 16, 8)
    assert torch.equal(p[2, 5], m[16:24, 5])
    assert torch.equal(unpack_kmajor(p), m)
    with pytest.raises(ValueError):
        pack_kmajor(m[:12])


@pytest.mark.gpu
@pytest.mark.parametrize("cout", [48, 3])
def test_conv_chain_kernel_1x1_is_a_plain_gemm(cuda, cout):
    """A lone 1x1 layer is a plain GEMM [pixels, 48] @ [48, cout]: the
    check that the wgmma descriptors (LBO, SBO) read the K-major operands
    as packed.  N = 48, and N = 16 for the 3-channel head."""
    case = dict(h=20, w=72, chans=(48, cout), acts=("none",), ks=(1,))
    x, aux, ws, bs = make_case(case, seed=7)
    got = run_port(case, x, aux, ws, bs, cuda)[0]
    want = run_port(case, x, aux, ws, bs, cuda, plain=True)[0]
    assert np.max(np.abs(got - want)) <= 2.0 ** -7 * np.max(np.abs(want))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [72, 200])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_conv_chain_kernel_ragged_batch2(cuda, name, w):
    """Every card case at widths that are not multiples of the 64-column
    tile, 22 or 26 rows (not multiples of the 2- or 4-row tile), batch 2;
    the bound of test_conv_chain_kernel_matches_plain."""
    case = CARD_CASES[name]
    h = 22 if w == 72 else 26
    x, aux, ws, bs = make_case(case, seed=2, h=h, w=w, batch=2)
    got = run_port(case, x, aux, ws, bs, cuda)
    want = run_port(case, x, aux, ws, bs, cuda, plain=True)
    for g, wv in zip(got, want):
        assert g.shape == wv.shape and g.shape[0] == 2
        assert np.isfinite(g).all()
        err = float(np.max(np.abs(g - wv)))
        assert err <= 2.0 ** -6 * float(np.max(np.abs(wv))), (name, w, err)
        assert np.mean(np.abs(g - wv)) < 1e-3 * np.std(wv), (name, w)


@pytest.mark.gpu
def test_conv_chain_kernel_rejects_bad_input(cuda):
    case = CASES["single"]
    x, _, ws, bs = make_case(case)
    chain = pack_chain([torch.from_numpy(ws[0]).to(cuda)], [torch.from_numpy(bs[0]).to(cuda)],
                       case["acts"], case["ks"])
    xt = torch.from_numpy(x).to(cuda)
    with pytest.raises(TypeError):
        conv_chain(xt, chain)  # fp32, not bf16
    with pytest.raises(ValueError):
        conv_chain(xt.to(BF16).transpose(1, 2), chain)  # not contiguous


# ------------------------------------------------------------------ warp


def _flow(h, w, kind):
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "zero":
        fl = np.zeros((h, w, 2))
    elif kind == "constant":
        fl = np.stack([np.full((h, w), 7.3), np.full((h, w), -2.6)], -1)
    elif kind == "smooth":
        fl = np.stack([3.0 + 1.5 * np.sin(xx / 40), -2.0 + np.cos(yy / 10)], -1)
    elif kind == "border":
        fl = np.stack([np.full((h, w), -14.0), np.full((h, w), 12.0)], -1)
    else:  # displacements far beyond the TPU kernel's +-48 clamp
        fl = np.stack([90.0 * np.sin(xx / 7 + yy / 5), -75.0 * np.cos(yy / 3)], -1)
    return fl.astype(np.float32)[None]


@pytest.mark.parametrize("kind,c", [("zero", 8), ("constant", 8), ("smooth", 8),
                                    ("border", 8), ("smooth", 16)])
def test_warp_plain_matches_warp_planar_pallas(tpu, kind, c):
    """Within the TPU kernel's limits (|flow| <= max_disp=16 here, residuals
    inside its bands) both compute the same bicubic sum on the same
    bf16-valued input; tolerance 2e-5 for the order of the 16 fp32 products
    and sums (values up to ~1.2, tap weights up to ~1.1)."""
    jnp = tpu.jnp
    h, w = 24, 100
    rng = np.random.default_rng(0)
    x = _bf16(rng.uniform(-1, 1, (1, h, w, c)))
    fl = _flow(h, w, kind)
    got = warp_bicubic_plain(torch.from_numpy(x), torch.from_numpy(fl),
                             out_dtype=torch.float32).numpy()
    wl = -(-(w + 1) // 128) * 128
    want = tpu.warp.warp_planar_pallas(
        _planar(jnp, x, wl), jnp.asarray(fl[0]), h_img=h, w_img=w,
        max_disp=16, tile_h=8, out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got, _unplanar(want, h, w), atol=2e-5)


def test_warp_wrapper_runs_plain_on_cpu():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 9, 13, 5)).astype(np.float32))
    fl = torch.from_numpy(_flow(9, 13, "smooth"))
    before = warp_bicubic.launches
    got = warp_bicubic(x, fl, out_dtype=torch.float32)
    assert warp_bicubic.launches == before
    torch.testing.assert_close(got, warp_bicubic_plain(x, fl, torch.float32), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("c,in_dtype,out_dtype,kind", [
    (56, torch.float32, BF16, "smooth"),
    (56, torch.float32, torch.float32, "large"),
    (3, BF16, torch.float32, "border"),
    (8, BF16, BF16, "large"),
])
def test_warp_kernel_matches_plain(cuda, c, in_dtype, out_dtype, kind):
    """fp32 output: 1e-5 (fp32 FMA order).  bf16 output: 1e-2, one bf16 ulp
    for |value| < 2 (the two sides may round to neighbouring bf16 values)."""
    h, w = 37, 70
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, h, w, c)).astype(np.float32)).to(cuda)
    x = x.to(in_dtype)
    fl = torch.from_numpy(np.concatenate([_flow(h, w, kind), -_flow(h, w, kind)])).to(cuda)
    before = warp_bicubic.launches
    got = warp_bicubic(x, fl, out_dtype=out_dtype)
    assert warp_bicubic.launches == before + 1
    want = warp_bicubic_plain(x, fl, out_dtype=torch.float32)
    tol = 1e-5 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.gpu
def test_warp_kernel_rejects_bad_input(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    fl = torch.zeros(1, 8, 8, 2, device=cuda)
    with pytest.raises(TypeError):
        warp_bicubic(x.half(), fl)
    with pytest.raises(ValueError):
        warp_bicubic(x, fl[:, :4])
    with pytest.raises(ValueError):
        warp_bicubic(x.transpose(1, 2), fl)


# ------------------------------------------------------- fused engine step


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2])
def test_fused_steps_on_card_match_plain_versions(cuda, batch):
    """Two fused engine steps (state carried) with the CUDA kernels against
    the same steps on the CPU, where the wrappers run their plain versions.
    Fed the same inputs, each chain agrees with its plain version to a mean
    of ~1e-5 of std (the chain tests above hold that).  Over 21 layers,
    though, the rare band-rounding flips that fp32 sums taken in another
    order cause feed the next roundings.  Two bf16 runs of the whole net
    then differ by about as much as either differs from fp32, so the bound
    is the fast path's envelope against fp32: normalized max error < 0.2 at
    step 1 and < 0.3 at step 2."""
    from rvdd_tpu_torch.models import build_network
    from rvdd_tpu_torch.recurrent import engine

    h, w = 48, 64
    rng = np.random.default_rng(6)
    frames = torch.from_numpy(rng.uniform(-1, 1, (batch, 2, h, w, 3)).astype(np.float32))
    yy, xx = np.mgrid[0:h, 0:w]
    fl = np.stack([2.5 + np.sin(xx / 9), -1.5 + np.cos(yy / 7)], -1)
    flows = torch.from_numpy(np.stack([fl, -fl])[:batch, None].astype(np.float32))
    cfg = engine.EngineConfig(feature_rec=True, net_impl="fused")
    outs = {}
    for dev in ("cpu", cuda):
        net = build_network("convunet-mode=fixedfeatures+feat", 6, 3, seed=2, device=dev)
        d1, s = engine.inference_step(cfg, net, None, frames.to(dev), flows.to(dev))
        d2, _ = engine.inference_step(cfg, net, s, frames.to(dev), flows.to(dev))
        outs[str(dev)] = (d1.cpu().numpy(), d2.cpu().numpy())
    for got, want, lim in zip(outs["cuda"], outs["cpu"], (0.2, 0.3)):
        assert np.isfinite(got).all()
        assert _norm_err(got, want) < lim, _norm_err(got, want)
