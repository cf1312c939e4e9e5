"""conv_chain's 'w32' mode on the CPU: the mirrors of the warp-specialized
body's launch plan (ops/cuda/conv_chain.py:ws_plan) for every layer of
ConvUNet's 'wf32' packing, and of its persistent tile schedule (ws_tiles)
at the resolutions of those chains.

The 'w32' mode (bf16 bands, fp32 weights as three bf16 planes) runs the
warp-specialized body of the 'high' and 'highest' modes with bf16 tiles
of 4 rows, so its plan has other budgets.  The kernel itself runs only on
the card; tests/test_torch_kernels.py holds its plan against these mirrors
there (``gpu`` marker) and its outputs against the plain version.
"""

import pytest

torch = pytest.importorskip("torch")

from rvdd_tpu_torch.bench import _kernel_group, make_model  # noqa: E402
from rvdd_tpu_torch.models.fast_unet import CHAINS  # noqa: E402
from rvdd_tpu_torch.ops.cuda.conv_chain import (  # noqa: E402
    SMEM_MAX,
    WS_COLS,
    WS_SRC_COLS,
    WS_STAGES,
    ws_layout,
    ws_plan,
    ws_rows,
    ws_src_rows,
    ws_tiles,
)

#: the tile rows of the 'w32' mode
ROWS = ws_rows("w32")
#: the packings with 'w32' chains: the 'wf32' preset of both ConvUNet models
PACKINGS = [("convunet+feat", "wf32"), ("convunet+feat+future", "wf32")]


def _w32_layers(model, precision):
    """(chain, layer index, ks, cin_tot, cout_pad, upsample) of every layer
    of the packing's 'w32' chains (the decoders' first layers read an
    upsampled input)."""
    _, _, packed = make_model("fused", seed=0, device="cpu", model=model, precision=precision)
    return [(name, i, layer.ks, layer.cin0_pad + layer.aux_c, layer.cout_pad,
             name.startswith("dec") and i == 0)
            for name in CHAINS if packed[name].mode == "w32"
            for i, layer in enumerate(packed[name].layers)]


@pytest.fixture(scope="module")
def layers():
    return {p: _w32_layers(*p) for p in PACKINGS}


def test_wf32_runs_every_chain_in_w32(layers):
    """'wf32' packs all six chains of both models in the 'w32' mode: 21
    launches a frame."""
    for p in PACKINGS:
        assert sorted({name for name, *_ in layers[p]}) == sorted(CHAINS)
        assert len(layers[p]) == 21


@pytest.mark.parametrize("packing", PACKINGS, ids=["-".join(p) for p in PACKINGS])
def test_w32_plan_fits_shared_memory(layers, packing):
    """Every 'w32' layer's plan fits the 232,448 bytes a block may have,
    its size is the end of its mbarriers, and it runs the warp-specialized
    CTA of 4-row tiles."""
    for name, i, ks, cin, n, up in layers[packing]:
        p = ws_plan(ks, cin, n, "w32", up)
        (o, b) = p["layout"]["barriers"]
        assert p["smem"] == p["layout"]["total"] == o + b <= SMEM_MAX, (name, i, p)
        assert p["trw"] == ROWS == 4 and p["nwg"] == 3 and p["mode"].startswith("w32 ")


@pytest.mark.parametrize("packing", PACKINGS, ids=["-".join(p) for p in PACKINGS])
def test_w32_plan_buffers_are_disjoint(layers, packing):
    """The weights (or the weight stages), the tile regions, an upsample
    layer's source windows, the consumers' staged bands and the mbarriers
    do not overlap and start 128-byte aligned; the weights are three bf16
    planes (hi, mid, lo), a region holds a slab of the tile's bf16 input
    with its halo, one TMA box of rows x columns x 16 bytes an 8-channel
    group, each box at a 128-byte boundary; a window holds the half-res
    rows and columns a tile reads; a staged band a consumer's 4 x 32
    pixels of bf16 outputs, the box of its TMA store."""
    for name, i, ks, cin, n, up in layers[packing]:
        p = ws_plan(ks, cin, n, "w32", up)
        lay = p["layout"]
        spans = sorted([lay["weights"], *lay["regions"], *lay["windows"], *lay["bands"],
                        lay["barriers"]])
        for (o0, b0), (o1, _) in zip(spans, spans[1:]):
            assert o0 + b0 <= o1, (name, i, spans)
        assert all(o % 128 == 0 for o, _ in spans)
        halo = ks // 2
        box = (ROWS + 2 * halo) * (WS_COLS + 2 * halo) * 16
        plane = -(-box // 128) * 128
        assert lay["slab_c"] * p["slabs"] == cin
        assert all(b == lay["slab_c"] // 8 * plane for _, b in lay["regions"])
        assert all(b == ws_src_rows(ROWS) * WS_SRC_COLS * cin * 2 for _, b in lay["windows"])
        assert [b for _, b in lay["bands"]] == [ROWS * WS_COLS // 2 * n * 2] * 2
        if p["stages"]:
            assert lay["weights"][1] == WS_STAGES * lay["stage"] == \
                WS_STAGES * lay["slab_c"] * n * 2 * 3
        else:
            assert lay["weights"][1] == ks * ks * cin * n * 2 * 3


@pytest.mark.parametrize("packing", PACKINGS, ids=["-".join(p) for p in PACKINGS])
def test_w32_plan_forms_of_the_main_path(layers, packing):
    """A K = 432 layer keeps its three weight planes (124,416 bytes)
    resident beside two 4-row bf16 tiles (38,400 bytes each) and the two
    consumers' staged bands (12,288 each): 225,920 bytes.  A decoder's
    upsampled K = 432 layer keeps them beside one tile and two 13,824-byte
    windows of its half-res input (4 rows of 36 columns): 215,168.  A K =
    864 layer (48 + 48 aux channels, 248,832 bytes of weights) streams them
    a tap of a 48-channel slab at a time through four 13,824-byte stages
    beside two 48-channel slabs: 156,800.  The K = 144 first layer (9
    channels, padded to 16) and the 1x1 head are resident."""
    seen = set()
    for name, i, ks, cin, n, up in layers[packing]:
        p, k = ws_plan(ks, cin, n, "w32", up), ks * ks * cin
        lay = p["layout"]
        seen.add((k, up))
        if k == 864:
            assert p["mode"] == "w32 streamed" and p["slabs"] == 2
            assert p["stages"] == WS_STAGES and lay["stage"] == 13824
            assert p["smem"] == 156800
            continue
        assert p["slabs"] == 1 and p["stages"] == 0
        if up:
            assert p["mode"] == "w32 upsample" and len(lay["regions"]) == 1
            assert [b for _, b in lay["windows"]] == [13824, 13824] and p["smem"] == 215168
            continue
        assert p["mode"] == "w32 resident"
        if k == 432:
            assert lay["weights"] == (0, 124416)
            assert [b for _, b in lay["regions"]] == [38400, 38400] and p["smem"] == 225920
        if k == 144:
            assert lay["weights"] == (0, 41472) and p["smem"] == 91776
    assert {(144, False), (432, True), (864, False), (48, False), (432, False)} <= seen


def test_w32_k864_weight_bytes_a_pixel():
    """Every tile of a streamed layer reads the layer's weights from L2
    once: 248,832 bytes over a 4 x 64 tile are 972 bytes a pixel, as the
    serial body's 4-row tiles read; 2-row tiles would read twice that."""
    p = ws_plan(3, 96, 48, "w32")
    wbytes = 9 * 96 * 48 * 2 * 3
    assert p["mode"] == "w32 streamed" and wbytes // (p["trw"] * WS_COLS) == 972
    assert p["layout"]["stage"] * p["slabs"] * 9 == wbytes


def test_w32_plan_budgets_beside_highest():
    """The weights of 'w32' and 'highest' are the same three planes; a
    4-row bf16 tile takes fewer bytes than a 2-row fp32 one where it has a
    halo (38,400 against 50,688 for 48 channels) and as many without one
    (a 1x1 layer), so beside the staged bands the same forms fit, and a
    64-channel layer streams in two slabs in both modes."""
    for ks, cin, n, up in [(3, 48, 48, False), (3, 48, 48, True), (3, 96, 48, False),
                           (3, 16, 48, False), (1, 48, 16, False)]:
        w32, highest = ws_plan(ks, cin, n, "w32", up), ws_plan(ks, cin, n, "highest", up)
        assert w32["mode"].split()[1] == highest["mode"].split()[1]
        assert w32["layout"]["weights"] == highest["layout"]["weights"]
        assert w32["layout"]["regions"][0][1] <= highest["layout"]["regions"][0][1]
    assert ws_layout(3, 64, 48, "w32", "resident", 1)["total"] > SMEM_MAX
    assert ws_plan(3, 64, 48, "w32")["mode"] == "w32 streamed"
    assert ws_plan(3, 64, 48, "w32")["slabs"] == 2


#: (batch, height, width): the 'w32' chains at 1080p (A and dec2 at full
#: resolution, B and dec1 at half, C and dec0 at a quarter) and ragged
#: sizes (shorter than a tile, widths that are not multiples of 64)
RESOLUTIONS = [(1, 1080, 1920), (1, 540, 960), (1, 270, 480), (2, 22, 72), (1, 1, 40),
               (2, 7, 130)]


@pytest.mark.parametrize("n_cta", [1, 5, 132])
@pytest.mark.parametrize("res", RESOLUTIONS, ids=["x".join(map(str, r)) for r in RESOLUTIONS])
def test_w32_tiles_cover_every_tile_once_in_order(res, n_cta):
    """Every 4-row tile of a 'w32' layer is taken by exactly one CTA, each
    CTA's tiles ascend, and no CTA is left without a tile."""
    b, h, w = res
    runs = ws_tiles(b, h, w, ROWS, n_cta)
    n = b * -(-h // ROWS) * -(-w // WS_COLS)
    assert len(runs) == min(n, n_cta)
    assert sorted(t for r in runs for t in r) == list(range(n))
    assert all(r and r == sorted(r) for r in runs)


@pytest.mark.parametrize("res", RESOLUTIONS, ids=["x".join(map(str, r)) for r in RESOLUTIONS])
def test_w32_tiles_are_balanced(res):
    """On the H100's 132 SMs no CTA takes more than one tile above another
    (8,100 tiles at 1080p: 61 or 62 each)."""
    counts = [len(r) for r in ws_tiles(*res, ROWS)]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("form", [0, 1, 2], ids=["resident", "streamed", "upsample"])
def test_bench_profile_groups_the_w32_kernel(form):
    """`bench --profile` counts the warp-specialized body's 'w32' launches
    (ws_layer_kernel<N, form, W32Num>) under the conv_chain group."""
    symbol = (f"void (anonymous namespace)::ws::ws_layer_kernel<48, {form}, "
              "(anonymous namespace)::ws::W32Num>("
              "(anonymous namespace)::LayerArgs, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
              "int, int, int)")
    assert _kernel_group(symbol, in_solver=False) == "conv_chain (CUDA)"
