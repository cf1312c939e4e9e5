"""conv_chain's 'high' mode on the CPU: the mirrors of the warp-specialized
body's launch plan (ops/cuda/conv_chain.py:ws_plan) for every 'high' layer
the main paths run, and of its persistent tile schedule (ws_tiles) at the
resolutions of those chains.

The 'high' mode runs the warp-specialized body of the 'highest' mode with
two bf16 planes (hi, lo) of weights and of the split tile, so its plan has
other budgets.  The kernel itself runs only on the card;
tests/test_torch_kernels.py holds its plan against these mirrors there
(``gpu`` marker) and its outputs against the plain version.
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

#: the tile rows of the 'high' mode
ROWS = ws_rows("high")

#: the packings with 'high' chains: convunet+feat+future's 'auto'
#: (hybrid:glue+A+dec2: chains A and dec2) and the 'mixed' preset of both
#: ConvUNet models (all six chains)
PACKINGS = [("convunet+feat+future", "auto"), ("convunet+feat", "mixed"),
            ("convunet+feat+future", "mixed")]


def _high_layers(model, precision):
    """(chain, layer index, ks, cin_tot, cout_pad, upsample) of every layer
    of the packing's 'high' chains (the decoders' first layers read an
    upsampled input)."""
    _, _, packed = make_model("fused", seed=0, device="cpu", model=model, precision=precision)
    return [(name, i, layer.ks, layer.cin0_pad + layer.aux_c, layer.cout_pad,
             name.startswith("dec") and i == 0)
            for name in CHAINS if packed[name].mode == "high"
            for i, layer in enumerate(packed[name].layers)]


@pytest.fixture(scope="module")
def layers():
    return {p: _high_layers(*p) for p in PACKINGS}


def test_auto_runs_high_in_chains_a_and_dec2(layers):
    """'auto' of convunet+feat+future packs chains A and dec2 (9 launches)
    in the 'high' mode, 'mixed' every chain (21 launches)."""
    auto = layers[("convunet+feat+future", "auto")]
    assert sorted({name for name, *_ in auto}) == ["A", "dec2"] and len(auto) == 9
    assert all(len(layers[p]) == 21 for p in PACKINGS[1:])


@pytest.mark.parametrize("packing", PACKINGS, ids=["-".join(p) for p in PACKINGS])
def test_high_plan_fits_shared_memory(layers, packing):
    """Every 'high' layer's plan fits the 232,448 bytes a block may have,
    its size is the end of its mbarriers, and it runs the warp-specialized
    CTA of 2-row tiles."""
    for name, i, ks, cin, n, up in layers[packing]:
        p = ws_plan(ks, cin, n, "high", up)
        (o, b) = p["layout"]["barriers"]
        assert p["smem"] == p["layout"]["total"] == o + b <= SMEM_MAX, (name, i, p)
        assert p["trw"] == ROWS and p["nwg"] == 3 and p["mode"].startswith("high ")


@pytest.mark.parametrize("packing", PACKINGS, ids=["-".join(p) for p in PACKINGS])
def test_high_plan_buffers_are_disjoint(layers, packing):
    """The weights (or the weight stages), the tile regions, an upsample
    layer's source windows and the mbarriers do not overlap and start
    128-byte aligned; the weights are two bf16 planes (hi, lo), a region
    holds a slab of the tile's fp32 input with its halo, a window the
    half-res rows and columns a tile reads."""
    for name, i, ks, cin, n, up in layers[packing]:
        p = ws_plan(ks, cin, n, "high", up)
        lay = p["layout"]
        spans = sorted([lay["weights"], *lay["regions"], *lay["windows"], lay["barriers"]])
        for (o0, b0), (o1, _) in zip(spans, spans[1:]):
            assert o0 + b0 <= o1, (name, i, spans)
        assert all(o % 128 == 0 for o, _ in spans)
        halo = ks // 2
        assert lay["slab_c"] * p["slabs"] == cin
        region = lay["slab_c"] // 8 * (ROWS + 2 * halo) * (WS_COLS + 2 * halo) * 32
        assert all(b >= region for _, b in lay["regions"])
        assert all(b == ws_src_rows(ROWS) * WS_SRC_COLS * cin * 4 for _, b in lay["windows"])
        if p["stages"]:
            assert lay["weights"][1] == WS_STAGES * lay["stage"] == \
                WS_STAGES * lay["slab_c"] * n * 2 * 2
        else:
            assert lay["weights"][1] == ks * ks * cin * n * 2 * 2


@pytest.mark.parametrize("packing", PACKINGS, ids=["-".join(p) for p in PACKINGS])
def test_high_plan_forms_of_the_main_path(layers, packing):
    """A K = 432 layer keeps its two weight planes (82,944 bytes) resident
    beside two 2-row fp32 tiles (50,688 bytes each): 184,448 bytes.  A
    decoder's upsampled K = 432 layer keeps them beside one tile and two
    20,736-byte windows of its half-res input: 175,232.  A K = 864 layer
    (48 + 48 aux channels, 165,888 bytes of weights) streams them a tap of
    a 48-channel slab at a time through four 9,216-byte stages beside two
    48-channel slabs: 138,368.  The K = 144 and 1x1 layers are resident."""
    seen = set()
    for name, i, ks, cin, n, up in layers[packing]:
        p, k = ws_plan(ks, cin, n, "high", up), ks * ks * cin
        lay = p["layout"]
        seen.add((k, up))
        if k == 864:
            assert p["mode"] == "high streamed" and p["slabs"] == 2
            assert p["stages"] == WS_STAGES and lay["stage"] == 9216
            assert p["smem"] == 138368
            continue
        assert p["slabs"] == 1 and p["stages"] == 0
        if up:
            assert p["mode"] == "high upsample" and len(lay["regions"]) == 1
            assert [b for _, b in lay["windows"]] == [20736, 20736] and p["smem"] == 175232
            continue
        assert p["mode"] == "high resident"
        if k == 432:
            assert lay["weights"] == (0, 82944)
            assert [b for _, b in lay["regions"]] == [50688, 50688] and p["smem"] == 184448
    assert {(144, False), (432, True), (864, False), (48, False)} <= seen


def test_high_plan_budgets_beside_highest():
    """Two planes where 'highest' has three: the same forms, the resident
    weights and a weight stage each smaller by a third, and the same
    fallbacks where nothing is resident (a 64-channel layer streams in two
    slabs in both modes)."""
    for ks, cin, n, up in [(3, 48, 48, False), (3, 48, 48, True), (3, 96, 48, False),
                           (3, 16, 48, False), (1, 48, 16, False)]:
        high, highest = ws_plan(ks, cin, n, "high", up), ws_plan(ks, cin, n, "highest", up)
        assert high["mode"].split()[1] == highest["mode"].split()[1]
        w2, w3 = high["layout"]["weights"][1], highest["layout"]["weights"][1]
        assert 3 * w2 == 2 * w3 and high["smem"] < highest["smem"]
    assert ws_layout(3, 64, 48, "high", "resident", 1)["total"] > SMEM_MAX
    assert ws_plan(3, 64, 48, "high")["mode"] == "high streamed"
    assert ws_plan(3, 64, 48, "high")["slabs"] == 2


#: (batch, height, width): the 'high' chains at 1080p (A and dec2 at full
#: resolution, B and dec1 at half, C and dec0 at a quarter under 'mixed')
#: and ragged sizes
RESOLUTIONS = [(1, 1080, 1920), (1, 540, 960), (1, 270, 480), (2, 22, 72), (1, 1, 40),
               (2, 7, 130)]


@pytest.mark.parametrize("n_cta", [1, 5, 132])
@pytest.mark.parametrize("res", RESOLUTIONS, ids=["x".join(map(str, r)) for r in RESOLUTIONS])
def test_high_tiles_cover_every_tile_once_in_order(res, n_cta):
    """Every tile of a 'high' layer is taken by exactly one CTA, each CTA's
    tiles ascend, and no CTA is left without a tile."""
    b, h, w = res
    runs = ws_tiles(b, h, w, ROWS, n_cta)
    n = b * -(-h // ROWS) * -(-w // WS_COLS)
    assert len(runs) == min(n, n_cta)
    assert sorted(t for r in runs for t in r) == list(range(n))
    assert all(r and r == sorted(r) for r in runs)


@pytest.mark.parametrize("res", RESOLUTIONS, ids=["x".join(map(str, r)) for r in RESOLUTIONS])
def test_high_tiles_are_balanced(res):
    """On the H100's 132 SMs no CTA takes more than one tile above another."""
    counts = [len(r) for r in ws_tiles(*res, ROWS)]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("form", [0, 1, 2], ids=["resident", "streamed", "upsample"])
def test_bench_profile_groups_the_high_kernel(form):
    """`bench --profile` counts the warp-specialized body's 'high' launches
    (ws_layer_kernel<N, form, HighNum>) under the conv_chain group."""
    symbol = (f"void (anonymous namespace)::ws::ws_layer_kernel<48, {form}, "
              "(anonymous namespace)::ws::HighNum>("
              "(anonymous namespace)::LayerArgs, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
              "int, int, int)")
    assert _kernel_group(symbol, in_solver=False) == "conv_chain (CUDA)"
