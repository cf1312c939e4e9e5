"""conv_chain's 'highest' body on the CPU: the mirrors of its launch plan
(ops/cuda/conv_chain.py:ws_plan, the shared memory of each layer the
main path runs) and of its persistent tile schedule (ws_tiles).

The kernel itself runs only on the card; tests/test_torch_kernels.py holds
its plan against these mirrors there (``gpu`` marker) and its outputs
against the plain version.
"""

import itertools

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

#: the tile rows of the 'highest' mode
ROWS = ws_rows("highest")

#: the packings whose layers the 'highest' body's plan must hold: the
#: 'accurate' and 'wf32' presets of both ConvUNet models (the same layer
#: shapes run in the 'highest' and 'w32' modes)
PACKINGS = list(itertools.product(("convunet+feat", "convunet+feat+future"), ("accurate", "wf32")))


def _layer_shapes(model, precision):
    """(chain, layer index, ks, cin_tot, cout_pad, upsample) of every layer
    of the packing's six chains (the decoders' first layers read an
    upsampled input)."""
    _, _, packed = make_model("fused", seed=0, device="cpu", model=model, precision=precision)
    return [(name, i, layer.ks, layer.cin0_pad + layer.aux_c, layer.cout_pad,
             name.startswith("dec") and i == 0)
            for name in CHAINS for i, layer in enumerate(packed[name].layers)]


@pytest.fixture(scope="module")
def shapes():
    return {p: _layer_shapes(*p) for p in PACKINGS}


@pytest.mark.parametrize("packing", PACKINGS, ids=["-".join(p) for p in PACKINGS])
def test_highest_plan_fits_shared_memory(shapes, packing):
    """Every layer's plan fits the 232,448 bytes a block may have, and its
    size is the end of its mbarriers."""
    for name, i, ks, cin, n, up in shapes[packing]:
        p = ws_plan(ks, cin, n, "highest", up)
        (o, b) = p["layout"]["barriers"]
        assert p["smem"] == p["layout"]["total"] == o + b <= SMEM_MAX, (name, i, p)
        assert p["trw"] == ROWS and p["nwg"] == 3


@pytest.mark.parametrize("packing", PACKINGS, ids=["-".join(p) for p in PACKINGS])
def test_highest_plan_buffers_are_disjoint(shapes, packing):
    """The weights (or the weight stages), the tile regions, an upsample
    layer's source windows and the mbarriers do not overlap and start
    128-byte aligned (as TMA wants its boxes); a region holds a slab of the
    tile's fp32 input with its halo, a window the half-res rows and columns
    a tile reads, and the stages a tap of a slab in three planes."""
    for name, i, ks, cin, n, up in shapes[packing]:
        p = ws_plan(ks, cin, n, "highest", up)
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
                WS_STAGES * lay["slab_c"] * n * 2 * 3
        else:
            assert lay["weights"][1] == ks * ks * cin * n * 2 * 3


@pytest.mark.parametrize("packing", PACKINGS, ids=["-".join(p) for p in PACKINGS])
def test_highest_plan_k432_has_two_tile_buffers(shapes, packing):
    """A K = 432 layer keeps its three weight planes (124,416 bytes)
    resident beside two 2-row fp32 tiles (50,688 bytes each), so the
    producer stages one while the consumers read the other; a decoder's
    upsampled K = 432 layer beside one tile and two 20,736-byte windows of
    its half-res input, which the producer fetches a tile ahead and
    interpolates; a K = 864 layer (48 + 48 aux channels) streams its
    weights in two 48-channel slabs; the K = 144 and 1x1 layers are
    resident too."""
    seen = set()
    for name, i, ks, cin, n, up in shapes[packing]:
        p, k = ws_plan(ks, cin, n, "highest", up), ks * ks * cin
        seen.add((k, up))
        if k == 864:
            assert p["mode"] == "highest streamed" and p["slabs"] == 2
            assert p["stages"] == WS_STAGES
            continue
        assert p["slabs"] == 1 and p["stages"] == 0
        if up:
            assert p["mode"] == "highest upsample" and len(p["layout"]["regions"]) == 1
            assert [b for _, b in p["layout"]["windows"]] == [20736, 20736]
            continue
        assert p["mode"] == "highest resident"
        if k == 432:
            assert p["layout"]["weights"] == (0, 124416)
            assert [b for _, b in p["layout"]["regions"]] == [50688, 50688]
            assert p["smem"] == 225920
    assert {(144, False), (432, False), (432, True), (864, False), (48, False)} <= seen


def test_highest_plan_streams_what_does_not_fit():
    """A layer too wide for resident weights streams with the fewest slabs
    that fit and divide its 16-channel groups: 64 channels in two, 192 in
    three, 97 groups (a prime) in slabs of one group."""
    assert ws_plan(3, 64, 48, "highest")["mode"] == "highest streamed"
    assert ws_layout(3, 64, 48, "highest", "resident", 1)["total"] > SMEM_MAX
    assert ws_plan(3, 64, 48, "highest")["slabs"] == 2
    p = ws_plan(3, 192, 48, "highest")
    assert p["slabs"] == 3 and ws_layout(3, 192, 48, "highest", "streamed", 2)["total"] > SMEM_MAX
    assert ws_plan(3, 16 * 97, 48, "highest")["slabs"] == 97
    # an upsample layer too wide for its form, and a 1x1 one, take the others
    assert ws_plan(3, 96, 48, "highest", upsample=True)["mode"] == "highest streamed"
    assert ws_plan(1, 48, 16, "highest", upsample=True)["mode"] == "highest resident"


#: (batch, height, width) of the layers at 1080p (A and dec2 at full
#: resolution, B and dec1 at half, C and dec0 at a quarter) and ragged ones
RESOLUTIONS = [(1, 1080, 1920), (1, 540, 960), (1, 270, 480), (2, 22, 72), (1, 1, 40)]


@pytest.mark.parametrize("n_cta", [1, 5, 132])
@pytest.mark.parametrize("res", RESOLUTIONS, ids=["x".join(map(str, r)) for r in RESOLUTIONS])
def test_highest_tiles_cover_every_tile_once_in_order(res, n_cta):
    """Every tile of the layer is taken by exactly one CTA, each CTA's
    tiles ascend, and no CTA is left without a tile."""
    b, h, w = res
    runs = ws_tiles(b, h, w, ROWS, n_cta)
    n = b * -(-h // ROWS) * -(-w // WS_COLS)
    assert len(runs) == min(n, n_cta)
    assert sorted(t for r in runs for t in r) == list(range(n))
    assert all(r and r == sorted(r) for r in runs)


@pytest.mark.parametrize("res", RESOLUTIONS, ids=["x".join(map(str, r)) for r in RESOLUTIONS])
def test_highest_tiles_are_balanced(res):
    """On the H100's 132 SMs no CTA takes more than one tile above another
    (16,200 tiles at 1080p: 122 or 123 each)."""
    counts = [len(r) for r in ws_tiles(*res, ROWS)]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("symbol", [
    "void (anonymous namespace)::conv_layer_kernel<48, 2, 6>((anonymous namespace)::LayerArgs)",
    "void (anonymous namespace)::ws::ws_layer_kernel<48, 1, (anonymous namespace)::ws::HighestNum>("
    "(anonymous namespace)::LayerArgs, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
    "int, int, int)"])
def test_bench_profile_groups_both_conv_chain_bodies(symbol):
    """`bench --profile` counts the serial body's launches and the
    'highest' body's under one conv_chain group."""
    assert _kernel_group(symbol, in_solver=False) == "conv_chain (CUDA)"
