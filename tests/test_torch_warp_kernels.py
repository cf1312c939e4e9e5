"""The tiled warp kernel (csrc/warp_bicubic.cu) on both of its tile paths.

The kernel stages an output tile's source window in shared memory
when it fits (the window path) and gathers from global memory when it does
not (the direct path).  ``tile_paths`` is that choice in plain PyTorch; the
CPU tests hold it against a brute-force count.  The tests marked ``gpu``
launch the kernel in both modes (``warp_bicubic``, ``warp_catmull_zero``)
on flows that keep every tile on one path or mix the two, check the
kernel's own tile counts against ``tile_paths``, and hold the output
against the plain versions.  This file imports no JAX, so the card tests
run on a machine without it (``-m gpu --noconftest``, see README).  Inputs
come from numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rvdd_tpu_torch.ops.cuda.warp_bicubic import (  # noqa: E402
    TILE_H,
    TILE_W,
    tile_paths,
    warp_bicubic,
    warp_bicubic_plain,
    warp_catmull_zero,
    warp_catmull_zero_plain,
    window_pixels,
)

BF16 = torch.bfloat16
F32 = torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: see README)")
    return torch.device("cuda")


def _flow(b, h, w, kind, seed=0):
    """numpy float32 [b, h, w, 2]; each batch image gets its own field."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for k in range(b):
        s = 1.0 if k % 2 == 0 else -0.7
        if kind == "smooth":  # every tile's window fits
            fl = np.stack([s * (3.0 + 1.5 * np.sin(xx / 40)), s * (-2.0 + np.cos(yy / 10))], -1)
        elif kind == "large":  # far beyond a window: the direct path
            fl = np.stack([90.0 * np.sin(xx / 7 + yy / 5), -75.0 * np.cos(yy / 3)], -1) * s
        elif kind == "outside":  # the solver mode's zeroing everywhere near the edges
            fl = np.stack([25.0 * np.sin(xx / 7 + yy / 5), -18.0 * np.cos(yy / 3)], -1) * s
        elif kind == "mixed":  # the first tile column smooth, the rest large
            sm = np.stack([2.0 + np.sin(xx / 9), -1.0 + 0.5 * np.cos(yy / 7)], -1)
            lg = np.stack([60.0 * np.sin(xx / 5 + yy / 3), -40.0 * np.cos(yy / 2)], -1)
            fl = np.where((xx < TILE_W)[..., None], sm, lg)
        elif kind == "gone":  # every position far outside: all zeroed in the solver mode
            fl = np.full((h, w, 2), 1e4)
        else:  # "random": independent displacements of up to +-2.5 px
            fl = rng.uniform(-2.5, 2.5, (h, w, 2))
        out.append(fl)
    return np.stack(out).astype(np.float32)


def _brute_paths(fl, cap, zero_outside):
    """The path rule pixel by pixel in numpy float32 (windows of at most
    cap pixels)."""
    b, h, w, _ = fl.shape
    boxes = {}
    for k in range(b):
        for r in range(h):
            for c in range(w):
                gx = np.float32(c) + fl[k, r, c, 0]
                gy = np.float32(r) + fl[k, r, c, 1]
                key = (k, r // TILE_H, c // TILE_W)
                boxes.setdefault(key, None)
                if zero_outside and not (1 <= gx < np.float32(w - 2) and 1 <= gy < np.float32(h - 2)):
                    continue
                tx = int(min(max(np.floor(gx), -3), w + 1)) - 1
                ty = int(min(max(np.floor(gy), -3), h + 1)) - 1
                x0, x1 = min(max(tx, 0), w - 1), min(max(tx + 3, 0), w - 1)
                y0, y1 = min(max(ty, 0), h - 1), min(max(ty + 3, 0), h - 1)
                old = boxes[key]
                if old is not None:
                    x0, x1 = min(x0, old[0]), max(x1, old[1])
                    y0, y1 = min(y0, old[2]), max(y1, old[3])
                boxes[key] = (x0, x1, y0, y1)
    counts = [0, 0, 0]
    for box in boxes.values():
        if box is None:
            counts[2] += 1
        else:
            x0, x1, y0, y1 = box
            counts[0 if (x1 - x0 + 1) * (y1 - y0 + 1) <= cap else 1] += 1
    return counts


@pytest.mark.parametrize("h,w,kind,c,zero_outside", [
    (37, 70, "smooth", 56, False),
    (45, 200, "smooth", 3, False),
    (37, 70, "large", 56, False),
    (45, 200, "mixed", 8, False),
    (33, 65, "random", 56, False),
    (37, 70, "outside", 4, True),
    (45, 200, "mixed", 4, True),
    (20, 40, "gone", 4, True),
    (33, 65, "random", 1, True),
])
def test_tile_paths_matches_brute_force(h, w, kind, c, zero_outside):
    """tile_paths (vectorized) counts each tile where a pixel-by-pixel walk
    of the rule puts it, ragged and border tiles included."""
    fl = _flow(2, h, w, kind, seed=h + w)
    got = tile_paths(torch.from_numpy(fl), c, zero_outside=zero_outside).tolist()
    want = _brute_paths(fl, window_pixels(c), zero_outside)
    assert got == want, (got, want)
    assert sum(got) == 2 * -(-h // TILE_H) * -(-w // TILE_W)


def test_tile_paths_shares_of_the_test_flows():
    """The flows the card tests use take the paths they are meant to take."""
    def paths(kind, zero=False, h=45, w=200, c=56):
        return tile_paths(torch.from_numpy(_flow(2, h, w, kind)), c, zero_outside=zero).tolist()

    def tiles(h, w):
        return 2 * -(-h // TILE_H) * -(-w // TILE_W)

    n = tiles(45, 200)
    assert paths("smooth") == [n, 0, 0]
    assert paths("smooth", h=37, w=70) == [tiles(37, 70), 0, 0]
    win, direct, _ = paths("mixed")
    assert win > 0 and direct > 0
    assert paths("large")[1] > 0
    assert paths("gone", zero=True, c=4) == [0, 0, n]


@pytest.mark.parametrize("zero_outside", [False, True])
def test_wrapper_tile_counts_on_cpu(zero_outside):
    """On CPU tensors the wrappers run the plain version and add
    tile_paths' counts to tile_counts."""
    fl = torch.from_numpy(_flow(2, 37, 70, "mixed"))
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 37, 70, 4)).astype(np.float32))
    counts = torch.zeros(3, dtype=torch.int32)
    if zero_outside:
        warp_catmull_zero(x, fl, tile_counts=counts)
        warp_catmull_zero(x, fl, tile_counts=counts)
    else:
        warp_bicubic(x, fl, out_dtype=F32, tile_counts=counts)
        warp_bicubic(x, fl, out_dtype=F32, tile_counts=counts)
    assert counts.tolist() == (2 * tile_paths(fl, 4, zero_outside=zero_outside)).tolist()


# ------------------------------------------------------------------ card


DTYPE_PAIRS = [(F32, F32), (F32, BF16), (BF16, BF16), (BF16, F32)]


def _run(cuda, c, in_dtype, out_dtype, fl_np, seed=4):
    b, h, w, _ = fl_np.shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, h, w, c)).astype(np.float32)).to(cuda)
    x = x.to(in_dtype)
    fl = torch.from_numpy(fl_np).to(cuda)
    counts = torch.zeros(3, dtype=torch.int32, device=cuda)
    before = warp_bicubic.launches
    got = warp_bicubic(x, fl, out_dtype=out_dtype, tile_counts=counts)
    torch.cuda.synchronize()
    assert warp_bicubic.launches == before + 1
    assert got.dtype == out_dtype and got.shape == x.shape
    want = warp_bicubic_plain(x, fl, out_dtype=F32)
    tol = 1e-5 if out_dtype == F32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)
    paths = counts.cpu().tolist()
    assert paths == tile_paths(fl.cpu(), c, in_dtype).tolist()
    return paths


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(37, 70), (45, 200)])
@pytest.mark.parametrize("in_dtype,out_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("c", [3, 4, 8, 56])
def test_warp_kernel_window_path(cuda, c, in_dtype, out_dtype, h, w):
    """Batch 2, heights and widths that are not multiples of the tile, a
    smooth flow: every tile stages its window.  fp32 output within 1e-5
    (fp32 FMA order), bf16 output within 1e-2 (one bf16 ulp below 2)."""
    paths = _run(cuda, c, in_dtype, out_dtype, _flow(2, h, w, "smooth"))
    assert paths[1] == 0 and paths[2] == 0 and paths[0] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["large", "mixed", "random"])
@pytest.mark.parametrize("in_dtype,out_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("c", [3, 8, 56])
def test_warp_kernel_direct_and_mixed_paths(cuda, c, in_dtype, out_dtype, kind):
    """Flows far beyond a window take the direct path; ``mixed`` puts both
    paths in one launch; ``random`` breaks the two-row tap sharing of every
    thread.  Tolerances as on the window path."""
    paths = _run(cuda, c, in_dtype, out_dtype, _flow(2, 45, 200, kind))
    if kind in ("large", "mixed"):
        assert paths[1] > 0
    if kind == "mixed":
        assert paths[0] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 5, 12, 16, 20, 136])
def test_warp_kernel_other_channel_counts(cuda, c):
    """The narrow kernel at C = 1 and 5 (element-wise staging, a partial
    vector) and 12 (two channel slices, the second a single vector); the
    wide one at C = 16 and 20 (4 and 8 threads a pixel pair, some idle) and
    136 (34 vectors: threads loop over them; its window rarely fits).  Both
    paths in one launch where the window fits."""
    for in_dtype, out_dtype in DTYPE_PAIRS:
        paths = _run(cuda, c, in_dtype, out_dtype, _flow(2, 45, 200, "mixed"))
        assert paths[1] > 0 and (c > 20 or paths[0] > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [4, 1])
@pytest.mark.parametrize("kind", ["smooth", "outside", "mixed", "gone", "random"])
def test_catmull_zero_kernel_paths(cuda, kind, c):
    """The solver mode on each path: 1e-5 x max|x| and exactly the plain
    version's zeros; a tile whose every pixel is zeroed writes zeros
    without staging."""
    fl_np = _flow(2, 45, 200, kind, seed=3)
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.uniform(-200, 200, (2, 45, 200, c)).astype(np.float32)).to(cuda)
    fl = torch.from_numpy(fl_np).to(cuda)
    counts = torch.zeros(3, dtype=torch.int32, device=cuda)
    before = warp_catmull_zero.launches
    got = warp_catmull_zero(x, fl, tile_counts=counts)
    torch.cuda.synchronize()
    assert warp_catmull_zero.launches == before + 1
    want = warp_catmull_zero_plain(x, fl)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(x.abs().max()))
    assert torch.equal(got == 0, want == 0)
    paths = counts.cpu().tolist()
    assert paths == tile_paths(fl.cpu(), c, zero_outside=True).tolist()
    if kind == "smooth":
        assert paths[0] > 0 and paths[1] == 0
    if kind == "mixed":
        assert paths[0] > 0 and paths[1] > 0
    if kind == "gone":
        assert paths == [0, 0, sum(paths)] and not got.any()


@pytest.mark.gpu
def test_warp_kernel_rejects_bad_tile_counts(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    fl = torch.zeros(1, 8, 8, 2, device=cuda)
    with pytest.raises(ValueError):
        warp_bicubic(x, fl, tile_counts=torch.zeros(3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        warp_catmull_zero(x, fl, tile_counts=torch.zeros(3, dtype=torch.int32))
