"""The TV-L1 solver's warp kernel (``warp_catmull_zero``, the solver mode of
csrc/warp_bicubic.cu) and the solver's kernel route, against their plain
versions on the card.

Every test here needs a card and is marked ``gpu``; the file imports no
JAX, so it runs on a machine without it (``-m gpu --noconftest``, see
README).  Inputs come from numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rvdd_tpu_torch.ops import tvl1  # noqa: E402
from rvdd_tpu_torch.ops.cuda.warp_bicubic import (  # noqa: E402
    warp_catmull_zero,
    warp_catmull_zero_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: see README)")
    return torch.device("cuda")


def _flow(h, w, kind, rng):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == "smooth":
        fl = np.stack([2.0 + 1.5 * np.sin(xx / 11), -1.0 + np.cos(yy / 7)], -1)
    elif kind == "outside":  # most taps leave the frame
        fl = np.stack([25.0 * np.sin(xx / 7 + yy / 5), -18.0 * np.cos(yy / 3)], -1)
    else:  # "edges": positions on and just inside/outside each zeroing edge
        tx = rng.choice([1.0, 1.0 - 1e-3, w - 2.0, w - 2.0 - 1e-3, w - 3.0, 0.0], (h, w))
        ty = rng.choice([1.0, 1.0 - 1e-3, h - 2.0, h - 2.0 - 1e-3, h - 3.0, 0.0], (h, w))
        fl = np.stack([tx - xx, ty - yy], -1)
    return fl.astype(np.float32)[None]


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,c,kind", [
    (37, 70, 4, "smooth"),
    (37, 70, 4, "outside"),
    (37, 70, 4, "edges"),
    (9, 15, 4, "smooth"),  # the coarsest level of a 540x960 flow
    (23, 41, 1, "smooth"),
    (23, 41, 1, "edges"),
    (5, 4, 4, "outside"),
])
def test_catmull_zero_kernel_matches_plain(cuda, h, w, c, kind):
    """fp32 out: 1e-5 x max|x| (the order of 16 fp32 FMAs), and exactly
    the plain version's zeros: both compute col + u in fp32 and apply the
    same rule."""
    rng = np.random.default_rng(h * w + c)
    x = torch.from_numpy(rng.uniform(-200, 200, (2, h, w, c)).astype(np.float32)).to(cuda)
    fl = np.concatenate([_flow(h, w, kind, rng), _flow(h, w, kind, rng)[:, ::-1, ::-1] * 0.5])
    fl = torch.from_numpy(np.ascontiguousarray(fl)).to(cuda)
    before = warp_catmull_zero.launches
    got = warp_catmull_zero(x, fl)
    torch.cuda.synchronize()
    assert warp_catmull_zero.launches == before + 1
    want = warp_catmull_zero_plain(x, fl)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(x.abs().max()))
    assert torch.equal(got == 0, want == 0)


@pytest.mark.gpu
def test_catmull_zero_kernel_rejects_bad_input(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda)
    fl = torch.zeros(1, 8, 8, 2, device=cuda)
    with pytest.raises(TypeError):
        warp_catmull_zero(x.to(torch.bfloat16), fl)
    with pytest.raises(ValueError):
        warp_catmull_zero(x, fl[:, :4])
    with pytest.raises(ValueError):
        warp_catmull_zero(x.transpose(1, 2), fl)


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["fast", "default"])
def test_tvl1_kernel_route_matches_plain_route(cuda, preset):
    """The solver on the card through the kernel and through the plain
    warp at 48x64 (3 scales): nwarps x nscales kernel launches, the same
    iterations per stage up to a threshold flip, and flows within
    tests/test_tvl1.py's limits of each other."""
    from scipy.ndimage import gaussian_filter, shift

    rng = np.random.default_rng(9)
    tex = gaussian_filter(rng.standard_normal((48, 64)), 2) * 40 + 100
    i0 = torch.from_numpy(tex.astype(np.float32)).to(cuda)
    moved = shift(tex, (0.5, -1.2), order=3, mode="mirror")
    i1 = torch.from_numpy(moved.astype(np.float32)).to(cuda)
    p = tvl1.FLOW_PRESETS[preset]
    flows, its = {}, {}
    for route, warp in (("kernel", None), ("plain", warp_catmull_zero_plain)):
        its[route] = []
        before = warp_catmull_zero.launches
        flows[route] = tvl1.tvl1_flow(i0, i1, preset, iterations=its[route], _warp=warp)
        launches = warp_catmull_zero.launches - before
        assert launches == (p.nwarps * tvl1._num_scales(64, 48, p) if route == "kernel" else 0)
    diff = [abs(a - b) for a, b in zip(its["kernel"], its["plain"])]
    assert sum(d > 0 for d in diff) <= 1 and max(diff) <= 1, its
    err = (flows["kernel"] - flows["plain"]).abs().cpu().numpy()
    assert np.median(err) < 0.02 and err.mean() < 0.05 and np.quantile(err, 0.95) < 0.12
    got = flows["kernel"].cpu().numpy()[6:-6, 6:-6]
    assert np.abs(np.median(got, axis=(0, 1)) - (-1.2, 0.5)).max() < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("model,cfg_kw", [
    ("convunet+feat", {}),  # EngineConfig's defaults: module path, warp_impl 'plain'
    ("convnext+feat+future", {"future_patch_depth": 1, "net_impl": "fused"}),
])
def test_compute_window_flows_launches_kernel_on_cuda(cuda, model, cfg_kw):
    """Whatever the config picks for the state warp, the solver's warp on
    CUDA tensors is the kernel: nwarps x nscales launches a flow."""
    from rvdd_tpu_torch import bench
    from rvdd_tpu_torch.recurrent import engine

    cfg = engine.EngineConfig(**cfg_kw)
    raw, _ = bench.make_inputs(24, 32, seed=3, device=cuda, model=model, with_flow=True)
    p = tvl1.FLOW_PRESETS["fast"]
    before = warp_catmull_zero.launches
    flows = engine.compute_window_flows(cfg, raw, "fast")
    torch.cuda.synchronize()
    n_flows = cfg.d + cfg.future_patch_depth
    assert flows.shape == (1, n_flows, 24, 32, 2) and torch.isfinite(flows).all()
    assert warp_catmull_zero.launches - before == n_flows * p.nwarps * tvl1._num_scales(32, 24, p)
