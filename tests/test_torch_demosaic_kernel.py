"""The Hamilton-Adams demosaic kernel (csrc/demosaic.cu) and its dispatch.

``ops.demosaic.hamilton_adams`` sends CUDA raw that wants no gradient to
the kernel, one launch for every leading dim (float32 alone: other dtypes
raise there), and the CPU and raw that requires grad under autograd to the
plain version.  The CPU tests hold the rule, the one-call
``prepare_frames`` against the per-frame calls it replaced (values and
gradients), and the wrapper's refusals.  The tests marked ``gpu`` hold the
kernel bitwise equal to the plain version on the card: at the stream's
540x960, on tiny frames where the edge clamps are most of the work, with
leading dims and on a non-contiguous slice, on raw with sign ties and
signed zeros.  This file imports no JAX, so the card tests run on a
machine without it (``-m gpu --noconftest``, see README).  Inputs come
from numpy seeds.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rvdd_tpu_torch import _build  # noqa: E402
from rvdd_tpu_torch.ops import demosaic  # noqa: E402
from rvdd_tpu_torch.ops.bayer import pack_cfa  # noqa: E402
from rvdd_tpu_torch.ops.cuda.demosaic import hamilton_adams_cuda  # noqa: E402
from rvdd_tpu_torch.recurrent.engine import EngineConfig, prepare_frames  # noqa: E402

F32 = torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: see README)")
    return torch.device("cuda")


def _raw(shape, kind="uniform", seed=0):
    """numpy float32 packed raw: 'uniform' in [0, 1), 'normal' (negative
    samples, so masked products give -0), 'ties' (quarters in [-1, 1], so
    the stencils' gradient comparisons often tie and sign() gives 0)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.uniform(0.0, 1.0, shape)
    elif kind == "normal":
        x = rng.normal(0.0, 1.0, shape)
    else:
        x = rng.integers(-4, 5, shape) / 4.0
    return torch.from_numpy(x.astype(np.float32))


def _per_frame(raw_frames):
    """prepare_frames' demosaic as it was: one call a frame, stacked."""
    return torch.stack([demosaic.hamilton_adams(raw_frames[:, i])
                        for i in range(raw_frames.shape[1])], dim=1)


def _bits(x):
    return x.contiguous().view(torch.int32)


# ------------------------------------------------------------- CPU tests


@pytest.mark.parametrize("is_cuda,dtype,requires_grad,grad_mode,want", [
    (True, F32, False, True, True),
    (True, F32, True, False, True),    # under no_grad nothing is wanted
    (True, F32, True, True, False),    # warp_raw under autograd
    (True, torch.bfloat16, False, True, True),    # the kernel refuses it
    (True, torch.float16, True, True, False),
    (False, F32, False, True, False),  # the CPU
])
def test_kernel_dispatch_rule(is_cuda, dtype, requires_grad, grad_mode, want):
    raw = types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype, requires_grad=requires_grad)
    with torch.set_grad_enabled(grad_mode):
        assert demosaic.kernel_takes(raw) is want


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16, torch.float64])
def test_cpu_runs_the_plain_version(monkeypatch, dtype):
    def refuse(_):
        raise AssertionError("the kernel was called for a CPU tensor")

    monkeypatch.setattr(demosaic, "hamilton_adams_cuda", refuse)
    before = demosaic.hamilton_adams.plain_cuda_calls
    raw = _raw((2, 5, 7, 4), "normal").to(dtype)
    out = demosaic.hamilton_adams(raw)
    assert out.shape == (2, 10, 14, 3) and out.dtype == dtype
    assert torch.equal(out, demosaic.hamilton_adams_plain(raw))
    assert demosaic.hamilton_adams.plain_cuda_calls == before  # CPU calls are not counted


@pytest.mark.parametrize("b,t,h,w,kind", [(1, 2, 6, 8, "uniform"), (2, 3, 5, 7, "normal"),
                                          (2, 4, 3, 2, "ties")])
def test_prepare_frames_one_call_equals_per_frame(b, t, h, w, kind):
    raw = _raw((b, t, h, w, 4), kind, seed=b * t)
    flows = _raw((b, t - 1, 1, h, w, 2), "normal", seed=1)
    rgb, flows2 = prepare_frames(EngineConfig(), raw, flows)
    assert rgb.shape == (b, t, 2 * h, 2 * w, 3)
    assert torch.equal(_bits(rgb), _bits(_per_frame(raw)))
    assert flows2.shape == (b, t - 1, 1, 2 * h, 2 * w, 2)
    # a non-contiguous slice of the window, as the stream hands over
    assert torch.equal(_bits(prepare_frames(EngineConfig(), raw[:, 1:], None)[0]),
                       _bits(_per_frame(raw[:, 1:])))


def test_prepare_frames_gradient_equals_per_frame():
    """Raw that requires grad under autograd (warp_raw's path in training)
    takes the plain version, and one call over the window gives the
    gradient the per-frame calls gave."""
    raw = _raw((2, 3, 5, 6, 4), "normal", seed=3)
    cot = _raw((2, 3, 10, 12, 3), "normal", seed=4)
    grads = []
    for fn in (lambda r: prepare_frames(EngineConfig(), r, None)[0], _per_frame):
        r = raw.clone().requires_grad_()
        (fn(r) * cot).sum().backward()
        grads.append(r.grad)
    assert torch.equal(_bits(grads[0]), _bits(grads[1]))
    assert float(grads[0].abs().sum()) > 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="packed raw must have 4 channels, got 3"):
        pack_cfa(torch.zeros(1, 2, 2, 3))
    with pytest.raises(ValueError, match="packed raw must have 4 channels, got 3"):
        hamilton_adams_cuda(torch.zeros(1, 2, 2, 3))
    with pytest.raises(ValueError, match="CUDA device"):
        hamilton_adams_cuda(torch.zeros(1, 2, 2, 4))


def test_demosaic_is_a_kernel_source():
    assert "demosaic" in _build.SOURCES
    assert _build.source_path("demosaic") == _build.CSRC_DIR / "demosaic.cu"


# ------------------------------------------------------------ card tests


def _check_bitwise(raw):
    before = hamilton_adams_cuda.launches
    got = demosaic.hamilton_adams(raw)
    want = demosaic.hamilton_adams_plain(raw)
    torch.cuda.synchronize()
    assert hamilton_adams_cuda.launches == before + 1
    assert got.shape == want.shape
    diff = (_bits(got) != _bits(want)).sum()
    assert int(diff) == 0, f"{int(diff)} of {got.numel()} values differ in their bits"


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "normal", "ties"])
def test_kernel_bitwise_at_the_stream_shape(cuda, kind):
    _check_bitwise(_raw((1, 2, 540, 960, 4), kind, seed=7).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [1, 2, 3, 5])
@pytest.mark.parametrize("w", [1, 2, 3, 5])
def test_kernel_bitwise_on_tiny_frames(cuda, h, w):
    for kind in ("normal", "ties"):
        _check_bitwise(_raw((2, 3, h, w, 4), kind, seed=10 * h + w).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(17, 33), (16, 32), (40, 70), (35, 45)])
def test_kernel_bitwise_with_leading_dims_and_ragged_tiles(cuda, h, w):
    """Tiles of 32 x 64 output pixels: frames that end inside a tile, on
    both store paths (2w % 4 == 0 and not)."""
    _check_bitwise(_raw((2, 3, h, w, 4), "ties", seed=h + w).to(cuda))
    _check_bitwise(_raw((h, w, 4), "normal", seed=h * w).to(cuda))


@pytest.mark.gpu
def test_kernel_bitwise_on_a_non_contiguous_slice(cuda):
    window = _raw((2, 3, 24, 40, 4), "normal", seed=5).to(cuda)
    sl = window[:, 1:]
    assert not sl.is_contiguous()
    _check_bitwise(sl)
    _check_bitwise(window[:, :, 1:-2])  # a frame that is not contiguous: copied first
    # raw 4 bytes off a 16-byte boundary: the staging reads sample by sample
    flat = _raw((2 * 24 * 40 * 4 + 1,), "ties", seed=6).to(cuda)
    unaligned = flat[1:].view(2, 24, 40, 4)
    assert unaligned.data_ptr() % 16
    _check_bitwise(unaligned)


@pytest.mark.gpu
def test_prepare_frames_is_one_launch(cuda):
    raw = _raw((1, 3, 30, 50, 4), "uniform", seed=2).to(cuda)
    flows = _raw((1, 2, 1, 30, 50, 2), "normal", seed=3).to(cuda)
    launches = hamilton_adams_cuda.launches
    plain = demosaic.hamilton_adams.plain_cuda_calls
    rgb, _ = prepare_frames(EngineConfig(), raw, flows)
    torch.cuda.synchronize()
    assert hamilton_adams_cuda.launches == launches + 1
    assert demosaic.hamilton_adams.plain_cuda_calls == plain
    assert torch.equal(_bits(rgb), _bits(demosaic.hamilton_adams_plain(raw)))


@pytest.mark.gpu
def test_plain_path_on_the_card_is_counted(cuda):
    """Only raw that requires grad under autograd takes the plain version
    on the card, counted, and the gradient flows as before; bfloat16 raw
    that wants none is refused, not demosaicked the slow way."""
    launches = hamilton_adams_cuda.launches
    plain = demosaic.hamilton_adams.plain_cuda_calls
    raw = _raw((1, 12, 20, 4), "normal", seed=8)
    with pytest.raises(TypeError, match="must be float32, got torch.bfloat16"):
        demosaic.hamilton_adams(raw.to(cuda, torch.bfloat16))
    r = raw.to(cuda).requires_grad_()
    demosaic.hamilton_adams(r).sum().backward()
    rc = raw.clone().requires_grad_()
    demosaic.hamilton_adams(rc).sum().backward()
    assert demosaic.hamilton_adams.plain_cuda_calls == plain + 1
    assert hamilton_adams_cuda.launches == launches
    torch.testing.assert_close(r.grad.cpu(), rc.grad, rtol=0, atol=1e-6)
