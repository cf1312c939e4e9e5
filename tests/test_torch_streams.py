"""Batched streams (rvdd_tpu_torch/recurrent/engine.py at B = 2) and the
benchmark's modes (rvdd_tpu_torch/bench.py: --streams, --scan, --exact,
--state_dtype, --no_split, --trace_dir, --model convunet) on the CPU, where
the kernels run their plain versions.

Two streams in one batch must give what each gives alone.  On the CPU
ConvUNet's tests turn oneDNN off: its 3x3 convolutions pick their blocking
by the batch at these small shapes (a 48-channel conv at 16x16 differs by
2e-5 between batch 1 and 2), which bf16 rounding then carries through the
net.  PyTorch's reference convolutions sum each sample of bf16-valued
inputs in the same order at any batch at the shapes used here (32x32
frames), so the fused step's streams are bit-equal to their single runs,
as in tests/test_fast_step.py's
test_fast_step_batched_streams_match_singles.  (Not at every shape: the
eighth-res core's 4x6 convs of a 32x48 frame sum the second sample in
another order.)  The reference convolutions run on one thread here: on
many threads in parallel test workers they contend for the cores.  The
flagship keeps oneDNN, whose depthwise and 1x1 convolutions do not block
by batch (its streams are bit-equal either way, and ten times faster).
On fp32 inputs the reference convolutions do not keep the order, so the
fp32 module path's streams are held to 1e-5 x max|out| of their single
runs (seen: 2e-6)."""

import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu_torch import bench  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import convnext_to_flax, convunet_to_flax  # noqa: E402
from rvdd_tpu_torch.models.fast_unet import FUSED_PRECISIONS  # noqa: E402
from rvdd_tpu_torch.recurrent import engine  # noqa: E402

B = 2
#: (arch, future frames, side): convunet+feat at the fused path's minimum of
#: 32 px, the flagship at its 64
NETS = {"convunet+feat": ("convunet-mode=fixedfeatures+feat", 0, 32),
        "flagship": ("newunet-mode=feat", 1, 64)}


@contextlib.contextmanager
def batch_exact(name="convunet+feat"):
    """Convolutions that sum each sample alike at any batch: for ConvUNet
    oneDNN off, on one thread; the flagship as it is."""
    if name == "flagship":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yield
    finally:
        torch.set_num_threads(threads)


def _net(name, seed=0):
    arch, fd, _ = NETS[name]
    return build_network(arch, (2 + fd) * 3, 3, True, seed=seed, device="cpu")


def _clip(name, seed=5, t=2):
    """Frames [B, t + fD, S, S, 3] and smooth flows [B, 1 + fD, S, S, 2]
    that differ by stream (tests/test_fast_step.py:100's fields)."""
    _, fd, s = NETS[name]
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (B, t + fd, s, s, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:s, 0:s]
    fl = np.stack([np.stack([1.5 + np.sin(xx / 17), -0.6 + 0.4 * np.cos(yy / 11)], -1),
                   np.stack([-2.1 + 0.3 * np.cos(xx / 13), 0.9 + np.sin(yy / 7)], -1)])
    flows = np.repeat(fl[:, None], 1 + fd, axis=1).astype(np.float32)
    if fd:
        flows[:, 1] *= -1  # the future frame's flow points the other way
    return torch.from_numpy(frames), torch.from_numpy(flows)


def _steps(cfg, net, frames, flows):
    d1, s = engine.inference_step(cfg, net, None, frames, flows)
    d2, _ = engine.inference_step(cfg, net, s, frames, flows)
    return d1, d2


def _cfg(name, **kw):
    fd = NETS[name][1]
    return engine.EngineConfig(model_patch_depth=2, future_patch_depth=fd, feature_rec=True,
                               **kw)


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_batched_fused_step_equals_single_streams(name, state_dtype):
    """Two steps with the carry: each stream of the B = 2 fused step equals
    its own B = 1 run bit for bit, under 'fast' with either carry."""
    net = _net(name)
    frames, flows = _clip(name)
    cfg = _cfg(name, net_impl="fused", state_dtype=state_dtype)
    with batch_exact(name):
        got = _steps(cfg, net, frames, flows)
        for b in range(B):
            want = _steps(cfg, net, frames[b:b + 1], flows[b:b + 1])
            for step, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g[b:b + 1], w), (name, b, step)


def _norm_err(got, want):
    return float(np.max(np.abs(got - want))) / (float(np.std(want)) + 1e-6)


@pytest.mark.parametrize("name", list(NETS))
def test_batched_fused_step_in_envelope_of_rvdd_tpu_batched_step(name):
    """The port's B = 2 fused step against rvdd_tpu's batched
    ``inference_step`` (its exact step: XLA net and warp, fp32) on the same
    weights: each stream within tests/test_fast_step.py's envelope, the
    tolerance of the B = 1 tests (tests/test_torch_engine.py,
    test_torch_convnext.py): normalized max error < 0.2 at step 1 and < 0.3
    at step 2."""
    arch, fd, s = NETS[name]
    net = _net(name, seed=1)
    params = (convnext_to_flax if name == "flagship" else convunet_to_flax)(net.state_dict())
    jnet = jfactory.build_network(arch, (2 + fd) * 3, 3, True)
    frames, flows = _clip(name, seed=6)
    jcfg = jengine.EngineConfig(model_patch_depth=2, patch_depth=2 + fd, future_patch_depth=fd,
                                feature_rec=True)
    nil = jnet.nil_features(B, s, s)
    fr, fl = jax.numpy.asarray(frames.numpy()), jax.numpy.asarray(flows.numpy())
    first = jax.jit(lambda p, f, g: jengine.inference_step(jcfg, jnet, p, None, f, g, nil))
    nxt = jax.jit(lambda p, st, f, g: jengine.inference_step(jcfg, jnet, p, st, f, g, nil))
    w1, st = first(params, fr, fl)
    w2, _ = nxt(params, st, fr, fl)
    got = _steps(_cfg(name, net_impl="fused"), net, frames, flows)
    for b in range(B):
        for g, w, lim in zip(got, (w1, w2), (0.2, 0.3)):
            assert _norm_err(g[b].numpy(), np.asarray(w[b])) < lim, (name, b)


def _same(got, want, exact_bits):
    if exact_bits:
        return torch.equal(got, want)
    return float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_scan_video_batched_equals_single_streams():
    """scan_video at B = 2 (3 frames, the edges replicated) gives each
    stream's own B = 1 scan: bit for bit on the fused path, within 1e-5 x
    max on the fp32 module path."""
    net = _net("convunet+feat")
    frames, flows = _clip("convunet+feat", t=3)
    clip = frames.transpose(0, 1).contiguous()  # [T, B, S, S, 3]
    clip_flows = flows[None].expand(3, *flows.shape).clone()  # [T, B, 1, S, S, 2]
    clip_flows[0] = 0  # no flow to the replicated frame before the clip
    nil = net.nil_features(B, 32, 32)
    for impl in ("fused", "module"):
        cfg = _cfg("convunet+feat", net_impl=impl)
        with batch_exact():
            got = engine.scan_video(cfg, net, clip, clip_flows, nil)
            assert got.shape == (3, B, 32, 32, 3)
            for b in range(B):
                want = engine.scan_video(cfg, net, clip[:, b:b + 1], clip_flows[:, b:b + 1],
                                         nil[b:b + 1])
                assert _same(got[:, b:b + 1], want, impl == "fused"), (impl, b)


# ------------------------------------------------------------ bench's modes


def test_metric_names_as_bench_py():
    """Each part where bench.py puts it (bench.py:316, :353)."""
    name = bench.metric_name
    assert name(540, 960, "convunet+feat", streams=4) == \
        "1080p_fps_per_chip_convunet_feat_x4streams"
    assert name(540, 960, "convunet+feat", streams=2, flow="default") == \
        "1080p_fps_per_chip_convunet_feat_x2streams_online_flow"
    assert name(540, 960, "convunet+feat", scan=True) == "1080p_fps_per_chip_convunet_feat_scan"
    assert name(540, 960, "convunet+feat", scan=True, streams=3, precision="wsplit") == \
        "1080p_fps_per_chip_convunet_feat_scan_x3streams_wsplit"
    assert name(540, 960, "convunet+feat", exact=True) == "1080p_fps_per_chip_convunet_feat_exact"
    assert name(540, 960, "convnext+feat+future", exact=True, precision="mixed") == \
        "1080p_fps_per_chip_convnext_feat_future_exact"
    assert name(540, 960, "convunet+feat", streams=2, flow="fast", exact=True) == \
        "1080p_fps_per_chip_convunet_feat_x2streams_online_flow_fast_exact"
    assert name(540, 960, "convunet") == "1080p_fps_per_chip_convunet"
    assert name(64, 96, "convunet+feat+future", streams=2, precision="accurate") == \
        "128x192_fps_per_chip_convunet_feat_future_x2streams_accurate"


def test_bench_flags_parse_and_refuse_without_card(monkeypatch):
    """The flags reach run() (which needs a card and raises without one);
    --scan refuses online flows and traces, as bench.py's scan has none."""
    seen = {}

    def fake_run(*a, **kw):
        seen.update(kw)
        return {"metric": "m"}

    monkeypatch.setattr(bench, "run", fake_run)
    bench.main(["--model", "convunet", "--streams", "3", "--exact", "--state_dtype",
                "bfloat16", "--no_split", "--trace_dir", "t", "--frames", "2"])
    assert seen == dict(flow=None, precision="auto", scan=False, trace_dir="t", streams=3,
                        exact=True, state_dtype="bfloat16", no_split=True, model="convunet")
    bench.main(["--scan", "--streams", "2"])
    assert seen["scan"] and seen["streams"] == 2
    for bad in (["--scan", "--with_flow"], ["--scan", "--trace_dir", "t"], ["--streams", "0"]):
        with pytest.raises(SystemExit):
            bench.main(bad)
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench.run(frames=1, streams=2, scan=True)
    with pytest.raises(RuntimeError):
        bench.run(frames=1, exact=True)


def test_no_split_is_scoped():
    before = FUSED_PRECISIONS["fast"]
    with bench.no_split():
        assert FUSED_PRECISIONS["fast"]["weight_split"] == {}
        _, _, packed = bench.make_model("fused", seed=0, device="cpu")
        assert not any(layer.split for c in ("A", "dec2") for layer in packed[c].layers)
    assert FUSED_PRECISIONS["fast"] is before
    _, _, packed = bench.make_model("fused", seed=0, device="cpu")
    assert [layer.split for layer in packed["dec2"].layers] == [False, False, False, True, True]


@pytest.mark.parametrize("model,exact", [("convunet", False), ("convunet+feat", True),
                                         ("convunet+feat", False)])
def test_bench_step_at_two_streams(model, exact):
    """bench's step_fn on make_inputs(streams=2) at 16x16 raw: the first
    frame and a streamed one, each stream equal to its own single run (bit
    for bit fused, within 1e-5 x max exact); the exact mode is the module
    path with the kernel warp (its plain version here); ``convunet`` has no
    feature recurrence."""
    mode = bench.Mode(streams=2, exact=exact)
    cfg, net, packed = mode.model(0, "cpu", model, "auto")
    assert cfg.feature_rec == (model != "convunet")
    assert (cfg.net_impl, cfg.warp_impl) == (("module", "kernel") if exact else ("fused", "kernel"))
    raw, flows = bench.make_inputs(16, 16, seed=0, device="cpu", model=model, streams=2)
    assert raw.shape == (2, 2, 16, 16, 4) and flows.shape == (2, 1, 1, 16, 16, 2)
    assert torch.equal(flows[0], flows[1])
    with batch_exact():
        d0, st = bench.step_fn(cfg, net, packed, None, raw, flows)
        d1, _ = bench.step_fn(cfg, net, packed, st, raw, flows)
        assert d1.shape == (2, 32, 32, 3) and torch.isfinite(d1).all()
        for b in range(2):
            e0, s1 = bench.step_fn(cfg, net, packed, None, raw[b:b + 1], flows[b:b + 1])
            e1, _ = bench.step_fn(cfg, net, packed, s1, raw[b:b + 1], flows[b:b + 1])
            assert _same(d0[b:b + 1], e0, not exact) and _same(d1[b:b + 1], e1, not exact), b


def test_make_inputs_one_stream_unchanged():
    """One stream draws what it drew before streams existed: the cached
    window's frames are the seed's first uniforms, and each stream of a
    batch of online-flow windows has its own texture over one field."""
    raw, _ = bench.make_inputs(8, 12, seed=3, device="cpu")
    want = np.random.default_rng(3).uniform(-1, 1, (1, 2, 8, 12, 4)).astype(np.float32)
    assert np.array_equal(raw.numpy(), want)
    raw2, fl2 = bench.make_inputs(8, 12, seed=3, device="cpu", with_flow=True, streams=2)
    assert not torch.equal(raw2[0], raw2[1]) and torch.equal(fl2[0], fl2[1])
    json.dumps(bench.Mode().__dict__)
