"""The port's options, registry and precision policy
(rvdd_tpu_torch/{config,registry,precision}.py) against rvdd_tpu's: one
command line parses in both packages to the same values, and maps onto the
port's engine."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from rvdd_tpu import config as jconfig  # noqa: E402
from rvdd_tpu_torch import config, precision, registry  # noqa: E402
from rvdd_tpu_torch.data.datasets import InferenceDataset, TrainWindowDataset  # noqa: E402
from rvdd_tpu_torch.recurrent.engine import EngineConfig  # noqa: E402

ARGV = ["--netDenoiser", "convunet-mode=fixedfeatures+feat", "--feature_rec",
        "--future_patch_depth", "1", "--net_impl", "fused", "--warp_impl", "pallas",
        "--state_dtype", "bfloat16", "--val_scan", "--val_pad_multiple", "16",
        "--no_exact_precision", "--compilation_cache_dir", "", "--suffix", "x"]


@pytest.mark.parametrize("train", [True, False])
def test_flags_and_defaults_match_rvdd_tpu(train):
    """Every rvdd_tpu flag exists in the port with its default and parses
    to the same value; the port adds --device only."""
    want = jconfig.parse_options(ARGV, train=train)
    got = config.parse_options(ARGV + ["--device", "cpu"], train=train)
    jfields = {f.name for f in dataclasses.fields(jconfig.Options)}
    fields = {f.name for f in dataclasses.fields(config.Options)}
    assert fields - jfields == {"device"} and jfields <= fields
    for name in jfields:
        assert getattr(got, name) == getattr(want, name), name
    assert got.device == "cpu" and got.save_dir == want.save_dir
    assert config.Options().device == "cuda"


@pytest.mark.parametrize("flags,net_impl,warp_impl,preset", [
    ([], "module", "auto", "fast"),
    (["--net_impl", "fused"], "fused", "auto", "fast"),
    (["--warp_impl", "xla"], "module", "plain", "fast"),
    (["--warp_impl", "pallas", "--net_impl", "fused"], "fused", "kernel", "fast"),
    (["--future_patch_depth", "1", "--net_impl", "fused"], "fused", "auto",
     "hybrid:glue+A+dec2"),
    (["--fused_precision", "mixed"], "module", "auto", "mixed"),
    (["--netDenoiser", "newunet-mode=feat", "--future_patch_depth", "1",
      "--fused_precision", "mixed"], "module", "auto", "mixed"),
])
def test_engine_config_maps_rvdd_tpu_values(flags, net_impl, warp_impl, preset):
    opt = config.parse_options(["--feature_rec"] + flags, train=False)
    cfg = opt.engine_config()
    assert isinstance(cfg, EngineConfig)
    assert (cfg.net_impl, cfg.warp_impl, cfg.fused_precision) == (net_impl, warp_impl, preset)
    want = jconfig.parse_options(["--feature_rec"] + flags, train=False)
    assert cfg.fused_precision == want.resolve_fused_precision()
    jcfg = want.engine_config()
    for f in ("model_patch_depth", "patch_depth", "future_patch_depth", "feature_rec",
              "no_warp", "prev_noisy_frame", "state_dtype", "lambda_l1", "raw_gt"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.train_unrollings == jcfg.train_unrollings


@pytest.mark.parametrize("flags", [["--mesh_shape", "data,space"],
                                   ["--mesh_shape", "data1xspace2"],
                                   ["--distributed", "--profile_dir", "/tmp/p"]])
def test_not_ported_flags_raise(flags):
    """Since the data-parallel slice the options parse as rvdd_tpu's, and
    the mesh spec is checked where training builds the mesh: a bad spec
    raises ValueError there, as rvdd_tpu's make_mesh does.  Since the space
    slice ``data1xspace2`` builds the mesh rvdd_tpu builds over two
    processes, and raises ValueError over one, as rvdd_tpu does over one
    device."""
    from rvdd_tpu.parallel.mesh import make_mesh as jmake_mesh
    from rvdd_tpu_torch.parallel.mesh import make_mesh

    opt = config.parse_options(flags + ["--device", "cpu"])
    want = jconfig.parse_options(flags)
    assert (opt.mesh_shape, opt.distributed, opt.profile_dir) == (
        want.mesh_shape, want.distributed, want.profile_dir)
    if opt.mesh_shape == "data,space":
        for build in (make_mesh, jmake_mesh):
            with pytest.raises(ValueError, match="bad mesh spec"):
                build(opt.mesh_shape)
    elif opt.mesh_shape == "data1xspace2":
        import jax

        want_mesh = jmake_mesh(opt.mesh_shape, devices=jax.devices()[:2])
        m = make_mesh(opt.mesh_shape, world_size=2)
        assert (m.data, m.space) == (want_mesh.shape["data"], want_mesh.shape["space"]) == (1, 2)
        for build, kw in ((make_mesh, dict(world_size=1)),
                          (jmake_mesh, dict(devices=jax.devices()[:1]))):
            with pytest.raises(ValueError):
                build(opt.mesh_shape, **kw)
    else:
        assert opt.distributed and opt.profile_dir == "/tmp/p"
        assert make_mesh(opt.mesh_shape).data == 1


def test_shift_warp_raises():
    """Since the training slice ``--warp_impl shift`` is accepted: outside
    the train step it is the plain warp, in the train step the plain warp
    that logs rvdd_tpu's clamp telemetry, and every other value trains with
    the plain warp too.  A value neither package has raises."""
    opt = config.parse_options(["--warp_impl", "shift"])
    assert opt.engine_config().warp_impl == "plain"
    assert opt.resolve_train_warp_impl() == "shift"
    for w in ("auto", "xla", "pallas"):
        assert config.parse_options(["--warp_impl", w]).resolve_train_warp_impl() == "plain"
    for call in ("engine_config", "resolve_train_warp_impl"):
        with pytest.raises(ValueError, match="bogus"):
            getattr(config.parse_options(["--warp_impl", "bogus"]), call)()


def test_registry():
    assert registry.get_model("recurrent") is EngineConfig
    assert registry.get_dataset("infer4rec") is InferenceDataset
    assert registry.get_dataset("axel4rec") is TrainWindowDataset
    with pytest.raises(KeyError):
        registry.get_model("nope")
    registry.register_model("mine", EngineConfig)
    assert registry.get_model("mine") is EngineConfig


def test_exact_precision_turns_tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        precision.use_fast_precision()
        with precision.exact_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 and torch.get_float32_matmul_precision() == "high"
        precision.use_exact_precision()
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
