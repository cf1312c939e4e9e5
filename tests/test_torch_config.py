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
from rvdd_tpu_torch.data.datasets import InferenceDataset  # noqa: E402
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


@pytest.mark.parametrize("flags", [["--mesh_shape", "data,space"], ["--distributed"],
                                   ["--profile_dir", "/tmp/p"]])
def test_not_ported_flags_raise(flags):
    with pytest.raises(NotImplementedError):
        config.parse_options(flags)


def test_shift_warp_raises():
    with pytest.raises(NotImplementedError, match="shift"):
        config.parse_options(["--warp_impl", "shift"]).engine_config()


def test_registry():
    assert registry.get_model("recurrent") is EngineConfig
    assert registry.get_dataset("infer4rec") is InferenceDataset
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.get_dataset("axel4rec")("root", "gt", "noisy")
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
