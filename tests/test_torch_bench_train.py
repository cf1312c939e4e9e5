"""bench's --train mode (rvdd_tpu_torch/bench.py:train_setup, run_train)
against the root bench.py's (:175-241) on the CPU at a tiny patch.

``run_train`` measures the card and refuses the CPU, so the CPU tests
drive what it times, ``train_setup``: the metric name is the root bench's
for each of the four models, the flagship always trains with remat, the
draws have the root bench's shapes, and the first step's loss equals
rvdd_tpu's ``make_train_step`` on the same draws and weights (rtol 2e-5,
tests/test_torch_train_grads.py's loss limit).  The inference-only flags
are refused with ``--train``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu.training import train_state as jts  # noqa: E402
from rvdd_tpu_torch import bench  # noqa: E402
from rvdd_tpu_torch.models.convert import convunet_from_flax  # noqa: E402

PATCH = 8


@pytest.mark.parametrize("model,name", [
    ("convunet", "train_samples_per_sec_convunet"),
    ("convunet+feat", "train_samples_per_sec_convunet_feat"),
    ("convunet+feat+future", "train_samples_per_sec_convunet_feat_future"),
    ("convnext+feat+future", "train_samples_per_sec_convnext_feat_future"),
])
def test_train_setup_shapes_names_and_remat(model, name):
    assert bench.train_metric_name(model) == name
    cfg, state, step, inputs = bench.train_setup(model, batch_size=2, patch=PATCH,
                                                 unrollings=2, device="cpu")
    fd = 1 if "future" in model else 0
    frames, flows, gt, weights = inputs
    assert frames.shape == (2, 2 + 1 + fd, PATCH, PATCH, 4)
    assert flows.shape == (2, 2, 1 + fd, PATCH, PATCH, 2)
    assert gt.shape == (2, 2 + 1 + fd, 2 * PATCH, 2 * PATCH, 3)
    assert torch.equal(weights, torch.full((2,), 0.5))
    assert cfg.remat == model.startswith("convnext") and cfg.warp_impl == "plain"
    assert bench.train_setup(model, patch=PATCH, unrollings=1, remat=True,
                             device="cpu")[0].remat
    assert state.optimizer.param_groups[0]["lr"] == 1e-4
    _, losses = step(state, *inputs)
    assert state.step == 1 and np.isfinite(float(losses["Denoiser"]))


@pytest.mark.parametrize("model", ["convunet+feat", "convunet+feat+future"])
def test_first_loss_matches_rvdd_tpu_train_step(model):
    """The root bench's step on the same draws: rvdd_tpu's make_train_step
    (its XLA warp, matmuls at highest) from the port net's weights."""
    cfg, state, step, inputs = bench.train_setup(model, batch_size=2, patch=PATCH,
                                                 unrollings=2, device="cpu")
    arch, fd, feat = bench.MODELS[model]
    jcfg = jengine.EngineConfig(model_patch_depth=2, patch_depth=3, future_patch_depth=fd,
                                feature_rec=feat, warp_impl="xla", net_impl="xla")
    jnet = jfactory.build_network(arch, cfg.network_input_nc, 3, feat)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(0),
                                   (1, 2 * PATCH, 2 * PATCH, cfg.network_input_nc))
    state.net.load_state_dict(convunet_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    jstate, tx = jts.create_train_state(params)
    jstep = jts.make_train_step(jcfg, jnet, tx, donate=False)
    _, jlosses = jstep(jts.set_learning_rate(jstate, 1e-4),
                       *[jnp.asarray(x.numpy()) for x in inputs])
    _, losses = step(state, *inputs)
    for k in ("L1", "PSNR", "Denoiser"):
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=2e-5)


def test_run_train_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no CPU mode"):
        bench.run_train(steps=1, patch=PATCH, device="cpu")


@pytest.mark.parametrize("flags", [["--streams", "2"], ["--scan"], ["--with_flow"],
                                   ["--exact"], ["--profile"], ["--trace_dir", "t"]])
def test_train_refuses_inference_flags(flags, capsys):
    with pytest.raises(SystemExit):
        bench.main(["--train"] + flags)
    assert "--train times the train step: not with " + flags[0] in capsys.readouterr().err
