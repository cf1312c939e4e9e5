"""The port's train CLI (rvdd_tpu_torch/cli/train.py over
training/loop.py:train) on the CPU on a tiny dataset made by the port's
generate_data (raw 24x32, 5 frames), flows computed by its FlowCache:

* one epoch writes the reference's files ('0', '1', 'latest' and
  'latest_val' nets, the optimizer state, status.json, opt_train.json,
  loss_log.txt with its step, validation and epoch lines, the visuals);
* ``--autoresume`` continues at epoch 2 with the optimizer state (AdamW's
  step count carries on), and from an rvdd_tpu run directory it loads the
  params and restarts the moments;
* rvdd_tpu's ``load_checkpoint`` reads the port's ``1_net_Denoise.msgpack``
  (the same bytes flax writes) and its net then gives the port's forward
  within 1e-5;
* the train step overfits a tiny clip (calibrated margins, as
  tests/test_overfit.py);
* without a card, the CLI's default ``--device cuda`` raises.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.training import checkpoints as jckpt  # noqa: E402
from rvdd_tpu_torch.cli import generate_data, train  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.ops.bayer import remosaic  # noqa: E402
from rvdd_tpu_torch.recurrent.engine import EngineConfig  # noqa: E402
from rvdd_tpu_torch.training.checkpoints import (  # noqa: E402
    flax_params,
    load_checkpoint,
    msgpack_serialize,
)
from rvdd_tpu_torch.training.train_state import (  # noqa: E402
    create_train_state,
    make_train_step,
    set_learning_rate,
)
from test_torch_validate import srgb_clip  # noqa: E402

ARCH = "convunet-mode=fixedfeatures+feat-filters=8"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_cli"))
    srgb_clip(root, 5, 48, 64)
    src = os.path.join(root, "srgb", "%03d", "%08d.png")
    generate_data.main(["--input_train_dataset", src, "--input_val_dataset", src,
                        "--nb_seq_train", "1", "--nb_seq_val", "1", "--first", "0", "--last",
                        "4", "--step", "1", "--output_train_dataset",
                        os.path.join(root, "train"), "--output_val_dataset",
                        os.path.join(root, "validation"), "--device", "cpu"])
    return root


def argv(root, *extra):
    return ["--netDenoiser", ARCH, "--feature_rec", "--dataroot", os.path.join(root, "train"),
            "--val_dataroot", os.path.join(root, "validation"), "--gtFolder", "gt_iso3200",
            "--nFolder", "noisy_iso3200", "--gt_linear_RGB_Folder", "gt_raw_linear_RGB_iso3200",
            "--val_videos", "000", "--checkpoints_dir", os.path.join(root, "ckpt"),
            "--patch_width", "16", "--patch_stride", "4", "--patch_depth", "3",
            "--frames2load", "4", "--unroll_focus", "all", "--niter", "1", "--niter_decay",
            "0", "--print_freq", "2", "--lr", "1e-3", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def run(data):
    """One epoch, then --autoresume into epoch 2: (save_dir, both results)."""
    first = train.main(argv(data, "--name", "run"))
    second = train.main(argv(data, "--name", "run", "--niter", "2", "--autoresume"))
    return os.path.join(data, "ckpt", "run"), first, second


def test_one_epoch_writes_the_reference_files(run):
    save_dir, first, _ = run
    names = set(os.listdir(save_dir))
    for epoch in ("0", "1", "latest", "latest_val"):
        assert f"{epoch}_net_Denoise.msgpack" in names
    for epoch in ("1", "latest", "latest_val"):
        assert f"{epoch}_optim_Denoise.pt" in names
    assert "0_optim_Denoise.pt" not in names
    assert {"status.json", "opt_train.json", "loss_log.txt", "val_visuals"} <= names
    log = open(os.path.join(save_dir, "loss_log.txt")).read()
    assert "(epoch: 1, iters: 2, time: " in log and "data: " in log and "Denoiser: " in log
    assert "---> validation: (epoch: 1," in log and "End of epoch 1 / 1" in log
    assert len(os.listdir(os.path.join(save_dir, "val_visuals", "000"))) == 4
    (rec,) = first["epochs"]
    assert rec["epoch"] == 1 and rec["steps"] == 4 and rec["finite"]
    assert rec["val"]["PSNR_valLoss"] > 0 and first["flows_computed"] > 0


def test_autoresume_continues_with_the_optimizer_state(run):
    save_dir, first, second = run
    assert json.load(open(os.path.join(save_dir, "status.json")))["epoch"] == 2
    assert [r["epoch"] for r in second["epochs"]] == [2]
    assert "autoresumed from epoch 1\n" in open(os.path.join(save_dir, "loss_log.txt")).read()
    steps = [torch.load(os.path.join(save_dir, f"{e}_optim_Denoise.pt"))["state"][0]["step"]
             for e in (1, 2)]
    assert [float(s) for s in steps] == [4.0, 8.0]


def test_rvdd_tpu_reads_the_port_checkpoint(run, tmp_path):
    """The port's file holds the bytes rvdd_tpu's save_checkpoint writes for
    the same params (keys sorted, as jax.device_get's copy sorts them)."""
    save_dir, _, _ = run
    net = build_network(ARCH, 6, 3, True, seed=5, device="cpu")
    load_checkpoint(save_dir, "1", net)
    jckpt.save_checkpoint(str(tmp_path), "1", flax_params(net))
    raw = open(os.path.join(save_dir, "1_net_Denoise.msgpack"), "rb").read()
    assert open(tmp_path / "1_net_Denoise.msgpack", "rb").read() == raw
    assert msgpack_serialize(flax_params(net)) == raw
    jnet = jfactory.build_network(ARCH, 6, 3, True)
    template = jfactory.init_network(jnet, jax.random.PRNGKey(0), (1, 32, 32, 6))
    params, _ = jckpt.load_checkpoint(save_dir, "1", template)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, 32, 48, 6)).astype(np.float32)
    feat = rng.uniform(-1, 1, (1, 32, 48, 8)).astype(np.float32)
    want, wfeat = jnet.apply({"params": params}, jax.numpy.asarray(x), jax.numpy.asarray(feat))
    with torch.no_grad():
        got, gfeat = net(torch.from_numpy(x), torch.from_numpy(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gfeat.numpy(), np.asarray(wfeat), atol=1e-5)


def test_autoresume_from_an_rvdd_tpu_run_restarts_the_moments(data):
    """An rvdd_tpu run directory (its params and optax state, saved by its
    save_checkpoint, and its status.json): the port loads the params and,
    having no optimizer state it reads, restarts the moments."""
    save_dir = os.path.join(data, "ckpt", "from_jax")
    jnet = jfactory.build_network(ARCH, 6, 3, True)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(4), (1, 32, 32, 6))
    from rvdd_tpu.training.train_state import create_train_state as jcreate

    jstate, _ = jcreate(params, "adamw")
    jckpt.save_checkpoint(save_dir, "3", params, jstate.opt_state)
    jckpt.save_status(save_dir, {"epoch": 3, "best_val": 1e9})
    out = train.main(argv(data, "--name", "from_jax", "--niter", "4", "--autoresume",
                          "--no_val"))
    assert [r["epoch"] for r in out["epochs"]] == [4]
    log = open(os.path.join(save_dir, "loss_log.txt")).read()
    assert "autoresumed from epoch 3 (no optimizer state: the moments restart)" in log
    step = torch.load(os.path.join(save_dir, "4_optim_Denoise.pt"))["state"][0]["step"]
    assert float(step) == out["epochs"][0]["steps"] == 4


def test_train_step_overfits_a_tiny_clip():
    """80 AdamW steps at lr 2e-3 on one static clip (tests/test_overfit.py's
    clip: a smooth texture, raw = its mosaic plus noise, zero flows, 3
    unrollings, 12 filters) with tests/test_overfit.py's limits: the loss
    below 0.2 x its start and PSNR up by more than 10 dB.  Calibrated on
    this seed (the port's seeded kaiming weights start nearer the target
    than rvdd_tpu's): the loss falls from 40.72 to 4.95 (ratio 0.121) and
    PSNR rises by 16.2 dB."""
    cfg = EngineConfig(model_patch_depth=2, patch_depth=4, feature_rec=True, warp_impl="plain")
    net = build_network("convunet-mode=fixedfeatures+feat-filters=12", 6, 3, True,
                        device="cpu")
    state = set_learning_rate(create_train_state(net, "adamw"), 2e-3)
    step = make_train_step(cfg)
    h, w = 16, 16
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:2 * h, 0:2 * w]
    gt1 = np.stack([0.6 * np.sin(xx / 3 + k) * np.cos(yy / 4 - k / 2)
                    + 0.2 * np.sin((xx + yy) / 7) for k in range(3)], -1).astype(np.float32)
    t = cfg.patch_depth
    gt = torch.from_numpy(np.broadcast_to(gt1, (1, t, 2 * h, 2 * w, 3)).copy())
    raw = (remosaic(torch.from_numpy(gt1))[None, None]
           + torch.from_numpy(rng.normal(0, 0.08, (1, t, h, w, 4)).astype(np.float32)))
    flows = torch.zeros(1, cfg.train_unrollings, cfg.d, h, w, 2)
    weights = torch.full((cfg.train_unrollings,), 1.0 / cfg.train_unrollings)
    state, first = step(state, raw, flows, gt, weights)
    for _ in range(79):
        state, last = step(state, raw, flows, gt, weights)
    l0, l1 = float(first["Denoiser"]), float(last["Denoiser"])
    p0, p1 = float(first["PSNR"]), float(last["PSNR"])
    assert np.isfinite(l1) and l1 < 0.2 * l0, (l0, l1)
    assert p1 - p0 > 10.0, (p0, p1)


def test_train_cli_needs_a_card_unless_cpu(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        args = argv(data, "--name", "nocard")
        train.main(args[:args.index("--device")] + args[args.index("--device") + 2:])
