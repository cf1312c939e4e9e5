"""The port's data-parallel training (parallel/mesh.py,
training/train_state.py:make_train_step(mesh=...), training/loop.py with
``--distributed``), dry-run on the CPU: four gloo processes started by
``python -m torch.distributed.run --standalone`` (a free rendezvous port of
its own, so parallel test workers do not collide), each with
OMP_NUM_THREADS=1 and a time limit of TIMEOUT seconds, after which the
whole process group is killed and the test fails.

* The step: one AdamW step of a tiny convunet+feat on a global batch of 4
  over ``data4``, against rvdd_tpu's train step on its ``data4`` mesh
  (``shard_batch`` / ``replicate`` on 4 of the conftest's virtual CPU
  devices) from the same weights and inputs; the same with
  ``normalization=batch``, whose statistics span the global batch in
  rvdd_tpu's sharded step and so must span the four processes here.  The losses agree at rtol
  2e-5 (PSNR from the global batch's squared error); the averaged
  gradients within 2e-3 x the largest with cosine above 1 - 1e-6
  (tests/test_gradients.py's limits), against ``jax.value_and_grad`` on the
  sharded batch; the parameters after the step as PARAM_TOL says; and all
  four ranks hold bit-equal gradients and parameters.
* The CLI: a 4-process ``--distributed`` epoch against the same command in
  one process at the same global batch: the epoch's losses within 1e-5
  relative, the saved parameters as PARAM_TOL says a step, one writer of
  every file (one log header a run, no flow file left half-written), and
  an ``--autoresume`` 4-process run continues into epoch 2 with the
  optimizer's step count carried on.
* ``--profile_dir``: a one-process run writes rank0.json, a Chrome trace of
  steps 2..5 (here the epoch ends after step 3) that holds the step's
  ``aten::`` convolutions, and its checkpoints are bit-equal to the same
  run's without the flag.
"""

import json
import os
import pathlib
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from rvdd_tpu.models import factory as jfactory  # noqa: E402
from rvdd_tpu.parallel import mesh as jmesh  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu.training import train_state as jts  # noqa: E402
from rvdd_tpu_torch.cli import generate_data, train  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import convnext_from_flax, convunet_from_flax  # noqa: E402
from rvdd_tpu_torch.training.checkpoints import flax_params, load_checkpoint  # noqa: E402
from test_torch_train_grads import check_grads  # noqa: E402
from test_torch_validate import srgb_clip  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = str(pathlib.Path(__file__).with_name("torch_dist_worker.py"))
TIMEOUT = 300  # seconds a torchrun may take before its processes are killed
ARCH = "convunet-mode=fixedfeatures+feat-filters=8"
LR = 1e-3


def param_close(got: dict, want: dict, grads: dict, steps: int = 1) -> None:
    """PARAM_TOL.  AdamW's first update is lr * g / (|g| + eps), about
    lr * sign(g), and each later one is bounded by lr in the same way: two
    runs whose gradients agree to rounding move every weight alike except
    where a gradient is so near zero that rounding flips its sign, which
    moves that weight by at most 2 lr a step.  So every weight within
    2 lr x steps + 1e-6, and the weights whose gradient (``grads``, the
    reference's, at the first step) exceeds 2e-3 x the largest, which no
    rounding flips, within 1e-6."""
    gscale = max(float(np.abs(g).max()) for g in grads.values())
    for k in want:
        d = np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64))
        assert d.max() <= 2 * LR * steps + 1e-6, (k, d.max())
        big = np.abs(grads[k]) > 2e-3 * gscale
        assert not big.any() or d[big].max() <= 1e-6, (k, d[big].max())


def torchrun(nproc: int, *args: str, timeout: int = TIMEOUT) -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc args...`` from the repo root, in a process group of its own that is
    killed whole after ``timeout`` seconds; returns its output."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(REPO),
                                                        os.environ.get("PYTHONPATH")])))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), *args]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"torchrun did not finish in {timeout} s:\n{out[-6000:]}")
    assert proc.returncode == 0, out[-6000:]
    return out


def _batch(b, h, w, patch_depth, seed=0, future=0):
    rng = np.random.default_rng(seed)
    td = patch_depth - 1
    raw = rng.uniform(-0.9, 0.9, (b, patch_depth + future, h, w, 4)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    flows = np.zeros((b, td, 1 + future, h, w, 2), np.float32)
    for r in range(b):
        for a in range(td):
            for k in range(1 + future):
                flows[r, a, k, ..., 0] = 1.3 + 0.8 * np.sin(xx / 5 + a + r + 2 * k)
                flows[r, a, k, ..., 1] = -0.7 + 0.6 * np.cos(yy / 4 - a * r - k)
    gt = rng.uniform(-0.9, 0.9, (b, patch_depth + future, 2 * h, 2 * w, 3)).astype(np.float32)
    weights = rng.uniform(0.2, 1.0, td).astype(np.float32)
    return raw, flows, gt, weights / weights.sum()


def rvdd_tpu_step(arch: str, spec: str, b: int, h: int, w: int, pd: int, future: int = 0):
    """rvdd_tpu's sharded AdamW step (its losses, the gradients and the
    parameters after the step, in the port's layout) on its ``spec`` mesh of
    the conftest's virtual CPU devices (a space axis shards H, axis -3),
    and the worker's inputs for the port's step on the same mesh from the
    same weights and global batch."""
    raw, flows, gt, weights = _batch(b, h, w, pd, future=future)
    in_nc = (2 + future) * 3
    jcfg = jengine.EngineConfig(model_patch_depth=2, patch_depth=pd, future_patch_depth=future,
                                feature_rec=True, warp_impl="xla", net_impl="xla")
    jnet = jfactory.build_network(arch, in_nc, 3, True)
    params = jfactory.init_network(jnet, jax.random.PRNGKey(1), (1, 2 * h, 2 * w, in_nc))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    to_port = convnext_from_flax if arch.startswith("newunet") else convunet_from_flax
    sd = to_port(np_tree(params))  # before the step donates the state
    jm = jmesh.make_mesh(spec, batch_size=b)
    sh = jmesh.shard_batch(jm, {"raw": raw, "flows": flows, "gt": gt},
                           spatial_axis=-3 if "space" in spec else None)

    # rvdd_tpu's step under an optimizer that first records the gradients
    # in its state: one compile gives its losses, gradients and update
    record = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    state, tx = jts.create_train_state(params, "adamw")
    state = jts.set_learning_rate(state, LR)
    with jm:
        state = jts.TrainState(jmesh.replicate(jm, state.params),
                               jmesh.replicate(jm, (record.init(params), state.opt_state)),
                               state.step)
        state, jlosses = jts.make_train_step(jcfg, jnet, optax.chain(record, tx))(
            state, sh["raw"], sh["flows"], sh["gt"], jnp.asarray(weights))
    jgrads = state.opt_state[0]
    inputs = dict(raw=raw, flows=flows, gt=gt, weights=weights, arch=arch, lr=LR, mesh=spec,
                  patch_depth=pd, future_patch_depth=future,
                  **{f"sd/{k}": v.numpy() for k, v in sd.items()})
    want = dict(losses={k: float(v) for k, v in jlosses.items()},
                grads={k: v.numpy() for k, v in to_port(np_tree(jgrads)).items()},
                params={k: v.numpy() for k, v in to_port(np_tree(state.params)).items()})
    return want, inputs


def run_jobs(nproc: int, tmp, jobs: dict) -> dict:
    """The worker's jobs (name -> inputs) in one ``torchrun`` of ``nproc``
    processes; each job's per-rank results by name."""
    args = []
    for name, inputs in jobs.items():
        os.makedirs(tmp / name)
        np.savez(tmp / f"{name}.npz", **inputs)
        args += [str(tmp / f"{name}.npz"), str(tmp / name)]
    torchrun(nproc, WORKER, "jobs", *args)
    return {name: [dict(np.load(tmp / name / f"rank{r}.npz")) for r in range(nproc)]
            for name in jobs}


#: the ablation whose batch statistics span the global batch.  SiLU, not
#: ReLU: under ReLU the port's one-process gradient of this net is already
#: 1.5e-3 x the largest from rvdd_tpu's (cosine 1 - 2.9e-6, below the bound),
#: under SiLU 9.9e-6 (x86, torch 2.13), so the test sees the mesh alone
BN_ARCH = "convunet-mode=fixedfeatures+feat-filters=8-depth=2-normalization=batch-activation=silu"


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """rvdd_tpu's sharded step and the port's 4-process step on the same
    weights and global batch, for ARCH and BN_ARCH (one torchrun):
    name -> (rvdd_tpu's losses, gradients and parameters after the step,
    in the port's layout; the port's per-rank results)."""
    tmp = tmp_path_factory.mktemp("dp_step")
    cases = {name: rvdd_tpu_step(arch, "data4", 4, 12, 16, 4)
             for name, arch in (("step", ARCH), ("bn", BN_ARCH))}
    ranks = run_jobs(4, tmp, {name: inputs for name, (_, inputs) in cases.items()})
    return {name: (cases[name][0], ranks[name]) for name in cases}


@pytest.fixture(scope="module")
def dp_step(dp_steps):
    return dp_steps["step"]


def check_step(want, ranks, rows):
    """The port's step against rvdd_tpu's: the losses at rtol 2e-5, the
    gradients by check_grads, the parameters by PARAM_TOL, and every rank's
    losses, gradients and parameters bit-equal to rank 0's."""
    got = {k[5:]: v for k, v in ranks[0].items() if k.startswith("grad/")}
    check_grads(got, want["grads"])
    params = {k[6:]: v for k, v in ranks[0].items() if k.startswith("param/")}
    assert params.keys() == want["params"].keys()
    param_close(params, want["params"], want["grads"])
    for r in ranks:
        assert int(r["rows"]) == rows
        for k in ("L1", "PSNR", "Denoiser"):
            np.testing.assert_allclose(float(r[f"loss/{k}"]), want["losses"][k], rtol=2e-5)
        for k, v in ranks[0].items():
            if k.startswith(("grad/", "param/", "loss/")):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_dp_step_batch_norm_matches_rvdd_tpu_sharded_step(dp_steps):
    """normalization=batch under data4: the statistics of the four
    processes' rows together, as rvdd_tpu's over its sharded global batch.
    Statistics of each process's own rows gave an L1 of 86.958 against
    rvdd_tpu's 84.804 (2.5e-2 relative, against the rtol of 2e-5) and
    gradients 0.29 x the largest from rvdd_tpu's (against 2e-3)."""
    want, ranks = dp_steps["bn"]
    check_step(want, ranks, rows=1)


def test_dp_step_losses_match_rvdd_tpu_sharded_step(dp_step):
    want, ranks = dp_step
    for r in ranks:
        assert int(r["rows"]) == 1
        for k in ("L1", "PSNR", "Denoiser"):
            np.testing.assert_allclose(float(r[f"loss/{k}"]), want["losses"][k], rtol=2e-5)


def test_dp_step_gradients_match_rvdd_tpu_sharded_step(dp_step):
    want, ranks = dp_step
    got = {k[5:]: v for k, v in ranks[0].items() if k.startswith("grad/")}
    check_grads(got, want["grads"])


def test_dp_step_parameters_match_and_are_bit_equal_across_ranks(dp_step):
    want, ranks = dp_step
    got = {k[6:]: v for k, v in ranks[0].items() if k.startswith("param/")}
    assert got.keys() == want["params"].keys()
    param_close(got, want["params"], want["grads"])
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k.startswith(("grad/", "param/", "loss/")):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


# ------------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_cli"))
    srgb_clip(root, 5, 48, 64)
    src = os.path.join(root, "srgb", "%03d", "%08d.png")
    generate_data.main(["--input_train_dataset", src, "--input_val_dataset", src,
                        "--nb_seq_train", "1", "--nb_seq_val", "1", "--first", "0", "--last",
                        "4", "--step", "1", "--output_train_dataset",
                        os.path.join(root, "train"), "--output_val_dataset",
                        os.path.join(root, "validation"), "--device", "cpu"])
    return root


def argv(root, name, *extra):
    return ["--netDenoiser", ARCH, "--feature_rec", "--dataroot", os.path.join(root, "train"),
            "--val_dataroot", os.path.join(root, "validation"), "--gtFolder", "gt_iso3200",
            "--nFolder", "noisy_iso3200", "--gt_linear_RGB_Folder", "gt_raw_linear_RGB_iso3200",
            "--val_videos", "000", "--checkpoints_dir", os.path.join(root, "ckpt"),
            "--patch_width", "16", "--patch_stride", "4", "--patch_depth", "3",
            "--frames2load", "4", "--unroll_focus", "all", "--niter", "1", "--niter_decay",
            "0", "--print_freq", "4", "--lr", str(LR), "--device", "cpu", "--name", name,
            *extra]


@pytest.fixture(scope="module")
def cli_runs(data):
    """A 4-process epoch at batch 4 (its ranks' results), the same epoch in
    one process, then a 4-process --autoresume into epoch 2 through
    ``-m rvdd_tpu_torch.cli.train``."""
    out = os.path.join(data, "dp_results")
    os.makedirs(out)
    torchrun(4, WORKER, "cli", out, *argv(data, "dp", "--batch_size", "4", "--distributed"))
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(4)]
    single = train.main(argv(data, "single", "--batch_size", "4"))
    resume_log = torchrun(4, "-m", "rvdd_tpu_torch.cli.train",
                          *argv(data, "dp", "--batch_size", "4", "--distributed", "--niter", "2",
                                "--autoresume"))
    return ranks, single, resume_log


def test_dp_cli_epoch_matches_one_process(data, cli_runs):
    ranks, single, _ = cli_runs
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert {(r["world_size"], r["backend"]) for r in ranks} == {(4, "gloo")}
    assert single["world_size"] == 1 and single["backend"] is None
    (want,) = single["epochs"]
    assert want["steps"] >= 2 and want["finite"]
    for r in ranks:
        (got,) = r["epochs"]
        assert got["steps"] == want["steps"] and got["finite"]
        for which in ("first", "last"):
            for k, v in want[which].items():
                assert got[which][k] == pytest.approx(v, rel=1e-5), (r["rank"], which, k)
        # rank 0's validation loss, broadcast to every rank
        assert got["val"]["Denoiser_valLoss"] == ranks[0]["epochs"][0]["val"][
            "Denoiser_valLoss"]
    assert ranks[0]["epochs"][0]["val"]["Denoiser_valLoss"] == pytest.approx(
        want["val"]["Denoiser_valLoss"], rel=1e-4)
    nets = []
    for name in ("dp", "single"):
        net = build_network(ARCH, 6, 3, True, seed=9, device="cpu")
        load_checkpoint(os.path.join(data, "ckpt", name), "1", net)
        nets.append({k: v.numpy() for k, v in net.state_dict().items()})
    # PARAM_TOL without the gradients: every weight within 2 lr a step, and
    # all but the near-zero-gradient few within 1e-6 (measured: all 16,203
    # within 1.4e-7, x86, torch 2.13)
    param_close(nets[0], nets[1], {k: np.zeros_like(v) for k, v in nets[1].items()},
                steps=want["steps"])
    d = np.concatenate([np.abs(nets[0][k] - nets[1][k]).ravel() for k in nets[1]])
    assert np.mean(d <= 1e-6) >= 0.999, np.sort(d)[-10:]


def test_dp_cli_has_one_writer(data, cli_runs):
    ranks, single, resume_log = cli_runs
    dp, one = os.path.join(data, "ckpt", "dp"), os.path.join(data, "ckpt", "single")
    log = open(os.path.join(dp, "loss_log.txt")).read()
    # two runs (the epoch, the resume), one header and one epoch-end line each
    assert log.count("================ Training Loss") == 2
    assert log.count("End of epoch 1 / 1") == 1 and log.count("End of epoch 2 / 2") == 1
    assert log.count("data-parallel: 4 process(es) on gloo, 1 of each batch's 4 rows") == 2
    one_log = open(os.path.join(one, "loss_log.txt")).read()
    assert (log.count("(epoch: 1, iters:") == one_log.count("(epoch: 1, iters:") > 0)
    assert set(os.listdir(dp)) == set(os.listdir(one)) | {"2_net_Denoise.msgpack",
                                                          "2_optim_Denoise.pt"}
    assert sorted(os.listdir(os.path.join(dp, "val_visuals", "000"))) == sorted(
        os.listdir(os.path.join(one, "val_visuals", "000")))
    assert all(r["flows_computed"] > 0 for r in ranks)
    flow_dir = os.path.join(data, "train", "flow", "noisy_iso3200", "tvl1", "noisyinputs", "000")
    names = os.listdir(flow_dir)
    assert names and all(re.fullmatch(r"\d+_\d+\.tif", n) for n in names), names


def test_dp_cli_autoresume_continues_the_optimizer(data, cli_runs):
    _, single, resume_log = cli_runs
    dp = os.path.join(data, "ckpt", "dp")
    assert "autoresumed from epoch 1\n" in open(os.path.join(dp, "loss_log.txt")).read()
    assert json.load(open(os.path.join(dp, "status.json")))["epoch"] == 2
    steps = single["epochs"][0]["steps"]
    counts = [float(torch.load(os.path.join(dp, f"{e}_optim_Denoise.pt"))["state"][0]["step"])
              for e in (1, 2)]
    assert counts == [steps, 2 * steps]


def test_profile_dir_traces_steps_and_changes_nothing(data, tmp_path):
    """--profile_dir in one process: rank0.json holds the traced steps'
    aten:: convolutions; the checkpoints equal an unprofiled run's bit for
    bit."""
    prof = str(tmp_path / "prof")
    runs = {}
    for name, extra in (("plain", []), ("profiled", ["--profile_dir", prof])):
        runs[name] = train.main(argv(data, name, "--batch_size", "2", "--no_val", *extra))
    assert runs["profiled"]["epochs"][0]["steps"] == 4  # steps 2 and 3 traced
    assert runs["profiled"]["trace"] == os.path.join(prof, "rank0.json")
    assert runs["plain"]["trace"] is None and os.listdir(prof) == ["rank0.json"]
    assert runs["profiled"]["epochs"][0]["trace_s"] > 0
    assert "trace_s" not in runs["plain"]["epochs"][0]
    events = json.load(open(os.path.join(prof, "rank0.json")))["traceEvents"]
    convs = [e for e in events if e.get("name") in ("aten::convolution", "aten::conv2d")]
    assert convs and any(e.get("name") == "aten::convolution_backward" for e in events)
    for e in ("0", "1", "latest"):
        a, b = (flax_params_of(os.path.join(data, "ckpt", n), e) for n in ("plain", "profiled"))
        assert a == b, e


def flax_params_of(save_dir: str, epoch: str) -> bytes:
    """The checkpoint's bytes, by way of a net (so any difference in the
    serialized weights shows)."""
    net = build_network(ARCH, 6, 3, True, device="cpu")
    load_checkpoint(save_dir, epoch, net)
    return b"".join(v.tobytes() for _, v in sorted(_leaves(flax_params(net))))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)
