"""The mesh's ``space`` axis in the port (parallel/space.py, the module
path on a shard, training/train_state.py's reduction, ``--mesh_shape
data<N>xspace<M>``), dry-run on the CPU: gloo processes started by
tests/test_torch_dist.py's ``torchrun`` helper (OMP_NUM_THREADS=1, killed
after its TIMEOUT), each run held against rvdd_tpu on the conftest's
virtual CPU devices from the same numpy inputs and converted weights, or
against the port's own unsharded op.

* (a) one AdamW step of the tiny convunet+feat on ``data2xspace2`` (4
  processes; raw rows 20 cut 8 + 12, so the last shard is ragged) against
  rvdd_tpu's step on its ``data2xspace2`` mesh: test_torch_dist.py's
  limits (losses at rtol 2e-5, gradients within 2e-3 x the largest with
  cosine above 1 - 1e-6, parameters by PARAM_TOL, every rank bit-equal).
* (b) the flagship ``newunet-mode=feat`` with features and a future frame
  on ``data1xspace2`` at narrow widths, with ``remat`` (the backward
  recomputes each unrolling, exchanges included), the same limits: the
  7x7 depthwise's 3-row halo reaches past the 2-row shards of its deepest
  level, and the align_corners=True upsample reads across the cut.
* (c) rvdd_tpu's sharded ``inference_step`` case (tests/test_round3.py) on
  ``data2xspace2``, at its atol of 2e-5.
* (d) a 2-process ``--distributed --mesh_shape data1xspace2`` CLI epoch
  against the same command in one process, at
  ``test_dp_cli_epoch_matches_one_process``'s limits, with one writer.
* (e) the exchanges on ``data1xspace4`` with a ragged last shard (raw rows
  19 cut 4 + 4 + 4 + 7), forward and backward against the unsharded op:
  the dilated bottleneck (dilation 4 at a level of 2-row shards),
  ``transposedconv3`` and ``transposedconv4`` (and the centring of a
  2h - 1 upsample in an odd level), instance and batch norm, ``stridedconv``,
  the ConvNeXt blocks, the warp with displacements beyond a shard, and the
  differentiable sum.

(a), (c) and (e) share one torchrun of 4 processes.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from rvdd_tpu.models import build_network as jbuild_network  # noqa: E402
from rvdd_tpu.models.factory import init_network  # noqa: E402
from rvdd_tpu.parallel import mesh as jmesh  # noqa: E402
from rvdd_tpu.recurrent import engine as jengine  # noqa: E402
from rvdd_tpu_torch.cli import train  # noqa: E402
from rvdd_tpu_torch.models import build_network  # noqa: E402
from rvdd_tpu_torch.models.convert import convunet_from_flax  # noqa: E402
from rvdd_tpu_torch.ops.warp import warp  # noqa: E402
from rvdd_tpu_torch.parallel.space import split_rows  # noqa: E402
from rvdd_tpu_torch.training.checkpoints import load_checkpoint  # noqa: E402
from test_torch_dist import (  # noqa: E402,F401
    ARCH,
    WORKER,
    argv,
    check_step,
    data,
    param_close,
    run_jobs,
    rvdd_tpu_step,
    torchrun,
)

#: the flagship at narrow widths: depth 4 (a 5-row deepest level), one block
#: a stage
FLAGSHIP = ("newunet-mode=feat-filters=8-n_blocks_encoder=1-n_blocks_decoder=1-"
            "n_blocks_bottleneck=1-n_blocks_postprocessing=1")
#: (e): the nets whose exchanges are held against the unsharded ones
OPS_ARCHS = (
    "convunet-mode=fixedfeatures+feat-filters=4-depth=3-bottleneck_depth=3-"
    "bottleneck_dilation=true-upsampling_mode=transposedconv3-normalization=instance",
    "convunet-mode=fixedfeatures+feat-filters=4-depth=3-downsampling_mode=stridedconv-"
    "upsampling_mode=transposedconv4-normalization=batch-activation=silu",
    "newunet-mode=feat-filters=4-depth=3-n_blocks_encoder=1-n_blocks_decoder=1-"
    "n_blocks_bottleneck=1-n_blocks_postprocessing=1",
)
OPS_RAW_H, OPS_ALIGN, OPS_W, OPS_C = 19, 4, 8, 6
#: (e)'s limit: outputs and input gradients within OPS_TOL x their largest,
#: parameter gradients within OPS_TOL x the net's largest (fp32 rounding of
#: reordered sums; measured below 3e-6, x86, torch 2.13)
OPS_TOL = 2e-5
INFER_ARCH = "convunet-mode=fixedfeatures+feat-depth=2-filters=8"


def _ops_inputs():
    rng = np.random.default_rng(0)
    b, hh = 2, 2 * OPS_RAW_H
    z = dict(kind="ops", mesh="data1xspace4", raw_height=OPS_RAW_H, row_align=OPS_ALIGN,
             x=rng.standard_normal((b, hh, OPS_W, OPS_C)).astype(np.float32),
             feat=rng.standard_normal((b, hh, OPS_W, 4)).astype(np.float32),
             gy=rng.standard_normal((b, hh, OPS_W, 3)).astype(np.float32),
             gf=rng.standard_normal((b, hh, OPS_W, 4)).astype(np.float32),
             gw=rng.standard_normal((b, hh, OPS_W, OPS_C)).astype(np.float32))
    yy = np.arange(hh)[None, :, None]
    v = (12 * np.sin(yy / 5.0 + np.arange(OPS_W)[None, None] / 3)
         + rng.uniform(-1, 1, (b, hh, OPS_W)))
    z["flow"] = np.stack([rng.uniform(-3, 3, (b, hh, OPS_W)), v], -1).astype(np.float32)
    z.update({f"arch{i}": a for i, a in enumerate(OPS_ARCHS)})
    return z


def _infer_case():
    """rvdd_tpu's sharded inference (tests/test_round3.py's case) and the
    worker's inputs."""
    cfg = jengine.EngineConfig(model_patch_depth=2, patch_depth=2, feature_rec=True,
                               warp_impl="xla")
    net = jbuild_network(INFER_ARCH, cfg.network_input_nc, 3, True)
    b, h, w = 4, 32, 32
    params = init_network(net, jax.random.PRNGKey(0), (1, 2 * h, 2 * w, cfg.network_input_nc))
    rng = np.random.default_rng(3)
    raw = rng.uniform(-1, 1, (b, 2, h, w, 4)).astype(np.float32)
    yy, xx = np.mgrid[0:2 * h, 0:2 * w]
    fl = np.stack([1.1 + np.sin(xx / 19), -0.5 + 0.4 * np.cos(yy / 13)], -1)
    flows = np.broadcast_to(fl[::2, ::2] / 2, (b, 1, 1, h, w, 2)).astype(np.float32).copy()

    def step(params, raw, flows):
        frames, flows2 = jengine.prepare_frames(cfg, raw, flows)
        nil = net.nil_features(frames.shape[0], 2 * h, 2 * w)
        den, _ = jengine.inference_step(cfg, net, params, None, frames, flows2[:, 0], nil)
        return den

    jm = jmesh.make_mesh("data2xspace2")
    with jm:
        want = np.asarray(jax.jit(step)(jmesh.replicate(jm, params),
                                        jmesh.shard_batch(jm, raw, spatial_axis=-3),
                                        jmesh.shard_batch(jm, flows, spatial_axis=-3)))
    sd = convunet_from_flax(jax.tree_util.tree_map(np.asarray, params))
    inputs = dict(kind="infer", arch=INFER_ARCH, mesh="data2xspace2", raw=raw, flows=flows,
                  **{f"sd/{k}": v.numpy() for k, v in sd.items()})
    return want, inputs


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """(a), (c) and (e) in one torchrun of 4 processes: name ->
    (reference, inputs, per-rank results)."""
    cases = {"step": rvdd_tpu_step(ARCH, "data2xspace2", 4, 20, 16, 4),
             "infer": _infer_case(), "ops": (None, _ops_inputs())}
    ranks = run_jobs(4, tmp_path_factory.mktemp("space4"),
                     {name: inputs for name, (_, inputs) in cases.items()})
    return {name: (want, inputs, ranks[name]) for name, (want, inputs) in cases.items()}


def test_space_step_matches_rvdd_tpu_sharded_step(four):
    want, _, ranks = four["step"]
    check_step(want, ranks, rows=2)


def test_space_flagship_step_matches_rvdd_tpu_sharded_step(tmp_path):
    want, inputs = rvdd_tpu_step(FLAGSHIP, "data1xspace2", 2, 20, 16, 3, future=1)
    ranks = run_jobs(2, tmp_path, {"flagship": dict(inputs, remat=True)})["flagship"]
    check_step(want, ranks, rows=2)


def test_space_inference_step_matches_rvdd_tpu(four):
    want, inputs, ranks = four["infer"]
    got = np.full_like(want, np.nan)
    for r in ranks:
        d = int(r["data_index"])
        got[2 * d:2 * d + 2, int(r["start"]):int(r["stop"])] = r["den"]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def _close(got, want, scale, what):
    err = float(np.abs(got - want).max())
    assert err <= OPS_TOL * scale, f"{what}: max|d| {err:.3e} against {scale:.3e}"


def test_space_exchanges_match_unsharded_ops(four):
    _, z, ranks = four["ops"]
    rows = split_rows(OPS_RAW_H, 4, OPS_ALIGN).scale(2)
    assert [(int(r["start"]), int(r["stop"])) for r in ranks] == list(rows.bounds)
    # the halo is wider than a shard: dilation 4 on the deepest level's 2-row
    # shards; the flow reaches beyond a shard's 8 rows
    assert min(b - a for a, b in rows.down().down().bounds) < 4
    assert np.abs(z["flow"][..., 1]).max() > max(b - a for a, b in rows.bounds[:-1])
    t = {k: torch.from_numpy(z[k]) for k in ("x", "feat", "gy", "gf", "gw", "flow")}
    for i, arch in enumerate(OPS_ARCHS):
        x, feat = t["x"].clone().requires_grad_(True), t["feat"].clone().requires_grad_(True)
        net = build_network(arch, OPS_C, 3, True, seed=i, device="cpu")
        y, f = net(x, feat)
        ((y * t["gy"]).sum() + (f * t["gf"]).sum()).backward()
        for key, ref in (("y", y), ("f", f), ("dx", x.grad), ("dfeat", feat.grad)):
            ref = ref.detach().numpy()
            _close(_rows(ranks, f"{i}/{key}"), ref, np.abs(ref).max(), f"{arch}: {key}")
        gscale = max(float(p.grad.abs().max()) for p in net.parameters())
        for k, p in net.named_parameters():
            _close(sum(r[f"{i}/grad/{k}"] for r in ranks), p.grad.numpy(), gscale,
                   f"{arch}: d{k}")
    x = t["x"].clone().requires_grad_(True)
    w, _ = warp(x, t["flow"], "bicubic")
    (w * t["gw"]).sum().backward()
    for key, ref in (("warp/y", w.detach().numpy()), ("warp/dx", x.grad.numpy())):
        _close(_rows(ranks, key), ref, np.abs(ref).max(), key)
    for r in ranks:
        np.testing.assert_allclose(float(r["sum"]), z["x"].sum(), rtol=1e-5)
        assert float(r["sum/grad"]) == 12.0  # 3 x 4 shards


# ------------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def cli_space(data):
    """A 2-process ``--mesh_shape data1xspace2`` epoch at batch 2 (its
    ranks' results) and the same epoch in one process."""
    out = os.path.join(data, "space_results")
    os.makedirs(out)
    torchrun(2, WORKER, "cli", out, *argv(data, "space", "--batch_size", "2", "--distributed",
                                         "--mesh_shape", "data1xspace2"))
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(2)]
    return ranks, train.main(argv(data, "space_single", "--batch_size", "2"))


def test_space_cli_epoch_matches_one_process(data, cli_space):
    ranks, single = cli_space
    assert [r["rank"] for r in ranks] == [0, 1]
    assert {(r["world_size"], r["backend"]) for r in ranks} == {(2, "gloo")}
    (want,) = single["epochs"]
    assert want["steps"] >= 2 and want["finite"]
    for r in ranks:
        (got,) = r["epochs"]
        assert got["steps"] == want["steps"] and got["finite"]
        for which in ("first", "last"):
            for k, v in want[which].items():
                assert got[which][k] == pytest.approx(v, rel=1e-5), (r["rank"], which, k)
    assert ranks[0]["epochs"][0]["val"]["Denoiser_valLoss"] == pytest.approx(
        want["val"]["Denoiser_valLoss"], rel=1e-4)
    nets = []
    for name in ("space", "space_single"):
        net = build_network(ARCH, 6, 3, True, seed=9, device="cpu")
        load_checkpoint(os.path.join(data, "ckpt", name), "1", net)
        nets.append({k: v.numpy() for k, v in net.state_dict().items()})
    param_close(nets[0], nets[1], {k: np.zeros_like(v) for k, v in nets[1].items()},
                steps=want["steps"])
    d = np.concatenate([np.abs(nets[0][k] - nets[1][k]).ravel() for k in nets[1]])
    assert np.mean(d <= 1e-6) >= 0.999, np.sort(d)[-10:]
    # one writer: one log header, the mesh named, the same files
    sp, one = os.path.join(data, "ckpt", "space"), os.path.join(data, "ckpt", "space_single")
    log = open(os.path.join(sp, "loss_log.txt")).read()
    assert log.count("================ Training Loss") == 1
    assert "data-parallel: 2 process(es) on gloo, 2 of each batch's 2 rows a process (mesh " \
           "data1xspace2: each patch's rows in blocks of 8 raw rows" in log
    assert set(os.listdir(sp)) == set(os.listdir(one))


def test_space_cli_epoch_records_its_exchange_bytes(cli_space):
    """On a space axis each rank's epoch record holds the MB a step it
    handed to the axis's collectives (``space.all_gather.bytes`` and
    ``space.all_sum.bytes``); the one-process epoch has none."""
    ranks, single = cli_space
    for r in ranks:
        (got,) = r["epochs"]
        assert got["exchange_mb_per_step"] > 0
    assert "exchange_mb_per_step" not in single["epochs"][0]
