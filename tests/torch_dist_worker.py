"""A rank of the port's multi-process runs in tests/test_torch_dist.py and
tests/test_torch_space.py, started by ``python -m torch.distributed.run
--standalone``.  It imports torch and rvdd_tpu_torch only (no JAX).

    torch_dist_worker.py jobs IN.npz OUT_DIR [IN.npz OUT_DIR ...]
        one gloo process group, then each job of the list in turn, its
        kind in IN.npz's ``kind`` ('step' where absent):

        step   one AdamW step of the port on the mesh ``mesh``: the net's
               weights (``sd/<key>``, loaded on rank 0 and replicated), the
               global batch (raw, flows, gt, weights) and the arguments
               (arch, lr, patch_depth, future_patch_depth, remat); each rank takes
               its data rows and, under a space axis, its rows of each
               patch, and writes OUT_DIR/rank<r>.npz with its losses
               (``loss/<name>``), the reduced gradients (``grad/<key>``),
               the parameters after the step (``param/<key>``) and its rows
               of the batch (``rows``).
        infer  rvdd_tpu's sharded inference step (tests/test_round3.py):
               prepare_frames and inference_step on this rank's shard of
               (raw, flows) under the mesh's scope; OUT_DIR/rank<r>.npz
               holds its output rows (``den``), its data index and its
               first and last RGB row.
        ops    the row exchanges on ``mesh`` (one data shard): for each
               architecture ``arch<i>``, the net on this rank's rows of
               (x, feat) with the loss sum(y * gy) + sum(f * gf); then the
               warp of x by ``flow``.  OUT_DIR/rank<r>.npz holds the
               outputs' rows, the inputs' gradients' rows and the rank's
               part of each parameter gradient, and its RGB rows.

    torch_dist_worker.py cli OUT_DIR TRAIN_ARGV...
        rvdd_tpu_torch.cli.train.main(TRAIN_ARGV); each rank writes what it
        returned to OUT_DIR/rank<r>.json.
"""

import json
import os
import sys

import numpy as np
import torch


def _net(z, arch, cfg, dev, rank0_only=False):
    """The net of ``arch`` with the weights ``sd/<key>`` of z (on rank 0
    alone with ``rank0_only``: every rank starts from its own seed and
    :func:`replicate` must make them rank 0's)."""
    from rvdd_tpu_torch.models import build_network

    rank = torch.distributed.get_rank()
    net = build_network(arch, cfg.network_input_nc, 3, True, seed=rank, device=dev)
    if rank == 0 or not rank0_only:
        net.load_state_dict({k[3:]: torch.from_numpy(z[k]) for k in z.files
                             if k.startswith("sd/")})
    return net


def step(z, dev, out_dir: str) -> None:
    from rvdd_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from rvdd_tpu_torch.recurrent.engine import EngineConfig
    from rvdd_tpu_torch.training.train_state import (
        create_train_state,
        make_train_step,
        set_learning_rate,
    )

    fd = int(z["future_patch_depth"]) if "future_patch_depth" in z.files else 0
    remat = bool(z["remat"]) if "remat" in z.files else False
    cfg = EngineConfig(model_patch_depth=2, patch_depth=int(z["patch_depth"]), feature_rec=True,
                       future_patch_depth=fd, warp_impl="plain", remat=remat)
    net = _net(z, str(z["arch"]), cfg, dev, rank0_only=True)
    mesh = make_mesh(str(z["mesh"]), batch_size=z["raw"].shape[0],
                     row_align=2 ** (net.depth - 1))
    replicate(mesh, net)
    state = set_learning_rate(create_train_state(net, "adamw"), float(z["lr"]))
    batch = shard_batch(mesh, {k: torch.from_numpy(z[k]) for k in ("raw", "flows", "gt")},
                        spatial_axis=-3)
    _, losses = make_train_step(cfg, "highest", mesh)(
        state, batch["raw"], batch["flows"], batch["gt"], torch.from_numpy(z["weights"]),
        height=z["raw"].shape[-3])
    out = {f"loss/{k}": v.numpy() for k, v in losses.items()}
    out.update({f"grad/{k}": p.grad.numpy() for k, p in net.named_parameters()})
    out.update({f"param/{k}": p.detach().numpy() for k, p in net.named_parameters()})
    out["rows"] = np.int64(batch["raw"].shape[0])
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)


def infer(z, dev, out_dir: str) -> None:
    from rvdd_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_scope
    from rvdd_tpu_torch.recurrent.engine import EngineConfig, inference_step, prepare_frames

    cfg = EngineConfig(model_patch_depth=2, patch_depth=2, feature_rec=True, warp_impl="plain")
    net = _net(z, str(z["arch"]), cfg, dev)
    raw = z["raw"]
    mesh = make_mesh(str(z["mesh"]), batch_size=raw.shape[0], row_align=2 ** (net.depth - 1))
    sh = shard_batch(mesh, {k: torch.from_numpy(z[k]) for k in ("raw", "flows")},
                     spatial_axis=-3)
    with shard_scope(mesh, raw.shape[-3]):
        frames, flows = prepare_frames(cfg, sh["raw"], sh["flows"])
        nil = net.nil_features(frames.shape[0], frames.shape[2], frames.shape[3])
        den, _ = inference_step(cfg, net, None, frames, flows[:, 0], nil)
    rows = mesh.space_rows(raw.shape[-3]).scale(2)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), den=den.numpy(),
             data_index=mesh.data_index, start=rows.start, stop=rows.stop)


def ops(z, dev, out_dir: str) -> None:
    from rvdd_tpu_torch.models import build_network
    from rvdd_tpu_torch.ops.warp import warp
    from rvdd_tpu_torch.parallel import space
    from rvdd_tpu_torch.parallel.mesh import make_mesh, shard_scope

    h = int(z["raw_height"])
    mesh = make_mesh(str(z["mesh"]), row_align=int(z["row_align"]))
    rows = mesh.space_rows(h).scale(2)
    sl = slice(rows.start, rows.stop)
    out = {"start": rows.start, "stop": rows.stop}

    def leaf(name):
        return torch.from_numpy(z[name][:, sl]).requires_grad_(True)

    i = 0
    while f"arch{i}" in z.files:
        x, feat = leaf("x"), leaf("feat")
        net = build_network(str(z[f"arch{i}"]), x.shape[-1], 3, True, seed=i, device=dev)
        with shard_scope(mesh, h):
            y, f = net(x, feat)
            loss = (y * torch.from_numpy(z["gy"][:, sl])).sum() + (
                f * torch.from_numpy(z["gf"][:, sl])).sum()
            loss.backward()
        out.update({f"{i}/y": y.detach().numpy(), f"{i}/f": f.detach().numpy(),
                    f"{i}/dx": x.grad.numpy(), f"{i}/dfeat": feat.grad.numpy()})
        out.update({f"{i}/grad/{k}": p.grad.numpy() for k, p in net.named_parameters()})
        i += 1
    x = leaf("x")
    w, _ = warp(x, torch.from_numpy(z["flow"][:, sl]), "bicubic", rows=rows)
    (w * torch.from_numpy(z["gw"][:, sl])).sum().backward()
    out.update({"warp/y": w.detach().numpy(), "warp/dx": x.grad.numpy()})
    # a sample's sum and its gradient over the shards
    t = x.detach().sum().requires_grad_(True)
    total = space.all_sum(t, rows.group)
    (total * 3.0).backward()
    out.update({"sum": total.detach().numpy(), "sum/grad": t.grad.numpy()})
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)


JOBS = {"step": step, "infer": infer, "ops": ops}


def jobs(pairs) -> None:
    from rvdd_tpu_torch.parallel.mesh import init_distributed

    dev = init_distributed("cpu")
    for inp, out_dir in zip(pairs[::2], pairs[1::2]):
        z = np.load(inp)
        JOBS[str(z["kind"]) if "kind" in z.files else "step"](z, dev, out_dir)
    torch.distributed.destroy_process_group()


def cli(out_dir: str, argv) -> None:
    from rvdd_tpu_torch.cli import train

    res = train.main(argv)
    with open(os.path.join(out_dir, f"rank{res['rank']}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    if sys.argv[1] == "jobs":
        jobs(sys.argv[2:])
    else:
        cli(sys.argv[2], sys.argv[3:])
