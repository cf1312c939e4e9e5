"""A rank of the port's data-parallel runs in tests/test_torch_dist.py,
started by ``python -m torch.distributed.run --standalone``.  It imports
torch and rvdd_tpu_torch only (no JAX).

    torch_dist_worker.py step IN.npz OUT_DIR
        one data-parallel AdamW step of the port on gloo: the net's weights
        (``sd/<key>``), the global batch (raw, flows, gt, weights) and the
        arguments (arch, lr, mesh) come from IN.npz; each rank writes
        OUT_DIR/rank<r>.npz with its losses (``loss/<name>``), the averaged
        gradients (``grad/<key>``) and the parameters after the step
        (``param/<key>``).
    torch_dist_worker.py cli OUT_DIR TRAIN_ARGV...
        rvdd_tpu_torch.cli.train.main(TRAIN_ARGV); each rank writes what it
        returned to OUT_DIR/rank<r>.json.
"""

import json
import os
import sys

import numpy as np
import torch


def step(inp: str, out_dir: str) -> None:
    from rvdd_tpu_torch.models import build_network
    from rvdd_tpu_torch.parallel.mesh import init_distributed, make_mesh, replicate, shard_batch
    from rvdd_tpu_torch.recurrent.engine import EngineConfig
    from rvdd_tpu_torch.training.train_state import (
        create_train_state,
        make_train_step,
        set_learning_rate,
    )

    z = np.load(inp)
    dev = init_distributed("cpu")
    cfg = EngineConfig(model_patch_depth=2, patch_depth=int(z["patch_depth"]), feature_rec=True,
                       warp_impl="plain")
    # every rank starts from its own seed: replicate must make them rank 0's
    rank = torch.distributed.get_rank()
    net = build_network(str(z["arch"]), cfg.network_input_nc, 3, True, seed=rank, device=dev)
    if rank == 0:
        net.load_state_dict({k[3:]: torch.from_numpy(z[k]) for k in z.files
                             if k.startswith("sd/")})
    mesh = make_mesh(str(z["mesh"]), batch_size=z["raw"].shape[0])
    replicate(mesh, net)
    state = set_learning_rate(create_train_state(net, "adamw"), float(z["lr"]))
    batch = shard_batch(mesh, {k: torch.from_numpy(z[k]) for k in ("raw", "flows", "gt")})
    _, losses = make_train_step(cfg, "highest", mesh)(
        state, batch["raw"], batch["flows"], batch["gt"], torch.from_numpy(z["weights"]))
    out = {f"loss/{k}": v.numpy() for k, v in losses.items()}
    out.update({f"grad/{k}": p.grad.numpy() for k, p in net.named_parameters()})
    out.update({f"param/{k}": p.detach().numpy() for k, p in net.named_parameters()})
    out["rows"] = np.int64(batch["raw"].shape[0])
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def cli(out_dir: str, argv) -> None:
    from rvdd_tpu_torch.cli import train

    res = train.main(argv)
    with open(os.path.join(out_dir, f"rank{res['rank']}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    if sys.argv[1] == "step":
        step(sys.argv[2], sys.argv[3])
    else:
        cli(sys.argv[2], sys.argv[3:])
