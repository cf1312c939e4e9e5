"""The ``train_space`` generator: the program's train step over a mesh of
several cards with a ``space`` axis (``mesh``, e.g. ``data1xspace4``), one
process a card on NCCL.

This process is rank 0 and starts the others (this file, run as a script).
Every rank makes the same weights and batches from the seed on its own
card and takes its rows of each batch (``shard_batch``); the program's
step (``make_train_step`` with the mesh, the module path under
``shard_scope``) exchanges the rows each layer needs across the cuts and
reduces the gradients.  Rank 0 decides when the window ends and tells the
others over a gloo group on the host after each step.  The traced run
profiles ``trace_steps`` steps on every rank; rank 0's trace gives the
per-layer metrics, every rank's its busy share.

The check (train.py's numbers): rank 0 follows the checked steps with the
reference on whole frames on its own card, once every rank has left the
mesh and freed its state: one sample at a time, each unrolling recomputed
in the backward, the sample gradients summed (the net has no statistics
across samples, so this is the batch's gradient).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys

import torch

if __package__ in (None, ""):  # started as a worker process
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from h100_bench import harness, weights  # noqa: E402
from h100_bench.traffic import train  # noqa: E402

#: seconds rank 0 waits for the other ranks to end after its own run
JOIN_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(r: harness.Run) -> harness.Outcome:
    world = int(r.cell["chips"])
    port = _free_port()
    args = {"cell": r.cell["name"], "seed": r.seed, "seconds": r.seconds, "trace": r.trace,
            "device": r.device, "variant": r.variant, "mix": r.mix, "port": port,
            "cores": harness.CORES}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), json.dumps(args),
                               str(rank)], stdout=subprocess.DEVNULL)
             for rank in range(1, world)]
    try:
        out = rank_main(r, 0, world, port)
    finally:
        for p in procs:
            try:
                p.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode != 0]
    if bad:
        raise RuntimeError(f"train_space: {len(bad)} rank(s) failed (exit codes {bad})")
    return out


def rank_main(r: harness.Run, rank: int, world: int, port: int):
    """One rank's run; rank 0 returns the Outcome, the others None."""
    import torch.distributed as dist

    from rvdd_tpu_torch.parallel.mesh import init_distributed, make_mesh, replicate, shard_batch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dev = init_distributed(r.device)
    ctrl = dist.new_group(backend="gloo")
    mix, cfg = r.mix, r.cfg
    mesh = make_mesh(mix["mesh"], batch_size=mix["batch"],
                     row_align=2 ** (cfg["net"]["depth"] - 1))
    precision = train.precision_of(r)
    gen = torch.Generator(device=dev).manual_seed(r.seed)
    params = weights.make(cfg, gen, dev)
    pool, wts = train.make_pool(mix, cfg, gen, dev)
    checked = mix["checked_steps"]
    shards = []
    for frames, fl, gt in pool:
        cut = shard_batch(mesh, {"n": frames, "flow": fl, "gt": gt}, spatial_axis=-3)
        shards.append([cut[k].clone() for k in ("n", "flow", "gt")])
    whole = pool[:checked] if rank == 0 else []
    del pool
    def keep_going(elapsed):
        flag = torch.tensor([float(elapsed < r.seconds)])
        dist.broadcast(flag, 0, group=ctrl)
        return bool(flag.item())

    with train.precision_scope(precision), _planted(r.variant):
        state, step = train.build_step(r, params, dev, precision, mesh)
        replicate(mesh, state.net)
        d = train.drive(r, state, step, shards, wts, dev, keep_going, world,
                        height=mix["patch_height"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    busy = (d.trace.busy_s, d.trace.window_s) if d.trace is not None else None
    gathered = [None] * world
    dist.all_gather_object(gathered, (peak, busy), group=ctrl)
    del state, step, shards
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier(group=ctrl)
    dist.destroy_process_group()
    if rank != 0:
        return None

    ref = train.reference_steps(r, params, whole, wts, dev, per_sample=True)
    rd = train.readings(d.losses, d.first_grad, d.final, *ref, params)
    metrics = {"train_samples_per_s": d.steps * mix["batch"] / d.elapsed, "setup_s": d.setup_s}
    return harness.Outcome(metrics, attempted=d.steps, failed=d.failed,
                           checks=harness.judge(rd, r.cell), readings=rd,
                           memory_peak_bytes=max(p for p, _ in gathered), count=world,
                           trace=d.trace,
                           per_rank_busy=[b for _, b in gathered] if r.trace else None)


@contextlib.contextmanager
def _planted(variant):
    """The fault ``fault:no_reduce`` for the scope: the step leaves out the
    reduction of the gradients and losses between the cards."""
    if variant != "fault:no_reduce":
        yield
        return
    from rvdd_tpu_torch.training import train_state

    saved = train_state._average
    train_state._average = lambda mesh, flat: None
    try:
        yield
    finally:
        train_state._average = saved


def _worker(argv) -> int:
    args, rank = json.loads(argv[0]), int(argv[1])
    harness.pin_cores(rank, tuple(args["cores"]))
    r = harness.make_run(args["cell"], args["seed"], args["seconds"], args["trace"],
                         args["device"], variant=args["variant"], mix_overrides=args["mix"])
    rank_main(r, rank, int(r.cell["chips"]), args["port"])
    return 0


if __name__ == "__main__":
    harness.set_cache_dirs()
    sys.exit(_worker(sys.argv[1:]))
