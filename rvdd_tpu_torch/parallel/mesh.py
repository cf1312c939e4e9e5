"""The mesh's ``data`` axis over torch.distributed (port of
rvdd_tpu/parallel/mesh.py).

rvdd_tpu describes its devices as a ``jax.sharding.Mesh``: batches are
sharded over the ``data`` axis, parameters replicated, and XLA inserts the
gradient all-reduce.  The port runs one process a card (``torchrun``), so
its mesh is the process group: every process holds the parameters (rank
0's, broadcast by :func:`replicate`), takes its contiguous rows of each
global batch (:func:`shard_batch`, the rows ``NamedSharding(mesh,
P("data"))`` puts on its device) and the train step averages the gradients
over the group (training/train_state.py:make_train_step).

Two differences from rvdd_tpu:

* the ``space`` axis (``--mesh_shape data<N>xspace<M>``, M > 1), which
  shards the patch height and relies on XLA's convolution halo exchanges,
  is not ported (ROADMAP.md) and raises ``NotImplementedError``;
* a data axis other than the number of processes raises ``ValueError``:
  rvdd_tpu leaves the devices beyond the axis idle, the port will not start
  a process that holds no shard.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import re
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from rvdd_tpu_torch.device import resolve_device

#: torchrun's environment, read by :func:`init_distributed`
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh of this process: the ``data`` and ``space`` sizes, this
    process's rank, the number of processes and their group (None when no
    process group is started)."""

    data: int
    space: int
    rank: int
    world_size: int
    group: Any = None


def init_distributed(device="cuda") -> torch.device:
    """Start the process group from torchrun's environment (the counterpart
    of ``jax.distributed.initialize()``) and return this process's device:
    ``cuda:<LOCAL_RANK>`` on NCCL for a CUDA device, the CPU on gloo.
    Raises without torchrun's environment, and for CUDA without a card."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's environment; {missing} are not set "
                           "(launch with python -m torch.distributed.run)")
    dev = resolve_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=dev)
    else:
        dist.init_process_group("gloo", rank=rank, world_size=world)
    return dev


def make_mesh(spec: str = "data", world_size: Optional[int] = None,
              batch_size: Optional[int] = None) -> Mesh:
    """The mesh of a spec string, over the started process group (or
    ``world_size`` processes without one):

    'data'              -> all processes (batch DP)
    'data<N>'           -> N processes
    'data<N>xspace<M>'  -> N-way batch DP x M-way spatial (M > 1 raises
                           NotImplementedError)

    With the auto 'data' spec and a known ``batch_size``, the data axis is
    capped at the largest divisor of the batch that fits the process count,
    as rvdd_tpu's make_mesh caps it at the device count."""
    m = re.fullmatch(r"data(\d*)(?:xspace(\d+))?", spec)
    if not m:
        raise ValueError(f"bad mesh spec '{spec}'")
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    if world_size is None:
        world_size = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    n = int(m.group(1)) if m.group(1) else None
    s = int(m.group(2)) if m.group(2) else 1
    if s > 1:
        raise NotImplementedError(
            f"mesh '{spec}': the space axis (halo exchanges at every convolution, pooling, "
            "upsample and warp) is not ported yet (ROADMAP.md)")
    if n is None:
        n = world_size // s
        if batch_size is not None:
            while n > 1 and batch_size % n:
                n -= 1
    if n != world_size:
        raise ValueError(
            f"mesh '{spec}' gives a data axis of {n} for a batch of {batch_size} over "
            f"{world_size} processes: start one process a shard (torchrun --nproc_per_node "
            f"{n}), or pick a batch size and spec whose data axis is {world_size}")
    return Mesh(data=n, space=s, rank=rank, world_size=world_size, group=group)


def shard_batch(mesh: Mesh, tree):
    """This process's rows ``[r*B/N, (r+1)*B/N)`` of the leading batch axis
    of every array (numpy or torch) in an array or a dict of them; None
    stays None."""

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if x is None or mesh.data == 1:
            return x
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            raise TypeError(f"shard_batch: a leaf of type {type(x).__name__}")
        b = x.shape[0]
        if b % mesh.data:
            raise ValueError(f"a batch of {b} does not split over a data axis of {mesh.data}")
        rows = b // mesh.data
        return x[mesh.rank * rows:(mesh.rank + 1) * rows]

    return take(tree)


@torch.no_grad()
def replicate(mesh: Mesh, net: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter and buffer of ``net`` from rank 0, in
    place; a mesh of one process without a group has nothing to do."""
    if mesh.group is None:
        if mesh.world_size != 1:
            raise RuntimeError(f"replicate over {mesh.world_size} processes without a process "
                               "group")
        return net
    for t in itertools.chain(net.parameters(), net.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)
    return net
