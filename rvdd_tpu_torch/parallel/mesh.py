"""The mesh's ``data`` and ``space`` axes over torch.distributed (port of
rvdd_tpu/parallel/mesh.py).

rvdd_tpu describes its devices as a ``jax.sharding.Mesh``: batches are
sharded over the ``data`` axis, parameters replicated, and XLA inserts the
gradient all-reduce.  The port runs one process a card (``torchrun``), so
its mesh is the process group: every process holds the parameters (rank
0's, broadcast by :func:`replicate`), takes its contiguous rows of each
global batch (:func:`shard_batch`, the rows ``NamedSharding(mesh,
P("data"))`` puts on its device) and the train step averages the gradients
over the group (training/train_state.py:make_train_step).

The ``space`` axis (``--mesh_shape data<N>xspace<M>``) cuts the patch
height over M processes: rank = d * M + s, as rvdd_tpu reshapes its devices
(n, s).  Each process takes its data rows and then its space rows of every
batch tensor (:func:`shard_batch` with ``spatial_axis=-3``), and the module
path exchanges the rows it needs across the cuts (parallel/space.py; XLA
inserts those exchanges in rvdd_tpu).  The port cuts the rows in whole
blocks of ``row_align`` packed raw rows (2^(depth-1), so that every pool
of the net stays inside a shard), the ragged tail on the last shard, where
rvdd_tpu cuts them evenly: the results are held on the whole batch.

One difference from rvdd_tpu: a mesh of other than the number of processes
raises ``ValueError``: rvdd_tpu leaves the devices beyond the mesh idle,
the port will not start a process that holds no shard.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import re
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.parallel import space
from rvdd_tpu_torch.parallel.space import Rows, split_rows

#: torchrun's environment, read by :func:`init_distributed`
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh of this process: the ``data`` and ``space`` sizes, this
    process's rank, the number of processes and their group (None when no
    process group is started); with a space axis the group of this
    process's data index (its M space shards) and of its space index (its
    N data shards), and the packed raw rows of a block of the row cut."""

    data: int
    space: int
    rank: int
    world_size: int
    group: Any = None
    space_group: Any = None
    data_group: Any = None
    row_align: int = 1

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space

    def space_rows(self, height: int) -> Rows:
        """This process's rows of a packed raw patch ``height`` rows tall."""
        return split_rows(height, self.space, self.row_align, self.space_index,
                          self.space_group)


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
              batch_size: Optional[int] = None, row_align: int = 1) -> Mesh:
    """The mesh of a spec string, over the started process group (or
    ``world_size`` processes without one):

    'data'              -> all processes (batch DP)
    'data<N>'           -> N processes
    'data<N>xspace<M>'  -> N-way batch DP x M-way spatial, N x M processes

    With the auto 'data' spec and a known ``batch_size``, the data axis is
    capped at the largest divisor of the batch that fits the process count,
    as rvdd_tpu's make_mesh caps it at the device count.  With a space axis
    and a process group, every process builds the space group of each data
    index and the data group of each space index (torch.distributed's
    ``new_group`` is collective).  ``row_align``: see :class:`Mesh`."""
    m = re.fullmatch(r"data(\d*)(?:xspace(\d+))?", spec)
    if not m:
        raise ValueError(f"bad mesh spec '{spec}'")
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    if world_size is None:
        world_size = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    n = int(m.group(1)) if m.group(1) else None
    s = int(m.group(2)) if m.group(2) else 1
    if n is None:
        n = world_size // s
        if batch_size is not None:
            while n > 1 and batch_size % n:
                n -= 1
    if n * s != world_size:
        raise ValueError(
            f"mesh '{spec}' gives a data axis of {n} x a space axis of {s} = {n * s} "
            f"process(es) for a batch of {batch_size} over {world_size} processes: start one "
            f"process a shard (torchrun --nproc_per_node {n * s}), or pick a batch size and "
            f"spec whose mesh has {world_size}")
    space_group = data_group = None
    if group is not None and s > 1:
        for d in range(n):
            g = dist.new_group([d * s + i for i in range(s)])
            if rank // s == d:
                space_group = g
        for i in range(s):
            g = dist.new_group([d * s + i for d in range(n)])
            if rank % s == i:
                data_group = g
    return Mesh(data=n, space=s, rank=rank, world_size=world_size, group=group,
                space_group=space_group, data_group=data_group, row_align=row_align)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [] if tree is None else [tree]


def shard_batch(mesh: Mesh, tree, spatial_axis: Optional[int] = None):
    """This process's rows ``[d*B/N, (d+1)*B/N)`` of the leading batch axis
    of every array (numpy or torch) in an array or a dict of them, d its
    data index; None stays None.  With ``spatial_axis`` (-3: H in every
    batch tensor) and a space axis, then its rows of that axis of every
    array of 4 or more dimensions (rvdd_tpu/parallel/mesh.py:batch_spec):
    the smallest such height in the tree is the packed raw patch's, cut by
    :meth:`Mesh.space_rows`, and a tensor twice as tall (the RGB ground
    truth) is cut at twice the rows."""
    leaves = _leaves(tree)
    for x in leaves:
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            raise TypeError(f"shard_batch: a leaf of type {type(x).__name__}")
    raw = None
    if spatial_axis is not None and mesh.space > 1:
        heights = [x.shape[spatial_axis] for x in leaves if x.ndim >= 4]
        raw = mesh.space_rows(min(heights)) if heights else None

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if x is None:
            return x
        if mesh.data > 1:
            b = x.shape[0]
            if b % mesh.data:
                raise ValueError(f"a batch of {b} does not split over a data axis of "
                                 f"{mesh.data}")
            rows = b // mesh.data
            x = x[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        if raw is not None and x.ndim >= 4:
            k, rem = divmod(x.shape[spatial_axis], raw.height)
            if rem or k not in (1, 2):
                raise ValueError(f"a tensor of {x.shape[spatial_axis]} rows beside a raw "
                                 f"patch of {raw.height}")
            r = raw.scale(k)
            idx = [slice(None)] * x.ndim
            idx[spatial_axis] = slice(r.start, r.stop)
            x = x[tuple(idx)]
        return x

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


def shard_scope(mesh: Optional[Mesh], height: Optional[int] = None):
    """The scope (parallel/space.py:scope) in which the module path runs
    this process's shard of a mesh of several processes: batch statistics
    over the whole mesh, and under a space axis this process's rows of a
    packed raw patch ``height`` rows tall.  Without a mesh, or with one
    process, nothing changes."""
    if mesh is None or mesh.group is None or mesh.world_size == 1:
        return contextlib.nullcontext()
    rows = None
    if mesh.space > 1:
        if height is None:
            raise ValueError("a space axis needs the packed raw patch's height")
        rows = mesh.space_rows(height)
    return space.scope(rows, batch_group=mesh.group)
