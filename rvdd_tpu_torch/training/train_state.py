"""Optimizers, the LR schedule and the train step (port of
rvdd_tpu/training/train_state.py).

Each optimizer computes what rvdd_tpu's optax one computes
(``make_optimizer``; reference: models/base_model.py:70-84):

* ``adamw``, ``adam`` and ``sgd`` (momentum = beta1) are
  ``torch.optim.AdamW``, ``Adam`` and ``SGD``: the same updates as optax's
  (eps outside the square root, no ``eps_root``, bias-corrected moments,
  AdamW's decay on every leaf, momentum as ``g + beta1 * trace``), up to
  rounding;
* ``adabelief`` (:class:`AdaBelief`) and ``ranger`` (:class:`Lookahead`
  with k = 6 and alpha = 0.5 over :class:`RAdam`) have no torch
  counterpart that computes optax's function, so they are written here.

rvdd_tpu wraps its optimizers in ``optax.inject_hyperparams``, which reads
the learning rate when it updates; the port sets ``param_group['lr']``
each epoch (:func:`set_learning_rate`).

The train step (:func:`make_train_step`) differentiates through every
unrolling of the module path with autograd (rvdd_tpu: ``jax.value_and_grad``
over its XLA net and warp) and steps the optimizer; it runs on the device of
the net.  ``matmul_precision`` is rvdd_tpu's ``--train_matmul_precision``:
'highest' and 'high' are the process's TF32 setting (precision.py, set by
the training loop), 'default' runs the forward under bf16 autocast.

Given a mesh (parallel/mesh.py), each process holds its shard of the
global batch and the step averages the gradients over the data axis between
``backward()`` and the optimizer step, as XLA's all-reduce does in
rvdd_tpu's sharded step: one ``all_reduce`` a step, of one flat bucket that
holds every gradient and the shard's loss statistics (L1, each unrolling's
mean squared error, the clamp fraction), so the losses returned are the
global batch's.  The shards are equal in size, so the mean over processes
is the mean over the batch; PSNR is recomputed from the averaged squared
errors, as rvdd_tpu's PSNR takes the mean over the whole batch.  An
explicit collective rather than ``DistributedDataParallel``: the step calls
the net once an unrolling before its one backward (and again under
``remat``), which DDP's reducer does not expect, and the trainer is bound by
its host, so one collective a step beats one a parameter bucket.

The forward and backward run in the mesh's scope (parallel/mesh.py:
shard_scope): batch statistics span the whole mesh, and with a ``space``
axis each process runs its rows of each sample (parallel/space.py), whose
losses are its part of the sample's means.  The step then sums the bucket
over the mesh and divides by the data axis alone: (1/N) x the sum over the
data and space shards of each shard's gradient of its part of the loss is
the gradient of the global batch's loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from rvdd_tpu_torch.ops.warp_shift import clamp_fraction
from rvdd_tpu_torch.parallel import space
from rvdd_tpu_torch.parallel.mesh import shard_scope
from rvdd_tpu_torch.recurrent.engine import (
    EngineConfig,
    compute_losses,
    prepare_frames,
    unrolled_forward,
)
from rvdd_tpu_torch.tracing import span

OPTIMIZERS = ("adamw", "adam", "adabelief", "ranger", "sgd")


def _pow32(x: float, n: int) -> np.float32:
    """``x**n`` for an integer count as XLA computes a float32 power with
    an int32 exponent: by squaring, rounding to float32 at each product."""
    base, out = np.float32(x), np.float32(1.0)
    while n:
        if n & 1:
            out = np.float32(out * base)
        base = np.float32(base * base)
        n >>= 1
    return out


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count``, in float32 as optax computes it."""
    return float(np.float32(1.0) - _pow32(decay, count))


class AdaBelief(torch.optim.Optimizer):
    """optax.adabelief (eps = 1e-16 outside the square root, eps_root =
    1e-16 added to the stored second moment of the prediction error
    ``g - mu`` every step, bias-corrected moments)."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-16,
                 eps_root: float = 1e-16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, eps_root=eps_root))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                g, mu, nu = p.grad, st["mu"], st["nu"]
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                pe = g - mu
                nu.mul_(b2).addcmul_(pe, pe, value=1.0 - b2).add_(group["eps_root"])
                mu_hat = mu / _bias_correction(b1, st["step"])
                nu_hat = nu / _bias_correction(b2, st["step"])
                p.sub_(group["lr"] * (mu_hat / (nu_hat.sqrt() + group["eps"])))


class RAdam(torch.optim.Optimizer):
    """optax.radam: rectified Adam with eps outside the square root and
    rectification where rho_t >= ``threshold`` (5.0); below it the update
    is the bias-corrected first moment.  rho_t is computed in float32, as
    optax computes it: its cancellation (two terms near 2/(1-b2)) moves the
    first rectified steps' factor by about 1% from the exact value, and the
    port follows optax there.  (torch.optim.RAdam adds eps before the bias
    correction and rectifies where rho_t > 5.)"""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 eps_root: float = 0.0, threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, eps_root=eps_root,
                                      threshold=threshold))

    @staticmethod
    def rectification(b2: float, count: int):
        """(rho_t, r_t) in float32, in optax's order of operations."""
        f = np.float32
        ro_inf = f(2.0 / (1.0 - b2) - 1.0)
        b2t = _pow32(b2, count)
        ro = ro_inf - f(2 * count) * b2t / (f(1.0) - b2t)
        r = np.sqrt((ro - f(4.0)) * (ro - f(2.0)) * ro_inf
                    / ((ro_inf - f(4.0)) * (ro_inf - f(2.0)) * ro)) if ro >= 4.0 else f(0.0)
        return float(ro), float(r)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                g, mu, nu = p.grad, st["mu"], st["nu"]
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                mu_hat = mu / _bias_correction(b1, st["step"])
                ro, r = self.rectification(b2, st["step"])
                if ro >= group["threshold"]:
                    nu_hat = nu / _bias_correction(b2, st["step"])
                    upd = r * mu_hat / ((nu_hat + group["eps_root"]).sqrt() + group["eps"])
                else:
                    upd = mu_hat
                p.sub_(group["lr"] * upd)


class Lookahead:
    """rvdd_tpu's lookahead (train_state.py:lookahead; Zhang et al. 2019)
    over an inner optimizer: the inner (fast) optimizer steps the weights;
    after every ``sync_period``-th step the slow weights move
    ``slow_step`` of the way to the fast ones and the fast weights are
    reset onto them.  The slow weights start as a copy of the weights at the
    first step (rvdd_tpu's at construction, which it does just before
    training), so weights loaded after construction are the first slow
    weights.  ``param_groups`` are the inner optimizer's."""

    def __init__(self, inner: torch.optim.Optimizer, sync_period: int = 6,
                 slow_step: float = 0.5):
        self.inner = inner
        self.sync_period = sync_period
        self.slow_step = slow_step
        self.count = 0
        self.slow: Optional[List[torch.Tensor]] = None

    def _params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        if self.slow is None:
            self.slow = [p.detach().clone() for p in self._params()]
        self.inner.step()
        self.count += 1
        if self.count % self.sync_period == 0:
            for p, s in zip(self._params(), self.slow):
                s.add_(p - s, alpha=self.slow_step)
                p.copy_(s)

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "slow": None if self.slow is None else [s.clone() for s in self.slow]}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.slow = None
        if state["slow"] is not None:
            self.slow = [v.to(p.device, p.dtype).clone()
                         for p, v in zip(self._params(), state["slow"])]


def make_optimizer(name: str, params, beta1: float = 0.9, weight_decay: float = 0.01):
    """rvdd_tpu's optimizer ``name`` over ``params``, with learning rate 0
    until :func:`set_learning_rate`."""
    params = list(params)
    betas = (beta1, 0.999)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=betas, eps=1e-8,
                                 weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=betas, eps=1e-8)
    if name == "adabelief":
        return AdaBelief(params, lr=0.0, betas=betas)
    if name == "ranger":
        # RAdam + Lookahead (reference: models/base_model.py:78-80; the
        # ranger package's defaults k=6, alpha=0.5)
        return Lookahead(RAdam(params, lr=0.0, betas=betas), sync_period=6, slow_step=0.5)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=beta1)
    raise NotImplementedError(f"optimizer {name}")


def lr_for_epoch(epoch: int, lr: float, policy: str, niter: int, niter_decay: int,
                 lr_decay_iters: int = 50) -> float:
    """Learning rate in effect during (1-based) ``epoch``."""
    e = epoch - 1  # the scheduler has stepped epoch-1 times
    if policy == "linear":
        factor = 1.0 - max(0, e + 1 - niter) / float(niter_decay + 1)
    elif policy == "step":
        factor = 0.1 ** (e // lr_decay_iters)
    elif policy == "cosine":
        factor = 0.5 * (1 + math.cos(math.pi * min(e, niter) / niter))
    elif policy == "plateau":
        # The reference steps ReduceLROnPlateau(mode='min', factor=0.2,
        # threshold=0.01, patience=5) with the epoch number as the metric
        # (base_model.py:128-133), so it never improves on epoch 1's value:
        # LR x0.2 at the end of epochs 7, 13, 19, ...  The training loop
        # implements the policy's intended semantics on the validation loss
        # instead; this branch is the reference's literal schedule.
        factor = 0.2 ** max(0, (e - 1) // 6)
    else:
        raise NotImplementedError(f"lr_policy {policy}")
    return lr * factor


@dataclasses.dataclass
class TrainState:
    """The net (its parameters), its optimizer and the count of steps."""

    net: torch.nn.Module
    optimizer: Any
    step: int = 0


def create_train_state(net: torch.nn.Module, optimizer: str = "adamw", beta1: float = 0.9,
                       weight_decay: float = 0.01) -> TrainState:
    return TrainState(net, make_optimizer(optimizer, net.parameters(), beta1, weight_decay))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def _check_precision(matmul_precision: str) -> None:
    if matmul_precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown train matmul precision {matmul_precision!r}")


def _losses(cfg: EngineConfig, net, raw_frames, raw_flows, gt, weights,
            matmul_precision: str, mses: Optional[list] = None):
    """The train step's forward: (losses with the graph, prepared flows);
    ``mses`` as compute_losses's."""
    autocast = (torch.autocast(raw_frames.device.type, dtype=torch.bfloat16)
                if matmul_precision == "default" else contextlib.nullcontext())
    with autocast:
        # on-device pre-demosaic and flow upsample (reference:
        # recurrent_model.py:124-129)
        frames, flows = prepare_frames(cfg, raw_frames, raw_flows)
        nil_feat = None
        if cfg.feature_rec:
            b, _, h, w, _ = frames.shape
            nil_feat = net.nil_features(b, h, w, device=frames.device)
        outs = unrolled_forward(cfg, net, frames, flows, len(weights), nil_feat)
    return compute_losses(cfg, outs, gt, torch.as_tensor(weights), mses), flows


def _average(mesh, flat: torch.Tensor) -> None:
    """``flat`` <- its mean over the mesh's data axis, in place, with one
    collective: NCCL's AVG (at one process NCCL still runs its one-rank
    reduction kernel, where a SUM is a no-op), gloo's SUM then a division
    (gloo has no AVG); with a space axis, the sum over the mesh divided by
    the data axis (each shard's values are its part of its sample's)."""
    if mesh.space > 1:
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.data)
    elif dist.get_backend(mesh.group) == "nccl":
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=mesh.group)
    else:
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world_size)


def _reduce(mesh, net, losses: dict, mses: list, weights) -> Dict[str, torch.Tensor]:
    """Average the gradients and the shard's loss statistics over the mesh
    (one bucket, one collective); returns the global batch's losses."""
    params = [p for p in net.parameters() if p.grad is not None]
    stats = torch.stack([losses["L1"].detach().float()] + mses
                        + ([losses["warp_clamp"].float()] if "warp_clamp" in losses else []))
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [stats])
    _average(mesh, flat)
    for p, g in zip(params, flat.split([p.numel() for p in params] + [len(stats)])):
        p.grad.copy_(g.view_as(p.grad))
    stats = flat[-len(stats):]
    w = torch.as_tensor(weights).to(stats.device, torch.float32)
    out = {"L1": stats[0],
           "PSNR": (w * (10.0 * torch.log10(4.0 / stats[1:1 + len(mses)]))).sum(),
           "Denoiser": stats[0]}
    if "warp_clamp" in losses:
        out["warp_clamp"] = stats[-1]
    return out


def _clamp_fraction(cfg: EngineConfig, flows: torch.Tensor) -> torch.Tensor:
    """The clamp telemetry of the step's flows; on a shard of the space
    axis computed on the whole sample's flows (its sweep's bands span the
    cuts) and divided by the shards, whose sum the step takes."""
    r = cfg.shift_warp_radius
    rows = space.rows_of(flows)
    if rows is None:
        return clamp_fraction(flows, radius_v=r, radius_h=r)
    with torch.no_grad():
        whole = space.gather_rows(flows, rows)
    return clamp_fraction(whole, radius_v=r, radius_h=r) / rows.size


def make_train_step(cfg: EngineConfig, matmul_precision: str = "highest", mesh=None):
    """The train step: (state, raw_frames [B, T, h, w, 4], raw_flows
    [B, TD, D+fD, h, w, 2] or None, gt [B, T, H', W', C_gt], weights [A],
    height=None) -> (state, losses).  ``len(weights)`` unrollings run; the
    losses are detached device tensors ('L1', 'PSNR', 'Denoiser', and under
    ``warp_impl='shift'`` 'warp_clamp').  With a ``mesh`` (parallel/mesh.py)
    the batch is this process's shard (under a space axis its rows of the
    packed raw patch ``height`` rows tall), and the gradients and losses are
    averaged over the data axis before the optimizer steps."""
    _check_precision(matmul_precision)

    def train_step(state: TrainState, raw_frames, raw_flows, gt, weights,
                   height: Optional[int] = None):
        with span("train.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        mses = [] if mesh is not None else None
        with shard_scope(mesh, height):
            with span("train.forward"):
                losses, flows = _losses(cfg, state.net, raw_frames, raw_flows, gt, weights,
                                        matmul_precision, mses)
            with span("train.backward"):
                losses["Denoiser"].backward()
            out: Dict[str, torch.Tensor] = {k: v.detach() for k, v in losses.items()}
            if cfg.warp_impl == "shift" and flows is not None and not cfg.no_warp:
                out["warp_clamp"] = _clamp_fraction(cfg, flows)
        if mesh is not None:
            with span("train.reduce"):
                out = _reduce(mesh, state.net, out, mses, weights)
        with span("train.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, out

    return train_step


def loss_and_grads(cfg: EngineConfig, net, raw_frames, raw_flows, gt, weights,
                   matmul_precision: str = "highest"):
    """The train step's losses (detached) and the gradient of its loss by
    parameter name, without an optimizer step; ``net`` keeps no gradient."""
    _check_precision(matmul_precision)
    net.zero_grad(set_to_none=True)
    losses, _ = _losses(cfg, net, raw_frames, raw_flows, gt, weights, matmul_precision)
    losses["Denoiser"].backward()
    grads = {k: p.grad.detach().clone() for k, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    return {k: v.detach() for k, v in losses.items()}, grads
