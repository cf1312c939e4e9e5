"""The ``train`` generator: the program's train step on one card, on
seeded draws made on the device; no data path.

Set-up builds one train state (the net with the benchmark's weights and
AdamW at the configuration's settings) and one step
(``make_train_step``), then drives them through the first
``checked_steps`` steps, each on a batch of its own, and ``warmup_steps``
more; the window goes on with the same state and step.  A step takes batch
i mod ``pool`` of a pool of distinct draws: packed raw frames and ground
truth uniform in [-1, 1], flows uniform in +-``flow_px``, the unrollings
weighted alike.  Every step ends in its loss read back to the host.

The check: the reference (fp32, TF32 off) follows the checked steps from
the same weights and batches with its own AdamW.  It compares each step's
loss, the first gradient as the optimizer got it (from its first moment
after one step), and each leaf's change after the checked steps, by the
worst leaf (compare.norm_gap).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from h100_bench import compare, harness, program, weights
from h100_bench.reference import nets, tf32
from h100_bench.reference.recurrent import AdamW, train_loss


def make_pool(mix: dict, cfg: dict, gen: torch.Generator, device):
    """``pool`` batches (frames [B, A+2, h, w, 4], flows [B, A, 2, h, w, 2],
    gt [B, A+2, 2h, 2w, 3] for raw patches of h x w) and the unrolling
    weights [A]."""
    b, a, fp = mix["batch"], mix["unrollings"], mix["flow_px"]
    h, w = mix["patch_height"], mix["patch_width"]
    t = a + cfg["engine"]["model_patch_depth"] - 1 + cfg["engine"]["future_patch_depth"]

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen, device=device) * 2.0 - 1.0) * scale

    pool = [(u(b, t, h, w, 4), u(b, a, 2, h, w, 2, scale=fp), u(b, t, 2 * h, 2 * w, 3))
            for _ in range(mix["pool"])]
    return pool, torch.full((a,), 1.0 / a, device=device)


def precision_scope(precision: str):
    from rvdd_tpu_torch.precision import exact_precision, fast_precision

    return exact_precision() if precision == "highest" else fast_precision()


def build_step(r: harness.Run, params: dict, dev, precision: str, mesh=None):
    """The program's (state, step) for the configuration's train step."""
    from rvdd_tpu_torch.training.train_state import (
        create_train_state,
        make_train_step,
        set_learning_rate,
    )

    tc, mix = r.cfg["train"], r.mix
    ecfg = program.engine_config(r.cfg, patch_depth=mix["unrollings"] + 1,
                                 warp_impl=tc["warp_impl"], net_impl="module",
                                 remat=tc["remat"])
    net = program.build_net(r.cfg, params, dev)
    state = create_train_state(net, tc["optimizer"], tc["betas"][0], tc["weight_decay"])
    set_learning_rate(state, tc["lr"])
    return state, make_train_step(ecfg, precision, mesh)


def first_gradient(state, beta1: float) -> dict:
    """The gradient the optimizer took at its first step, from its first
    moment (m1 = (1 - beta1) g1)."""
    out = {}
    for name, p in state.net.named_parameters():
        st = state.optimizer.state.get(p, {})
        if "exp_avg" in st:
            out[name] = st["exp_avg"].detach().clone() / (1.0 - beta1)
    return out


def reference_steps(r: harness.Run, params: dict, batches, wts, dev, per_sample=False):
    """The reference's losses, first gradient and final weights over the
    checked steps (fp32, TF32 off).  ``per_sample``: one sample at a time,
    each unrolling and each block recomputed in the backward, the gradients
    summed: whole 1080p frames then fit one card."""
    tc = r.cfg["train"]
    ref = nets.recompute_blocks(nets.build(r.cfg, dev), per_sample)
    ref.load_state_dict(params)
    names = [n for n, _ in ref.named_parameters()]
    leaves = [p for _, p in ref.named_parameters()]
    opt = AdamW(leaves, tc["lr"], tuple(tc["betas"]), tc["eps"], tc["weight_decay"])
    losses, g1 = [], None
    with tf32(False):
        for frames, fl, gt in batches:
            if per_sample:
                b = frames.shape[0]
                loss, grads = 0.0, [torch.zeros_like(p) for p in leaves]
                for i in range(b):
                    li = train_loss(ref, frames[i:i + 1], fl[i:i + 1], gt[i:i + 1], wts,
                                    checkpoint_steps=True) / b
                    for acc, g in zip(grads, torch.autograd.grad(li, leaves)):
                        acc += g
                    loss += float(li.detach())
            else:
                li = train_loss(ref, frames, fl, gt, wts)
                grads = torch.autograd.grad(li, leaves)
                loss = float(li.detach())
            if g1 is None:
                g1 = {n: g.detach().clone() for n, g in zip(names, grads)}
            opt.step(grads)
            losses.append(loss)
    return losses, g1, {n: p.detach() for n, p in zip(names, leaves)}


def readings(prog_losses, prog_g1, prog_final, ref_losses, ref_g1, ref_final,
             params) -> dict:
    """loss1_gap, loss_gap: the first and the worst step's |loss -
    reference| / |reference|; grad_gap, change_gap: compare.norm_gap of the
    first gradient and of the change of the weights over the checked steps,
    and change_median_gap the median leaf's, on the leaves the reference
    moves (compare.moved_leaves)."""
    moved = compare.moved_leaves(ref_g1)
    gaps = [abs(p - q) / abs(q) if p == p else float("inf")
            for p, q in zip(prog_losses, ref_losses)] or [float("inf")]
    change_p = {k: prog_final[k] - params[k] for k in prog_final}
    change_r = {k: ref_final[k] - params[k] for k in ref_final}
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": compare.norm_gap(prog_g1, ref_g1, moved),
            "change_gap": compare.norm_gap(change_p, change_r, moved),
            "change_median_gap": compare.norm_gap(change_p, change_r, moved, median=True),
            "leaves_compared": float(len(moved))}


@dataclasses.dataclass
class Driven:
    """What :func:`drive` measured and kept for the check."""

    losses: list
    first_grad: dict
    final: dict
    setup_s: float
    steps: int
    elapsed: float
    failed: int
    trace: Optional[harness.Trace]


def drive(r: harness.Run, state, step, batches, wts, dev, keep_going=None, cards: int = 1,
          **step_kw) -> Driven:
    """The checked steps, the warm-up steps and the window of one train
    state and step; every step ends in its loss read back.  A step takes
    batch i mod len(batches).  The window runs ``r.seconds`` (traced: the
    mix's ``trace_steps`` steps), or while ``keep_going(elapsed)`` says so;
    ``cards``: the cards that share a step; ``step_kw`` go to every
    step."""
    from torch.profiler import record_function

    mix, beta1 = r.mix, r.cfg["train"]["betas"][0]
    failed = 0
    if r.variant == "fault:state":
        state.optimizer.step = lambda *a, **k: None

    def one(i):
        nonlocal failed
        frames, fl, gt = batches[i % len(batches)]
        if r.variant == "fault:half_batch":
            h = frames.shape[0] // 2
            frames, fl, gt = frames[:h], fl[:h], gt[:h]
        with record_function(harness.SPAN + "train_step"):
            _, losses = step(state, frames, fl, gt, wts, **step_kw)
        with record_function(harness.SPAN + "loss_read"):
            loss = float(losses["Denoiser"])
        failed += loss != loss
        return loss

    checked = mix["checked_steps"]
    r.log(f"train: state and step ready at {time.perf_counter() - r.t_start:.2f} s")
    losses, first_grad = [], {}
    for i in range(checked):
        losses.append(one(i))
        if i == 0:
            first_grad = first_gradient(state, beta1)
    final = {k: p.detach().clone() for k, p in state.net.named_parameters()}
    r.log(f"train: {checked} checked steps done at {time.perf_counter() - r.t_start:.2f} s")
    for i in range(checked, checked + mix["warmup_steps"]):
        one(i)
    setup_s = time.perf_counter() - r.t_start
    keep_going = keep_going or (lambda elapsed: elapsed < r.seconds)

    def window(limit_steps=None):
        t0, j = time.perf_counter(), 0
        while (keep_going(time.perf_counter() - t0) if limit_steps is None
               else j < limit_steps):
            one(checked + mix["warmup_steps"] + j)
            j += 1
        return j, time.perf_counter() - t0

    trace = None
    if r.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(harness.SPAN + "window"):
                steps, elapsed = window(mix["trace_steps"])
        trace = harness.trace_from_profile(prof, steps, r.cfg, mix, cards)
    else:
        steps, elapsed = window()
    return Driven(losses, first_grad, final, setup_s, steps, elapsed, failed, trace)


def precision_of(r: harness.Run) -> str:
    """The train step's precision: the configuration's, or its control's."""
    train = r.cfg["control"]["train"] if r.variant == "control" else r.cfg["train"]
    return train["precision"]


def run(r: harness.Run) -> harness.Outcome:
    dev = torch.device(r.device)
    precision = precision_of(r)
    gen = torch.Generator(device=dev).manual_seed(r.seed)
    r.log(f"train: imports and the card ready at {time.perf_counter() - r.t_start:.2f} s")
    params = weights.make(r.cfg, gen, dev)
    pool, wts = make_pool(r.mix, r.cfg, gen, dev)
    r.log(f"train: weights and batches ready at {time.perf_counter() - r.t_start:.2f} s")
    with precision_scope(precision):
        state, step = build_step(r, params, dev, precision)
        d = drive(r, state, step, pool, wts, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {"train_samples_per_s": d.steps * r.mix["batch"] / d.elapsed,
               "setup_s": d.setup_s}
    del state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(r, params, pool[:r.mix["checked_steps"]], wts, dev)
    rd = readings(d.losses, d.first_grad, d.final, *ref, params)
    return harness.Outcome(metrics, attempted=d.steps, failed=d.failed,
                           checks=harness.judge(rd, r.cell), readings=rd,
                           memory_peak_bytes=peak, trace=d.trace)
