"""Plain fp32 PyTorch of the recurrent step, the training loss and AdamW.

The recurrence of RVDD with feature recurrence and one future frame
(model_patch_depth 2, future_patch_depth 1): a window of packed raw frames
(previous, current, future) and the flows of the previous and the future
frame to the current one.  The frames are demosaicked, the flows upsampled;
the carried state, the last output and the last features, is warped to the
current frame with the bicubic warp, and so is the future frame; the net
takes ``[warped output | current | warped future]`` and the warped
features and gives the output and the next features.  A stream starts from
the noisy previous frame and zero features.

Training unrolls that step from the start of a sample and weighs each
unrolling's L1 to the ground truth (x 100); AdamW is written out
(decoupled weight decay, bias-corrected moments, eps outside the root).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from h100_bench.reference.ops import demosaic, flow_upsample, warp

LAMBDA_L1 = 100.0


def frame_step(net, raw_window: torch.Tensor, flows: torch.Tensor,
               state: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """One streamed frame.  raw_window [B, 3, h, w, 4] (previous, current,
    future), flows [B, 2, h, w, 2] (previous -> current, future ->
    current), state (output [B, H, W, 3], features [B, H, W, F]) or None
    at a stream's start.  Returns (output, next state)."""
    rgb = demosaic(raw_window)  # [B, 3, H, W, 3]
    fl = flow_upsample(flows)  # [B, 2, H, W, 2]
    if state is None:
        b, _, hh, ww, _ = rgb.shape
        state = (rgb[:, 0], torch.zeros(b, hh, ww, net.filters, device=rgb.device))
    return _step(net, state, rgb[:, 1], rgb[:, 2], fl[:, 0], fl[:, 1])


def _step(net, state, cur, future, flow_prev, flow_future):
    den, feat = state
    c = den.shape[-1]
    warped = warp(torch.cat([den, feat], dim=-1), flow_prev)
    x = torch.cat([warped[..., :c], cur, warp(future, flow_future)], dim=-1)
    out, new_feat = net(x, warped[..., c:])
    return out, (out, new_feat)


def train_loss(net, raw_frames: torch.Tensor, raw_flows: torch.Tensor, gt: torch.Tensor,
               weights: torch.Tensor, checkpoint_steps: bool = False) -> torch.Tensor:
    """The weighted L1 loss of one training sample batch.  raw_frames
    [B, A + 2, h, w, 4], raw_flows [B, A, 2, h, w, 2], gt [B, A + 2, H, W, 3],
    weights [A] for A unrollings; the first frame starts the recurrence.
    ``checkpoint_steps`` recomputes each unrolling in the backward (the same
    gradients in the memory of one unrolling)."""
    rgb = demosaic(raw_frames)
    fl = flow_upsample(raw_flows)
    b, _, hh, ww, _ = rgb.shape
    state = (rgb[:, 0], torch.zeros(b, hh, ww, net.filters, device=rgb.device))
    loss = rgb.new_zeros(())
    for a in range(len(weights)):
        args = (net, state, rgb[:, a + 1], rgb[:, a + 2], fl[:, a, 0], fl[:, a, 1])
        out, state = (checkpoint(_step, *args, use_reentrant=False) if checkpoint_steps
                      else _step(*args))
        loss = loss + weights[a] * (out - gt[:, a + 1]).abs().mean() * LAMBDA_L1
    return loss


class AdamW:
    """AdamW over a list of tensors: p <- p (1 - lr wd), then the Adam step
    with bias-corrected moments, eps added outside the square root."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.params = list(params)
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))
