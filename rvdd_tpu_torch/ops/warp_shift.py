"""The clamp telemetry of rvdd_tpu's banded training warp (port of
rvdd_tpu/ops/warp_shift.py:_clamp_fraction_one and clamp_fraction; the
sweep itself is not ported).

rvdd_tpu trains on the TPU with a displacement-banded bicubic warp, because
XLA:TPU serializes the scatter-add that is the gather's gradient.  Its
sweep clamps per-pixel residuals beyond its radius to the window edge, so
on fast motion its gradients are approximate.  The port trains with the
exact plain warp (ops/warp.py), whose gather backward is a scatter-add on
the card, so nothing is clamped here: :func:`clamp_fraction` reports what
rvdd_tpu's sweep would have clamped on the same flows, for the train
step's ``warp_clamp`` loss entry under ``--warp_impl shift``.
"""

from __future__ import annotations

import torch

from rvdd_tpu_torch.ops.warp import cubic_kernel


def _clamp_fraction_one(flow: torch.Tensor, radius_v: int, radius_h: int, max_base: int,
                        band_rows: int) -> torch.Tensor:
    """Fraction of pixels of one flow [H, W, 2] with at least one
    nonzero-weight bicubic tap that the banded sweep would clamp to its
    window's edge (the index arithmetic of rvdd_tpu's ``_warp_shift_one``)."""
    h, w = flow.shape[0], flow.shape[1]
    dev = flow.device
    u = flow[..., 0].float()
    v = flow[..., 1].float()

    rb = min(band_rows, h)
    while h % rb:
        rb -= 1
    nb = h // rb
    rows_win = min(rb + 2 * radius_v + 4, h)
    nh = 2 * radius_h + 4

    vb = torch.round(v.reshape(nb, -1).mean(dim=1)).clamp(-max_base, max_base).long()
    band0 = torch.arange(nb, device=dev) * rb
    win_start = (band0 + vb - (radius_v + 1)).clamp(0, h - rows_win)
    ws_row = win_start.repeat_interleave(rb)[:, None]

    gy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + v
    iy = torch.floor(gy)
    wy = cubic_kernel(gy - iy)
    iy = iy.long()
    v_clamped = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for k in range(4):
        rel = (iy - 1 + k).clamp(0, h - 1) - ws_row
        v_clamped |= ((rel < 0) | (rel > rows_win - 1)) & (wy[k] != 0.0)

    qx = torch.round(u.mean()).clamp(-max_base, max_base).long()
    gx = torch.arange(w, device=dev, dtype=torch.float32)[None, :] + u
    ix = torch.floor(gx)
    wx = cubic_kernel(gx - ix)
    ix = ix.long()
    coli = torch.arange(w, device=dev)[None, :]
    h_clamped = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for k in range(4):
        off = (ix - 1 + k).clamp(0, w - 1) - qx + radius_h + 1 - coli
        h_clamped |= ((off < 0) | (off > nh - 1)) & (wx[k] != 0.0)

    return (v_clamped | h_clamped).float().mean()


@torch.no_grad()
def clamp_fraction(flow: torch.Tensor, radius_v: int = 8, radius_h: int = 8,
                   max_base: int = 48, band_rows: int = 8) -> torch.Tensor:
    """Mean fraction of pixels whose warp rvdd_tpu's banded sweep would
    approximate (clamp) under the given geometry, over flows
    [..., H, W, 2] with any leading axes.  Zero for TV-L1 video flows."""
    f2 = flow.reshape((-1,) + tuple(flow.shape[-3:]))
    return torch.stack([_clamp_fraction_one(f, radius_v, radius_h, max_base, band_rows)
                        for f in f2]).mean()
