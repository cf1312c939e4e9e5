"""Unrolling-loss weight schedules (``--unroll_focus``; port of
rvdd_tpu/recurrent/schedules.py, pure numpy, copied as it is).

Pure host-side functions of (epoch, iteration); the resulting weight vector
is passed into the train step as data (reference:
models/recurrent_model.py:352-466).

Conventions copied from the reference:
* ``TD`` here is ``patch_depth - 1`` (the weight-vector length used by
  compute_unrolling_weights; with the only supported model_patch_depth=2
  this equals the number of unrollings),
* epochs are 1-based,
* 'gradual[ii]_from[jj]' trains non-recurrently (1 unrolling) until epoch
  jj, then interpolates per-iteration from one-hot to the final weights
  over ii epochs; 'graduni' ends uniform, 'gradual' ends with 90% of the
  weight on the last unrolling.

Note: the reference's 'ge_j' mode skips zero-weight unrollings when
stacking losses, which would misalign the weight vector; we instead weight
all unrollings (zero weights contribute nothing), which is the intended
semantics.
"""

from __future__ import annotations

import numpy as np


def _gradual_epochs(focus: str):
    """(epoch1, epoch2) for gradu* schedules, or None."""
    if not focus.startswith("gradu"):
        return None
    epoch1 = int(focus[-2:]) if focus[-7:-2] == "_from" else 1
    epoch2 = float(focus[7:9]) + epoch1
    return epoch1, epoch2


def active_unrollings(focus: str, td: int, epoch: int) -> int:
    """Number of unrollings actually run at this epoch (reference:
    models/recurrent_model.py:255-264)."""
    g = _gradual_epochs(focus)
    if g is not None and epoch < g[0]:
        return 1
    return td


def unroll_weights(
    focus: str, td: int, epoch: int, epoch_iter: float = 0.0, epoch_length: float = 1.0
) -> np.ndarray:
    """Loss weight per unrolling; length = active_unrollings(...)."""
    if active_unrollings(focus, td, epoch) == 1:
        return np.ones(1, np.float32)

    if focus[:2] == "ge":
        a = int(focus[3:])
        w = np.zeros(td, np.float32)
        w[a:] = 1.0
        return w / w.sum()

    if focus.startswith("gradu"):
        epoch1, epoch2 = _gradual_epochs(focus)
        w0 = np.zeros(td, np.float32)
        w0[0] = 1.0
        if focus[4:7] == "uni":
            w2 = np.full(td, 1.0 / td, np.float32)
            w1 = 0.5 * (w0 + w2)
        else:
            w2 = np.full(td, 0.1 / (td - 1), np.float32)
            w2[td - 1] = 0.9
            w1 = np.full(td, 1.0 / td, np.float32)
        if epoch >= epoch2:
            return w2
        tr = 2.0 * min(
            1.0, (epoch - epoch1 + float(epoch_iter) / float(epoch_length)) / (epoch2 - epoch1)
        )
        if tr < 1.0:
            return ((1.0 - tr) * w0 + tr * w1).astype(np.float32)
        tr -= 1.0
        return ((1.0 - tr) * w1 + tr * w2).astype(np.float32)

    # 'all': uniform
    return np.full(td, 1.0 / td, np.float32)
