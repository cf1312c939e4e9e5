"""The train step's share of the bf16 peak, %: 3 x the forward FLOP of a
step's samples and unrollings (work/model.py; the backward counted as twice
the forward, recomputation not counted) x steps / traced window / the peak
of the cards that share the step."""

from h100_bench import peaks
from h100_bench.work.model import forward_flops


def read(t):
    h, w = 2 * t.mix["patch_height"], 2 * t.mix["patch_width"]
    fwd = forward_flops(t.cfg, t.mix["batch"], h, w) * t.mix["unrollings"]
    return 100.0 * 3 * fwd * t.units / t.window_s / (t.cards * peaks.BF16_FLOPS)
