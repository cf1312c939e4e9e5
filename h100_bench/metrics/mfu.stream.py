"""The whole stream's share of the bf16 peak, %: the model's forward FLOP a
frame (work/model.py) x frames / traced window / peak."""

from h100_bench import peaks
from h100_bench.work.model import forward_flops, rgb_size


def read(t):
    h, w = rgb_size(t.mix)
    return 100.0 * forward_flops(t.cfg, 1, h, w) * t.units / t.window_s / peaks.BF16_FLOPS
