"""``warp_bicubic``'s share of its roofline, % (work/warp_bicubic.py)."""

from h100_bench.metrics import roofline
from h100_bench.work import warp_bicubic


def read(t):
    return roofline(t, warp_bicubic)
