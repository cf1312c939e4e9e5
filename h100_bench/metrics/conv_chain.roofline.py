"""``conv_chain``'s share of its roofline, % (work/conv_chain.py)."""

from h100_bench.metrics import roofline
from h100_bench.work import conv_chain


def read(t):
    return roofline(t, conv_chain)
