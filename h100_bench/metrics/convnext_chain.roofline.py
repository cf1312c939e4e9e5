"""``convnext_chain``'s share of its roofline, % (work/convnext_chain.py)."""

from h100_bench.metrics import roofline
from h100_bench.work import convnext_chain


def read(t):
    return roofline(t, convnext_chain)
