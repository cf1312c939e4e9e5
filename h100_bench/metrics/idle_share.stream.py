"""The device's idle share of the traced window, %: 1 - busy / window,
busy the union of the device ops' intervals (on several cards, rank 0's)."""

from h100_bench.metrics import idle_share


def read(t):
    return idle_share(t)
