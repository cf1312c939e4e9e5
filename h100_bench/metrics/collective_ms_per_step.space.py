"""Rank 0's device ms a train step in NCCL kernels (the space axis's halo
exchanges and gathers and the gradient reduction)."""


def read(t):
    spent = t.seconds(("nccl",))
    return 1e3 * spent / t.units if spent else None
