"""Device kernels a train step in the traced window (memory copies and
sets left out); on several cards, rank 0's."""


def read(t):
    kernels = [k for k in t.kernels if not k[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / t.units if kernels else None
