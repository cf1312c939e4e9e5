"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), from NVIDIA's data
sheet, dense rates without sparsity.  They assume the card's full power
limit of 700 W; a run prints the card's ``power.limit`` beside its numbers,
since a card set lower runs slower under load."""

#: bf16 dense tensor-core rate, FLOP/s (a multiply-add is 2 FLOP)
BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: the power limit those rates assume, W
POWER_LIMIT_W = 700.0


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` FLOP and ``nbytes``
    bytes of device memory traffic: the larger of the two times."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
