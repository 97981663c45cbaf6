"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at the 700 W limit).

A share of a peak is stated against these, with the card's power limit
beside it (a card set below 700 W runs slower under load).
"""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the work can take: the larger of its operations' and its bytes' times."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
