"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit; the result line carries the card's own
limit beside every share)."""

BF16_FLOPS = 989e12     # FLOP/s, bf16 and fp16 tensor cores
HBM_BYTES = 3.35e12     # bytes/s


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the chip needs at the least: the larger of the operations at
    the bf16 peak and the bytes at the memory's peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
