"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the roofline every share in this
benchmark is taken against."""

#: bf16 / fp16 tensor-core FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the HBM bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
