"""``packed_matmul_roofline``: B2 (``kernels/packed_matmul``) against its
roofline, over the traced steps: the same work as B1's
(:func:`stream_matmul_roofline.launch_work`: codes, scales, x and out,
``2 * M * K * N`` operations; no lane-packed view is counted as more than
the codes it holds), against the device time of every launch whose name
holds ``packed_matmul``."""
from perfbench.metrics.stream_matmul_roofline import roofline

KERNEL = "packed_matmul"


def read(run) -> float | None:
    return roofline(run, KERNEL)
