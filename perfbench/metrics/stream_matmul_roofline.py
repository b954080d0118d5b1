"""``stream_matmul_roofline``: B1 (``kernels/stream_matmul``) against its
roofline, over the traced steps.

The work of one ``x @ dequant(W)`` launch, ``x`` (M, K), ``W`` (K, N) at
``bits`` with one bf16 scale per ``group`` rows of K: the weight codes
(``K * N * bits / 8`` bytes), the scales (``2 * K / group * N``), ``x``
and the output in bf16, the activations' type (``2 * M * K``,
``2 * M * N``), and ``2 * M * K * N`` operations at the bf16 peak.  No
index or offset table is counted: those are one implementation's choice.
The step runs each of a layer's seven projections once per layer at the
step's M (its active rows), so the traced steps' work is summed from the
configuration's shapes and set against the device time of every launch
whose name holds ``stream_matmul``.
"""
from perfbench.peaks import bound_s

KERNEL = "stream_matmul"


def launch_work(m: int, k: int, n: int, bits: int, group: int
                ) -> tuple[float, float]:
    """``(operations, bytes)`` of one ``(M, K) @ (K, N)`` launch."""
    nbytes = k * n * bits / 8 + 2 * (k // group) * n + 2 * m * k + 2 * m * n
    return 2.0 * m * k * n, nbytes


def step_bound_s(shape, quant, rows: int) -> float:
    """Least seconds of one step's projections, each launch bound apart."""
    per_layer = sum(bound_s(*launch_work(rows, k, n, quant["weight_bits"],
                                         quant["group_size"]))
                    for _, k, n in shape.linears())
    return shape.n_layers * per_layer


def roofline(run, kernel: str) -> float | None:
    tr = run.trace
    if tr is None:
        return None
    dev_s = tr.kernel_s(kernel)
    if dev_s <= 0:
        return None
    least = sum(step_bound_s(run.shape, run.quant, s.rows) for s in tr.steps)
    return 100.0 * least / dev_s


def read(run) -> float | None:
    return roofline(run, KERNEL)
