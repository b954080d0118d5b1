"""``step_mfu``: the whole step's share of the chip's peak over the
window.

Each step's least time is the larger of its operations over the bf16
peak and its bytes over the HBM bandwidth, counted from the
configuration's shapes at the step's active rows M and their KV tokens:
every projection's int-N codes and bf16 scales, M rows of the embedding,
the whole unembedding (bf16), each active row's KV up to its position at
the KV width, ``2 * M * K * N`` per projection, ``2 * M * d * V`` for the
logits and the attention's ``4 * n_heads * head_dim`` per live token.
The bounds of the window's steps are summed and divided by the window's
seconds.  A later change that takes a kernel off the path leaves that
kernel's roofline silent; this share still bounds the whole step.
"""
from perfbench.metrics.stream_attention_roofline import layer_work
from perfbench.metrics.stream_matmul_roofline import launch_work
from perfbench.peaks import bound_s


def step_work(shape, quant, rows: int, kv_tokens: int
              ) -> tuple[float, float]:
    """``(operations, bytes)`` of one decode step."""
    flops = nbytes = 0.0
    for _, k, n in shape.linears():
        f, b = launch_work(rows, k, n, quant["weight_bits"],
                           quant["group_size"])
        # x and out are activations between kernels, not HBM traffic a
        # step has to make: count the weights alone
        flops += f
        nbytes += b - 2 * rows * k - 2 * rows * n
    af, ab = layer_work(shape, quant["kv_bits"], rows, kv_tokens)
    ab -= 2 * 2 * rows * shape.n_heads * shape.head_dim
    flops, nbytes = shape.n_layers * (flops + af), shape.n_layers * (nbytes + ab)
    d, v = shape.d_model, shape.vocab_size
    flops += 2.0 * rows * d * v
    nbytes += 2 * rows * d + 2 * d * v
    return flops, nbytes


def read(run) -> float | None:
    if not run.steps:
        return None
    least = sum(bound_s(*step_work(run.shape, run.quant, s.rows, s.kv_tokens))
                for s in run.steps)
    return 100.0 * least / run.window_s
