"""``stream_attention_roofline``: B3 (``kvcache/stream_attention``) against
its roofline, over the traced steps.

The work of one layer's decode attention over the active rows: the int-N
codes of every live key and value (each row's tokens up to and including
its position: ``2 * head_dim * kv_bits / 8`` bytes per token and KV head)
with their bf16 scales (``2 * 2`` bytes), the bf16 queries and outputs
(``2 * 2 * n_heads * head_dim`` bytes a row), and ``4 * n_heads *
head_dim`` operations per live token.  Pages not yet written are not
counted.
"""
from perfbench.peaks import bound_s

KERNEL = "stream_attention"


def layer_work(shape, kv_bits: int, rows: int, kv_tokens: int
               ) -> tuple[float, float]:
    """``(operations, bytes)`` of one layer's attention over ``rows`` rows
    that attend over ``kv_tokens`` tokens in all."""
    hd, h, hkv = shape.head_dim, shape.n_heads, shape.n_kv_heads
    kv = kv_tokens * hkv * (2 * hd * kv_bits / 8 + 2 * 2)
    return 4.0 * kv_tokens * h * hd, kv + 2 * 2 * rows * h * hd


def read(run) -> float | None:
    tr = run.trace
    if tr is None:
        return None
    dev_s = tr.kernel_s(KERNEL)
    if dev_s <= 0:
        return None
    least = sum(run.shape.n_layers * bound_s(*layer_work(
        run.shape, run.quant["kv_bits"], s.rows, s.kv_tokens))
        for s in tr.steps)
    return 100.0 * least / dev_s
