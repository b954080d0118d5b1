"""repro_torch: the PyTorch / NVIDIA H100 port of the Iris reproduction.

A package of its own beside ``repro`` (the JAX/TPU reference, which it
never imports).  This slice serves dense decoders (smollm-135m) from
int-N Iris weight streams with a packed Iris KV cache, through two
hand-written CUDA kernels (``csrc/stream_matmul.cu``,
``csrc/stream_attention.cu``) built with ``nvcc`` at first use.  Entry
points run on ``"cuda"`` unless given ``device="cpu"``, where the
kernels' plain PyTorch versions run instead.
"""
