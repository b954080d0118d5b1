"""repro_torch: the PyTorch / NVIDIA H100 port of the Iris reproduction.

A package of its own beside ``repro`` (the JAX/TPU reference, which it
never imports).  It serves decoders of one ``attn -> mlp`` sublayer
(the dense configs and qwen2-vl-2b) from int-N Iris weight streams with
a packed Iris KV cache, and every config of the reference unquantized,
through hand-written CUDA kernels (``csrc/*.cu``) built with ``nvcc`` at
first use.  It trains every family as the reference does
(``Model.loss``, AdamW with optional gradient compression, the
fault-tolerant train loop over the synthetic pipeline; ``python -m
repro_torch.launch.train``).  Entry points run on ``"cuda"`` unless
given ``device="cpu"``, where the kernels' plain PyTorch versions run
instead.
"""
