"""The plain reference of the served models: PyTorch operations in f32.

It imports nothing of the program under test and takes nothing the
program made: it is handed the same seeded bf16 weights and the same
tokens, and works out the group-wise weight quantization and the int-N
KV rounding again from them (:mod:`.quant`), then runs the whole
sequence through one causal forward pass (:mod:`.model`).
"""
