"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
the counterparts of the reference's ``examples/`` scripts."""
