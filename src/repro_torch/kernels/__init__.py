"""Hand-written CUDA kernels of the port, their wrappers, build and plain
versions (``ref``)."""
