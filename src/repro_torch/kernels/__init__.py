"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the dispatch between the two (``ops``)."""
