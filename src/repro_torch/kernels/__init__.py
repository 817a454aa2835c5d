"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (CUDA sources under ``csrc/``, built by ``build``)."""
