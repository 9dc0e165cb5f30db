"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (ports of the reference's Pallas kernels, ``kernels/*``)."""
