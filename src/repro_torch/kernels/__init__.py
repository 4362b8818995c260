"""Hand-written Hopper kernels for the TPU kernels of ``repro.kernels``,
each beside its plain PyTorch version (``ops`` dispatches by device)."""
