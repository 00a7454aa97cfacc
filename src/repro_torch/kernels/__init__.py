"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (DESIGN §3.4). Importing this package builds nothing."""
