"""Op lowerings of the port: plain PyTorch, and the wrappers of the
hand-written CUDA kernels with their plain versions."""
