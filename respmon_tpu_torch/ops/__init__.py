"""Device ops of the port: plain PyTorch, plus hand-written CUDA kernels."""
