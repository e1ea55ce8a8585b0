"""PyTorch executors and the CUDA kernels' wrappers."""
