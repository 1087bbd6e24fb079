"""Builder and loader of the port's hand-written CUDA kernels."""
