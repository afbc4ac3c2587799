"""Hand-written CUDA kernels (csrc/), the nvcc build step and the wrappers."""
