"""Tensor operations of the pipeline and the wrappers of its CUDA kernels."""
