"""Sparse operators, CG and the CUDA kernel wrappers of the port."""
