"""Compute ops: the packed attention kernel and its dispatcher, length
regulation, Griffin-Lim, and the nvcc build of the CUDA kernels."""
