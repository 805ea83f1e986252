"""Operators with hand-written CUDA kernels, and their build."""
