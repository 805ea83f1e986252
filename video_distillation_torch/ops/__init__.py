"""Operators with hand-written CUDA kernels, their build, and the losses."""
