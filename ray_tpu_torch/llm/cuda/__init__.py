"""Wrappers of the serving path's CUDA kernels (K4 paged attention)."""
