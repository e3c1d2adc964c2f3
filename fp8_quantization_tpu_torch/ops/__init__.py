"""Quantization numerics and the hand-written kernels."""
