"""Convolutions, initializers, image ops and the hand-written CUDA kernels."""
