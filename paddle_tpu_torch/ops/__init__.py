"""Operators: layer norm and the hand-written Hopper kernels."""
