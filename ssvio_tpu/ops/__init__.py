"""Compute kernels: geometry, features, tracking, optimizers."""
