"""Kernels of the port: each a wrapper over a hand-written Hopper kernel
(``csrc/``) with its plain PyTorch version beside it."""
