"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute path.

Beside ``ray_tpu`` (the JAX/TPU reference), this package runs the same
models and engines in PyTorch, with every Pallas TPU kernel replaced by a
kernel written by hand for NVIDIA Hopper (``csrc/``). It imports neither
``jax`` nor any module of ``ray_tpu``: what it needs from there is copied.

Entry points run on the first CUDA device unless the caller passes
``device="cpu"`` (the CPU tests do). With no CUDA device and no explicit
CPU request they raise; nothing falls back to the CPU silently.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0`` and raises when no CUDA device is present;
    anything else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_tpu_torch: no CUDA device is available; pass device='cpu' "
                "to run on the CPU")
        return torch.device("cuda", 0)
    return torch.device(device)
