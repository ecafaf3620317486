"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute path.

Beside ``ray_tpu`` (the JAX/TPU reference), this package runs the same
models and engines in PyTorch, with every Pallas TPU kernel replaced by a
kernel written by hand for NVIDIA Hopper (``csrc/``). It imports neither
``jax`` nor any module of ``ray_tpu``: what it needs from there is copied.

The paths so far:
- serving: ``serve.llm_paged.PagedLLMEngine`` -> ``models.llama.forward_paged``
  -> the paged decode kernel; its prefill/decode handoff
  (``PagedLLMEngine.prefill_extract`` / ``attach_sequence``, the decode half
  through the same kernel); and speculative decoding
  (``serve.spec_decode.SpecDecodeLLMEngine``, the draft's decodes through
  the paged kernel at the draft's shape);
- training: ``train.spmd.make_train_step`` -> ``models.llama.loss_fn`` ->
  the flash attention forward and backward kernels;
- the MoE and ViT families (``models.moe``, ``models.vit``: ``forward`` and
  ``loss_fn`` on dense attention, as the reference runs them);
- an in-process runtime (``core``: ``init``, ``remote`` tasks and thread
  actors, ``put``/``get``/``wait``, re-exported here) and the serve control
  plane over it (``serve``: ``run``, ``start_http_proxy``,
  ``build_openai_app``), so an HTTP request reaches ``PagedLLMEngine``.

Entry points run on the first CUDA device unless the caller passes
``device="cpu"`` (the CPU tests do). With no CUDA device and no explicit
CPU request they raise; nothing falls back to the CPU silently.
"""

from __future__ import annotations

import torch

from ray_tpu_torch import train

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


from ray_tpu_torch.core.api import (available_resources, cluster_resources,  # noqa: E402
                                    get, get_actor, init, is_initialized, kill, put, remote,
                                    shutdown, wait)
