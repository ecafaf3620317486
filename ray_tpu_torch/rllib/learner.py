"""What every port learner shares: parameters on a device, a functional
loss, gradients without module state, optax's optimizer, and the
compute_grads/apply_grads split the LearnerGroup drives (reference:
core/learner/learner.py compute_gradients/apply_gradients).

A learner keeps its parameters as a tree of plain tensors on
``ray_tpu_torch.resolve_device(device)``: ``cuda:0`` unless the caller
passes ``device="cpu"``, and an error when no card is there. Initial weights
and in-update noise are drawn from CPU generators seeded by ``cfg.seed``
and moved to the device, so a learner on the card and one on the CPU start
from the same numbers. Gradients come from ``torch.autograd.grad`` over
detached aliases of the leaves made for each call: nothing toggles
``requires_grad`` on shared tensors, so thread actors may hold learners side
by side, each on the default stream.
"""

from __future__ import annotations

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.np_policy import to_numpy_params


class Learner:
    """Subclasses build ``self.params`` (on ``self.device``) and define
    ``loss(params, batch) -> (total, metrics)`` and ``_make_optimizer()``;
    ``_sync_targets()`` keeps target networks after each step."""

    total_key = "total_loss"  # the name the reference gives the total in metrics
    int_keys = ("actions",)  # batch entries that index (torch.gather needs int64)

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = ray_tpu_torch.resolve_device(device)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.num_updates = 0

    # ---------------------------------------------------------------- state
    def _on_device(self, tree):
        return optim.tree_map(lambda t: torch.tensor(np.asarray(t, np.float32),
                                                     device=self.device), tree)

    def _reset(self) -> None:
        """Fresh optimizer state and targets for the current parameters."""
        self.optimizer = self._make_optimizer()
        self._init_targets()

    def _init_targets(self) -> None:
        """Target networks start as copies of their online networks."""

    def _sync_targets(self) -> None:
        """After each optimizer step (DQN's periodic copy, SAC's Polyak)."""

    def from_jax(self, params_np) -> "Learner":
        """Take the JAX learner's parameter tree (numpy, the same nesting) as
        this learner's, with a fresh optimizer and targets equal to it, as a
        JAX learner has them right after its own init."""
        self.params = self._on_device(params_np)
        self.num_updates = 0
        self._reset()
        return self

    def set_params(self, params_np) -> None:
        """Replace the parameters only (the optimizer state stays)."""
        self.params = self._on_device(params_np)

    def get_params(self):
        return to_numpy_params(self.params)

    # --------------------------------------------------------------- update
    def _tensors(self, batch: dict) -> dict:
        return {k: torch.tensor(np.asarray(v, np.int64 if k in self.int_keys else np.float32),
                                device=self.device)
                for k, v in batch.items()}

    def _noise(self, b: dict) -> dict:
        """Inputs an update draws itself (none here; SAC-style learners add
        their reparameterisation normals)."""
        return b

    def _grads(self, b: dict) -> tuple[list[torch.Tensor], dict]:
        live = optim.tree_map(lambda p: p.detach().requires_grad_(), self.params)
        total, metrics = self.loss(live, b)
        leaves = optim.tree_leaves(live)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return grads, {**metrics, self.total_key: total}

    def _step(self, grads: list[torch.Tensor]) -> None:
        with torch.no_grad():
            self.optimizer.step(optim.tree_leaves(self.params), grads)
            self.num_updates += 1
            self._sync_targets()

    @staticmethod
    def _floats(metrics: dict) -> dict:
        values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()])
        return dict(zip(metrics, values.tolist()))  # one device-to-host copy

    def update(self, batch: dict) -> dict:
        grads, metrics = self._grads(self._noise(self._tensors(batch)))
        self._step(grads)
        return self._floats(metrics)

    # the LearnerGroup's data-parallel protocol
    def compute_grads(self, batch: dict) -> tuple:
        """(gradient tree as host numpy, metrics) for one shard."""
        grads, metrics = self._grads(self._noise(self._tensors(batch)))
        return to_numpy_params(optim.tree_unflatten(self.params, grads)), self._floats(metrics)

    def apply_grads(self, grads) -> None:
        self._step([torch.as_tensor(g, dtype=torch.float32).to(self.device)
                    for g in optim.tree_leaves(grads)])
