"""One-device training step: the counterpart of ray_tpu/train/spmd.py.

``make_train_step`` returns ``(state, tokens, targets) -> (state, metrics)``
as the JAX step does, without a mesh (sharding comes with the port's
device mesh). The step runs ``llama.loss_fn`` and its backward, then the
optimizer of ``make_optimizer``, which matches the JAX package's optax
chain exactly:

- ``clip_by_global_norm(1.0)`` in optax's form: the gradients are left as
  they are when their global norm is below the limit, else become
  ``g / norm * max_norm`` (``clip_grad_norm_`` would add 1e-6 to the norm);
- ``torch.optim.AdamW`` with b1 0.9, b2 0.95, eps 1e-8 and decoupled weight
  decay on every parameter (optax ``mask=None``): ``p(1 - lr * wd) - lr *
  mu_hat / (sqrt(nu_hat) + eps)`` is optax's ``p - lr * (mu_hat /
  (sqrt(nu_hat) + eps) + wd * p)``, moments kept in the parameter's dtype as
  optax keeps them;
- the learning rate of ``optax.warmup_cosine_decay_schedule(0, lr, warmup,
  10000, 0.1 * lr)`` at the number of updates already done, so the first
  step runs at lr 0.

The step updates the parameters and the optimizer state in place (the JAX
step donates its state) and hands them back in a new ``TrainState``.
``grad_norm`` is the global norm of the unclipped gradients, ``step`` the
count after the update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama

# the JAX package's make_optimizer constants
DECAY_STEPS, END_LR_FRACTION = 10000, 0.1
B1, B2, EPS = 0.9, 0.95, 1e-8
MAX_NORM = 1.0


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int


def leaves(tree: dict) -> list[torch.Tensor]:
    """Tensors of a nested dict, in insertion order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Global-norm clipping, then ``torch.optim.AdamW`` under a
    warmup-cosine schedule (built by ``make_optimizer``)."""

    learning_rate: float
    weight_decay: float
    warmup: int

    def schedule(self, count: int) -> float:
        """Learning rate after ``count`` updates: linear from 0 over the
        warmup, then cosine down to a tenth of the peak at DECAY_STEPS."""
        lr = self.learning_rate
        if count < self.warmup:
            return -lr * (1 - count / self.warmup) + lr
        span = DECAY_STEPS - self.warmup
        cosine = 0.5 * (1 + math.cos(math.pi * min(count - self.warmup, span) / span))
        alpha = END_LR_FRACTION if lr else 0.0
        return lr * ((1 - alpha) * cosine + alpha)

    def init(self, params: dict) -> dict:
        adamw = torch.optim.AdamW(leaves(params), lr=0.0, betas=(B1, B2), eps=EPS,
                                  weight_decay=self.weight_decay, foreach=True)
        return {"count": 0, "adamw": adamw}

    @torch.no_grad()
    def update(self, params: dict, grads: list[torch.Tensor], opt_state: dict) -> torch.Tensor:
        """Clip ``grads`` (in ``leaves(params)`` order) and apply one AdamW
        update to ``params`` and ``opt_state``, in place. Returns the global
        norm of the unclipped gradients, a float32 scalar on their device."""
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
        keep = norm < MAX_NORM
        div, mul = torch.where(keep, 1.0, norm), torch.where(keep, 1.0, MAX_NORM)
        adamw = opt_state["adamw"]
        for p, g in zip(leaves(params), grads):
            p.grad = g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
        adamw.param_groups[0]["lr"] = self.schedule(opt_state["count"])
        adamw.step()
        adamw.zero_grad(set_to_none=True)
        opt_state["count"] += 1
        return norm


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   warmup: int = 100) -> Optimizer:
    return Optimizer(learning_rate, weight_decay, warmup)


def init_state(cfg: llama.LlamaConfig, generator: torch.Generator, optimizer=None,
               device=None) -> TrainState:
    """Seeded ``llama.init`` on ``device`` (the card unless ``"cpu"`` is
    asked for; raises without one) and a fresh optimizer state."""
    device = resolve_device(device)
    optimizer = optimizer or make_optimizer()
    params = llama.init(cfg, generator, device)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def make_train_step(cfg: llama.LlamaConfig, optimizer=None, attn_fn: Callable | None = None,
                    device=None) -> Callable:
    """Build the train step: ``(state, tokens, targets) -> (state, {"loss",
    "grad_norm", "step"})``. Tokens and targets ([B, S] ints, numpy or
    torch) are moved to ``device`` (the card unless ``"cpu"`` is asked for;
    raises without one), where the state must live."""
    device = resolve_device(device)
    optimizer = optimizer or make_optimizer()

    def step_fn(state: TrainState, tokens, targets):
        tokens = torch.as_tensor(tokens, device=device)
        targets = torch.as_tensor(targets, device=device)
        tensors = [p.requires_grad_() for p in leaves(state.params)]
        loss = llama.loss_fn(state.params, tokens, targets, cfg, attn_fn)
        grads = list(torch.autograd.grad(loss, tensors))
        grad_norm = optimizer.update(state.params, grads, state.opt_state)
        new_state = TrainState(state.params, state.opt_state, state.step + 1)
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm,
                           "step": new_state.step}

    return step_fn
