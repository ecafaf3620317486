"""The optimizer the learners use, written out to optax's formulas (the
reference learners chain optax transforms).

- ``adam``: optax.adam (``scale_by_adam`` then ``scale_by_learning_rate``):
  mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the bias corrections
  1 - b^count in float32, update = -lr * mu_hat / (sqrt(nu_hat) + eps).
- ``clip_by_global_norm``: optax's rule exactly, g while the global norm is
  below ``max_norm`` and (g / norm) * max_norm otherwise
  (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6 instead).
- ``multi_transform``: one Adam per labelled group of top-level keys, each
  with its own learning rate, after one global clip over all groups, as
  ``sac.py`` and ``sac_continuous.py`` chain it. Adam is elementwise and every
  group steps once an update, so the groups share one step count and differ
  only in their learning rate.

Parameter trees are nested dicts and lists of tensors; their leaves are
taken in JAX's order (dict keys sorted), so they line up with
``jax.tree.leaves`` of the reference learner's tree.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree shaped like ``like`` holding ``leaves`` in tree_leaves order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree),
                                                      *map(tree_leaves, rest))])


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every leaf's squared sum."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm (no host sync: the choice is a select)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def multi_transform(tree: dict, lrs: dict[str, float], labels: dict[str, str]) -> list[float]:
    """The learning rate of each leaf of ``tree`` (tree_leaves order) under
    optax.multi_transform({label: adam(lr)}, {top-level key: label})."""
    return [lrs[labels[k]] for k in sorted(tree) for _ in tree_leaves(tree[k])]


class Adam:
    """optax.adam over a list of leaf tensors, each with its learning rate,
    after an optional global-norm clip. ``step`` updates the leaves and the
    moments in place."""

    def __init__(self, leaves: list[torch.Tensor], lr, *, max_norm: float | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lrs = [float(lr)] * len(leaves) if np.isscalar(lr) else [float(x) for x in lr]
        if len(self.lrs) != len(leaves):
            raise ValueError(f"{len(self.lrs)} learning rates for {len(leaves)} leaves")
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]

    def step(self, leaves: list[torch.Tensor], grads: list[torch.Tensor]) -> None:
        if self.max_norm is not None:
            grads = clip_by_global_norm(grads, self.max_norm)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1 - b2))
        self.count += 1
        # optax forms 1 - b^count in float32 from the int32 count
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_mul_(updates, [-lr for lr in self.lrs])
        torch._foreach_add_(leaves, updates)
