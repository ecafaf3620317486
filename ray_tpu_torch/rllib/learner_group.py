"""LearnerGroup: data-parallel learner workers with synchronous gradient
averaging (the port of ray_tpu/rllib/learner_group.py).

Parity: rllib/core/learner/learner_group.py:100 (LearnerGroup: N learner
workers updating one logical policy). Each learner is a thread actor of the
port's runtime hosting one learner replica (any port learner: they all
expose the compute_grads/apply_grads split); a group update shards the
batch, gathers per-shard gradients, averages them example-weighted on the
host, and hands the averaged gradients to every learner, so every replica
takes the IDENTICAL optimizer step (bitwise-equal replicas, the DDP
contract). Replicas on one card share its default stream.

Differences from the reference: the factory is passed to the actors as the
callable itself (thread actors share the process, so there is no cloudpickle
blob); and the update runs per call only. The reference's resident compiled
step graph (``ray_tpu.dag.compiled``) waits for the port's compiled graphs,
ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib import optim


class _LearnerWorker:
    """Actor hosting one learner replica."""

    def __init__(self, factory: Callable):
        self.learner = factory()

    def compute_grads(self, shard: dict):
        return self.learner.compute_grads(shard)

    def apply_grads(self, grads) -> bool:
        self.learner.apply_grads(grads)
        return True

    def get_params(self):
        return self.learner.get_params()


def _average(results: list, sizes: list) -> tuple:
    """Example-weighted average of per-shard (grads, metrics) (the
    reference's _GradAverager.average: loss means are per-shard means)."""
    total = float(sum(sizes))
    weights = [s / total for s in sizes]
    grads = optim.tree_map(lambda *gs: sum(w * g for w, g in zip(weights, gs)),
                           *[g for g, _ in results])
    metrics: dict = {}
    for (_, m), w in zip(results, weights):
        for k, v in m.items():
            metrics[k] = metrics.get(k, 0.0) + w * v
    return grads, metrics


class LearnerGroup:
    def __init__(self, learner_factory: Callable, num_learners: int = 2,
                 num_cpus_per_learner: float = 0.5):
        if num_learners < 1:
            raise ValueError("num_learners must be >= 1")
        cls = ray_tpu_torch.remote(num_cpus=num_cpus_per_learner,
                                   max_concurrency=2)(_LearnerWorker)
        self.workers = [cls.remote(learner_factory) for _ in range(num_learners)]
        self.num_learners = num_learners
        # replica-identity check: gradient averaging is only valid against
        # IDENTICAL parameters; an unseeded factory silently trains garbage
        if num_learners > 1:
            all_params = ray_tpu_torch.get(
                [w.get_params.remote() for w in self.workers], timeout=300)
            base = optim.tree_leaves(all_params[0])
            for rank, other in enumerate(all_params[1:], start=1):
                for a, b in zip(base, optim.tree_leaves(other)):
                    if not np.array_equal(a, b):
                        self.shutdown()
                        raise ValueError(
                            "learner replicas diverge at init (rank 0 vs "
                            f"rank {rank}): the learner_factory must produce "
                            "deterministic (seeded) parameters")

    def update(self, batch: dict) -> dict:
        """One data-parallel step: shard -> per-learner grads -> example-
        weighted average -> identical apply on every learner."""
        n = len(next(iter(batch.values())))
        if n == 0:
            return {}
        bounds = np.linspace(0, n, self.num_learners + 1).astype(int)
        shards, sizes = [], []
        for i in range(self.num_learners):
            lo, hi = bounds[i], bounds[i + 1]
            if hi > lo:
                shards.append({k: v[lo:hi] for k, v in batch.items()})
                sizes.append(hi - lo)
        results = ray_tpu_torch.get(
            [w.compute_grads.remote(s) for w, s in zip(self.workers, shards)], timeout=600)
        grads, metrics = _average(results, sizes)
        ray_tpu_torch.get([w.apply_grads.remote(grads) for w in self.workers], timeout=600)
        return metrics

    def get_params(self):
        return ray_tpu_torch.get(self.workers[0].get_params.remote(), timeout=120)

    def shutdown(self) -> None:
        for w in self.workers:
            ray_tpu_torch.kill(w)
