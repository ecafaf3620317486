"""Per-worker train context + the ``ray_tpu_torch.train.report`` API (a copy
of ray_tpu/train/context.py).

Parity: ray.train.get_context() / ray.train.report(metrics, checkpoint)
(train/v2 context + report_handler.py). Context is thread-local because each
worker's loop (here: each Tune trial) runs in its own thread.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_local = threading.local()


@dataclass
class TrainContext:
    rank: int = 0
    world_size: int = 1
    report_fn: Callable | None = None
    dataset_shards: dict = field(default_factory=dict)

    def get_world_rank(self) -> int:
        return self.rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_dataset_shard(self, name: str = "train"):
        return self.dataset_shards.get(name)


def set_context(ctx: TrainContext) -> None:
    _local.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        ctx = TrainContext()  # defaults outside a worker (rank 0 of 1)
        _local.ctx = ctx
    return ctx


def report(metrics: dict, checkpoint: Optional[Checkpoint] = None) -> None:
    """Reference: ray.train.report — rank-aware metric/checkpoint sync point."""
    ctx = get_context()
    if ctx.report_fn is not None:
        ctx.report_fn(metrics, checkpoint)
