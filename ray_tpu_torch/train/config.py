"""Run configuration dataclasses (the RunConfig family of
ray_tpu/train/config.py).

Parity: python/ray/air/config.py (RunConfig, FailureConfig,
CheckpointConfig), what Tune reads: the experiment's name and its
callbacks. ``ScalingConfig``, ``JaxConfig`` and ``Result`` come with the
multi-rank trainer (ROADMAP queue 1 item 5b).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class FailureConfig:
    """Reference: air/config.py FailureConfig; train/v2 failure_handling."""

    max_failures: int = 0  # retries of the whole worker group
    # Preemptions budget separately (reference: spot reclaim doesn't consume
    # the failure budget); -1 = unlimited
    max_preemption_failures: int = -1


@dataclasses.dataclass
class CheckpointConfig:
    """Reference: air/config.py CheckpointConfig."""

    num_to_keep: int | None = None
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    """Reference: air/config.py RunConfig."""

    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    # experiment-tracking callbacks (reference: air RunConfig.callbacks)
    callbacks: list | None = None

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results", self.name or "experiment"
        )
