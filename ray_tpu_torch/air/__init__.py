"""AIR glue: run configs + experiment-tracking callbacks (the port of
ray_tpu/air/__init__.py).

Parity: python/ray/air/ — the configs live in train/config.py (re-exported
here). ``ScalingConfig`` comes with the multi-rank trainer and the
wandb/mlflow integrations after it (ROADMAP queue 1 items 5b and 8).
"""

from ray_tpu_torch.air.callbacks import Callback
from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig

__all__ = ["CheckpointConfig", "FailureConfig", "RunConfig", "Callback"]
