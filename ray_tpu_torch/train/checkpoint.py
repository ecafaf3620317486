"""Directory checkpoints (the directory ``Checkpoint`` of
ray_tpu/train/checkpoint.py).

Parity: python/ray/train — Checkpoint (train/_checkpoint.py): a path to a
directory of checkpoint data, the handle ``train.report`` passes on. The
reference's orbax ``from_state``/``to_state``, ``CheckpointManager`` and the
object-plane checkpoints are not ported yet (ROADMAP queue 1 item 5b).
"""

from __future__ import annotations

import os


class Checkpoint:
    """A directory of checkpoint data (reference: ray.train.Checkpoint)."""

    def __init__(self, path: str):
        self.path = path

    @staticmethod
    def from_directory(path: str) -> "Checkpoint":
        return Checkpoint(os.path.abspath(path))

    def as_directory(self) -> str:
        return self.path
