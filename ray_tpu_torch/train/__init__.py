"""Training: the one-device and mesh train steps of the port (``spmd``), and
the pieces Tune's trials report through (``context``: ``report``,
``get_context``; the directory ``Checkpoint``; the ``RunConfig`` family in
``config``)."""

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.context import get_context, report

__all__ = ["Checkpoint", "get_context", "report"]
