"""Experiment callbacks invoked by the Tune loop (a copy of
ray_tpu/air/callbacks.py).

Parity: python/ray/tune/callback.py (Callback with on_trial_* hooks) as
consumed through air RunConfig(callbacks=[...]).
"""

from __future__ import annotations

import logging
from typing import Any


class Callback:
    """Override any subset; all hooks are optional no-ops."""

    def setup(self, experiment_name: str | None = None) -> None:
        """Called once before the first trial launches."""

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        pass

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str, last_result: dict,
                          error: str | None = None) -> None:
        pass

    def on_experiment_end(self, results: Any) -> None:
        pass


def invoke(callbacks, hook: str, *args, **kwargs) -> None:
    """Best-effort fan-out: a broken tracker must not kill the experiment."""
    for cb in callbacks or ():
        try:
            getattr(cb, hook)(*args, **kwargs)
        except Exception:  # noqa: BLE001
            logging.getLogger("ray_tpu_torch.air").warning(
                "callback %s.%s failed", type(cb).__name__, hook, exc_info=True
            )
