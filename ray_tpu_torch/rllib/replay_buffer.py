"""Replay buffer: experience storage shared through the actor runtime.

Parity: rllib/utils/replay_buffers/ (ReplayBuffer + the actor-hosted usage in
off-policy algorithms) — transitions live in one buffer actor that env-runner
sampling feeds and learner updates draw from, so collection and learning
scale independently (reference: DQN's replay actor pattern).
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    """Uniform FIFO transition store (usable inline or as a runtime actor)."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._storage: dict[str, np.ndarray] | None = None
        self._next = 0
        self._size = 0
        self.added_total = 0

    def add_batch(self, batch: dict) -> int:
        """Add {obs, actions, rewards, next_obs, dones} arrays (N rows each)."""
        n = len(batch["obs"])
        if n == 0:
            return self._size
        if self._storage is None:
            self._storage = {
                k: np.zeros((self.capacity, *np.asarray(v).shape[1:]),
                            dtype=np.asarray(v).dtype)
                for k, v in batch.items()
            }
        for k, v in batch.items():
            v = np.asarray(v)
            idx = (self._next + np.arange(n)) % self.capacity
            self._storage[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)
        self.added_total += n
        return self._size

    def sample(self, batch_size: int) -> dict:
        if self._size == 0:
            return {}
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._storage.items()}

    def __len__(self) -> int:
        return self._size

    def size(self) -> int:
        return self._size

    def stats(self) -> dict:
        return {"size": self._size, "capacity": self.capacity,
                "added_total": self.added_total}
