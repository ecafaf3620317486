"""Connector pipelines: composable observation/action transforms for rollouts.

Parity: rllib/connectors/ — env-to-module pipelines shape raw env
observations into what the policy consumes (flatten, running-stat
normalization, frame stacking), module-to-env pipelines shape policy outputs
into what the env consumes (clip, unsquash). Connectors are stateful where
the transform requires it (frame stacks reset at episode boundaries; running
stats accumulate per runner), and pipelines are built per EnvRunner from a
factory so actor-parallel runners never share mutable state.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Sequence

import numpy as np


class Connector:
    """One transform stage. Override __call__; override reset() if stateful."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reset(self) -> None:
        """Called at episode boundaries (stateful connectors drop state)."""


class ConnectorPipeline(Connector):
    def __init__(self, connectors: Sequence[Connector]):
        self.connectors = list(connectors)

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x

    def reset(self) -> None:
        for c in self.connectors:
            c.reset()


# ------------------------------------------------------------- env-to-module
class FlattenObs(Connector):
    def __call__(self, obs):
        return np.asarray(obs, np.float32).reshape(-1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs):
        return np.clip(obs, self.low, self.high)


class NormalizeObs(Connector):
    """Running mean/std standardization (Welford). Stats persist across
    episodes (they describe the observation distribution, not the episode)."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0):
        self.count = 0
        self.mean: np.ndarray | None = None
        self.m2: np.ndarray | None = None
        self.eps, self.clip = eps, clip

    def __call__(self, obs):
        obs = np.asarray(obs, np.float64)
        if self.mean is None:
            self.mean = np.zeros_like(obs)
            self.m2 = np.zeros_like(obs)
        self.count += 1
        delta = obs - self.mean
        self.mean += delta / self.count
        self.m2 += delta * (obs - self.mean)
        var = self.m2 / max(1, self.count - 1) if self.count > 1 else np.ones_like(obs)
        out = (obs - self.mean) / np.sqrt(var + self.eps)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)


class FrameStack(Connector):
    """Concatenate the last k observations (zero-padded at episode start)."""

    def __init__(self, k: int = 4):
        if k < 1:
            raise ValueError("FrameStack k must be >= 1")
        self.k = k
        self.frames: deque = deque(maxlen=k)

    def __call__(self, obs):
        obs = np.asarray(obs, np.float32)
        if not self.frames:
            for _ in range(self.k - 1):
                self.frames.append(np.zeros_like(obs))
        self.frames.append(obs)
        return np.concatenate(list(self.frames), axis=-1)

    def reset(self) -> None:
        self.frames.clear()


# ------------------------------------------------------------- module-to-env
class ClipActions(Connector):
    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, action):
        return np.clip(action, self.low, self.high)


class UnsquashActions(Connector):
    """Map policy-space [-1, 1] onto the env's Box range."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)


PipelineFactory = Callable[[], ConnectorPipeline]


def pipeline(*connector_factories: Callable[[], Connector]) -> PipelineFactory:
    """Factory-of-factories: each EnvRunner actor builds its own stateful
    pipeline instance (reference: connector pipelines are per-EnvRunner)."""

    def make() -> ConnectorPipeline:
        return ConnectorPipeline([f() for f in connector_factories])

    return make
