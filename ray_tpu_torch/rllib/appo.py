"""APPO in PyTorch: asynchronous PPO (IMPALA architecture, PPO surrogate),
the port of ray_tpu/rllib/appo.py.

Parity: rllib/algorithms/appo/. IMPALA's actor-learner decoupling and
stale weight broadcasts, with the clipped PPO surrogate applied to V-trace
corrected advantages and several SGD epochs per collected batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tpu_torch.rllib.env_runner import Episode
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, IMPALALearner
from ray_tpu_torch.rllib.ppo import minibatch_sgd


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    """Fluent surface mirrors the reference's APPOConfig."""

    clip_param: float = 0.3
    num_epochs: int = 2
    minibatch_size: int = 256
    lr: float = 3e-3

    def build(self, device=None) -> "APPO":
        return APPO(self, device=device)


class APPOLearner(IMPALALearner):
    """IMPALA's nets, clip and Adam; the clipped surrogate on V-trace targets."""

    def loss(self, params, b: dict):
        cfg = self.cfg
        logp, values, entropy = self._policy_terms(params, b)
        # clipped surrogate vs the BEHAVIOR policy (the stale actor weights):
        # the asynchronous analog of PPO's old-policy ratio
        ratio = torch.exp(logp - b["behavior_logp"])
        clipped = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param)
        adv = b["advantages"]
        pg_loss = -torch.minimum(ratio * adv, clipped * adv).mean()
        vf_loss = ((values - b["vs_targets"]) ** 2).mean()
        total = pg_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}


class APPO(IMPALA):
    """IMPALA's collection loop; PPO-clipped multi-epoch learner."""

    def _make_learner(self, obs_dim: int, num_actions: int, device):
        return APPOLearner(self.cfg, obs_dim, num_actions, device=device)

    def _episode_batch(self, episodes: list[Episode]) -> dict:
        batch = super()._episode_batch(episodes)
        # the surrogate ratio needs the behavior (actor-side) logprobs
        batch["behavior_logp"] = np.concatenate(
            [np.asarray(ep.logprobs, np.float32) for ep in episodes if len(ep)]
        )
        return batch

    def _update_from_batch(self, batch: dict) -> dict:
        """Multi-epoch clipped minibatch SGD over the collected batch."""
        cfg = self.cfg
        return minibatch_sgd(
            self.learner.update, batch, cfg.num_epochs, cfg.minibatch_size,
            rng=np.random.default_rng(cfg.seed + self.iterations),
        )
