"""IMPALA in PyTorch: importance-weighted actor-learner with V-trace (the
port of ray_tpu/rllib/impala.py).

Parity: rllib/algorithms/impala/. Actors collect with a (stale) behavior
policy while the learner updates, and V-trace (Espeholt et al. 2018)
corrects the off-policyness with clipped importance ratios. Weights
broadcast to the env runners only every `broadcast_interval` iterations.
The learner's update (policy gradient with rho-weighted advantages, value
regression to v-trace targets, entropy bonus; global-norm clip 5.0 and Adam)
runs on the learner's device; V-trace runs on the host in numpy, as in the
reference. ``gymnasium`` is imported only to make a named env.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.env_runner import Episode, EnvRunnerGroup
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.np_policy import (actor_critic_policy_fn, log_softmax, np_mlp,
                                           to_numpy_params)
from ray_tpu_torch.rllib.off_policy import probe_env_spaces
from ray_tpu_torch.rllib.ppo import _mlp_apply, _mlp_init, _take, make_env_creator


@dataclasses.dataclass
class IMPALAConfig:
    """Reference: IMPALAConfig surface (fluent API below)."""

    env: str | Callable = "CartPole-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 256
    lr: float = 6e-4
    gamma: float = 0.99
    rho_clip: float = 1.0  # V-trace rho-bar (importance ratio cap)
    c_clip: float = 1.0  # V-trace c-bar (trace-cutting cap)
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    broadcast_interval: int = 2  # iterations between weight broadcasts
    hidden: tuple = (64, 64)
    seed: int = 0

    def environment(self, env) -> "IMPALAConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: int | None = None) -> "IMPALAConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "IMPALAConfig":
        fields = {f.name for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if k not in fields:
                raise ValueError(f"Unknown training option {k}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "IMPALA":
        return IMPALA(self, device=device)


def vtrace(behavior_logp, current_logp, rewards, values, bootstrap, dones,
           gamma, rho_clip, c_clip):
    """Host-side V-trace for one trajectory (numpy; Espeholt eq. 1), a copy
    of the reference's. Returns (vs targets [T], pg advantages [T])."""
    T = len(rewards)
    ratios = np.exp(current_logp - behavior_logp)
    rhos = np.minimum(rho_clip, ratios)
    cs = np.minimum(c_clip, ratios)
    next_values = np.append(values[1:], bootstrap)
    next_values = np.where(dones, 0.0, next_values)
    deltas = rhos * (rewards + gamma * next_values - values)
    vs_minus_v = np.zeros(T + 1)
    for t in range(T - 1, -1, -1):
        not_done = 0.0 if dones[t] else 1.0
        vs_minus_v[t] = deltas[t] + gamma * cs[t] * not_done * vs_minus_v[t + 1]
    vs = values + vs_minus_v[:-1]
    next_vs = np.append(vs[1:], bootstrap)
    next_vs = np.where(dones, 0.0, next_vs)
    advantages = rhos * (rewards + gamma * next_vs - values)
    return vs, advantages


class IMPALALearner(Learner):
    """Policy + value nets with the V-trace-corrected update."""

    max_norm = 5.0

    def __init__(self, cfg: IMPALAConfig, obs_dim: int, num_actions: int, device=None):
        super().__init__(cfg, device)
        self.params = {
            "pi": _mlp_init(self.generator, (obs_dim, *cfg.hidden, num_actions), self.device),
            "vf": _mlp_init(self.generator, (obs_dim, *cfg.hidden, 1), self.device),
        }
        self._reset()

    def _make_optimizer(self) -> optim.Adam:
        return optim.Adam(optim.tree_leaves(self.params), self.cfg.lr, max_norm=self.max_norm)

    def _policy_terms(self, params, b: dict):
        """(log-probs of all actions, of the taken ones, values, entropy)."""
        logp_all = torch.log_softmax(_mlp_apply(params["pi"], b["obs"]), dim=-1)
        values = _mlp_apply(params["vf"], b["obs"])[:, 0]
        entropy = -(torch.exp(logp_all) * logp_all).sum(dim=1).mean()
        return _take(logp_all, b["actions"]), values, entropy

    def loss(self, params, b: dict):
        cfg = self.cfg
        logp, values, entropy = self._policy_terms(params, b)
        pg_loss = -(logp * b["advantages"]).mean()
        vf_loss = ((values - b["vs_targets"]) ** 2).mean()
        total = pg_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}


class IMPALA:
    """The Algorithm (reference: algorithms/algorithm.py train() loop)."""

    def __init__(self, cfg: IMPALAConfig, device=None):
        self.cfg = cfg
        env_creator = make_env_creator(cfg.env)
        obs_dim, num_actions = probe_env_spaces(env_creator)
        self.learner = self._make_learner(obs_dim, num_actions, device)
        self.env_steps_total = 0
        self.iterations = 0
        # the shared numpy actor-critic policy: real V(obs) flows into
        # ep.bootstrap_value, so fragment-cut episodes bootstrap correctly
        self.runners = EnvRunnerGroup(env_creator, actor_critic_policy_fn,
                                      num_runners=cfg.num_env_runners)
        self.runners.sync_weights(to_numpy_params(self.learner.params))

    def _make_learner(self, obs_dim: int, num_actions: int, device):
        """Subclass hook (APPO swaps in its clipped-surrogate learner)."""
        return IMPALALearner(self.cfg, obs_dim, num_actions, device=device)

    def _episode_batch(self, episodes: list[Episode]) -> dict:
        cfg = self.cfg
        # numpy host pass for the V-trace inputs (episode lengths vary)
        params_np = to_numpy_params(self.learner.params)
        obs_all, act_all, vs_all, adv_all = [], [], [], []
        for ep in episodes:
            if not len(ep):
                continue
            obs = np.asarray(ep.obs, np.float32)
            logp_cur_all = log_softmax(np_mlp(params_np["pi"], obs.astype(np.float64)))
            values = np_mlp(params_np["vf"], obs.astype(np.float64))[:, 0]
            actions = np.asarray(ep.actions, np.int64)
            logp_cur = logp_cur_all[np.arange(len(actions)), actions]
            dones = np.asarray(ep.dones, bool)
            vs, adv = vtrace(
                np.asarray(ep.logprobs, np.float64), logp_cur.astype(np.float64),
                np.asarray(ep.rewards, np.float64), values.astype(np.float64),
                float(ep.bootstrap_value), dones,
                cfg.gamma, cfg.rho_clip, cfg.c_clip,
            )
            obs_all.append(obs)
            act_all.append(actions)
            vs_all.append(vs)
            adv_all.append(adv)
        return {
            "obs": np.concatenate(obs_all),
            "actions": np.concatenate(act_all),
            "vs_targets": np.concatenate(vs_all).astype(np.float32),
            "advantages": np.concatenate(adv_all).astype(np.float32),
        }

    def _update_from_batch(self, batch: dict) -> dict:
        """Subclass hook: one plain update here; APPO does clipped
        multi-epoch minibatch SGD over the same batch."""
        return self.learner.update(batch)

    def train(self) -> dict:
        cfg = self.cfg
        episodes = self.runners.sample(cfg.rollout_fragment_length)
        self.env_steps_total += sum(len(e) for e in episodes)
        batch = self._episode_batch(episodes)
        metrics = self._update_from_batch(batch) if len(batch["obs"]) else {}
        self.iterations += 1
        # stale broadcast: actors keep collecting with old weights between
        # broadcasts, the off-policy gap V-trace corrects
        if self.iterations % cfg.broadcast_interval == 0:
            self.runners.sync_weights(to_numpy_params(self.learner.params))
        finished = [e for e in episodes if e.dones and e.dones[-1]]
        return {
            "env_steps_total": self.env_steps_total,
            "episodes_this_iter": len(finished),
            "episode_reward_mean": (
                float(np.mean([e.total_reward() for e in finished]))
                if finished else float("nan")
            ),
            **metrics,
        }

    def stop(self) -> None:
        self.runners.stop()
