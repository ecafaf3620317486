"""DQN in PyTorch: double Q-learning with a target network + replay actor
(the port of ray_tpu/rllib/dqn.py).

Parity: rllib/algorithms/dqn/ (DQN with target network, double-Q targets,
epsilon-greedy exploration, replay buffer) over the shared Learner/EnvRunner
layering. Experience flows env runners -> replay buffer actor -> learner
minibatches; the update runs on the learner's device and the target network
is copied from the online one every ``target_update_freq`` updates. The
runners' epsilon-greedy policy evaluates the Q-network in numpy on the host
(the reference jits it), and ``gymnasium`` is imported only to make a named
env.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.np_policy import np_mlp, to_numpy_params
from ray_tpu_torch.rllib.off_policy import off_policy_train_iteration, probe_env_spaces
from ray_tpu_torch.rllib.ppo import _mlp_apply, _mlp_init, _take, make_env_creator
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer


@dataclasses.dataclass
class DQNConfig:
    """Reference: DQNConfig surface (fluent API below)."""

    env: str | Callable = "CartPole-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 128
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    learning_starts: int = 500  # min transitions before updates
    train_batch_size: int = 64
    updates_per_iter: int = 64
    target_update_freq: int = 500  # learner updates between target syncs
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 4000  # env steps to anneal over
    double_q: bool = True
    hidden: tuple = (64, 64)
    seed: int = 0

    def environment(self, env) -> "DQNConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: int | None = None) -> "DQNConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "DQNConfig":
        fields = {f.name for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if k not in fields:
                raise ValueError(f"Unknown training option {k}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "DQN":
        return DQN(self, device=device)


class DQNLearner(Learner):
    """Q-network + target network + the double-DQN update."""

    total_key = "loss"

    def __init__(self, cfg: DQNConfig, obs_dim: int, num_actions: int, device=None):
        super().__init__(cfg, device)
        self.params = _mlp_init(self.generator, (obs_dim, *cfg.hidden, num_actions),
                                self.device)
        self._reset()

    def _make_optimizer(self) -> optim.Adam:
        return optim.Adam(optim.tree_leaves(self.params), self.cfg.lr)

    def _init_targets(self) -> None:
        self.target_params = optim.tree_map(torch.clone, self.params)

    def _sync_targets(self) -> None:
        if self.num_updates % self.cfg.target_update_freq == 0:
            self._init_targets()

    def loss(self, params, b: dict):
        cfg = self.cfg
        q_taken = _take(_mlp_apply(params, b["obs"]), b["actions"])
        q_next_target = _mlp_apply(self.target_params, b["next_obs"])
        if cfg.double_q:
            # online net picks the argmax, target net evaluates it
            best = torch.argmax(_mlp_apply(params, b["next_obs"]), dim=1)
            q_next = _take(q_next_target, best)
        else:
            q_next = q_next_target.max(dim=1).values
        target = b["rewards"] + cfg.gamma * (1.0 - b["dones"]) * q_next
        td = q_taken - target.detach()
        # Huber loss (reference: dqn default)
        loss = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5).mean()
        return loss, {"td_error_mean": td.abs().mean(), "q_mean": q_taken.mean()}


class DQN:
    """The Algorithm (reference: algorithms/algorithm.py train() loop)."""

    def __init__(self, cfg: DQNConfig, device=None):
        self.cfg = cfg
        env_creator = make_env_creator(cfg.env)
        obs_dim, num_actions = probe_env_spaces(env_creator)
        self.learner = DQNLearner(cfg, obs_dim, num_actions, device=device)
        self.env_steps_total = 0
        algo = self

        def policy_fn(params, obs, rng):
            # epsilon-greedy exploration with annealed epsilon; logprob/value
            # slots unused by DQN (EnvRunner protocol shared with PPO)
            eps = algo.epsilon()
            if rng.random() < eps:
                action = int(rng.integers(num_actions))
            else:
                action = int(np.argmax(np_mlp(params, np.asarray(obs, np.float32)[None])[0]))
            return action, 0.0, 0.0

        self.runners = EnvRunnerGroup(env_creator, policy_fn,
                                      num_runners=cfg.num_env_runners)
        self.runners.sync_weights(to_numpy_params(self.learner.params))
        # replay buffer as a runtime actor: collection and learning share it
        buffer_actor = ray_tpu_torch.remote(num_cpus=0)(ReplayBuffer)
        self.buffer = buffer_actor.remote(cfg.buffer_capacity, cfg.seed)

    def epsilon(self) -> float:
        cfg = self.cfg
        frac = min(1.0, self.env_steps_total / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def train(self) -> dict:
        """One iteration: collect a fragment per runner, replay-update
        (shared loop in off_policy.py)."""
        out = off_policy_train_iteration(self)
        out["epsilon"] = self.epsilon()
        return out

    def stop(self) -> None:
        self.runners.stop()
        ray_tpu_torch.kill(self.buffer)
