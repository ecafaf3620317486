"""PPO in PyTorch: learner + algorithm (the port of ray_tpu/rllib/ppo.py).

Parity: rllib/algorithms/ppo/ (PPO with clipped surrogate + GAE),
rllib/core/learner/learner.py:112 (Learner: owns optimizer + update step) and
learner_group.py:100. The learner's parameters and optimizer state live on
the card (``device=None`` is ``cuda:0``); env runners evaluate the policy
in numpy on the host, as the reference's do.

Differences from the reference: ``gymnasium`` is imported only when
``cfg.env`` is a string to make into an env (the reference imports it at
the top of ``PPO.__init__``), so a callable env needs no gymnasium; the
initial weights come from a seeded ``torch.Generator``, not
``jax.random`` (``PPOLearner.from_jax`` takes a JAX learner's weights).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.env_runner import Episode, EnvRunnerGroup
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.np_policy import actor_critic_policy_fn, to_numpy_params


@dataclasses.dataclass
class PPOConfig:
    """Reference: AlgorithmConfig + PPOConfig surface (fluent API below)."""

    env: str | Callable = "CartPole-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 256
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    entropy_coeff: float = 0.01
    vf_coeff: float = 0.5
    num_epochs: int = 4
    minibatch_size: int = 128
    hidden: tuple = (64, 64)
    seed: int = 0
    # >1: data-parallel learner workers with synchronous gradient averaging
    # (reference: core/learner/learner_group.py:100 LearnerGroup)
    num_learners: int = 1
    # connector pipeline factories (reference: rllib/connectors): each env
    # runner builds its own stateful instances
    env_to_module: Callable | None = None
    module_to_env: Callable | None = None

    def environment(self, env) -> "PPOConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int, rollout_fragment_length: int | None = None) -> "PPOConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "PPOConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown training option {k}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "PPO":
        return PPO(self, device=device)


def make_env_creator(env) -> Callable:
    """A callable env as it is; a name through gymnasium, imported here only."""
    if callable(env):
        return env

    def make():
        import gymnasium as gym

        return gym.make(env)

    return make


def _mlp_init(generator: torch.Generator, sizes, device) -> list:
    """Layers of normal * sqrt(2 / fan_in) weights and zero biases, drawn on
    the CPU from ``generator`` and moved to ``device``."""
    params = []
    for m, n in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((m, n), generator=generator) * math.sqrt(2.0 / m)
        params.append({"w": w.to(device), "b": torch.zeros(n, device=device)})
    return params


def _mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """The MLP with tanh hidden activations. Stacked weights ([M, m, n] and
    [M, n], TQC's critics) give [M, B, n] from x [B, m] or [M, B, m]."""
    for i, layer in enumerate(params):
        b = layer["b"]
        x = torch.matmul(x, layer["w"]) + (b[:, None, :] if b.dim() == 2 else b)
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


def _take(values: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """values[i, actions[i]] (take_along_axis on an int64 index)."""
    return values.gather(1, actions[:, None])[:, 0]


class PPOLearner(Learner):
    """The update half (reference: core/learner/learner.py:112, loss + optimizer)."""

    def __init__(self, cfg: PPOConfig, obs_dim: int, num_actions: int, device=None):
        super().__init__(cfg, device)
        self.params = {
            "pi": _mlp_init(self.generator, (obs_dim, *cfg.hidden, num_actions), self.device),
            "vf": _mlp_init(self.generator, (obs_dim, *cfg.hidden, 1), self.device),
        }
        self._reset()

    def _make_optimizer(self) -> optim.Adam:
        return optim.Adam(optim.tree_leaves(self.params), self.cfg.lr)

    def loss(self, params, b: dict):
        cfg = self.cfg
        logp_all = torch.log_softmax(_mlp_apply(params["pi"], b["obs"]), dim=-1)
        logp = _take(logp_all, b["actions"])
        ratio = torch.exp(logp - b["logprobs"])
        clipped = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param)
        adv = b["advantages"]
        pg_loss = -torch.minimum(ratio * adv, clipped * adv).mean()
        values = _mlp_apply(params["vf"], b["obs"])[:, 0]
        vf_loss = ((values - b["returns"]) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(dim=1).mean()
        total = pg_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}


def minibatch_sgd(update_fn, batch: dict, num_epochs: int, minibatch_size: int,
                  rng=None) -> dict:
    """Shared epoch/shuffle/slice loop (PPO, APPO): the reference's, so the
    same ``rng`` draws the same minibatches. Full minibatches only
    (n < minibatch_size falls back to one full batch)."""
    n = len(batch["obs"])
    if n == 0:
        return {}
    rng = rng or np.random.default_rng()
    mb = min(minibatch_size, n)
    idx = np.arange(n)
    metrics: dict = {}
    for _ in range(num_epochs):
        rng.shuffle(idx)
        for lo in range(0, n - mb + 1, mb):
            sel = idx[lo:lo + mb]
            metrics = update_fn({k: v[sel] for k, v in batch.items()})
    return metrics


def gae(cfg, ep: Episode) -> tuple[np.ndarray, np.ndarray]:
    """Generalized advantage estimation over one episode segment (a copy of
    the reference's); cfg needs .gamma/.lambda_."""
    rewards = np.asarray(ep.rewards)
    values = np.asarray(ep.values + [ep.bootstrap_value])
    adv = np.zeros(len(rewards))
    last = 0.0
    for t in reversed(range(len(rewards))):
        nonterminal = 0.0 if ep.dones[t] else 1.0
        delta = rewards[t] + cfg.gamma * values[t + 1] * nonterminal - values[t]
        last = delta + cfg.gamma * cfg.lambda_ * nonterminal * last
        adv[t] = last
    returns = adv + values[:-1]
    return adv, returns


class PPO:
    """The Algorithm (reference: algorithms/algorithm.py train() loop)."""

    def __init__(self, cfg: PPOConfig, device=None):
        self.cfg = cfg
        env_creator = make_env_creator(cfg.env)
        probe = env_creator()
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        if cfg.env_to_module is not None:
            # the policy consumes CONNECTED observations: probe their shape
            # through a throwaway pipeline instance
            sample, _ = probe.reset(seed=0)
            obs_dim = int(np.prod(np.asarray(cfg.env_to_module()(sample)).shape))
        probe.close()
        self.learner = PPOLearner(cfg, obs_dim, num_actions, device=device)
        self.learner_group = None
        if cfg.num_learners > 1:
            from ray_tpu_torch.rllib.learner_group import LearnerGroup

            self.learner_group = LearnerGroup(
                lambda: PPOLearner(cfg, obs_dim, num_actions, device=device),
                num_learners=cfg.num_learners)
        self.runner_group = EnvRunnerGroup(env_creator, actor_critic_policy_fn,
                                           cfg.num_env_runners,
                                           env_to_module=cfg.env_to_module,
                                           module_to_env=cfg.module_to_env)
        self._iteration = 0

    def train(self) -> dict:
        """One iteration: sample -> GAE -> minibatch SGD epochs -> metrics."""
        cfg = self.cfg
        self.runner_group.sync_weights(to_numpy_params(self.learner.params))
        episodes = self.runner_group.sample(cfg.rollout_fragment_length)
        obs, actions, logprobs, advs, rets = [], [], [], [], []
        for ep in episodes:
            a, r = gae(cfg, ep)
            obs.extend(ep.obs)
            actions.extend(ep.actions)
            logprobs.extend(ep.logprobs)
            advs.extend(a)
            rets.extend(r)
        obs = np.asarray(obs, dtype=np.float32)
        actions = np.asarray(actions, dtype=np.int32)
        logprobs = np.asarray(logprobs, dtype=np.float32)
        advs = np.asarray(advs, dtype=np.float32)
        advs = (advs - advs.mean()) / (advs.std() + 1e-8)
        rets = np.asarray(rets, dtype=np.float32)

        n = len(obs)
        update_fn = (self.learner_group.update if self.learner_group is not None
                     else self.learner.update)
        metrics = minibatch_sgd(
            update_fn,
            {"obs": obs, "actions": actions, "logprobs": logprobs,
             "advantages": advs, "returns": rets},
            cfg.num_epochs, cfg.minibatch_size,
        )
        if self.learner_group is not None:
            # runner weight sync reads self.learner.params: adopt the group's
            # (identical-across-replicas) parameters
            self.learner.set_params(self.learner_group.get_params())
        self._iteration += 1
        finished = [ep for ep in episodes if ep.dones and ep.dones[-1]]
        mean_reward = float(np.mean([ep.total_reward() for ep in finished])) if finished else 0.0
        return {
            "training_iteration": self._iteration,
            "episode_reward_mean": mean_reward,
            "episodes_this_iter": len(finished),
            "timesteps_this_iter": n,
            **metrics,
        }

    def stop(self) -> None:
        self.runner_group.stop()
        if self.learner_group is not None:
            self.learner_group.shutdown()
