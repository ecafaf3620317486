"""Continuous-action SAC in PyTorch: tanh-squashed Gaussian policy, twin Q,
learned alpha (the port of ray_tpu/rllib/sac_continuous.py).

Parity: rllib/algorithms/sac/ in its original continuous-control form
(Haarnoja 2018); the discrete variant lives in sac.py. One update covers
both critics, the reparameterised actor and the temperature on the
learner's device. Actions map env-range <-> [-1, 1] at the algorithm
boundary, so the learner is scale-free.

The update's two standard normals (for the next action and for the
actor's action, [B, A] each) are drawn from the learner's CPU
``torch.Generator`` and enter the loss as the batch entries ``eps_next``
and ``eps_pi``, where the reference draws them from a ``jax.random`` key
split inside its jitted update; a batch that brings its own entries (a
test feeding the normals JAX drew) is used as it is. The runners sample
the policy in numpy on the host, and ``gymnasium`` is imported only to
make a named env.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib.connectors import UnsquashActions, pipeline
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.np_policy import np_mlp, to_numpy_params
from ray_tpu_torch.rllib.off_policy import (off_policy_train_iteration,
                                            probe_env_spaces_continuous)
from ray_tpu_torch.rllib.ppo import _mlp_apply, _mlp_init, make_env_creator
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sac import SoftTargetLearner

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


@dataclasses.dataclass
class ContinuousSACConfig:
    env: str | Callable = "Pendulum-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 200
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    target_entropy: Optional[float] = None  # None => -act_dim (SAC default)
    buffer_capacity: int = 100_000
    learning_starts: int = 1000
    train_batch_size: int = 256
    updates_per_iter: int = 64
    hidden: tuple = (64, 64)
    seed: int = 0

    def environment(self, env) -> "ContinuousSACConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: int | None = None) -> "ContinuousSACConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "ContinuousSACConfig":
        fields = {f.name for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if k not in fields:
                raise ValueError(f"Unknown training option {k}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "ContinuousSAC":
        return ContinuousSAC(self, device=device)


def _squashed_gaussian(pi_out: torch.Tensor, eps: torch.Tensor):
    """tanh(mu + std*eps) with its log-prob (change-of-variables corrected)."""
    mu, log_std = torch.chunk(pi_out, 2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    raw = mu + std * eps
    act = torch.tanh(raw)
    # N(mu, std) log-density at raw, minus the tanh Jacobian term
    logp = (-0.5 * ((raw - mu) / std) ** 2 - log_std
            - 0.5 * math.log(2.0 * math.pi)).sum(-1)
    logp = logp - (2.0 * (math.log(2.0) - raw - F.softplus(-2.0 * raw))).sum(-1)
    return act, logp


class ContinuousSACLearner(SoftTargetLearner):
    """Twin Q(s,a) critics + reparameterised actor + temperature."""

    int_keys = ()

    def __init__(self, cfg: ContinuousSACConfig, obs_dim: int, act_dim: int, device=None):
        super().__init__(cfg, device)
        self.params = {
            "pi": _mlp_init(self.generator, (obs_dim, *cfg.hidden, 2 * act_dim), self.device),
            "q1": _mlp_init(self.generator, (obs_dim + act_dim, *cfg.hidden, 1), self.device),
            "q2": _mlp_init(self.generator, (obs_dim + act_dim, *cfg.hidden, 1), self.device),
            "log_alpha": torch.zeros((), device=self.device),
        }
        self.target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                               else -float(act_dim))
        self._reset()

    def _noise(self, b: dict) -> dict:
        """The update's two [B, A] normals, unless the batch brings them."""
        shape = tuple(b["actions"].shape)
        for key in ("eps_next", "eps_pi"):
            if key not in b:
                b[key] = torch.randn(shape, generator=self.generator).to(self.device)
        return b

    @staticmethod
    def _q(q, obs, act) -> torch.Tensor:
        return _mlp_apply(q, torch.cat([obs, act], dim=-1))[:, 0]

    def loss(self, params, b: dict):
        cfg, target, q = self.cfg, self.target, self._q
        obs, next_obs = b["obs"], b["next_obs"]
        alpha = torch.exp(params["log_alpha"])
        # --- critic target: soft Bellman backup through the next action ---
        next_a, next_logp = _squashed_gaussian(_mlp_apply(params["pi"], next_obs),
                                               b["eps_next"])
        tq = torch.minimum(q(target["q1"], next_obs, next_a), q(target["q2"], next_obs, next_a))
        target_q = (b["rewards"] + cfg.gamma * (1.0 - b["dones"])
                    * (tq - alpha.detach() * next_logp)).detach()
        q1 = q(params["q1"], obs, b["actions"])
        q2 = q(params["q2"], obs, b["actions"])
        critic_loss = ((q1 - target_q) ** 2).mean() + ((q2 - target_q) ** 2).mean()
        # --- actor: reparameterised sample through min-Q ---
        a_pi, logp_pi = _squashed_gaussian(_mlp_apply(params["pi"], obs), b["eps_pi"])
        # gradient flows through the ACTION (reparameterisation) but must not
        # reach critic weights, else the actor term inflates Q
        q1_frozen = [{k: v.detach() for k, v in layer.items()} for layer in params["q1"]]
        q2_frozen = [{k: v.detach() for k, v in layer.items()} for layer in params["q2"]]
        q_min = torch.minimum(q(q1_frozen, obs, a_pi), q(q2_frozen, obs, a_pi))
        actor_loss = (alpha.detach() * logp_pi - q_min).mean()
        # --- temperature ---
        alpha_loss = (-params["log_alpha"] * (logp_pi + self.target_entropy).detach()).mean()
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha": alpha, "entropy": -logp_pi.mean()}


class ContinuousSAC:
    """The Algorithm (reference: algorithms/algorithm.py train() loop)."""

    action_dtype = np.float32  # consulted by off_policy_train_iteration
    learner_cls: "type | None" = None  # TQC swaps in its quantile learner

    def __init__(self, cfg: ContinuousSACConfig, device=None):
        self.cfg = cfg
        env_creator = make_env_creator(cfg.env)
        obs_dim, act_dim, low, high = probe_env_spaces_continuous(env_creator)
        learner_cls = type(self).learner_cls or ContinuousSACLearner
        self.learner = learner_cls(cfg, obs_dim, act_dim, device=device)
        self.env_steps_total = 0

        def policy_fn(params, obs, rng):
            # module-space action in [-1,1]; the UnsquashActions connector maps
            # to the env's Box range at the runner boundary, so episodes (and
            # the replay buffer) hold module-space actions
            out = np_mlp(params["pi"], np.asarray(obs, np.float32)[None])[0]
            mu, log_std = out[:act_dim], out[act_dim:]
            std = np.exp(np.clip(log_std, LOG_STD_MIN, LOG_STD_MAX))
            a = np.tanh(mu + std * rng.standard_normal(act_dim))
            return a.astype(np.float32), 0.0, 0.0

        self.runners = EnvRunnerGroup(
            env_creator, policy_fn, num_runners=cfg.num_env_runners,
            module_to_env=pipeline(lambda: UnsquashActions(low, high)),
        )
        self.runners.sync_weights(to_numpy_params(self.learner.params))
        buffer_actor = ray_tpu_torch.remote(num_cpus=0)(ReplayBuffer)
        self.buffer = buffer_actor.remote(cfg.buffer_capacity, cfg.seed)

    def train(self) -> dict:
        return off_policy_train_iteration(self)

    def stop(self) -> None:
        self.runners.stop()
        ray_tpu_torch.kill(self.buffer)
