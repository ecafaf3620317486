"""Discrete SAC in PyTorch: twin Q critics, entropy-temperature auto-tuning
(the port of ray_tpu/rllib/sac.py).

Parity: rllib/algorithms/sac/ (SAC with twin Q networks, soft targets, and
learned alpha) in its discrete-action form (Christodoulou 2019). One update
covers actor, both critics and the temperature on the learner's device:
one global-norm clip (5.0), then Adam with the actor's, the critics' and
alpha's learning rates; Polyak targets after every step. The runners sample
the policy in numpy on the host (the reference jits its forward), and
``gymnasium`` is imported only to make a named env.
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

# per-component learning rates (reference: SAC's separate actor/critic/alpha
# optimizers), as optax.multi_transform labels of the top-level keys
SAC_LABELS = {"pi": "actor", "q1": "critic", "q2": "critic", "log_alpha": "alpha"}


@dataclasses.dataclass
class SACConfig:
    """Reference: SACConfig surface (fluent API below)."""

    env: str | Callable = "CartPole-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 256
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.01  # soft target update rate
    target_entropy_scale: float = 0.7  # of max entropy log(|A|)
    buffer_capacity: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 128
    updates_per_iter: int = 64
    hidden: tuple = (64, 64)
    seed: int = 0

    def environment(self, env) -> "SACConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int,
                    rollout_fragment_length: int | None = None) -> "SACConfig":
        self.num_env_runners = num_env_runners
        if rollout_fragment_length:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "SACConfig":
        fields = {f.name for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if k not in fields:
                raise ValueError(f"Unknown training option {k}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "SAC":
        return SAC(self, device=device)


class SoftTargetLearner(Learner):
    """What the SACs and TQC share: clip 5.0, then Adam per labelled group
    (``labels``), and Polyak targets of the critics (``target_keys``)."""

    max_norm = 5.0
    labels = SAC_LABELS
    target_keys = ("q1", "q2")

    def _make_optimizer(self) -> optim.Adam:
        cfg = self.cfg
        lrs = {"actor": cfg.actor_lr, "critic": cfg.critic_lr, "alpha": cfg.alpha_lr}
        return optim.Adam(optim.tree_leaves(self.params),
                          optim.multi_transform(self.params, lrs, self.labels),
                          max_norm=self.max_norm)

    def _init_targets(self) -> None:
        self.target = {k: optim.tree_map(torch.clone, self.params[k]) for k in self.target_keys}

    def _sync_targets(self) -> None:
        """target = (1 - tau) target + tau online, leaf by leaf."""
        tau = self.cfg.tau
        targets = optim.tree_leaves(self.target)
        online = optim.tree_leaves({k: self.params[k] for k in self.target_keys})
        fresh = torch._foreach_add(torch._foreach_mul(targets, 1 - tau),
                                   torch._foreach_mul(online, tau))
        self.target = optim.tree_unflatten(self.target, fresh)


class SACLearner(SoftTargetLearner):
    """Actor + twin critics + temperature in one update."""

    def __init__(self, cfg: SACConfig, obs_dim: int, num_actions: int, device=None):
        super().__init__(cfg, device)
        sizes = (obs_dim, *cfg.hidden, num_actions)
        self.params = {
            "pi": _mlp_init(self.generator, sizes, self.device),
            "q1": _mlp_init(self.generator, sizes, self.device),
            "q2": _mlp_init(self.generator, sizes, self.device),
            "log_alpha": torch.zeros((), device=self.device),
        }
        self.target_entropy = cfg.target_entropy_scale * float(np.log(num_actions))
        self._reset()

    def loss(self, params, b: dict):
        cfg, target = self.cfg, self.target
        alpha = torch.exp(params["log_alpha"])
        # --- critic targets (soft state value of next state) ---
        next_logp = torch.log_softmax(_mlp_apply(params["pi"], b["next_obs"]), dim=-1)
        next_p = torch.exp(next_logp)
        tq = torch.minimum(_mlp_apply(target["q1"], b["next_obs"]),
                           _mlp_apply(target["q2"], b["next_obs"]))
        next_v = (next_p * (tq - alpha.detach() * next_logp)).sum(-1)
        target_q = (b["rewards"] + cfg.gamma * (1.0 - b["dones"]) * next_v).detach()
        q1 = _take(_mlp_apply(params["q1"], b["obs"]), b["actions"])
        q2 = _take(_mlp_apply(params["q2"], b["obs"]), b["actions"])
        critic_loss = ((q1 - target_q) ** 2).mean() + ((q2 - target_q) ** 2).mean()
        # --- actor: minimize E[alpha*logp - Q] over the action distribution ---
        logp = torch.log_softmax(_mlp_apply(params["pi"], b["obs"]), dim=-1)
        p = torch.exp(logp)
        q_min = torch.minimum(_mlp_apply(params["q1"], b["obs"]),
                              _mlp_apply(params["q2"], b["obs"])).detach()
        actor_loss = (p * (alpha.detach() * logp - q_min)).sum(-1).mean()
        # --- temperature: match target entropy ---
        entropy = -(p * logp).sum(-1)
        alpha_loss = (params["log_alpha"] * (entropy - self.target_entropy).detach()).mean()
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha": alpha, "entropy": entropy.mean()}


class SAC:
    """The Algorithm (reference: algorithms/algorithm.py train() loop)."""

    def __init__(self, cfg: SACConfig, device=None):
        self.cfg = cfg
        env_creator = make_env_creator(cfg.env)
        obs_dim, num_actions = probe_env_spaces(env_creator)
        self.learner = SACLearner(cfg, obs_dim, num_actions, device=device)
        self.env_steps_total = 0

        def policy_fn(params, obs, rng):
            # the stochastic policy IS the exploration (no epsilon schedule)
            logits = np_mlp(params["pi"], np.asarray(obs, np.float32)[None])[0]
            z = (logits - logits.max()).astype(np.float64)
            p = np.exp(z)
            p /= p.sum()  # float64: rng.choice validates the sum at ~1e-8
            action = int(rng.choice(len(p), p=p))
            return action, float(np.log(p[action] + 1e-9)), 0.0

        self.runners = EnvRunnerGroup(env_creator, policy_fn,
                                      num_runners=cfg.num_env_runners)
        self.runners.sync_weights(to_numpy_params(self.learner.params))
        buffer_actor = ray_tpu_torch.remote(num_cpus=0)(ReplayBuffer)
        self.buffer = buffer_actor.remote(cfg.buffer_capacity, cfg.seed)

    def train(self) -> dict:
        return off_policy_train_iteration(self)

    def stop(self) -> None:
        self.runners.stop()
        ray_tpu_torch.kill(self.buffer)
