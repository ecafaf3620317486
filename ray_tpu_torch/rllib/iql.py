"""IQL: Implicit Q-Learning (Kostrikov et al. 2021), offline continuous RL in
PyTorch (the port of ray_tpu/rllib/iql.py).

Parity: the rllib offline family's continuous-control member. The
in-sample trick: never evaluate Q on out-of-dataset actions:

- V(s) chases the EXPECTILE of the target Q(s, a_data): L2^tau penalizes
  under-estimation asymmetrically, so V approaches max_a Q within the
  dataset's support;
- Q(s, a) regresses to r + gamma * V(s') (no next-action sampling);
- the policy is extracted by advantage-weighted regression:
  max E[exp(beta * (Q - V)) * log pi(a_data | s)].

One update covers V, both Qs and the actor on the learner's device (the
card unless ``device="cpu"``), then moves the target Qs a Polyak step
toward the online ones. Minibatches are drawn on the host by
``np.random.default_rng(cfg.seed)`` as the reference draws them, and the
deterministic mean action is computed in numpy on the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.np_policy import np_mlp, to_numpy_params
from ray_tpu_torch.rllib.offline import OfflineConfig, load_offline_data
from ray_tpu_torch.rllib.ppo import _mlp_apply, _mlp_init
from ray_tpu_torch.rllib.sac_continuous import LOG_STD_MAX, LOG_STD_MIN


@dataclasses.dataclass
class IQLConfig(OfflineConfig):
    """Shares the offline family's dataset/lr/train_batch_size/gamma fields
    and its fields-validated training() method."""

    hidden: tuple = (256, 256)
    lr: float = 3e-4
    expectile: float = 0.7    # tau: 0.5 is SARSA, ->1 approaches max_a Q
    beta: float = 3.0         # AWR inverse temperature
    adv_clip: float = 100.0   # exp-weight cap (the paper's stabilizer)
    polyak: float = 0.005     # target-Q rate

    def build(self, device=None) -> "IQL":
        return IQL(self, device=device)


class IQL(Learner):
    int_keys = ()

    def __init__(self, cfg: IQLConfig, device=None):
        super().__init__(cfg, device)
        data = load_offline_data(cfg.dataset)
        self._data = {k: np.asarray(v, np.float32) for k, v in data.items()}
        obs_dim = self._data["obs"].shape[1]
        self._acts = self._data["actions"].astype(np.float32)
        if self._acts.ndim == 1:
            self._acts = self._acts[:, None]
        self._act_dim = act_dim = self._acts.shape[1]
        self._n = len(self._data["obs"])
        g, dev = self.generator, self.device
        self.params = {
            "pi": _mlp_init(g, (obs_dim, *cfg.hidden, 2 * act_dim), dev),
            "q1": _mlp_init(g, (obs_dim + act_dim, *cfg.hidden, 1), dev),
            "q2": _mlp_init(g, (obs_dim + act_dim, *cfg.hidden, 1), dev),
            "v": _mlp_init(g, (obs_dim, *cfg.hidden, 1), dev),
        }
        self._rng = np.random.default_rng(cfg.seed)
        self._reset()

    def _make_optimizer(self) -> optim.Adam:
        return optim.Adam(optim.tree_leaves(self.params), self.cfg.lr)

    def _init_targets(self) -> None:
        self.target = {k: optim.tree_map(torch.clone, self.params[k]) for k in ("q1", "q2")}

    def _sync_targets(self) -> None:
        rate = self.cfg.polyak
        for k in ("q1", "q2"):
            self.target[k] = optim.tree_map(lambda t, o: (1 - rate) * t + rate * o,
                                            self.target[k], self.params[k])

    def from_jax(self, params_np, target_np=None) -> "IQL":
        """The JAX algorithm's parameters and, when given, its target Qs
        (else copies of the online Qs, as after its init)."""
        super().from_jax(params_np)
        if target_np is not None:
            self.target = self._on_device(target_np)
        return self

    @staticmethod
    def _q(q, obs, act) -> torch.Tensor:
        return _mlp_apply(q, torch.cat([obs, act], dim=-1))[:, 0]

    def loss(self, params, b: dict):
        cfg, q = self.cfg, self._q
        obs, actions = b["obs"], b["actions"]
        # --- V: expectile regression toward the in-sample target Q ---
        tq = torch.minimum(q(self.target["q1"], obs, actions),
                           q(self.target["q2"], obs, actions)).detach()
        v = _mlp_apply(params["v"], obs)[:, 0]
        u = tq - v
        w_exp = torch.abs(cfg.expectile - (u < 0.0).float())
        v_loss = (w_exp * u ** 2).mean()
        # --- Q: one-step backup through V(s'), never through a policy ---
        next_v = _mlp_apply(params["v"], b["next_obs"])[:, 0]
        y = (b["rewards"] + cfg.gamma * (1.0 - b["dones"]) * next_v).detach()
        q_loss = (((q(params["q1"], obs, actions) - y) ** 2)
                  + ((q(params["q2"], obs, actions) - y) ** 2)).mean()
        # --- actor: advantage-weighted regression on the dataset's actions ---
        adv = tq - v.detach()
        w = torch.clamp(torch.exp(cfg.beta * adv), max=cfg.adv_clip)
        mu, log_std = torch.split(_mlp_apply(params["pi"], obs), actions.shape[1], dim=1)
        log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
        logp = (-0.5 * ((actions - mu) / torch.exp(log_std)) ** 2
                - log_std - 0.5 * math.log(2 * math.pi)).sum(dim=1)
        actor_loss = -(w * logp).mean()
        return v_loss + q_loss + actor_loss, {"v_loss": v_loss, "q_loss": q_loss,
                                              "actor_loss": actor_loss,
                                              "adv_mean": adv.mean()}

    def _batch(self, idx) -> dict:
        return {"obs": self._data["obs"][idx], "actions": self._acts[idx],
                "rewards": self._data["rewards"][idx], "next_obs": self._data["next_obs"][idx],
                "dones": self._data["dones"][idx]}

    def train(self, num_updates: int = 100) -> dict:
        metrics = {}
        for _ in range(num_updates):
            idx = self._rng.integers(0, self._n, self.cfg.train_batch_size)
            metrics = self.update(self._batch(idx))
        return metrics

    def compute_single_action(self, obs) -> np.ndarray:
        """The policy's mean action (deterministic)."""
        out = np_mlp(to_numpy_params(self.params["pi"]), np.asarray(obs, np.float32)[None])[0]
        return out[: self._act_dim]
