"""Offline RL in PyTorch: train from recorded experience, no environment
interaction (the port of ray_tpu/rllib/offline.py).

Parity: rllib/offline/ + the offline algorithm family: BC
(algorithms/bc/), MARWIL (algorithms/marwil/) and CQL (algorithms/cql/,
discrete variant). Datasets are JSONL transition rows or numpy dicts. Each
algorithm is a learner (``learner.Learner``): its parameters and Adam state
live on the card (``device=None`` is ``cuda:0``; pass ``device="cpu"`` for
the CPU), the minibatches are drawn on the host by
``np.random.default_rng(cfg.seed)`` as the reference draws them, and the
greedy policy runs in numpy on the host (``np_policy.np_mlp``).

Row schema: {"obs": [...], "action": int, "reward": float,
"next_obs": [...], "done": 0/1}.

Differences from the reference: a JSONL path is read here with ``json``,
line by line (the reference reads it through ``ray_tpu.data``, which the
port does not have yet, so a Dataset source waits for ROADMAP queue 1 item
8; any object with ``take_all()`` or any iterable of rows is taken); the
initial weights come from a seeded ``torch.Generator``, and ``from_jax``
takes a JAX algorithm's parameters.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.np_policy import np_mlp, to_numpy_params
from ray_tpu_torch.rllib.ppo import _mlp_apply, _mlp_init, _take


# ------------------------------------------------------------------ data
def write_offline_json(transitions: dict, path: str) -> int:
    """Write a transition batch (numpy dict) as JSONL rows; returns row count."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(transitions["obs"])
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "obs": np.asarray(transitions["obs"][i]).tolist(),
                # continuous actions keep their floats (the loader's
                # action_dtype follows the data)
                "action": np.asarray(transitions["actions"][i]).tolist(),
                "reward": float(transitions["rewards"][i]),
                "next_obs": np.asarray(transitions["next_obs"][i]).tolist(),
                "done": float(transitions["dones"][i]),
            }) + "\n")
    return n


def load_offline_data(source: Any, action_dtype=None) -> dict:
    """Normalize an offline source into a numpy transition dict.

    Accepts a numpy dict, a JSONL path (read here with ``json``), an object
    with ``take_all()`` returning rows, or any iterable of rows. A
    ``ray_tpu.data`` Dataset is such an object in the reference; the port
    has no data package yet (ROADMAP queue 1 item 8). ``action_dtype``
    defaults to the data's own type, so continuous actions do not truncate;
    the discrete algorithms pass ``np.int64``."""
    if isinstance(source, dict):
        return source
    if isinstance(source, str):
        with open(source) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    else:
        rows = source.take_all() if hasattr(source, "take_all") else list(source)
    return {
        "obs": np.asarray([r["obs"] for r in rows], np.float32),
        "actions": np.asarray([r["action"] for r in rows], action_dtype),
        "rewards": np.asarray([r["reward"] for r in rows], np.float32),
        "next_obs": np.asarray([r["next_obs"] for r in rows], np.float32),
        "dones": np.asarray([r["done"] for r in rows], np.float32),
    }


# ------------------------------------------------------------------ configs
@dataclasses.dataclass
class OfflineConfig:
    dataset: Any = None  # numpy dict | JSONL path | rows
    lr: float = 1e-3
    train_batch_size: int = 256
    hidden: tuple = (64, 64)
    seed: int = 0
    gamma: float = 0.99

    def offline_data(self, dataset) -> "OfflineConfig":
        self.dataset = dataset
        return self

    def training(self, **kw) -> "OfflineConfig":
        fields = {f.name for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if k not in fields:
                raise ValueError(f"Unknown training option {k}")
            setattr(self, k, v)
        return self


@dataclasses.dataclass
class BCConfig(OfflineConfig):
    def build(self, device=None) -> "BC":
        return BC(self, device=device)


@dataclasses.dataclass
class MARWILConfig(OfflineConfig):
    beta: float = 1.0       # 0 = plain BC; >0 advantage-weights the cloning
    vf_coeff: float = 1.0

    def build(self, device=None) -> "MARWIL":
        return MARWIL(self, device=device)


@dataclasses.dataclass
class CQLConfig(OfflineConfig):
    alpha_cql: float = 1.0  # conservative penalty weight
    target_update_freq: int = 100

    def build(self, device=None) -> "CQL":
        return CQL(self, device=device)


class _OfflineAlgorithm(Learner):
    """Shared train() loop: minibatch updates over the fixed dataset."""

    def __init__(self, cfg: OfflineConfig, device=None):
        super().__init__(cfg, device)
        self.data = load_offline_data(cfg.dataset, action_dtype=np.int64)
        if not len(self.data["obs"]):
            raise ValueError("offline dataset is empty")
        self.obs_dim = int(self.data["obs"].shape[-1])
        self.num_actions = int(self.data["actions"].max()) + 1
        self._rng = np.random.default_rng(cfg.seed)
        self.updates_total = 0
        self._policy_np_cache = None
        self.params = self._build()
        self._reset()

    def _make_optimizer(self) -> optim.Adam:
        return optim.Adam(optim.tree_leaves(self.params), self.cfg.lr)

    def from_jax(self, params_np) -> "_OfflineAlgorithm":
        self._policy_np_cache = None
        return super().from_jax(params_np)

    def train(self, num_updates: int = 50) -> dict:
        n = len(self.data["obs"])
        bs = min(self.cfg.train_batch_size, n)
        metrics = {}
        for _ in range(num_updates):
            idx = self._rng.integers(0, n, bs)
            metrics = self._update({k: v[idx] for k, v in self.data.items()})
            self.updates_total += 1
        self._policy_np_cache = None  # params changed
        return {"updates_total": self.updates_total, **metrics}

    def _update(self, batch: dict) -> dict:
        """One Adam update on ``batch``; its metrics as floats."""
        return self.update(batch)

    def compute_single_action(self, obs) -> int:
        if self._policy_np_cache is None:
            # card -> host once per train() round, not per step
            self._policy_np_cache = to_numpy_params(self._policy_params())
        return int(np.argmax(np_mlp(self._policy_np_cache,
                                    np.asarray(obs, np.float64)[None])[0]))

    def evaluate(self, env_creator, episodes: int = 2, max_steps: int = 500) -> float:
        """Mean episode reward of the greedy learned policy."""
        totals = []
        for ep in range(episodes):
            env = env_creator()
            obs, _ = env.reset(seed=self.cfg.seed + ep)
            total = 0.0
            for _ in range(max_steps):
                obs, r, term, trunc, _ = env.step(self.compute_single_action(obs))
                total += float(r)
                if term or trunc:
                    break
            env.close()
            totals.append(total)
        return float(np.mean(totals))


class BC(_OfflineAlgorithm):
    """Behavior cloning: NLL of the logged actions (algorithms/bc/)."""

    total_key = "bc_loss"

    def _build(self) -> list:
        return _mlp_init(self.generator, (self.obs_dim, *self.cfg.hidden, self.num_actions),
                         self.device)

    def _policy_params(self):
        return self.params

    def loss(self, params, b: dict):
        logp = torch.log_softmax(_mlp_apply(params, b["obs"]), dim=-1)
        return -_take(logp, b["actions"]).mean(), {}


class MARWIL(_OfflineAlgorithm):
    """Monotonic advantage re-weighted imitation learning (algorithms/marwil/):
    clone the data policy with per-sample weights exp(beta * advantage),
    where the advantage baseline V is regressed on one-step returns."""

    def _build(self) -> dict:
        cfg = self.cfg
        return {"pi": _mlp_init(self.generator, (self.obs_dim, *cfg.hidden, self.num_actions),
                                self.device),
                "vf": _mlp_init(self.generator, (self.obs_dim, *cfg.hidden, 1), self.device)}

    def _policy_params(self):
        return self.params["pi"]

    def loss(self, params, b: dict):
        cfg = self.cfg
        v = _mlp_apply(params["vf"], b["obs"])[:, 0]
        v_next = _mlp_apply(params["vf"], b["next_obs"])[:, 0].detach()
        target = b["rewards"] + cfg.gamma * (1.0 - b["dones"]) * v_next
        vf_loss = ((v - target) ** 2).mean()
        adv = (target - v).detach()
        adv = adv / (adv.abs().mean() + 1e-8)  # scale-free exponent
        w = torch.exp(torch.clamp(cfg.beta * adv, -5.0, 5.0))
        logp = torch.log_softmax(_mlp_apply(params["pi"], b["obs"]), dim=-1)
        pi_loss = (w * -_take(logp, b["actions"])).mean()
        return pi_loss + cfg.vf_coeff * vf_loss, {"pi_loss": pi_loss, "vf_loss": vf_loss}


class CQL(_OfflineAlgorithm):
    """Conservative Q-learning, discrete (algorithms/cql/): double-Q TD loss
    plus the conservative gap logsumexp(Q) - Q(a_data), which pushes down
    Q-values of actions the dataset never took. The target network is
    copied from the online one after every ``target_update_freq``-th
    update of ``train``."""

    def _build(self) -> list:
        return _mlp_init(self.generator, (self.obs_dim, *self.cfg.hidden, self.num_actions),
                         self.device)

    def _policy_params(self):
        return self.params

    def _init_targets(self) -> None:
        self.target_params = optim.tree_map(torch.clone, self.params)

    def _sync_targets(self) -> None:
        if (self.updates_total + 1) % self.cfg.target_update_freq == 0:
            self._init_targets()

    def from_jax(self, params_np, target_np=None) -> "CQL":
        """The JAX algorithm's parameters and, when given, its target
        network (else a copy of the parameters, as after its init)."""
        super().from_jax(params_np)
        if target_np is not None:
            self.target_params = self._on_device(target_np)
        return self

    def loss(self, params, b: dict):
        cfg = self.cfg
        q = _mlp_apply(params, b["obs"])
        q_a = _take(q, b["actions"])
        # double-Q target: online argmax, target net evaluation
        next_a = torch.argmax(_mlp_apply(params, b["next_obs"]), dim=1)
        next_q = _take(_mlp_apply(self.target_params, b["next_obs"]), next_a)
        target = b["rewards"] + cfg.gamma * (1.0 - b["dones"]) * next_q.detach()
        td_loss = ((q_a - target) ** 2).mean()
        cql_gap = (torch.logsumexp(q, dim=1) - q_a).mean()
        return td_loss + cfg.alpha_cql * cql_gap, {"td_loss": td_loss, "cql_gap": cql_gap}
