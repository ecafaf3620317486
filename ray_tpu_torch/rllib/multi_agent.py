"""Multi-agent RL: MultiAgentEnv + per-policy learners over one env fleet (the
port of ray_tpu/rllib/multi_agent.py).

Parity: rllib/env/multi_agent_env.py (the dict-keyed env API with the
"__all__" done convention), multi_agent_env_runner.py:73 (per-agent episode
collection) and the policies/policy_mapping_fn config surface
(algorithm_config.multi_agent()). Each policy gets its own PPOLearner on the
card (``device=None`` is ``cuda:0``); one shared fleet of runner thread
actors collects dict-keyed steps in numpy on the host and routes each
agent's trajectory to its mapped policy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import Episode
from ray_tpu_torch.rllib.np_policy import actor_critic_policy_fn, to_numpy_params
from ray_tpu_torch.rllib.ppo import PPOConfig, PPOLearner, gae, minibatch_sgd


class MultiAgentEnv:
    """Dict-keyed env ABC (reference: env/multi_agent_env.py).

    reset() -> (obs_dict, info_dict)
    step(action_dict) -> (obs, rewards, terminateds, truncateds, infos),
    each keyed by agent id; terminateds/truncateds carry "__all__".
    """

    possible_agents: list = []

    def reset(self, seed=None):
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError

    def close(self):
        pass


class MultiAgentEnvRunner:
    """One actor stepping a MultiAgentEnv; per-agent Episode segmentation
    (reference: multi_agent_env_runner.py:73)."""

    def __init__(self, env_creator: Callable, policy_fn: Callable,
                 policy_mapping: dict, seed: int = 0):
        self.env = env_creator()
        self.policy_fn = policy_fn  # (params, obs, rng) -> (action, logp, value)
        self.policy_mapping = policy_mapping  # agent_id -> policy_id
        self.weights = {}  # policy_id -> params
        self.rng = np.random.default_rng(seed)
        self._obs, _ = self.env.reset(seed=seed)
        # live episodes' reward from PRIOR fragments, per agent (the
        # single-agent runner's _carry_reward, here dict-keyed)
        self._carry: dict = {}

    def set_weights(self, weights: dict) -> None:
        self.weights = weights

    def sample(self, num_steps: int) -> dict:
        """~num_steps env steps; returns {policy_id: [Episode, ...]}."""
        out: dict[str, list[Episode]] = {}
        eps: dict[str, Episode] = {}  # live episode per agent
        steps = 0
        while steps < num_steps:
            actions, logps, values = {}, {}, {}
            for aid, obs in self._obs.items():
                pid = self.policy_mapping[aid]
                a, lp, v = self.policy_fn(
                    self.weights[pid], np.asarray(obs, np.float64), self.rng)
                actions[aid], logps[aid], values[aid] = a, lp, v
            nxt, rews, terms, truncs, _ = self.env.step(actions)
            for aid in actions:
                ep = eps.setdefault(
                    aid, Episode(reward_offset=self._carry.get(aid, 0.0)))
                done = bool(terms.get(aid) or truncs.get(aid)
                            or terms.get("__all__") or truncs.get("__all__"))
                ep.obs.append(np.asarray(self._obs[aid]))
                ep.actions.append(actions[aid])
                ep.rewards.append(float(rews.get(aid, 0.0)))
                ep.logprobs.append(logps[aid])
                ep.values.append(values[aid])
                ep.dones.append(done)
                ep.terminateds.append(bool(terms.get(aid) or terms.get("__all__")))
            steps += 1
            if terms.get("__all__") or truncs.get("__all__"):
                for aid, ep in eps.items():
                    out.setdefault(self.policy_mapping[aid], []).append(ep)
                eps = {}
                self._carry = {}
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        # fragment boundary: bootstrap live episodes with V(current obs) and
        # carry their reward-so-far into the next fragment's Episode
        for aid, ep in eps.items():
            if len(ep):
                pid = self.policy_mapping[aid]
                if aid in self._obs:
                    _, _, ep.bootstrap_value = self.policy_fn(
                        self.weights[pid],
                        np.asarray(self._obs[aid], np.float64), self.rng)
                self._carry[aid] = ep.total_reward()
                out.setdefault(pid, []).append(ep)
        return out

    def ping(self) -> str:
        return "ok"


@dataclasses.dataclass
class MultiAgentPPOConfig(PPOConfig):
    """policies: {policy_id: (obs_dim, num_actions)};
    policy_mapping: {agent_id: policy_id} (the reference's policy_mapping_fn,
    tabulated — mappings here are static per agent id)."""

    policies: dict = dataclasses.field(default_factory=dict)
    policy_mapping: dict = dataclasses.field(default_factory=dict)

    def multi_agent(self, policies: dict, policy_mapping: dict) -> "MultiAgentPPOConfig":
        self.policies = policies
        self.policy_mapping = policy_mapping
        return self

    def build(self, device=None) -> "MultiAgentPPO":
        return MultiAgentPPO(self, device=device)


def policy_batch(cfg, episodes: list) -> dict | None:
    """One policy's PPO batch from its episodes: GAE per episode, advantages
    normalised over the batch (None when no episode has a step)."""
    obs, actions, logprobs, advs, rets = [], [], [], [], []
    for ep in episodes:
        if not len(ep):
            continue
        a, r = gae(cfg, ep)
        obs.extend(ep.obs)
        actions.extend(ep.actions)
        logprobs.extend(ep.logprobs)
        advs.extend(a)
        rets.extend(r)
    if not obs:
        return None
    advs = np.asarray(advs, np.float32)
    advs = (advs - advs.mean()) / (advs.std() + 1e-8)
    return {"obs": np.asarray(obs, np.float32),
            "actions": np.asarray(actions, np.int32),
            "logprobs": np.asarray(logprobs, np.float32),
            "advantages": advs,
            "returns": np.asarray(rets, np.float32)}


class MultiAgentPPO:
    """Independent PPO per policy over a shared multi-agent env fleet."""

    def __init__(self, cfg: MultiAgentPPOConfig, device=None):
        if not cfg.policies or not cfg.policy_mapping:
            raise ValueError("multi_agent(policies=..., policy_mapping=...) required")
        if not callable(cfg.env):
            raise ValueError("MultiAgentPPO needs an env_creator callable")
        self.cfg = cfg
        self.learners = {
            pid: PPOLearner(cfg, obs_dim, num_actions, device=device)
            for pid, (obs_dim, num_actions) in cfg.policies.items()
        }
        runner_cls = ray_tpu_torch.remote(num_cpus=1, max_concurrency=2)(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.remote(cfg.env, actor_critic_policy_fn,
                              cfg.policy_mapping, seed=i)
            for i in range(cfg.num_env_runners)
        ]
        self._iteration = 0
        self._sync()

    def _np_weights(self) -> dict:
        return {pid: to_numpy_params(ln.params)
                for pid, ln in self.learners.items()}

    def _sync(self) -> None:
        w = self._np_weights()
        ray_tpu_torch.get([r.set_weights.remote(w) for r in self.runners], timeout=60)

    def train(self) -> dict:
        cfg = self.cfg
        self._sync()
        per_policy: dict[str, list[Episode]] = {}
        for batch in ray_tpu_torch.get(
            [r.sample.remote(cfg.rollout_fragment_length) for r in self.runners],
            timeout=600,
        ):
            for pid, eps in batch.items():
                per_policy.setdefault(pid, []).extend(eps)
        metrics: dict = {}
        rewards_all = []
        for pid, episodes in per_policy.items():
            batch = policy_batch(cfg, episodes)
            if batch is None:
                continue
            metrics[pid] = minibatch_sgd(self.learners[pid].update, batch,
                                         cfg.num_epochs, cfg.minibatch_size)
            finished = [e for e in episodes if e.dones and e.dones[-1]]
            rewards_all += [e.total_reward() for e in finished]
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_reward_mean": (float(np.mean(rewards_all))
                                    if rewards_all else float("nan")),
            "policies": metrics,
        }

    def stop(self) -> None:
        for r in self.runners:
            ray_tpu_torch.kill(r)
