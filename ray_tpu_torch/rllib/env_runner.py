"""EnvRunners: actor fleet collecting environment rollouts (a copy of
ray_tpu/rllib/env_runner.py over the port's in-process runtime).

Parity: rllib/env/env_runner.py:36 (EnvRunner ABC with FaultAwareApply),
single_agent_env_runner.py:68 (SingleAgentEnvRunner) and env_runner_group.py:70
(EnvRunnerGroup). Runners hold envs + a policy snapshot and return batched
trajectories; the group fans sampling out over thread actors
(``ray_tpu_torch.remote``) and syncs weights. Policies run in numpy on the
host, so the same seed, params and env give the reference runner's episodes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

import ray_tpu_torch


@dataclass
class Episode:
    obs: list = field(default_factory=list)
    actions: list = field(default_factory=list)
    rewards: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)
    values: list = field(default_factory=list)
    dones: list = field(default_factory=list)
    # terminated only (no time-limit truncation): off-policy targets bootstrap
    # through truncation but not termination (rllib's terminated/truncated split)
    terminateds: list = field(default_factory=list)
    # value of the next obs when a rollout fragment cuts a live episode
    # (reference: rllib bootstraps fragment boundaries with vf(last_obs))
    bootstrap_value: float = 0.0
    # the env's final observation at episode end (gymnasium returns it from
    # the terminal step); off-policy targets bootstrap from it on truncation
    final_obs: object = None
    # reward accumulated by this episode in PREVIOUS fragments (an episode can
    # span rollout fragments; metrics must report the whole episode)
    reward_offset: float = 0.0

    def total_reward(self) -> float:
        return float(sum(self.rewards)) + self.reward_offset

    def __len__(self):
        return len(self.actions)


class SingleAgentEnvRunner:
    """One actor running one env with the current policy."""

    def __init__(self, env_creator: Callable, policy_fn: Callable, seed: int = 0,
                 env_to_module: Callable | None = None,
                 module_to_env: Callable | None = None):
        self.env = env_creator()
        self.policy_fn = policy_fn  # (params, obs, rng) -> (action, logprob, value)
        self.params = None
        self.rng = np.random.default_rng(seed)
        # connector pipelines are factories so each runner actor owns its
        # stateful instances (frame stacks, running stats)
        self._env_to_module = env_to_module() if env_to_module else None
        self._module_to_env = module_to_env() if module_to_env else None
        raw, _ = self.env.reset(seed=seed)
        self._obs = self._process_obs(raw)
        self._carry_reward = 0.0  # live episode's reward from prior fragments

    def _process_obs(self, raw):
        return self._env_to_module(raw) if self._env_to_module else raw

    def set_weights(self, params) -> None:
        self.params = params

    def sample(self, num_steps: int) -> list[Episode]:
        """Collect num_steps of experience, episode-segmented."""
        episodes: list[Episode] = []
        ep = Episode(reward_offset=self._carry_reward)
        steps = 0
        while steps < num_steps:
            action, logprob, value = self.policy_fn(self.params, np.asarray(self._obs), self.rng)
            env_action = (self._module_to_env(action) if self._module_to_env
                          else action)
            nxt, reward, terminated, truncated, _ = self.env.step(env_action)
            done = bool(terminated or truncated)
            ep.obs.append(np.asarray(self._obs))
            ep.actions.append(action)  # module-space: what the learner trains on
            ep.rewards.append(float(reward))
            ep.logprobs.append(float(logprob))
            ep.values.append(float(value))
            ep.dones.append(done)
            ep.terminateds.append(bool(terminated))
            steps += 1
            if done:
                ep.final_obs = np.asarray(self._process_obs(nxt))
                if self._env_to_module is not None:
                    self._env_to_module.reset()  # drop per-episode state
                raw, _ = self.env.reset()
                self._obs = self._process_obs(raw)
                self._carry_reward = 0.0
                episodes.append(ep)
                ep = Episode()
            else:
                self._obs = self._process_obs(nxt)
        if len(ep):
            # live episode cut by the fragment boundary: bootstrap with V(next obs)
            _, _, ep.bootstrap_value = self.policy_fn(self.params, np.asarray(self._obs), self.rng)
            self._carry_reward = ep.total_reward()
            episodes.append(ep)
        return episodes

    def ping(self) -> str:
        return "ok"


class EnvRunnerGroup:
    """Fan-out sampling over runner thread actors (reference:
    env_runner_group.py:70); ``stop()`` kills them."""

    def __init__(self, env_creator: Callable, policy_fn: Callable, num_runners: int = 2,
                 env_to_module: Callable | None = None,
                 module_to_env: Callable | None = None):
        runner_cls = ray_tpu_torch.remote(num_cpus=1, max_concurrency=2)(SingleAgentEnvRunner)
        self.runners = [
            runner_cls.remote(env_creator, policy_fn, seed=i,
                              env_to_module=env_to_module,
                              module_to_env=module_to_env)
            for i in range(num_runners)
        ]

    def sync_weights(self, params) -> None:
        ray_tpu_torch.get([r.set_weights.remote(params) for r in self.runners], timeout=60)

    def sample(self, steps_per_runner: int) -> list[Episode]:
        batches = ray_tpu_torch.get([r.sample.remote(steps_per_runner) for r in self.runners],
                                    timeout=600)
        return [ep for b in batches for ep in b]

    def stop(self) -> None:
        for r in self.runners:
            ray_tpu_torch.kill(r)
