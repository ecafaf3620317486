"""Shared off-policy machinery: replay-driven train iteration (the port of
ray_tpu/rllib/off_policy.py).

Used by DQN and the SACs (reference: the replay/update loop both inherit
from the off-policy Algorithm base in rllib/algorithms/). The replay buffer
runs as a thread actor of the port's runtime; the runners get the learner's
weights as host numpy."""

from __future__ import annotations

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.np_policy import to_numpy_params


def _episodes_to_transitions(episodes, action_dtype=np.int64) -> dict:
    """SARS'd tuples from episode fragments. The last step of a fragment cut
    mid-episode has no next_obs recorded: it is dropped (negligible at
    fragment lengths >> 1)."""
    obs, actions, rewards, next_obs, dones = [], [], [], [], []
    for ep in episodes:
        n = len(ep)
        terms = ep.terminateds or ep.dones
        for i in range(n):
            if ep.dones[i]:
                # terminated: masked out of the target; truncated: bootstrap
                # from the env's true final observation
                nxt = ep.final_obs if ep.final_obs is not None else ep.obs[i]
            elif i + 1 < n:
                nxt = ep.obs[i + 1]
            else:
                continue  # fragment-cut live step: next obs unknown
            obs.append(ep.obs[i])
            actions.append(ep.actions[i])
            rewards.append(ep.rewards[i])
            next_obs.append(nxt)
            # Q-targets bootstrap through time-limit TRUNCATION (next state
            # exists, the env just stopped watching) but not TERMINATION:
            # rllib's terminated/truncated distinction.
            dones.append(float(terms[i]))
    if not obs:
        return {"obs": np.zeros((0,)), "actions": np.zeros((0,), action_dtype),
                "rewards": np.zeros((0,)), "next_obs": np.zeros((0,)),
                "dones": np.zeros((0,))}
    return {
        "obs": np.asarray(obs, np.float32),
        "actions": np.asarray(actions, action_dtype),
        "rewards": np.asarray(rewards, np.float32),
        "next_obs": np.asarray(next_obs, np.float32),
        "dones": np.asarray(dones, np.float32),
    }


def off_policy_train_iteration(algo) -> dict:
    """One iteration: collect a fragment per runner, push transitions to the
    buffer actor, run pipelined replay updates, sync weights. `algo` provides
    cfg/runners/buffer/learner/env_steps_total (duck-typed)."""
    cfg = algo.cfg
    episodes = algo.runners.sample(cfg.rollout_fragment_length)
    algo.env_steps_total += sum(len(e) for e in episodes)
    batch = _episodes_to_transitions(
        episodes, getattr(algo, "action_dtype", np.int64)
    )
    size = ray_tpu_torch.get(algo.buffer.add_batch.remote(batch), timeout=60)
    metrics: dict = {}
    updates = 0
    if size >= cfg.learning_starts:
        # pipeline: the next minibatch is in flight while this one trains
        next_ref = algo.buffer.sample.remote(cfg.train_batch_size)
        for _ in range(cfg.updates_per_iter):
            sample = ray_tpu_torch.get(next_ref, timeout=60)
            next_ref = algo.buffer.sample.remote(cfg.train_batch_size)
            if not sample:
                break
            metrics = algo.learner.update(sample)
            updates += 1
        algo.runners.sync_weights(to_numpy_params(algo.learner.params))
    finished = [e for e in episodes if e.dones and e.dones[-1]]
    return {
        "env_steps_total": algo.env_steps_total,
        "buffer_size": size,
        "num_updates": updates,
        "episodes_this_iter": len(finished),
        "episode_reward_mean": (
            float(np.mean([e.total_reward() for e in finished]))
            if finished else float("nan")
        ),
        **metrics,
    }


def probe_env_spaces(env_creator) -> tuple[int, int]:
    """(obs_dim, num_actions) from one throwaway env instance."""
    probe = env_creator()
    obs_dim = int(np.prod(probe.observation_space.shape))
    num_actions = int(probe.action_space.n)
    probe.close()
    return obs_dim, num_actions


def probe_env_spaces_continuous(env_creator) -> tuple[int, int, np.ndarray, np.ndarray]:
    """(obs_dim, act_dim, low, high) for a Box action space."""
    probe = env_creator()
    try:
        space = probe.action_space
        if not hasattr(space, "high"):
            raise ValueError(
                f"continuous algorithm needs a Box action space, got {space}"
            )
        obs_dim = int(np.prod(probe.observation_space.shape))
        act_dim = int(np.prod(space.shape))
        low = np.asarray(space.low, np.float32).reshape(-1)
        high = np.asarray(space.high, np.float32).reshape(-1)
        if not (np.isfinite(low).all() and np.isfinite(high).all()):
            raise ValueError(
                f"continuous algorithm needs finite Box bounds, got "
                f"low={low} high={high} (wrap the env with a bounded action "
                f"space or rescale)"
            )
    finally:
        probe.close()
    return obs_dim, act_dim, low, high
