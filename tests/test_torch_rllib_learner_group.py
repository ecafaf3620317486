"""The port's LearnerGroup (ray_tpu_torch.rllib.learner_group) on the CPU:
the two data-parallel tests of tests/test_learner_group.py on port
learners, and the group's gradients held to the JAX PPO learner's.

Tolerances: the group against one learner on the full batch, rtol 2e-4 /
atol 2e-5 as the reference's test states (example-weighted shard
gradients sum in another order); the group's averaged gradient against
the JAX learner's full-batch gradient, 1e-5 of each leaf's largest entry;
replicas bitwise equal. Every test runs under its own 60 s deadline and
leaves no non-daemon thread behind.
"""

import signal
import threading

import numpy as np
import pytest

from ray_tpu.rllib.ppo import PPOConfig as JPPOConfig
from ray_tpu.rllib.ppo import PPOLearner as JPPOLearner

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.dqn import DQNConfig, DQNLearner
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.rllib.np_policy import to_numpy_params
from ray_tpu_torch.rllib.ppo import PPOConfig, PPOLearner

DEADLINE_S = 60


@pytest.fixture
def session():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    rt.init(num_cpus=8, num_gpus=0)
    try:
        yield
    finally:
        try:
            rt.shutdown()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


def _batch(n, obs_dim=4, num_actions=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, num_actions, size=n).astype(np.int32),
        "logprobs": np.log(np.full(n, 0.5, dtype=np.float32)),
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(size=n).astype(np.float32),
    }


def _leaves(tree):
    return optim.tree_leaves(tree)


def test_group_update_matches_single_learner(session):
    """Example-weighted gradient averaging over shards == one learner seeing
    the full batch (the DDP contract), to float tolerance."""
    batch = _batch(64)
    single = PPOLearner(PPOConfig(seed=3), 4, 2, device="cpu")
    single.update(batch)
    group = LearnerGroup(lambda: PPOLearner(PPOConfig(seed=3), 4, 2, device="cpu"),
                         num_learners=2)
    try:
        group.update(batch)
        for a, b in zip(_leaves(group.get_params()), _leaves(single.get_params())):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    finally:
        group.shutdown()


def test_replicas_stay_identical_across_steps(session):
    group = LearnerGroup(lambda: PPOLearner(PPOConfig(seed=1), 4, 2, device="cpu"),
                         num_learners=3)
    try:
        for step in range(3):
            group.update(_batch(48, seed=step))
        params = [rt.get(w.get_params.remote(), timeout=120) for w in group.workers]
        for other in params[1:]:
            for a, b in zip(_leaves(params[0]), _leaves(other)):
                np.testing.assert_array_equal(a, b)
    finally:
        group.shutdown()


def test_group_gradient_matches_jax_full_batch(session):
    """The group's averaged shard gradient (uneven shards of 50 over 3) is the
    JAX PPO learner's gradient on the whole batch, and its metrics are the
    JAX learner's full-batch metrics."""
    jl = JPPOLearner(JPPOConfig(seed=3), 4, 2)
    start = to_numpy_params(jl.params)
    batch = _batch(50, seed=4)
    j_grads, j_metrics = jl.compute_grads(batch)
    seen = []

    def factory():
        learner = PPOLearner(PPOConfig(seed=3), 4, 2, device="cpu").from_jax(start)
        apply = learner.apply_grads
        learner.apply_grads = lambda g: (seen.append(g), apply(g))
        return learner

    group = LearnerGroup(factory, num_learners=3)
    try:
        metrics = group.update(batch)
    finally:
        group.shutdown()
    assert len(seen) == 3
    for k, v in j_metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    for got, want in zip(_leaves(seen[0]), _leaves(j_grads)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + 1e-8
    for other in seen[1:]:  # every replica applied the same averaged gradient
        for a, b in zip(_leaves(seen[0]), _leaves(other)):
            np.testing.assert_array_equal(a, b)


def test_group_refuses_unseeded_replicas_and_takes_any_learner(session):
    seeds = iter(range(10))
    with pytest.raises(ValueError, match="diverge at init"):
        LearnerGroup(lambda: PPOLearner(PPOConfig(seed=next(seeds)), 4, 2, device="cpu"),
                     num_learners=2)
    # a DQN learner exposes the same split; its target sync runs in apply_grads
    group = LearnerGroup(lambda: DQNLearner(DQNConfig(target_update_freq=1), 4, 2,
                                            device="cpu"), num_learners=2)
    try:
        rng = np.random.default_rng(0)
        out = group.update({"obs": rng.normal(size=(32, 4)).astype(np.float32),
                            "actions": rng.integers(0, 2, 32).astype(np.int32),
                            "rewards": rng.normal(size=32).astype(np.float32),
                            "next_obs": rng.normal(size=(32, 4)).astype(np.float32),
                            "dones": np.zeros(32, np.float32)})
        assert {"loss", "td_error_mean", "q_mean"} == set(out)
        assert group.update({"obs": np.zeros((0, 4))}) == {}
    finally:
        group.shutdown()
