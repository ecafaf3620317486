"""The port's multi-agent PPO (ray_tpu_torch.rllib.multi_agent) held to the
JAX package's (ray_tpu.rllib.multi_agent) on the CPU.

The game is tests/test_rllib_offline.py's ``_TargetGame`` (two agents, a
+/-1 cue each, shared episodes of 16 steps), copied here. The runners are
compared as plain objects (the reference's runtime is never started): the
same numpy weights and seed give the same per-agent episodes, field by
field, over fragments that cross episode ends and carry reward across
fragments. One ``MultiAgentPPO.train()`` with one runner on the port's
runtime is held to the reference's pieces composed by hand: its runner,
``gae``, ``minibatch_sgd`` and the JAX ``PPOLearner`` from the same
parameters (``minibatch_sgd`` draws from an unseeded ``default_rng()``;
both sides get one seeded alike). Tolerances, as tests/test_torch_rllib.py
holds the learners: metrics rtol 1e-5 / atol 1e-6, parameters atol 5e-6.
No learning curve is asserted.

Every test runs under its own 60 s deadline (SIGALRM); those that need the
runtime start it in one process and leave no non-daemon thread behind.
"""

import signal
import threading

import numpy as np
import pytest
import torch

from ray_tpu.rllib import multi_agent as j_ma
from ray_tpu.rllib import ppo as j_ppo
from ray_tpu.rllib.np_policy import actor_critic_policy_fn as j_policy

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import multi_agent as ma
from ray_tpu_torch.rllib import optim, ppo
from ray_tpu_torch.rllib.np_policy import actor_critic_policy_fn, to_numpy_params

DEADLINE_S = 60
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 5e-6
MAPPINGS = {"shared": {"a0": "shared", "a1": "shared"}, "two": {"a0": "p0", "a1": "p1"}}


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture
def runtime():
    before = set(threading.enumerate())
    rt.init(num_cpus=8, num_gpus=0)
    try:
        yield
    finally:
        rt.shutdown()
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive() and not t.daemon]
        assert not left, left


class _TargetGame:
    """Two-agent cooperative env: each agent sees a +/-1 cue and must pick the
    matching action; shared episode ends after 16 steps."""

    possible_agents = ["a0", "a1"]

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.t = 0
        self.cues = {}

    def _obs(self):
        self.cues = {a: int(self.rng.integers(2)) for a in self.possible_agents}
        return {a: np.asarray([1.0 if c else -1.0, 1.0], np.float32)
                for a, c in self.cues.items()}

    def reset(self, seed=None):
        self.t = 0
        return self._obs(), {}

    def step(self, action_dict):
        rews = {a: float(action_dict[a] == self.cues[a]) for a in self.possible_agents}
        self.t += 1
        done = self.t >= 16
        return self._obs(), rews, {"__all__": done}, {"__all__": False}, {}


def _weights(pids, seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    return {pid: {"pi": [{"w": r.normal(size=(2, 16)), "b": r.normal(size=16) * 0.1},
                         {"w": r.normal(size=(16, 2)), "b": np.zeros(2)}],
                  "vf": [{"w": r.normal(size=(2, 16)), "b": np.zeros(16)},
                         {"w": r.normal(size=(16, 1)), "b": np.zeros(1)}]}
            for pid in pids}


def _assert_episodes(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for pid in want:
        assert len(got[pid]) == len(want[pid]), pid
        for g, w in zip(got[pid], want[pid]):
            for f in ("actions", "rewards", "logprobs", "values", "dones", "terminateds"):
                assert getattr(g, f) == getattr(w, f), (pid, f)
            np.testing.assert_array_equal(np.asarray(g.obs), np.asarray(w.obs))
            assert (g.bootstrap_value, g.reward_offset) == (w.bootstrap_value, w.reward_offset)


@pytest.mark.parametrize("mapping", list(MAPPINGS))
def test_runner_gives_the_reference_episodes(mapping):
    """Fragments of 37, 100 and 250 steps: episode ends inside a fragment,
    live episodes bootstrapped at its end, their reward carried on."""
    policy_mapping = MAPPINGS[mapping]
    w = _weights(sorted(set(policy_mapping.values())))
    ref = j_ma.MultiAgentEnvRunner(_TargetGame, j_policy, policy_mapping, seed=3)
    port = ma.MultiAgentEnvRunner(_TargetGame, actor_critic_policy_fn, policy_mapping, seed=3)
    ref.set_weights(w)
    port.set_weights(w)
    carried = False
    for steps in (37, 100, 250):
        want, got = ref.sample(steps), port.sample(steps)
        _assert_episodes(got, want)
        carried |= any(ep.reward_offset > 0 for eps in got.values() for ep in eps)
    assert carried  # a fragment began inside an episode with reward behind it


def _seeded_default_rng(monkeypatch):
    """minibatch_sgd's ``np.random.default_rng()`` (no seed) made seeded, on
    both sides alike; seeded calls pass through."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(1234 if seed is None else seed))


def test_one_train_matches_the_reference_pieces(runtime, monkeypatch):
    """One train() with one runner of 100 steps and two policies against the
    reference runner, gae, minibatch_sgd and JAX PPOLearners composed by
    hand from the same parameters."""
    _seeded_default_rng(monkeypatch)
    mapping = MAPPINGS["two"]
    cfg = ma.MultiAgentPPOConfig(num_env_runners=1, rollout_fragment_length=100,
                                 hidden=(32, 32)).environment(_TargetGame)
    cfg.multi_agent(policies={"p0": (2, 2), "p1": (2, 2)}, policy_mapping=mapping)
    j_cfg = j_ma.MultiAgentPPOConfig(num_env_runners=1, rollout_fragment_length=100,
                                     hidden=(32, 32), seed=1)
    j_learners = {pid: j_ppo.PPOLearner(j_cfg, 2, 2) for pid in ("p0", "p1")}
    algo = cfg.build(device="cpu")
    try:
        for pid, ln in algo.learners.items():
            ln.from_jax(to_numpy_params(j_learners[pid].params))
        out = algo.train()
    finally:
        algo.stop()
    # the reference's pieces, by hand
    runner = j_ma.MultiAgentEnvRunner(_TargetGame, j_policy, mapping, seed=0)
    runner.set_weights({pid: to_numpy_params(ln.params) for pid, ln in j_learners.items()})
    want, rewards = {}, []
    for pid, episodes in runner.sample(100).items():
        obs, actions, logprobs, advs, rets = [], [], [], [], []
        for ep in episodes:
            a, r = j_ppo.gae(j_cfg, ep)
            obs += ep.obs
            actions += ep.actions
            logprobs += ep.logprobs
            advs += list(a)
            rets += list(r)
        advs = np.asarray(advs, np.float32)
        advs = (advs - advs.mean()) / (advs.std() + 1e-8)
        want[pid] = j_ppo.minibatch_sgd(
            j_learners[pid].update,
            {"obs": np.asarray(obs, np.float32), "actions": np.asarray(actions, np.int32),
             "logprobs": np.asarray(logprobs, np.float32), "advantages": advs,
             "returns": np.asarray(rets, np.float32)}, j_cfg.num_epochs, j_cfg.minibatch_size)
        rewards += [ep.total_reward() for ep in episodes if ep.dones and ep.dones[-1]]
    assert out["training_iteration"] == 1
    assert out["episode_reward_mean"] == float(np.mean(rewards))
    assert sorted(out["policies"]) == ["p0", "p1"]
    for pid, metrics in want.items():
        assert set(out["policies"][pid]) == set(metrics), pid
        for k, v in metrics.items():
            np.testing.assert_allclose(out["policies"][pid][k], float(v), **METRIC_TOL,
                                       err_msg=f"{pid} {k}")
        got = optim.tree_leaves(to_numpy_params(algo.learners[pid].params))
        ref = optim.tree_leaves(to_numpy_params(j_learners[pid].params))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=PARAM_ATOL, err_msg=pid)


def test_train_with_two_runners_and_a_shared_policy(runtime):
    """Two runners, one policy for both agents: the reference's result keys,
    finite metrics, the learner moved (structure, no curve)."""
    cfg = ma.MultiAgentPPOConfig().environment(_TargetGame).env_runners(
        2, rollout_fragment_length=40).multi_agent(policies={"shared": (2, 2)},
                                                   policy_mapping=MAPPINGS["shared"])
    algo = cfg.build(device="cpu")
    before = to_numpy_params(algo.learners["shared"].params)
    try:
        out = [algo.train() for _ in range(2)]
    finally:
        algo.stop()
    assert set(out[-1]) == {"training_iteration", "episode_reward_mean", "policies"}
    assert [o["training_iteration"] for o in out] == [1, 2]
    assert 0 <= out[-1]["episode_reward_mean"] <= 16
    m = out[-1]["policies"]["shared"]
    assert {"pg_loss", "vf_loss", "entropy", "total_loss"} == set(m)
    assert all(np.isfinite(v) for v in m.values())
    after = to_numpy_params(algo.learners["shared"].params)
    assert any(not np.array_equal(a, b) for a, b in
               zip(optim.tree_leaves(before), optim.tree_leaves(after)))


@pytest.mark.parametrize("case", ["no_policies", "no_mapping", "named_env"])
def test_config_errors_match_the_reference(case):
    def make(mod):
        cfg = mod.MultiAgentPPOConfig().environment(_TargetGame)
        if case == "named_env":
            cfg.environment("CartPole-v1")
        if case != "no_policies":
            cfg.policies = {"p": (2, 2)}
        if case != "no_mapping":
            cfg.policy_mapping = {"a0": "p", "a1": "p"}
        return cfg

    with pytest.raises(ValueError) as want:
        j_ma.MultiAgentPPO(make(j_ma))
    with pytest.raises(ValueError) as got:
        make(ma).build(device="cpu")
    assert str(got.value) == str(want.value)


def test_without_a_card_build_raises_before_any_actor(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ma.MultiAgentPPOConfig().environment(_TargetGame).multi_agent(
        policies={"p": (2, 2)}, policy_mapping={"a0": "p", "a1": "p"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.build()  # no runtime is needed to get here: the learners come first
    assert isinstance(ma.MultiAgentPPOConfig(), ppo.PPOConfig)
