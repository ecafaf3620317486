"""The port's RLlib core (ray_tpu_torch.rllib) held to the JAX package's
(ray_tpu.rllib) on the same seeded numpy inputs, float32, on the CPU.

Learners (PPO, IMPALA, APPO, DQN, discrete SAC, continuous SAC, TQC) at the
reference's default widths (hidden (64, 64)) and batch sizes, each port
learner starting from the JAX learner's parameters (``from_jax``). The
continuous learners get the normals JAX draws from its key split
(``eps_next``/``eps_pi`` batch entries). Tolerances:
- loss and every metric of one update: rtol 1e-5, atol 1e-6 (measured at
  most 1.2e-6 relative). TQC's critic loss (and the total holding it) is a
  float32 mean over M x B x K x kept = 3.68 M atoms: XLA's CPU reduction
  loses 2.2e-5 of it relative, so it is held to JAX at rtol 1e-4 and to a
  float64 evaluation of the port's own loss at rtol 1e-6.
- every gradient leaf (the JAX gradients from ``jax.value_and_grad`` of
  the reference learner's own loss function): |port - jax| <= 1e-5 x the
  leaf's largest |jax| entry + 1e-8 (measured at most 9.4e-7 of it).
- parameters (and DQN's synced / the SACs' Polyak targets) after 3
  updates: atol 5e-6 (measured at most 5.3e-7). One element whose Adam
  step flipped sign would be off by 2 lr >= 6e-4, far outside it.
Host-side pieces (gae, vtrace, the replay buffer's ring, minibatch_sgd's
draws, the env runner's episodes) must equal the reference's exactly.

Every test runs under its own 60 s deadline (SIGALRM); those that need the
runtime start it in one process and leave no non-daemon thread behind.
"""

import inspect
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import appo as j_appo
from ray_tpu.rllib import dqn as j_dqn
from ray_tpu.rllib import impala as j_impala
from ray_tpu.rllib import ppo as j_ppo
from ray_tpu.rllib import replay_buffer as j_replay
from ray_tpu.rllib import sac as j_sac
from ray_tpu.rllib import sac_continuous as j_sacc
from ray_tpu.rllib import tqc as j_tqc
from ray_tpu.rllib.env_runner import Episode as JEpisode
from ray_tpu.rllib.env_runner import SingleAgentEnvRunner as JRunner
from ray_tpu.rllib.np_policy import actor_critic_policy_fn as j_policy

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import (appo, dqn, impala, iql, offline, optim, ppo, replay_buffer,
                                 sac, sac_continuous, tqc)
from ray_tpu_torch.rllib.env_runner import Episode, SingleAgentEnvRunner
from ray_tpu_torch.rllib.np_policy import actor_critic_policy_fn, to_numpy_params

DEADLINE_S = 60
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL, GRAD_FLOOR = 1e-5, 1e-8
PARAM_ATOL = 5e-6


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


# --------------------------------------------------------------- learners
# name: (JAX learner, JAX config, port learner, port config, batch size,
#        config overrides, (obs dim, actions or action dim))
CASES = {
    "ppo": (j_ppo.PPOLearner, j_ppo.PPOConfig, ppo.PPOLearner, ppo.PPOConfig,
            128, {}, (4, 2)),
    "impala": (j_impala.IMPALALearner, j_impala.IMPALAConfig, impala.IMPALALearner,
               impala.IMPALAConfig, 512, {}, (4, 2)),
    "appo": (j_appo.APPOLearner, j_appo.APPOConfig, appo.APPOLearner, appo.APPOConfig,
             256, {}, (4, 2)),
    # a target sync at update 2, so the third update reads the synced target
    "dqn": (j_dqn.DQNLearner, j_dqn.DQNConfig, dqn.DQNLearner, dqn.DQNConfig,
            64, {"target_update_freq": 2}, (4, 2)),
    "dqn_single_q": (j_dqn.DQNLearner, j_dqn.DQNConfig, dqn.DQNLearner, dqn.DQNConfig,
                     64, {"target_update_freq": 2, "double_q": False}, (4, 2)),
    "sac": (j_sac.SACLearner, j_sac.SACConfig, sac.SACLearner, sac.SACConfig,
            128, {}, (4, 2)),
    "sac_continuous": (j_sacc.ContinuousSACLearner, j_sacc.ContinuousSACConfig,
                       sac_continuous.ContinuousSACLearner,
                       sac_continuous.ContinuousSACConfig, 256, {}, (3, 1)),
    "tqc": (j_tqc.TQCLearner, j_tqc.TQCConfig, tqc.TQCLearner, tqc.TQCConfig,
            256, {}, (3, 1)),
}
CONTINUOUS = ("sac_continuous", "tqc")


def _batch(name: str, n: int, seed: int, dims) -> dict:
    """A fixed batch of the learner's inputs (CartPole's or Pendulum's shapes)."""
    obs_dim, a = dims
    r = np.random.default_rng(seed)

    def normal(*shape):
        return r.normal(size=shape).astype(np.float32)

    obs = normal(n, obs_dim)
    if name in CONTINUOUS:
        return {"obs": obs, "actions": r.uniform(-1, 1, (n, a)).astype(np.float32),
                "rewards": normal(n), "next_obs": normal(n, obs_dim),
                "dones": (r.random(n) < 0.1).astype(np.float32)}
    actions = r.integers(0, a, n).astype(np.int32)
    if name == "ppo":
        return {"obs": obs, "actions": actions,
                "logprobs": np.log(r.uniform(0.2, 0.8, n)).astype(np.float32),
                "advantages": normal(n), "returns": normal(n)}
    if name in ("impala", "appo"):
        out = {"obs": obs, "actions": actions, "vs_targets": normal(n), "advantages": normal(n)}
        if name == "appo":
            out["behavior_logp"] = np.log(r.uniform(0.2, 0.8, n)).astype(np.float32)
        return out
    return {"obs": obs, "actions": actions, "rewards": normal(n), "next_obs": normal(n, obs_dim),
            "dones": (r.random(n) < 0.1).astype(np.float32)}


def _flat(tree, prefix="") -> dict:
    """{path: float32 array} of a nested dict/list tree (JAX or torch leaves)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _flat(x, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(to_numpy_params(tree), np.float32)}


def _pair(name: str):
    """(JAX learner, port learner on the CPU from the JAX learner's params)."""
    j_learner, j_cfg, p_learner, p_cfg, n, kw, dims = CASES[name]
    jl = j_learner(j_cfg(**kw), *dims)
    pl = p_learner(p_cfg(**kw), *dims, device="cpu").from_jax(to_numpy_params(jl.params))
    return jl, pl


def _port_batch(name: str, jl, batch: dict) -> tuple[dict, object]:
    """The batch for the port's next update (with the normals the JAX
    learner's next update draws) and that update's key, as the JAX learner
    splits it (sac_continuous.py:200)."""
    if name not in CONTINUOUS:
        return batch, None
    _, sub = jax.random.split(jl._key)
    k_next, k_pi = jax.random.split(sub)
    shape = batch["actions"].shape
    return {**batch, "eps_next": np.asarray(jax.random.normal(k_next, shape)),
            "eps_pi": np.asarray(jax.random.normal(k_pi, shape))}, sub


def _jax_grads(name: str, jl, batch: dict, key, total_key: str) -> tuple:
    """(metrics with the total, grads) of the JAX learner at its current
    parameters: PPO's own compute_grads, or ``jax.value_and_grad`` of the
    learner's loss function (taken from its jitted update's closure)."""
    if name == "ppo":
        return jl.compute_grads(batch)[::-1]
    update = jl._update.__wrapped__
    loss_fn = dict(zip(update.__code__.co_freevars,
                       (c.cell_contents for c in update.__closure__)))["loss_fn"]
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    given = {"params": jl.params, "target_params": getattr(jl, "target_params", None),
             "target": getattr(jl, "target", None), "key": key}
    args = [given[a] if a in given else b[a] for a in inspect.signature(loss_fn).parameters]
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(*args)
    return {**{k: float(v) for k, v in metrics.items()}, total_key: float(loss)}, grads


def _assert_metrics(got: dict, want: dict, name: str, loose=()) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        tol = dict(rtol=1e-4, atol=1e-6) if k in loose else METRIC_TOL
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=f"{name} {k}")


def _targets(learner):
    return getattr(learner, "target_params", getattr(learner, "target", None))


@pytest.mark.parametrize("name", list(CASES))
def test_learner_one_update_matches_jax(name):
    """One update's loss and metrics, and every gradient leaf, at the
    reference's default widths and batch size."""
    jl, pl = _pair(name)
    n, dims = CASES[name][4], CASES[name][6]
    batch = _batch(name, n, 0, dims)
    pb, key = _port_batch(name, jl, batch)
    j_metrics, j_grads = _jax_grads(name, jl, batch, key, pl.total_key)
    p_grads, p_metrics = pl.compute_grads(pb)
    loose = ("critic_loss", "total_loss") if name == "tqc" else ()
    _assert_metrics(p_metrics, j_metrics, name, loose)
    want, got = _flat(j_grads), _flat(p_grads)
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        bound = GRAD_REL * float(np.abs(w).max()) + GRAD_FLOOR
        err = float(np.abs(got[path] - w).max())
        assert err <= bound, (name, path, err, bound)
    if name == "tqc":
        # the port's float32 critic loss against its own float64 evaluation
        b64 = {k: v.double() for k, v in pl._tensors(pb).items()}
        pl64 = CASES[name][2](CASES[name][3](), *dims, device="cpu").from_jax(
            to_numpy_params(jl.params))
        pl64.params, pl64.target, pl64.taus = (optim.tree_map(torch.Tensor.double, pl64.params),
                                               optim.tree_map(torch.Tensor.double, pl64.target),
                                               pl64.taus.double())
        exact = pl64.loss(pl64.params, b64)[1]["critic_loss"].item()
        np.testing.assert_allclose(p_metrics["critic_loss"], exact, rtol=1e-6)
    # the update itself reports the same numbers
    _assert_metrics(pl.update(pb), jl.update(batch), name, loose)


@pytest.mark.parametrize("name", list(CASES))
def test_learner_params_after_three_updates_match_jax(name):
    """Parameters, and DQN's synced / the SACs' Polyak targets, after 3
    updates on 3 batches."""
    jl, pl = _pair(name)
    n, dims = CASES[name][4], CASES[name][6]
    for step in range(3):
        batch = _batch(name, n, step, dims)
        pb, _ = _port_batch(name, jl, batch)
        jl.update(batch)
        pl.update(pb)
    assert pl.num_updates == 3
    pairs = [(jl.params, pl.params)]
    if _targets(jl) is not None:
        pairs.append((_targets(jl), _targets(pl)))
    for want_tree, got_tree in pairs:
        want, got = _flat(want_tree), _flat(got_tree)
        assert sorted(want) == sorted(got)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{name} {path}")
    if name.startswith("dqn"):  # synced at update 2, then the online net moved once more
        assert not np.array_equal(_flat(pl.params)["/0/w"], _flat(pl.target_params)["/0/w"])


def test_optim_matches_optax_over_groups():
    """Adam after one global clip, per-group learning rates, against optax's
    chain(clip_by_global_norm, multi_transform(adam...)) over 4 steps, with
    the clip on (large gradients) and off (small)."""
    import optax

    r = np.random.default_rng(0)
    tree = {"a": [{"w": r.normal(size=(5, 3)).astype(np.float32)}],
            "b": r.normal(size=(4,)).astype(np.float32), "c": np.float32(0.5)}
    labels = {"a": "x", "b": "y", "c": "x"}
    lrs = {"x": 1e-2, "y": 3e-3}
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.multi_transform({k: optax.adam(v) for k, v in lrs.items()}, labels))
    j_params = jax.tree.map(jnp.asarray, tree)
    state = tx.init(j_params)
    p_leaves = [torch.tensor(np.asarray(x)) for x in optim.tree_leaves(tree)]
    opt = optim.Adam(p_leaves, optim.multi_transform(tree, lrs, labels), max_norm=1.0)
    for step, scale in enumerate((10.0, 0.01, 10.0, 0.01)):
        g = jax.tree.map(lambda x: (r.normal(size=np.shape(x)) * scale).astype(np.float32),
                         tree)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.step(p_leaves, [torch.tensor(np.asarray(x)) for x in optim.tree_leaves(g)])
        for got, want in zip(p_leaves, jax.tree.leaves(j_params)):
            # within 2 float32 ulps of parameters of size ~1 (the update's own
            # rounding can tip the sum's last bit)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.4e-7, atol=1e-8,
                                       err_msg=f"step {step}")


def test_clip_is_optax_rule_not_clip_grad_norm():
    """Above max_norm the leaves become g / norm * max_norm exactly (no
    +1e-6 in the divisor); below it they pass unchanged."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]  # norm 13
    out = optim.clip_by_global_norm(g, 5.0)
    torch.testing.assert_close(out[0], torch.tensor([3.0, 4.0]) / 13.0 * 5.0, rtol=0, atol=0)
    torch.testing.assert_close(optim.clip_by_global_norm(g, 14.0)[1], g[1], rtol=0, atol=0)


def test_learners_without_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, (_, _, p_learner, p_cfg, _, kw, dims) in CASES.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_learner(p_cfg(**kw), *dims)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ppo.PPOConfig().build()  # the algorithm's learner, before any actor
    # the offline algorithms (BC, MARWIL, CQL, IQL) build their learner the same way
    rows = {"obs": np.zeros((4, 3), np.float32), "actions": np.array([0, 1, 1, 0]),
            "rewards": np.zeros(4, np.float32), "next_obs": np.zeros((4, 3), np.float32),
            "dones": np.zeros(4, np.float32)}
    for cfg in (offline.BCConfig(), offline.MARWILConfig(), offline.CQLConfig(),
                iql.IQLConfig()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.offline_data(rows).build()


# ---------------------------------------------------------- host-side parts
def _episodes(seed: int, count: int = 4) -> list:
    r = np.random.default_rng(seed)
    out = []
    for i in range(count):
        T = int(r.integers(1, 40))
        dones = [False] * (T - 1) + [bool(i % 2)]
        kw = dict(rewards=list(r.normal(size=T)), values=list(r.normal(size=T)), dones=dones,
                  bootstrap_value=float(r.normal()))
        out.append((JEpisode(**kw), Episode(**kw)))
    return out


def test_gae_matches_reference():
    cfg = ppo.PPOConfig()
    for j_ep, p_ep in _episodes(0, 8):
        for want, got in zip(j_ppo.gae(cfg, j_ep), ppo.gae(cfg, p_ep)):
            np.testing.assert_array_equal(got, want)


def test_vtrace_matches_reference():
    r = np.random.default_rng(1)
    for T in (1, 7, 64):
        args = (np.log(r.uniform(0.1, 1, T)), np.log(r.uniform(0.1, 1, T)), r.normal(size=T),
                r.normal(size=T), float(r.normal()), r.random(T) < 0.2, 0.99, 1.0, 1.0)
        for want, got in zip(j_impala.vtrace(*args), impala.vtrace(*args)):
            np.testing.assert_array_equal(got, want)


def test_replay_buffer_ring_matches_reference():
    """Wrap-around writes, size, stats and seeded samples are the reference's."""
    ref, port = j_replay.ReplayBuffer(capacity=50, seed=3), replay_buffer.ReplayBuffer(50, 3)
    r = np.random.default_rng(2)
    for n in (20, 0, 25, 30, 7):
        batch = {"obs": r.normal(size=(n, 4)).astype(np.float32),
                 "actions": r.integers(0, 2, n), "rewards": r.normal(size=n)}
        assert port.add_batch(batch) == ref.add_batch(batch)
        assert port.stats() == ref.stats() and len(port) == len(ref)
        if len(ref):
            want, got = ref.sample(16), port.sample(16)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    assert port.stats()["added_total"] == 82 and len(port) == 50


def test_minibatch_sgd_draws_match_reference():
    batch = {"obs": np.arange(300), "x": np.arange(300) * 2.0}
    draws = {"ref": [], "port": []}
    for label, fn in (("ref", j_ppo.minibatch_sgd), ("port", ppo.minibatch_sgd)):
        def record(b, label=label):
            draws[label].append(b["obs"].copy())
            return {"n": len(b["obs"])}

        out = fn(record, batch, 3, 128, rng=np.random.default_rng(5))
        assert out == {"n": 128}
    assert len(draws["port"]) == 6  # 2 full minibatches an epoch, the tail dropped
    for want, got in zip(draws["ref"], draws["port"]):
        np.testing.assert_array_equal(got, want)


def test_env_runner_gives_the_reference_episodes_on_cartpole():
    """Same numpy params, seed and CartPole: the same episodes, field by
    field, over fragments that cut live episodes."""
    import gymnasium as gym

    r = np.random.default_rng(0)
    params = {"pi": [{"w": r.normal(size=(4, 64)), "b": np.zeros(64)},
                     {"w": r.normal(size=(64, 2)) * 0.1, "b": np.zeros(2)}],
              "vf": [{"w": r.normal(size=(4, 64)), "b": np.zeros(64)},
                     {"w": r.normal(size=(64, 1)), "b": np.zeros(1)}]}
    ref = JRunner(lambda: gym.make("CartPole-v1"), j_policy, seed=7)
    port = SingleAgentEnvRunner(lambda: gym.make("CartPole-v1"), actor_critic_policy_fn, seed=7)
    ref.set_weights(params)
    port.set_weights(params)
    for steps in (100, 37, 250):
        want, got = ref.sample(steps), port.sample(steps)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            for f in ("actions", "rewards", "logprobs", "values", "dones", "terminateds"):
                assert getattr(g, f) == getattr(w, f), f
            np.testing.assert_array_equal(np.asarray(g.obs), np.asarray(w.obs))
            assert (g.bootstrap_value, g.reward_offset) == (w.bootstrap_value, w.reward_offset)
            np.testing.assert_array_equal(g.final_obs, w.final_obs)


# ------------------------------------------------------ algorithms, 1 iteration
def _cartpole():
    import gymnasium as gym

    return gym.make("CartPole-v1")


def _pendulum():
    import gymnasium as gym

    return gym.make("Pendulum-v1")


OFF_POLICY = dict(learning_starts=64, updates_per_iter=8)
ALGOS = {
    "ppo": (ppo.PPOConfig, _cartpole, {}),
    "impala": (impala.IMPALAConfig, _cartpole, {"broadcast_interval": 1}),
    "appo": (appo.APPOConfig, _cartpole, {"broadcast_interval": 1}),
    "dqn": (dqn.DQNConfig, _cartpole, OFF_POLICY),
    "sac": (sac.SACConfig, _cartpole, OFF_POLICY),
    "sac_continuous": (sac_continuous.ContinuousSACConfig, _pendulum, OFF_POLICY),
    "tqc": (tqc.TQCConfig, _pendulum, OFF_POLICY),
}


@pytest.mark.parametrize("name", list(ALGOS))
def test_algorithm_one_iteration(runtime, name):
    """One train() with 2 env runners of 64 steps each: the reference's
    metrics, finite, with the learner on the CPU (structure, no curve)."""
    cfg_cls, env, kw = ALGOS[name]
    algo = cfg_cls().environment(env).env_runners(2, rollout_fragment_length=64) \
        .training(**kw).build(device="cpu")
    try:
        before = to_numpy_params(algo.learner.params)
        out = algo.train()
    finally:
        algo.stop()
    loss_key = {"ppo": "total_loss", "impala": "total_loss", "appo": "total_loss",
                "dqn": "loss"}.get(name, "total_loss")
    assert np.isfinite(out[loss_key]), out
    if name == "ppo":
        assert out["timesteps_this_iter"] == 128 and out["training_iteration"] == 1
        assert {"pg_loss", "vf_loss", "entropy"} <= set(out)
    elif name in ("impala", "appo"):
        assert out["env_steps_total"] == 128 and {"pg_loss", "vf_loss", "entropy"} <= set(out)
    else:
        assert out["num_updates"] == 8 and out["env_steps_total"] == 128
        assert 64 <= out["buffer_size"] <= 128
        if name == "dqn":
            assert {"td_error_mean", "q_mean"} <= set(out) and 0.05 <= out["epsilon"] < 1.0
        else:
            assert {"critic_loss", "actor_loss", "alpha", "entropy"} <= set(out)
    moved = [not np.array_equal(a, b) for a, b in
             zip(optim.tree_leaves(before), optim.tree_leaves(to_numpy_params(algo.learner.params)))]
    assert any(moved)
