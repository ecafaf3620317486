"""The port's DreamerV3 (ray_tpu_torch.rllib.dreamerv3) held to the JAX
package's (ray_tpu.rllib.dreamerv3) on the same seeded numpy inputs,
float32, on the CPU.

Config: the reference test's cut (tests/test_learner_group.py:91-97: batch
4 x length 12, horizon 5, deter 32, hidden 32, 4 groups x 4 classes), on
CartPole's shapes (4 observations, 2 actions). The port starts from the JAX
algorithm's trees (``from_jax``). The JAX programs are taken from the
closures of its jitted updates; its gradients are what its optimizers
receive (a recording optimizer in their place). The port's Gumbel noise is
``jax.random.gumbel`` under the reference's own key splits: ``observe``
splits its key into T, ``imagine`` each step's into (ka, kz),
``policy_step`` into (kz, ka).

Tolerances:
- metrics and scalars: rtol 1e-5, atol 1e-6; the outputs that pass
  through the 12-step recurrence (the world-model metrics, hs and zs, the
  imagined return and the actor and critic losses) may use rtol 1e-4
  (measured at most 2.5e-7 relative, hs and zs within 9e-8);
- every gradient leaf: |port - jax| <= 1e-5 x the leaf's largest |jax|
  entry + 1e-8 (measured at most 4.2e-7 of it: world model 4.2e-7, actor
  1.6e-7, critic 3.7e-7);
- parameters after one update: atol 5e-6;
- every categorical draw (the latents' one-hots, the actions): equal.
No learning curve is asserted.

Every test runs under its own 60 s deadline (SIGALRM) and needs no
runtime, port or process.
"""

import functools
import math
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import dreamerv3 as j_d3
from ray_tpu_torch.rllib import dreamerv3 as d3
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.np_policy import to_numpy_params

DEADLINE_S = 60
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
RECURRENT_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_REL, GRAD_FLOOR = 1e-5, 1e-8
PARAM_ATOL = 5e-6
CUT = dict(batch_size=4, batch_length=12, horizon=5, deter_dim=32, hidden=32,
           stoch_groups=4, stoch_classes=4, collect_episodes=2, max_episode_len=60)
B, T, H, G, C, A, OBS = 4, 12, 5, 4, 4, 2, 4
WM_METRICS = ("wm_loss", "recon", "reward", "continue", "kl_dyn", "kl_rep")


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


class NumpyCartPole:
    """CartPole-v1 in numpy (gymnasium's classic_control/cartpole.py
    dynamics), a callable env with gymnasium's spaces' two fields."""

    observation_space = types.SimpleNamespace(shape=(4,))
    action_space = types.SimpleNamespace(n=2)

    def __init__(self):
        self.rng = np.random.default_rng()
        self.state, self.t = np.zeros(4), 0

    def reset(self, seed=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state, self.t = self.rng.uniform(-0.05, 0.05, 4), 0
        return self.state.astype(np.float32), {}

    def step(self, action):
        x, x_dot, th, th_dot = self.state
        force = 10.0 if action == 1 else -10.0
        cos, sin = math.cos(th), math.sin(th)
        temp = (force + 0.05 * th_dot ** 2 * sin) / 1.1
        th_acc = (9.8 * sin - cos * temp) / (0.5 * (4.0 / 3.0 - 0.1 * cos ** 2 / 1.1))
        x_acc = temp - 0.05 * th_acc * cos / 1.1
        self.state = np.array([x + 0.02 * x_dot, x_dot + 0.02 * x_acc,
                               th + 0.02 * th_dot, th_dot + 0.02 * th_acc])
        self.t += 1
        terminated = bool(abs(self.state[0]) > 2.4 or abs(self.state[2]) > 12 * 2 * math.pi / 360)
        return self.state.astype(np.float32), 1.0, terminated, self.t >= 500, {}

    def close(self):
        pass


def _np(tree):
    return to_numpy_params(jax.tree.map(np.asarray, tree))


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@functools.lru_cache(maxsize=None)
def _jd():
    """The JAX DreamerV3 (its trees are never reassigned here)."""
    return j_d3.DreamerV3Config(env=NumpyCartPole).training(**CUT).build()


def _pair():
    """(JAX DreamerV3, port DreamerV3 on the CPU from its trees, port config)."""
    jd = _jd()
    cfg = d3.DreamerV3Config(env=NumpyCartPole).training(**CUT)
    pd = cfg.build(device="cpu").from_jax(_np(jd.wm), _np(jd.actor), _np(jd.critic))
    return jd, pd, cfg


@functools.lru_cache(maxsize=None)
def _programs() -> dict:
    """The reference's programs, from the closures of its jitted updates."""
    jd = _jd()
    wm_c = _closure(jd._wm_update.__wrapped__)
    ac_c = _closure(jd._ac_update.__wrapped__)
    obs_c = _closure(_closure(wm_c["wm_loss"])["observe"])
    return {"wm_loss": wm_c["wm_loss"], "kl_cat": _closure(wm_c["wm_loss"])["kl_cat"],
            "observe": _closure(wm_c["wm_loss"])["observe"], "sample_st": obs_c["sample_st"],
            "gru": obs_c["gru"], "imagine": ac_c["imagine"],
            "lambda_returns": ac_c["lambda_returns"]}


def _batch(seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    return {"obs": r.normal(size=(B, T, OBS)).astype(np.float32),
            "actions": np.eye(A, dtype=np.float32)[r.integers(0, A, (B, T))],
            "rewards": r.normal(size=(B, T)).astype(np.float32),
            "dones": (r.random((B, T)) < 0.1).astype(np.float32)}


def _gumbel(key, shape) -> np.ndarray:
    return np.asarray(jax.random.gumbel(key, shape, jnp.float32))


def observe_noise(key) -> np.ndarray:
    """observe's noise: its key split into T, one [B, G, C] draw a step."""
    return np.stack([_gumbel(k, (B, G, C)) for k in jax.random.split(key, T)])


def imagine_noise(key, n: int) -> tuple:
    """imagine's noise: its key split into the horizon, each step's into (ka, kz)."""
    g_a, g_z = [], []
    for k in jax.random.split(key, H):
        ka, kz = jax.random.split(k)
        g_a.append(_gumbel(ka, (n, A)))
        g_z.append(_gumbel(kz, (n, G, C)))
    return np.stack(g_a), np.stack(g_z)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


class _Recorder:
    """An optimizer in the reference's place that keeps the gradients it
    gets and moves nothing."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params=None):
        self.grads = grads
        return jax.tree.map(jnp.zeros_like, grads), state


def _assert_grads(got: list, want, what: str) -> None:
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        bound = GRAD_REL * float(np.abs(w).max()) + GRAD_FLOOR
        err = float(np.abs(g.numpy() - w).max())
        assert err <= bound, (what, i, err, bound)


def _assert_params(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(optim.tree_leaves(to_numpy_params(got)),
                                   jax.tree.leaves(want))):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} leaf {i}")


@functools.lru_cache(maxsize=None)
def _wm_reference() -> dict:
    """The JAX world-model step on _batch(0) with key k1: its aux, the
    gradients its optimizer receives and the parameters after it."""
    jd = _jd()
    key = jax.random.PRNGKey(11)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    grads_of = jax.jit(jax.value_and_grad(_programs()["wm_loss"], has_aux=True))
    (_, aux), grads = grads_of(jd.wm, batch, key)  # what wm_update hands its optimizer
    wm, _, _ = jd._wm_update(jd.wm, jd.wm_state, batch, key)
    return {"key": key, "aux": jax.tree.map(np.asarray, aux), "grads": grads, "params": wm}


@functools.lru_cache(maxsize=None)
def _ac_reference() -> dict:
    """The JAX actor-critic step from the world-model step's posterior
    states, with key k2: the gradients, the metrics and the trees after it."""
    jd = _jd()
    aux = _wm_reference()["aux"]
    sh = jnp.asarray(aux["hs"].reshape(-1, CUT["deter_dim"]))
    sz = jnp.asarray(aux["zs"].reshape(-1, G * C))
    key = jax.random.PRNGKey(12)
    args = (jd.actor, jd.critic, jd.actor_state, jd.critic_state, jd.wm, sh, sz, key)
    real = jd.actor_opt, jd.critic_opt
    jd.actor_opt, jd.critic_opt = _Recorder(), _Recorder()

    def grads_of(*a):  # traced once: the recorders keep the traced gradients
        jd._ac_update.__wrapped__(*a)
        return jd.actor_opt.grads, jd.critic_opt.grads

    try:
        grads = jax.jit(grads_of)(*args)
    finally:
        jd.actor_opt, jd.critic_opt = real
    actor, critic, _, _, metrics = jd._ac_update(*args)
    return {"key": key, "sh": np.asarray(sh), "sz": np.asarray(sz), "grads": grads,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "actor": actor, "critic": critic, "wm": jd.wm}


# ------------------------------------------------------------------ pieces
def test_symlog_and_symexp_match_reference():
    x = np.concatenate([np.random.default_rng(0).normal(size=200) * 20,
                        [0.0, -0.0, 1e-8, -1e-8, 50.0, -50.0]]).astype(np.float32)
    for port, ref in ((d3.symlog, j_d3._symlog), (d3.symexp, j_d3._symexp)):
        np.testing.assert_allclose(port(_t(x)).numpy(), np.asarray(ref(jnp.asarray(x))),
                                   rtol=1e-6, atol=0)
    np.testing.assert_allclose(d3.symexp(d3.symlog(_t(x))).numpy(), x, rtol=1e-5, atol=1e-6)


def test_kl_cat_matches_reference_with_free_bits():
    """KL summed over groups, clipped from below at free_bits: rows under and
    over the clip, values and the gradient (zero where clipped)."""
    r = np.random.default_rng(1)
    lhs = (r.normal(size=(64, G * C)) * np.linspace(0.1, 3, 64)[:, None]).astype(np.float32)
    rhs = r.normal(size=(64, G * C)).astype(np.float32)
    cfg = d3.DreamerV3Config().training(**CUT)
    kl = _programs()["kl_cat"]
    want = np.asarray(kl(jnp.asarray(lhs), jnp.asarray(rhs)))
    assert (want == cfg.free_bits).any() and (want > cfg.free_bits).any()
    np.testing.assert_allclose(d3.kl_cat(cfg, _t(lhs), _t(rhs)).numpy(), want, **METRIC_TOL)
    j_grad = jax.grad(lambda a: kl(a, jnp.asarray(rhs)).sum())(jnp.asarray(lhs))
    p_lhs = _t(lhs).requires_grad_()
    d3.kl_cat(cfg, p_lhs, _t(rhs)).sum().backward()
    _assert_grads([p_lhs.grad], j_grad, "kl_cat")


def test_sample_st_draws_and_straight_through_gradient_match_reference():
    r = np.random.default_rng(2)
    logits = r.normal(size=(32, G * C)).astype(np.float32)
    weights = r.normal(size=(32, G * C)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    cfg = d3.DreamerV3Config().training(**CUT)
    st = _programs()["sample_st"]
    want = np.asarray(st(jnp.asarray(logits), key))
    p_logits = _t(logits).requires_grad_()
    got = d3.sample_st(cfg, p_logits, _t(_gumbel(key, (32, G, C))))
    np.testing.assert_array_equal(got.detach().numpy().round(), want.round())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    (got * _t(weights)).sum().backward()
    j_grad = jax.grad(lambda lg: (st(lg, key) * weights).sum())(jnp.asarray(logits))
    _assert_grads([p_logits.grad], j_grad, "sample_st")
    assert float(p_logits.grad.abs().max()) > 0  # the straight-through path carries it


# ------------------------------------------------------------- world model
def test_wm_loss_aux_matches_reference():
    ref = _wm_reference()
    _, pd, cfg = _pair()
    batch = {k: _t(v) for k, v in _batch().items()}
    loss, aux = d3.wm_loss(cfg, pd.wm, batch, _t(observe_noise(ref["key"])))
    for k in WM_METRICS:
        np.testing.assert_allclose(float(aux[k]), float(ref["aux"][k]), **RECURRENT_TOL,
                                   err_msg=k)
    assert float(loss) == float(aux["wm_loss"])
    # the posterior samples are the same one-hots (straight-through values)
    np.testing.assert_array_equal(aux["zs"].numpy().round(), ref["aux"]["zs"].round())
    for k in ("hs", "zs"):
        np.testing.assert_allclose(aux[k].numpy(), ref["aux"][k], rtol=0, atol=1e-6, err_msg=k)


def test_wm_update_gradients_and_parameters_match_reference():
    ref = _wm_reference()
    _, pd, cfg = _pair()
    batch = {k: _t(v) for k, v in _batch().items()}
    g = _t(observe_noise(ref["key"]))
    grads, _ = d3.wm_grads(cfg, pd.wm, batch, g)
    _assert_grads(grads, ref["grads"], "wm")
    aux = pd.wm_update(_batch(), g)
    assert set(aux) == set(WM_METRICS) | {"hs", "zs"}
    _assert_params(pd.wm, ref["params"], "wm")


# --------------------------------------------------------- actor-critic
def test_imagine_and_lambda_returns_match_reference():
    ref = _ac_reference()
    _, pd, cfg = _pair()
    prog = _programs()
    n = ref["sh"].shape[0]
    g_a, g_z = imagine_noise(ref["key"], n)
    j_hs, j_zs, j_ents = jax.jit(prog["imagine"])(ref["wm"], _jd().actor, jnp.asarray(ref["sh"]),
                                                  jnp.asarray(ref["sz"]), ref["key"])
    hs, zs, ents = d3.imagine(cfg, pd.wm, pd.actor, _t(ref["sh"]), _t(ref["sz"]), _t(g_a),
                              _t(g_z))
    np.testing.assert_array_equal(zs.numpy().round(), np.asarray(j_zs).round())
    for got, want, what in ((hs, j_hs, "hs"), (zs, j_zs, "zs"), (ents, j_ents, "ents")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6,
                                   err_msg=what)
    r = np.random.default_rng(4)
    rews, conts, values = (r.normal(size=(H, 16)).astype(np.float32) for _ in range(3))
    want = prog["lambda_returns"](jnp.asarray(rews), jnp.asarray(conts), jnp.asarray(values))
    got = d3.lambda_returns(cfg, _t(rews), _t(conts), _t(values))
    assert got.shape == (H - 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **METRIC_TOL)


def test_ac_update_metrics_gradients_and_parameters_match_reference():
    """One imagined rollout: the metrics, the actor's and the critic's
    gradients, and both trees after the step. The actor's gradient is the
    entropy term's alone, as the reference's is (an imagined action is a
    plain one-hot of a sampled index)."""
    ref = _ac_reference()
    _, pd, cfg = _pair()
    n = ref["sh"].shape[0]
    g_a, g_z = (_t(x) for x in imagine_noise(ref["key"], n))
    sh, sz = _t(ref["sh"]), _t(ref["sz"])
    a_grads, c_grads, metrics = d3.ac_grads(cfg, pd.actor, pd.critic, pd.wm, sh, sz, g_a, g_z)
    _assert_grads(a_grads, ref["grads"][0], "actor")
    _assert_grads(c_grads, ref["grads"][1], "critic")
    assert set(metrics) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), want, **RECURRENT_TOL, err_msg=k)
    # the entropy term alone gives the same actor gradient
    live = d3._live(pd.actor)
    ents = d3.imagine(cfg, pd.wm, live, sh, sz, g_a, g_z)[2]
    ent_only = d3._grads(-cfg.entropy_coeff * ents.mean(), live)
    for got, want in zip(a_grads, ent_only):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    out = pd.ac_update(sh, sz, g_a, g_z)
    assert {k: float(v) for k, v in out.items()} == {k: float(v) for k, v in metrics.items()}
    _assert_params(pd.actor, ref["actor"], "actor")
    _assert_params(pd.critic, ref["critic"], "critic")


# ------------------------------------------------------------- collection
def test_policy_step_matches_reference():
    jd, pd, cfg = _pair()
    r = np.random.default_rng(5)
    h = r.normal(size=(1, CUT["deter_dim"])).astype(np.float32) * 0.5
    z = np.eye(C, dtype=np.float32)[r.integers(0, C, G)].reshape(1, G * C)
    policy_step = jd._policy_step
    for i in range(8):
        obs = r.normal(size=(1, OBS)).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        kz, ka = jax.random.split(key)
        j_h, j_z, j_a = policy_step(jd.wm, jd.actor, jnp.asarray(h), jnp.asarray(z),
                                    jnp.asarray(obs), key)
        p_h, p_z, p_a = d3.policy_step(cfg, pd.wm, pd.actor, _t(h), _t(z), _t(obs),
                                       _t(_gumbel(kz, (1, G, C))), _t(_gumbel(ka, (1, A))))
        assert int(p_a[0]) == int(j_a[0])
        np.testing.assert_array_equal(p_z.numpy().round(), np.asarray(j_z).round())
        np.testing.assert_allclose(p_h.numpy(), np.asarray(j_h), rtol=0, atol=1e-6)
        h, z = np.asarray(j_h), np.asarray(j_z)


def test_sample_batch_draws_match_reference():
    """The same buffer and numpy generator give the same [B, T] batches
    (episodes shorter and longer than the batch length)."""
    jd, pd, _ = _pair()
    r = np.random.default_rng(6)
    buffer = []
    for L in (5, 12, 30, 1, 17):
        buffer.append({"obs": r.normal(size=(L, OBS)).astype(np.float32),
                       "actions": r.integers(0, A, L), "rewards": r.normal(size=L),
                       "dones": np.arange(L) == L - 1})
    jd._buffer, pd._buffer = buffer, buffer
    jd._np_rng, pd._np_rng = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        want, got = jd._sample_batch(), pd._sample_batch()
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_from_jax_carries_the_reference_trees():
    jd, pd, _ = _pair()
    for what in ("wm", "actor", "critic"):
        got = optim.tree_leaves(to_numpy_params(getattr(pd, what)))
        want = jax.tree.leaves(_np(getattr(jd, what)))
        assert len(got) == len(want) and len(got) > 0, what
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w, np.float32), err_msg=what)
    assert pd.wm_opt.count == 0 and pd.actor_opt.count == 0 and pd.critic_opt.count == 0
    assert pd.wm_opt.max_norm == 100.0 and pd.actor_opt.max_norm is None
    # the port's own init has the reference's shapes and zero biases
    own = d3.DreamerV3Config(env=NumpyCartPole).training(**CUT).build(device="cpu")
    for what in ("wm", "actor", "critic"):
        shapes = [tuple(t.shape) for t in optim.tree_leaves(getattr(own, what))]
        assert shapes == [np.shape(w) for w in jax.tree.leaves(getattr(jd, what))], what
    assert float(own.wm["gru_x"]["b"].abs().sum()) == 0.0


# ------------------------------------------------------------- algorithm
def test_train_two_iterations_on_the_cpu():
    """Two train() calls over a numpy CartPole: the reference's metric
    keys, finite values, and the replay buffer's episode count."""
    algo = d3.DreamerV3Config(env=NumpyCartPole).training(**CUT).build(device="cpu")
    j_keys = {"wm_loss", "recon", "reward", "continue", "kl_dyn", "kl_rep", "actor_loss",
              "critic_loss", "imagined_return", "episode_reward_mean", "training_iteration",
              "buffer_episodes"}
    before = [t.clone() for t in optim.tree_leaves(algo.actor)]
    for i in (1, 2):
        out = algo.train()
        assert set(out) == j_keys
        assert all(math.isfinite(v) for v in out.values()), out
        assert out["training_iteration"] == i and out["buffer_episodes"] == 2 * i
        assert out["episode_reward_mean"] > 0
    assert any(not torch.equal(a, b) for a, b in zip(before, optim.tree_leaves(algo.actor)))


def test_config_errors_and_no_card(monkeypatch):
    with pytest.raises(ValueError, match="Unknown training option bogus"):
        d3.DreamerV3Config().training(bogus=1)
    with pytest.raises(ValueError, match="Unknown training option bogus"):
        j_d3.DreamerV3Config().training(bogus=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        d3.DreamerV3Config(env=NumpyCartPole).build()
