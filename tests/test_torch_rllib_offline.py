"""The port's offline RL (ray_tpu_torch.rllib.offline and .iql) held to the
JAX package's (ray_tpu.rllib.offline and .iql) on the same seeded numpy
datasets, float32, on the CPU.

BC, MARWIL and CQL learn from a dataset of 4-dimensional observations and 2
discrete actions, IQL from one of 3-dimensional observations and a
1-dimensional continuous action, 600 rows each, made with numpy from a
seed. Each port algorithm starts from the JAX algorithm's parameters (and
targets), ``from_jax``. Tolerances:
- one update's metrics against the JAX algorithm's ``_update`` on the same
  batch: rtol 1e-5, atol 1e-6 (the atol for metrics near zero, as
  tests/test_torch_rllib.py holds the online learners);
- parameters and targets after 3 updates of ``train`` (the same minibatch
  draws; CQL's target synced at update 2, IQL's Polyak target moved each
  update): atol 1e-6;
- the minibatches ``train`` draws, the loaders' arrays and the files
  ``write_offline_json`` writes: equal, but for continuous actions read
  back as float64: the reference parses the JSONL with pandas, whose fast
  float parser may miss the last float64 bit (9.7e-16 seen), where the
  port's ``json`` reads each number exactly; they are held within rtol
  1e-12 and equal in float32, the dtype IQL learns in;
- the greedy discrete actions equal, IQL's mean actions atol 1e-5 (numpy
  against XLA, float32).
No learning curve is asserted: the reference's own vary from run to run.

Every test runs under its own 60 s deadline (SIGALRM) and needs no
runtime, port or process.
"""

import json
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import iql as j_iql
from ray_tpu.rllib import offline as j_off
from ray_tpu_torch.rllib import iql, offline, optim
from ray_tpu_torch.rllib.np_policy import to_numpy_params

DEADLINE_S = 60
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 1e-6
ROWS = 600
DISCRETE = ("bc", "marwil", "cql")
ALGOS = (*DISCRETE, "iql")


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


def _dataset(name: str, seed: int = 0) -> dict:
    """A transition dict: 4 observations and actions {0, 1}, or (IQL) 3
    observations and one action in [-1, 1]."""
    r = np.random.default_rng(seed)
    obs_dim = 3 if name == "iql" else 4
    obs = r.normal(size=(ROWS, obs_dim)).astype(np.float32)
    if name == "iql":
        actions = r.uniform(-1, 1, (ROWS, 1)).astype(np.float32)
    else:
        actions = r.integers(0, 2, ROWS).astype(np.int64)
    return {"obs": obs, "actions": actions,
            "rewards": r.normal(size=ROWS).astype(np.float32),
            "next_obs": r.normal(size=(ROWS, obs_dim)).astype(np.float32),
            "dones": (r.random(ROWS) < 0.1).astype(np.float32)}


# name: (JAX config, port config, config overrides)
CONFIGS = {
    "bc": (j_off.BCConfig, offline.BCConfig, {}),
    "marwil": (j_off.MARWILConfig, offline.MARWILConfig, {}),
    # a target sync at update 2, so the third update reads the synced target
    "cql": (j_off.CQLConfig, offline.CQLConfig, {"target_update_freq": 2}),
    "iql": (j_iql.IQLConfig, iql.IQLConfig, {}),
}


def _pair(name: str):
    """(the JAX algorithm, the port's on the CPU from its parameters)."""
    j_cfg, p_cfg, kw = CONFIGS[name]
    data = _dataset(name)
    j_algo = j_cfg(**kw).offline_data(data).build()
    p_algo = p_cfg(**kw).offline_data(data).build(device="cpu")
    target = j_algo.target if name == "iql" else None
    if name == "cql":
        target = j_algo.target_params
    if target is None:
        p_algo.from_jax(to_numpy_params(j_algo.params))
    else:
        p_algo.from_jax(to_numpy_params(j_algo.params), to_numpy_params(target))
    return j_algo, p_algo


def _batch(name: str, seed: int = 7) -> dict:
    data = _dataset(name)
    idx = np.random.default_rng(seed).integers(0, ROWS, 256)
    return {k: v[idx] for k, v in data.items()}


def _jax_update(name: str, j_algo, batch: dict) -> dict:
    if name != "iql":
        return j_algo._update(batch)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    j_algo.params, j_algo.target, j_algo.opt_state, m = j_algo._update(
        j_algo.params, j_algo.target, j_algo.opt_state, b)
    return {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("name", ALGOS)
def test_one_update_metrics_match_jax(name):
    j_algo, p_algo = _pair(name)
    batch = _batch(name)
    want = _jax_update(name, j_algo, batch)
    got = p_algo.update(batch) if name == "iql" else p_algo._update(batch)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **METRIC_TOL, err_msg=k)


def _trees(name: str, algo) -> dict:
    trees = {"params": algo.params}
    if name == "cql":
        trees["target"] = algo.target_params
    if name == "iql":
        trees["target"] = algo.target
    return {k: optim.tree_leaves(to_numpy_params(t)) for k, t in trees.items()}


@pytest.mark.parametrize("name", ALGOS)
def test_params_and_targets_after_three_train_updates_match_jax(name):
    j_algo, p_algo = _pair(name)
    j_out, p_out = j_algo.train(3), p_algo.train(3)
    assert set(p_out) == set(j_out)
    want, got = _trees(name, j_algo), _trees(name, p_algo)
    assert set(got) == set(want)
    for tree in want:
        assert len(got[tree]) == len(want[tree])
        for i, (a, b) in enumerate(zip(got[tree], want[tree])):
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=f"{tree} {i}")
    if name == "cql":  # synced at update 2, then moved apart by update 3
        assert not np.array_equal(got["target"][0], got["params"][0])
        np.testing.assert_allclose(got["target"][0], want["target"][0], atol=PARAM_ATOL)


def _recorder(name: str, algo, port: bool) -> list:
    """Record the observations of every minibatch ``algo.train`` updates on."""
    seen = []
    if port:
        attr = "update" if name == "iql" else "_update"
        inner = getattr(algo, attr)
        setattr(algo, attr, lambda batch: seen.append(np.asarray(batch["obs"])) or inner(batch))
    elif name == "iql":
        inner = algo._update
        algo._update = lambda p, t, o, batch: seen.append(np.asarray(batch["obs"])) or inner(
            p, t, o, batch)
    else:
        inner = algo._update
        algo._update = lambda batch: seen.append(np.asarray(batch["obs"])) or inner(batch)
    return seen


@pytest.mark.parametrize("name", ALGOS)
def test_train_draws_the_reference_minibatches(name):
    j_algo, p_algo = _pair(name)
    if name != "iql":
        j_algo.cfg.train_batch_size = p_algo.cfg.train_batch_size = 700  # above the rows
    want, got = _recorder(name, j_algo, False), _recorder(name, p_algo, True)
    j_algo.train(4)
    p_algo.train(4)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if name != "iql":  # min(batch size, rows), as the reference takes it
        assert got[0].shape[0] == ROWS


@pytest.mark.parametrize("name", ["bc", "iql"])
def test_write_then_load_round_trip_matches_reference(tmp_path, name):
    data = _dataset(name)
    path, j_path = str(tmp_path / "d" / "rows.jsonl"), str(tmp_path / "j" / "rows.jsonl")
    assert offline.write_offline_json(data, path) == ROWS
    assert j_off.write_offline_json(data, j_path) == ROWS
    with open(path) as a, open(j_path) as b:
        assert a.read() == b.read()
    # the reference reads the path through ray_tpu.data (no runtime needed)
    dtype = None if name == "iql" else np.int64
    want = j_off.load_offline_data(path, action_dtype=dtype)
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for source in (path, rows, _TakeAll(rows)):
        got = offline.load_offline_data(source, action_dtype=dtype)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            if want[k].dtype == np.float64:  # continuous actions (module doc)
                np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
                np.testing.assert_array_equal(got[k].astype(np.float32),
                                              want[k].astype(np.float32), err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the rows hold each float32 in its shortest float64 repr: exact here
    for k, v in data.items():
        np.testing.assert_array_equal(offline.load_offline_data(path)[k].astype(v.dtype), v)
    assert offline.load_offline_data(data) is data


class _TakeAll:
    def __init__(self, rows):
        self.rows = rows

    def take_all(self):
        return list(self.rows)


@pytest.mark.parametrize("name", ALGOS)
def test_compute_single_action_matches_reference(name):
    j_algo, p_algo = _pair(name)
    j_algo.train(3)
    p_algo.train(3)
    obs = np.random.default_rng(11).normal(size=(32, 3 if name == "iql" else 4))
    got = [p_algo.compute_single_action(o) for o in obs]
    want = [j_algo.compute_single_action(o) for o in obs]
    if name == "iql":
        np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-5, rtol=0)
    else:
        assert got == want
        assert all(isinstance(a, int) for a in got)


def test_empty_dataset_and_unknown_option_are_refused():
    empty = {k: v[:0] for k, v in _dataset("bc").items()}
    with pytest.raises(ValueError, match="empty"):
        offline.BCConfig().offline_data(empty).build(device="cpu")
    with pytest.raises(ValueError, match="Unknown training option"):
        offline.CQLConfig().training(alpha=1.0)


def test_offline_algorithms_need_no_card_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, (_, p_cfg, kw) in CONFIGS.items():
        algo = p_cfg(**kw).offline_data(_dataset(name)).build(device="cpu")
        assert all(t.device.type == "cpu" for t in optim.tree_leaves(algo.params))
