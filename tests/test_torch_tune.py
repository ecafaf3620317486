"""The port's Tune (ray_tpu_torch.tune), its train context and AIR callbacks,
held to the JAX package's (ray_tpu.tune) on the CPU.

Searchers and schedulers are pure Python: the port's and the reference's,
seeded alike and fed one scripted stream of results, must give the same
configs and the same decisions. Then tests/test_tune.py's cases run on the
port's in-process runtime: the best result, an errored trial, ASHA stopping
trials, PBT exploiting a leader, ``run()``, the dataframe, and the
callbacks' order. No test starts the reference's runtime.

Every test runs under its own 60 s deadline (SIGALRM); those that need the
runtime start it in one process and leave no non-daemon thread behind.
"""

import math
import signal
import threading
import time

import numpy as np
import pytest

from ray_tpu.tune import schedulers as j_sched
from ray_tpu.tune import search as j_search

import ray_tpu_torch as rt
from ray_tpu_torch import air, tune
from ray_tpu_torch.train import report
from ray_tpu_torch.tune import schedulers, search

DEADLINE_S = 60


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


# --------------------------------------------------- searchers, no runtime
def _space(mod, grid: bool = True) -> dict:
    out = {"lr": mod.loguniform(1e-4, 1e-1), "wd": mod.uniform(0, 1),
           "layers": mod.randint(1, 5), "act": mod.choice(["relu", "tanh", [1, 2]]),
           "fixed": 7}
    if grid:
        out["bs"] = mod.grid_search([32, 64])
    return out


def _drain(searcher, n: int = 1000) -> list:
    out = []
    for i in range(n):
        cfg = searcher.suggest(f"t{i}")
        if cfg is None:
            break
        out.append(cfg)
    return out


def test_basic_variant_generator_draws_match_reference():
    for seed in (0, 1, 7):
        want = _drain(j_search.BasicVariantGenerator(_space(j_search), 5, seed=seed))
        got = _drain(search.BasicVariantGenerator(_space(search), 5, seed=seed))
        assert len(got) == 10 and got == want
        assert {c["bs"] for c in got} == {32, 64}


def _objective(cfg: dict) -> float:
    return (math.log(cfg["lr"]) + 5) ** 2 + (cfg["wd"] - 0.3) ** 2 + cfg["layers"] * 0.1 \
        + (0.5 if cfg["act"] == "tanh" else 0.0)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_tpe_searcher_matches_reference_on_a_scripted_stream(mode):
    """Startup draws, then TPE suggestions from the same history, with
    repeated reports a trial (the best one is kept)."""
    ref = j_search.TPESearcher(_space(j_search, grid=False), metric="loss", mode=mode,
                               num_samples=30, n_startup=6, seed=3)
    port = search.TPESearcher(_space(search, grid=False), metric="loss", mode=mode,
                              num_samples=30, n_startup=6, seed=3)
    for i in range(31):
        tid = f"t{i}"
        want, got = ref.suggest(tid), port.suggest(tid)
        assert got == want, i
        if want is None:
            break
        for step in range(2):
            result = {"loss": _objective(want) + step * 0.01}
            ref.on_trial_complete(tid, result)
            port.on_trial_complete(tid, result)
    assert port.suggest("extra") is None
    with pytest.raises(ValueError, match="grid_search"):
        search.TPESearcher(_space(search))


def test_optuna_search_is_gated_like_the_reference():
    try:
        import optuna  # noqa: F401
    except ImportError:
        for mod in (j_search, search):
            with pytest.raises(ImportError, match="TPESearcher"):
                mod.OptunaSearch({"x": mod.uniform(0, 1)})
    else:
        s = search.OptunaSearch({"x": search.uniform(0, 1)}, num_samples=2)
        assert s.suggest("t0")


# --------------------------------------------------- schedulers, no runtime
def _stream(n_trials: int, n_iters: int, seed: int) -> list:
    """(trial, result) in a round-robin interleaving with some trials ahead."""
    r = np.random.default_rng(seed)
    base = {f"t{i}": float(r.uniform(0, 1)) for i in range(n_trials)}
    events = []
    for it in range(1, n_iters + 1):
        for tid in r.permutation(list(base)):
            events.append((str(tid), {"loss": base[tid] + 0.05 * r.normal(),
                                      "score": (1 - base[tid]) * it,
                                      "training_iteration": it}))
    return events


SCHEDULERS = {
    "fifo": lambda m: m.FIFOScheduler(),
    "asha": lambda m: m.ASHAScheduler(metric="loss", mode="min", grace_period=1,
                                      reduction_factor=2, max_t=9),
    "asha_max": lambda m: m.ASHAScheduler(metric="score", mode="max", grace_period=2,
                                          reduction_factor=3, max_t=6),
    "median": lambda m: m.MedianStoppingRule(metric="loss", mode="min", grace_period=2,
                                             min_samples_required=2),
    "pbt": lambda m: m.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": (0.001, 1.0), "opt": ["sgd", "adam"]}, seed=0),
    "pb2": lambda m: m.PB2(metric="loss", mode="min", perturbation_interval=2,
                           hyperparam_mutations={"lr": (0.0, 1.0), "mom": (0.5, 0.99)},
                           seed=1),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_decisions_match_reference(name):
    """Each scheduler, seeded alike, over the same 6 trials x 8 reports:
    the same decisions and the same exploit configs, report by report."""
    ref, port = SCHEDULERS[name](j_sched), SCHEDULERS[name](schedulers)
    configs = {f"t{i}": {"lr": 0.1 * (i + 1), "mom": 0.9, "opt": "sgd"} for i in range(6)}
    for tid, cfg in configs.items():
        for s in (ref, port):
            if hasattr(s, "record_config"):
                s.record_config(tid, cfg)
    decisions, exploits = [], []
    for tid, result in _stream(6, 8, seed=2):
        want, got = ref.on_result(tid, dict(result)), port.on_result(tid, dict(result))
        assert got == want, (tid, result)
        exploit = port.exploit_config(tid)
        assert exploit == ref.exploit_config(tid)
        decisions.append(got)
        exploits += [exploit] if exploit is not None else []
    if name in ("asha", "asha_max", "median"):
        assert schedulers.STOP in decisions  # the stream exercises stopping
    if name in ("pbt", "pb2"):
        assert exploits and port._latest == ref._latest  # and exploiting


def test_create_bohb_matches_reference():
    space_j, space_p = _space(j_search, grid=False), _space(search, grid=False)
    (j_s, j_q), (p_s, p_q) = (j_sched.create_bohb(space_j, num_samples=12, seed=1),
                              schedulers.create_bohb(space_p, num_samples=12, seed=1))
    assert isinstance(p_s, schedulers.ASHAScheduler) and isinstance(p_q, search.TPESearcher)
    for i in range(12):
        want, got = j_q.suggest(f"t{i}"), p_q.suggest(f"t{i}")
        assert got == want
        result = {"loss": _objective(want), "training_iteration": 1}
        assert p_s.on_result(f"t{i}", result) == j_s.on_result(f"t{i}", result)
        j_q.on_trial_complete(f"t{i}", result)
        p_q.on_trial_complete(f"t{i}", result)


# -------------------------------------------------------- on the runtime
def test_tuner_finds_best(runtime):
    def objective(config):
        report({"loss": (config["x"] - 3.0) ** 2})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
    ).fit()
    best = grid.get_best_result()
    assert best.config["x"] == 3.0 and best.metrics["loss"] == 0.0
    assert len(grid) == 4 and {r.state for r in grid} == {"COMPLETED"}
    assert all(r.metrics["training_iteration"] == 1 for r in grid)


def test_trial_error_recorded(runtime):
    def bad(config):
        if config["x"] == 1:
            raise RuntimeError("trial blew up")
        report({"loss": 0})

    grid = tune.Tuner(bad, param_space={"x": tune.grid_search([0, 1])},
                      tune_config=tune.TuneConfig()).fit()
    assert sorted(r.state for r in grid) == ["COMPLETED", "ERRORED"]
    errored = [r for r in grid if r.state == "ERRORED"][0]
    assert "trial blew up" in errored.error
    with pytest.raises(ValueError, match="No trial reported"):
        tune.Tuner(lambda cfg: None, param_space={"x": 1}).fit().get_best_result()


def test_asha_stops_bad_trials(runtime):
    iterations = {}

    def objective(config):
        for i in range(1, 10):
            iterations[config["x"]] = i
            report({"loss": config["x"] * 1.0, "training_iteration": i})
            time.sleep(0.01)

    sched = tune.ASHAScheduler(metric="loss", mode="min", grace_period=1,
                               reduction_factor=2, max_t=9)
    grid = tune.Tuner(
        objective, param_space={"x": tune.grid_search([1, 2, 3, 4])},
        tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=sched,
                                    max_concurrent_trials=4),
    ).fit()
    assert iterations[4] < 9  # the worst trial stopped at a report
    assert grid.get_best_result().config["x"] == 1
    # max_t ends the best at its 9th report; the rung cut the others earlier
    early = [r for r in grid if r.state == "TERMINATED" and len(r.metrics_history) < 9]
    assert early and all(r.config["x"] != 1 for r in early)


def test_pbt_exploits_leader(runtime):
    sched = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": (0.001, 1.0)}, seed=0)
    gate = threading.Barrier(4)  # one round of overlap, as the reference's test forces

    def objective(config):
        lr = config["lr"]
        try:
            gate.wait(timeout=20)
        except threading.BrokenBarrierError:
            pass
        for i in range(1, 9):
            report({"score": lr * i, "training_iteration": i})
            lr = config["lr"]  # may be updated by exploit
            time.sleep(0.01)

    grid = tune.Tuner(
        objective, param_space={"lr": tune.grid_search([0.001, 0.01, 0.5, 0.9])},
        tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=sched,
                                    max_concurrent_trials=4),
    ).fit()
    assert len(grid) == 4
    assert [r.config["lr"] for r in grid] != [0.001, 0.01, 0.5, 0.9]


def test_run_and_dataframe(runtime):
    grid = tune.run(lambda cfg: report({"loss": cfg["a"]}),
                    config={"a": tune.grid_search([2, 1])}, metric="loss", mode="min")
    assert grid.get_best_result().config["a"] == 1
    df = grid.get_dataframe()
    assert len(df) == 2 and {"trial_id", "state", "config/a", "loss"} <= set(df.columns)
    assert sorted(df["loss"]) == [1, 2]


def test_callbacks_fire_in_order_and_a_broken_one_is_contained(runtime):
    events = []

    class Recorder(air.Callback):
        def setup(self, experiment_name=None):
            events.append(("setup", experiment_name))

        def on_trial_start(self, trial_id, config):
            events.append(("start", trial_id, config["x"]))

        def on_trial_result(self, trial_id, result):
            events.append(("result", trial_id, result["loss"]))

        def on_trial_complete(self, trial_id, last_result, error=None):
            events.append(("complete", trial_id, last_result["loss"], error))

        def on_experiment_end(self, results):
            events.append(("end", len(results)))

    class Broken(air.Callback):
        def on_trial_result(self, trial_id, result):
            raise RuntimeError("tracker outage")

    def trainable(config):
        for i in range(3):
            report({"loss": config["x"] / (i + 1)})

    grid = tune.Tuner(trainable, param_space={"x": tune.grid_search([1.0, 2.0])},
                      tune_config=tune.TuneConfig(max_concurrent_trials=1),
                      run_config=air.RunConfig(name="exp", callbacks=[Broken(), Recorder()])
                      ).fit()
    assert [r.state for r in grid] == ["COMPLETED", "COMPLETED"]
    want = [("setup", "exp")]
    for tid, x in (("trial_00000", 1.0), ("trial_00001", 2.0)):
        want += [("start", tid, x)] + [("result", tid, x / (i + 1)) for i in range(3)]
        want.append(("complete", tid, x / 3, None))
    assert events == want + [("end", 2)]


def test_train_context_outside_a_trial():
    from ray_tpu_torch.train import Checkpoint, context, get_context

    ctx = get_context()
    assert (ctx.get_world_rank(), ctx.get_world_size()) == (0, 1)
    report({"loss": 1.0})  # no report_fn: a no-op outside a trial
    seen = []
    context.set_context(context.TrainContext(rank=2, world_size=4,
                                             report_fn=lambda m, c: seen.append((m, c))))
    try:
        ckpt = Checkpoint.from_directory(".")
        report({"loss": 2.0}, ckpt)
        assert seen == [({"loss": 2.0}, ckpt)] and ckpt.as_directory() == ckpt.path
        assert get_context().get_world_rank() == 2
    finally:
        context.set_context(context.TrainContext())
    cfg = air.RunConfig(name="n", storage_path="/x")
    assert cfg.resolved_storage_path() == "/x" and cfg.failure_config.max_failures == 0
