"""Tuner + TuneController: trial orchestration over the port's in-process
runtime (the port of ray_tpu/tune/tuner.py).

Parity: python/ray/tune/ — Tuner (tuner.py:43), tune.run (tune.py:267),
TuneController (execution/tune_controller.py:72): an event loop launching trial
actors under a concurrency cap, routing their reports through the searcher and
scheduler, early-stopping per scheduler decisions, tracking a ResultGrid.
Each trial is a thread actor of ``ray_tpu_torch``'s runtime
(``max_concurrency=4``) whose function runs on a daemon thread; a stop
decision takes effect at the trial's next ``report`` (``_TrialStopped``), and
every trial's actor is killed when it finishes. Trials hold no tensors of
their own: a trainable that builds a learner picks its device.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable

import ray_tpu_torch
from ray_tpu_torch.air.callbacks import invoke as _cb
from ray_tpu_torch.train.context import TrainContext, set_context
from ray_tpu_torch.tune.schedulers import STOP, FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher


@dataclass
class TuneConfig:
    """Reference: tune/tune_config.py."""

    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    search_alg: Searcher | None = None
    scheduler: TrialScheduler | None = None


@dataclass
class TrialResult:
    trial_id: str
    config: dict
    metrics: dict = field(default_factory=dict)
    metrics_history: list = field(default_factory=list)
    error: str | None = None
    state: str = "PENDING"


class ResultGrid:
    """Reference: tune/result_grid.py."""

    def __init__(self, results: list[TrialResult], metric: str, mode: str):
        self._results = results
        self.metric = metric
        self.mode = mode

    def __len__(self):
        return len(self._results)

    def __iter__(self):
        return iter(self._results)

    def __getitem__(self, i):
        return self._results[i]

    def get_best_result(self, metric: str | None = None, mode: str | None = None) -> TrialResult:
        metric = metric or self.metric
        mode = mode or self.mode
        done = [r for r in self._results if r.metrics.get(metric) is not None]
        if not done:
            raise ValueError("No trial reported the target metric")
        return sorted(done, key=lambda r: r.metrics[metric], reverse=(mode == "max"))[0]

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = {"trial_id": r.trial_id, "state": r.state, **{f"config/{k}": v for k, v in r.config.items()}}
            row.update(r.metrics)
            rows.append(row)
        return pd.DataFrame(rows)


class _TrialRunner:
    """Actor hosting one trial's function (reference: tune Trainable/actor)."""

    def __init__(self, trial_id: str, config: dict):
        self.trial_id = trial_id
        self.config = config
        self._reports: "queue.Queue[dict]" = queue.Queue()
        self._done = threading.Event()
        self._stop = threading.Event()
        self._error: str | None = None
        self._new_config: dict | None = None
        self._lock = threading.Lock()

    def run(self, fn: Callable) -> None:
        def report_fn(metrics, checkpoint=None):
            self._reports.put(dict(metrics))
            if self._stop.is_set():
                raise _TrialStopped()

        def target():
            set_context(TrainContext(rank=0, world_size=1, report_fn=report_fn))
            try:
                fn(self.config)
            except _TrialStopped:
                pass
            except BaseException:  # noqa: BLE001
                self._error = traceback.format_exc()
            finally:
                self._done.set()

        threading.Thread(target=target, daemon=True, name=f"trial-{self.trial_id}").start()

    def poll(self) -> dict:
        finished = self._done.is_set()
        reports = []
        try:
            while True:
                reports.append(self._reports.get_nowait())
        except queue.Empty:
            pass
        return {"reports": reports, "finished": finished,
                "error": self._error if finished else None}

    def stop(self) -> None:
        self._stop.set()

    def update_config(self, config: dict) -> None:
        with self._lock:
            self.config.update(config)


class _TrialStopped(Exception):
    pass


class Tuner:
    """Reference: tune/tuner.py:43."""

    def __init__(self, trainable: Callable, *, param_space: dict | None = None,
                 tune_config: TuneConfig | None = None, run_config=None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        searcher = tc.search_alg or BasicVariantGenerator(self.param_space, tc.num_samples)
        scheduler = tc.scheduler or FIFOScheduler()
        callbacks = list(getattr(self.run_config, "callbacks", None) or [])
        _cb(callbacks, "setup", getattr(self.run_config, "name", None))
        results: list[TrialResult] = []
        running: dict[str, tuple] = {}  # trial_id -> (actor, TrialResult, iteration)
        trial_counter = 0
        actor_cls = ray_tpu_torch.remote(num_cpus=1, max_concurrency=4)(_TrialRunner)

        def launch_next() -> bool:
            nonlocal trial_counter
            trial_id = f"trial_{trial_counter:05d}"
            cfg = searcher.suggest(trial_id)
            if cfg is None:
                return False
            trial_counter += 1
            tr = TrialResult(trial_id, dict(cfg), state="RUNNING")
            results.append(tr)
            _cb(callbacks, "on_trial_start", trial_id, dict(cfg))
            if hasattr(scheduler, "record_config"):
                scheduler.record_config(trial_id, cfg)
            actor = actor_cls.remote(trial_id, cfg)
            ray_tpu_torch.get(actor.run.remote(self.trainable))
            running[trial_id] = [actor, tr, 0]
            return True

        exhausted = False
        while not exhausted or running:
            while not exhausted and len(running) < tc.max_concurrent_trials:
                if not launch_next():
                    exhausted = True
            polls = {tid: ray_tpu_torch.get(entry[0].poll.remote()) for tid, entry in running.items()}
            for tid, poll in polls.items():
                actor, tr, iteration = running[tid]
                for rep in poll["reports"]:
                    iteration += 1
                    running[tid][2] = iteration
                    rep.setdefault("training_iteration", iteration)
                    tr.metrics = rep
                    tr.metrics_history.append(rep)
                    _cb(callbacks, "on_trial_result", tid, rep)
                    searcher.on_trial_complete(tid, rep)
                    decision = scheduler.on_result(tid, rep)
                    new_cfg = scheduler.exploit_config(tid)
                    if new_cfg is not None:
                        tr.config.update(new_cfg)
                        ray_tpu_torch.get(actor.update_config.remote(new_cfg))
                    if decision == STOP:
                        ray_tpu_torch.get(actor.stop.remote())
                        tr.state = "TERMINATED"
                if poll["finished"]:
                    tr.error = poll["error"]
                    tr.state = "ERRORED" if poll["error"] else (
                        "TERMINATED" if tr.state == "TERMINATED" else "COMPLETED"
                    )
                    _cb(callbacks, "on_trial_complete", tid, tr.metrics, tr.error)
                    ray_tpu_torch.kill(actor)
                    del running[tid]
            time.sleep(0.02)
        grid = ResultGrid(results, tc.metric, tc.mode)
        _cb(callbacks, "on_experiment_end", grid)
        return grid


def run(trainable: Callable, *, config: dict | None = None, num_samples: int = 1,
        metric: str = "loss", mode: str = "min", scheduler=None, **kw) -> ResultGrid:
    """Reference: tune.run (tune/tune.py:267) — functional entrypoint."""
    return Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(metric=metric, mode=mode, num_samples=num_samples,
                               scheduler=scheduler),
    ).fit()
