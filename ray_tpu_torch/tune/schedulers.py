"""Trial schedulers: ASHA (async successive halving) + PBT (a copy of
ray_tpu/tune/schedulers.py: the same seed and results give the same
decisions).

Parity: python/ray/tune/schedulers/ — async_hyperband.py (ASHAScheduler) and
pbt.py (PopulationBasedTraining). The scheduler sees per-trial reports and
returns CONTINUE/STOP; PBT additionally mutates lagging trials from leaders.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def on_result(self, trial_id: str, result: dict) -> str:
        return CONTINUE

    def exploit_config(self, trial_id: str) -> Optional[dict]:
        return None


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Async successive halving (reference: tune/schedulers/async_hyperband.py).

    At each rung (iteration = grace_period * reduction_factor^k) a trial stops
    unless its metric is in the top 1/reduction_factor of completed rung entries.
    """

    def __init__(self, metric: str = "loss", mode: str = "min", grace_period: int = 1,
                 reduction_factor: int = 3, max_t: int = 100, time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self.time_attr = time_attr
        self._rungs: dict[int, list[float]] = defaultdict(list)

    def _rung_for(self, t: int) -> int | None:
        r = self.grace
        while r <= self.max_t:
            if t == r:
                return r
            r *= self.rf
        return None

    def on_result(self, trial_id: str, result: dict) -> str:
        t = int(result.get(self.time_attr, 0))
        if t >= self.max_t:
            return STOP
        rung = self._rung_for(t)
        if rung is None:
            return CONTINUE
        val = result.get(self.metric)
        if val is None:
            return CONTINUE
        rung_vals = self._rungs[rung]
        rung_vals.append(float(val))
        if len(rung_vals) < self.rf:
            return CONTINUE  # not enough peers yet: optimistic continue (async)
        ordered = sorted(rung_vals, reverse=(self.mode == "max"))
        cutoff = ordered[max(0, len(ordered) // self.rf - 1)]
        good = val >= cutoff if self.mode == "max" else val <= cutoff
        return CONTINUE if good else STOP


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py): at each perturbation interval,
    bottom-quantile trials copy a top-quantile trial's config (exploit) and
    perturb it (explore)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 2, quantile_fraction: float = 0.25,
                 hyperparam_mutations: dict | None = None, seed: int | None = None,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.quantile = quantile_fraction
        self.mutations = hyperparam_mutations or {}
        self.time_attr = time_attr
        self.rng = random.Random(seed)
        self._latest: dict[str, tuple[float, dict]] = {}  # trial -> (metric, config)
        self._exploit: dict[str, dict] = {}

    def record_config(self, trial_id: str, config: dict) -> None:
        self._latest.setdefault(trial_id, (float("-inf") if self.mode == "max" else float("inf"), dict(config)))

    def on_result(self, trial_id: str, result: dict) -> str:
        val = result.get(self.metric)
        if val is None:
            return CONTINUE
        _, cfg = self._latest.get(trial_id, (None, {}))
        self._latest[trial_id] = (float(val), cfg)
        t = int(result.get(self.time_attr, 0))
        if t > 0 and t % self.interval == 0 and len(self._latest) >= 3:
            ranked = sorted(self._latest.items(), key=lambda kv: kv[1][0],
                            reverse=(self.mode == "max"))
            n = len(ranked)
            k = max(1, int(n * self.quantile))
            top = ranked[:k]
            bottom_ids = {tid for tid, _ in ranked[-k:]}
            if trial_id in bottom_ids:
                leader_id, (lval, lcfg) = self.rng.choice(top)
                if leader_id != trial_id:
                    self._exploit[trial_id] = self._perturb(lcfg)
        return CONTINUE

    def _perturb(self, config: dict) -> dict:
        out = dict(config)
        for k, spec in self.mutations.items():
            if callable(spec):
                out[k] = spec()
            elif isinstance(spec, list):
                out[k] = self.rng.choice(spec)
            elif isinstance(spec, tuple) and len(spec) == 2:
                factor = self.rng.choice([0.8, 1.2])
                out[k] = min(max(out.get(k, spec[0]) * factor, spec[0]), spec[1])
        return out

    def exploit_config(self, trial_id: str) -> Optional[dict]:
        """Trial-side poll: new config to adopt, if any (cleared on read)."""
        cfg = self._exploit.pop(trial_id, None)
        if cfg is not None:
            cur = self._latest.get(trial_id)
            if cur:
                self._latest[trial_id] = (cur[0], dict(cfg))
        return cfg


class MedianStoppingRule(TrialScheduler):
    """Stop trials whose running-average is worse than the median of the
    other trials' running averages at the same step (reference:
    tune/schedulers/median_stopping_rule.py)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 3, min_samples_required: int = 3):
        self.metric, self.mode = metric, mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: dict[str, list[float]] = {}

    def on_result(self, trial_id: str, result: dict) -> str:
        val = result.get(self.metric)
        if val is None:
            return CONTINUE
        hist = self._history.setdefault(trial_id, [])
        hist.append(float(val))
        t = len(hist)
        if t < self.grace_period:
            return CONTINUE
        means = [sum(h[:t]) / min(t, len(h))
                 for tid, h in self._history.items()
                 if tid != trial_id and len(h) >= t]
        if len(means) < self.min_samples:
            return CONTINUE
        means.sort()
        median = means[len(means) // 2]
        mine = sum(hist) / t
        worse = mine > median if self.mode == "min" else mine < median
        return STOP if worse else CONTINUE


class PB2(PopulationBasedTraining):
    """PBT with model-based exploration (reference: tune/schedulers/pb2.py):
    instead of random perturbation factors, continuous hyperparams are chosen
    by GP-UCB over the population's (config -> score improvement) history —
    a small RBF-kernel GP fit in numpy at each exploit."""

    def __init__(self, *args, ucb_beta: float = 2.0, n_candidates: int = 32, **kw):
        super().__init__(*args, **kw)
        self.ucb_beta = ucb_beta
        self.n_candidates = n_candidates
        # (normalized config vector, score delta) observations per exploit key
        self._obs: list[tuple[list, float]] = []
        self._prev_scores: dict[str, float] = {}

    def _bounds(self):
        return {k: spec for k, spec in self.mutations.items()
                if isinstance(spec, tuple) and len(spec) == 2}

    def _norm(self, cfg: dict) -> list:
        return [(float(cfg.get(k, lo)) - lo) / max(hi - lo, 1e-12)
                for k, (lo, hi) in sorted(self._bounds().items())]

    def on_result(self, trial_id: str, result: dict) -> str:
        val = result.get(self.metric)
        if val is not None:
            prev = self._prev_scores.get(trial_id)
            if prev is not None:
                _, cfg = self._latest.get(trial_id, (None, {}))
                delta = float(val) - prev
                if self.mode == "min":
                    delta = -delta
                self._obs.append((self._norm(cfg), delta))
                self._obs = self._obs[-64:]  # bounded history
            self._prev_scores[trial_id] = float(val)
        return super().on_result(trial_id, result)

    def _gp_fit(self, X, y):
        """Factor the GP once; returns ucb(x) doing only mat-vec work per
        candidate (K is shared across all candidates of one exploit)."""
        import numpy as np

        X, y = np.asarray(X, float), np.asarray(y, float)
        if not len(X):
            return lambda x: 0.0
        ys = (y - y.mean()) / (y.std() + 1e-9)
        ls, noise = 0.3, 1e-2

        def k(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * ls * ls))

        K = k(X, X) + noise * np.eye(len(X))
        try:
            K_inv = np.linalg.inv(K)
        except np.linalg.LinAlgError:
            return lambda x: 0.0
        alpha = K_inv @ ys
        beta = self.ucb_beta

        def ucb(x):
            kx = k(X, np.asarray(x, float)[None])[:, 0]
            mu = float(kx @ alpha)
            var = float(1.0 - kx @ (K_inv @ kx))
            return mu + beta * math.sqrt(max(var, 1e-12))

        return ucb

    def _perturb(self, config: dict) -> dict:
        bounds = self._bounds()
        if not bounds:
            return super()._perturb(config)
        out = dict(config)
        # non-tuple mutations keep PBT behavior
        for k, spec in self.mutations.items():
            if callable(spec):
                out[k] = spec()
            elif isinstance(spec, list):
                out[k] = self.rng.choice(spec)
        ucb = self._gp_fit([v for v, _ in self._obs], [d for _, d in self._obs])
        best_cfg, best_score = None, float("-inf")
        for _ in range(self.n_candidates):
            cand = dict(out)
            for k, (lo, hi) in bounds.items():
                cand[k] = self.rng.uniform(lo, hi)
            score = ucb(self._norm(cand))
            if score > best_score:
                best_cfg, best_score = cand, score
        return best_cfg or out


def create_bohb(param_space: dict, metric: str = "loss", mode: str = "min",
                num_samples: int = 64, max_t: int = 100,
                reduction_factor: int = 3, seed: int | None = None):
    """BOHB (reference: tune/schedulers/hb_bohb.py + search/bohb/): HyperBand-
    style successive halving (ASHA rungs) driven by a model-based sampler
    (native TPE). Returns (scheduler, searcher) to pass into TuneConfig."""
    from ray_tpu_torch.tune.search import TPESearcher

    scheduler = ASHAScheduler(metric=metric, mode=mode, max_t=max_t,
                              reduction_factor=reduction_factor)
    searcher = TPESearcher(param_space, metric=metric, mode=mode,
                           num_samples=num_samples, seed=seed)
    return scheduler, searcher
