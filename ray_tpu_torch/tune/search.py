"""Search spaces + search algorithms (a copy of ray_tpu/tune/search.py: the
same seed gives the same samples).

Parity: python/ray/tune/search/ — sample.py distributions (uniform, loguniform,
choice, randint, grid_search) and basic_variant.py (BasicVariantGenerator:
grid expansion × random sampling). Optuna/hyperopt-style suggesters plug in via
the same ``Searcher`` interface (suggest/on_trial_complete).
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Any, Callable, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class Randint(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    options: list

    def sample(self, rng):
        return rng.choice(self.options)


@dataclass
class GridSearch:
    values: list


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> Randint:
    return Randint(low, high)


def choice(options) -> Choice:
    return Choice(list(options))


def grid_search(values) -> GridSearch:
    return GridSearch(list(values))


class Searcher:
    """Reference: tune/search/searcher.py Searcher interface."""

    def suggest(self, trial_id: str) -> Optional[dict]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid × random expansion (reference: tune/search/basic_variant.py)."""

    def __init__(self, param_space: dict, num_samples: int = 1, seed: int | None = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        grid_keys = [k for k, v in param_space.items() if isinstance(v, GridSearch)]
        grids = [param_space[k].values for k in grid_keys]
        self._grid_points = [dict(zip(grid_keys, combo)) for combo in itertools.product(*grids)] or [{}]
        self._emitted = 0
        self.total = len(self._grid_points) * num_samples

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._emitted >= self.total:
            return None
        grid = self._grid_points[self._emitted % len(self._grid_points)]
        cfg = {}
        for k, v in self.param_space.items():
            if k in grid:
                cfg[k] = grid[k]
            elif isinstance(v, Domain):
                cfg[k] = v.sample(self.rng)
            else:
                cfg[k] = v
        self._emitted += 1
        return cfg


def _reject_grid(param_space: dict, who: str) -> None:
    """Model-based searchers sample, they don't enumerate: a GridSearch entry
    would otherwise pass through verbatim as a config value."""
    for k, v in param_space.items():
        if isinstance(v, GridSearch):
            raise ValueError(
                f"{who} does not support grid_search entries (param {k!r}); "
                "use tune.choice(...) or BasicVariantGenerator")


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (reference: the optuna-backed
    tune/search/optuna default sampler, implemented natively).

    History splits into good/bad by the gamma quantile; numeric params draw
    candidates from Gaussians centered on good observations and are scored by
    the good/bad density ratio; categorical params sample from smoothed good
    counts. Falls back to random until n_startup observations exist."""

    def __init__(self, param_space: dict, metric: str = "loss",
                 mode: str = "min", num_samples: int = 64,
                 n_startup: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int | None = None):
        _reject_grid(param_space, "TPESearcher")
        self.param_space = param_space
        self.metric, self.mode = metric, mode
        self.num_samples = num_samples
        self.n_startup, self.gamma, self.n_candidates = n_startup, gamma, n_candidates
        self.rng = random.Random(seed)
        self._configs: dict[str, dict] = {}
        self._values: dict[str, float] = {}
        self._emitted = 0

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        if result is None or self.metric not in result:
            return
        v = float(result[self.metric])
        if trial_id in self._values:
            self._values[trial_id] = (min if self.mode == "min" else max)(
                self._values[trial_id], v)
        else:
            self._values[trial_id] = v

    def _split(self):
        done = [(self._values[t], self._configs[t]) for t in self._values
                if t in self._configs]
        done.sort(key=lambda kv: kv[0], reverse=(self.mode == "max"))
        k = max(1, int(len(done) * self.gamma))
        return [c for _, c in done[:k]], [c for _, c in done[k:]]

    @staticmethod
    def _kde_logpdf(x: float, obs: list, bw: float) -> float:
        if not obs:
            return -1e9
        s = sum(math.exp(-0.5 * ((x - o) / bw) ** 2) for o in obs)
        return math.log(s / (len(obs) * bw) + 1e-300)

    def _suggest_param(self, key, dom, good, bad):
        if isinstance(dom, Choice):
            counts = {o if not isinstance(o, (list, dict)) else repr(o): 1.0
                      for o in dom.options}
            for c in good:
                v = c.get(key)
                kk = v if not isinstance(v, (list, dict)) else repr(v)
                if kk in counts:
                    counts[kk] += 1.0
            opts, weights = zip(*[(o, counts[o if not isinstance(o, (list, dict))
                                             else repr(o)]) for o in dom.options])
            return self.rng.choices(list(opts), weights=list(weights))[0]
        if isinstance(dom, (Uniform, LogUniform, Randint)):
            log = isinstance(dom, LogUniform)
            if isinstance(dom, Randint):
                lo, hi = dom.low, dom.high - 1  # Randint.high is exclusive
            elif log:
                lo, hi = math.log(dom.low), math.log(dom.high)
            else:
                lo, hi = dom.low, dom.high
            xf = (lambda v: math.log(v)) if log else float
            g = [xf(c[key]) for c in good if key in c]
            b = [xf(c[key]) for c in bad if key in c]
            bw = max((hi - lo) / 5.0, 1e-12)
            best, best_score = None, -1e18
            for _ in range(self.n_candidates):
                center = self.rng.choice(g) if g else self.rng.uniform(lo, hi)
                x = min(max(self.rng.gauss(center, bw), lo), hi)
                score = self._kde_logpdf(x, g, bw) - self._kde_logpdf(x, b, bw)
                if score > best_score:
                    best, best_score = x, score
            out = math.exp(best) if log else best
            return int(round(out)) if isinstance(dom, Randint) else out
        return dom  # fixed value

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._emitted >= self.num_samples:
            return None
        self._emitted += 1
        if len(self._values) < self.n_startup:
            cfg = {k: (v.sample(self.rng) if isinstance(v, Domain) else v)
                   for k, v in self.param_space.items()}
        else:
            good, bad = self._split()
            cfg = {k: (self._suggest_param(k, v, good, bad)
                       if isinstance(v, Domain) else v)
                   for k, v in self.param_space.items()}
        self._configs[trial_id] = dict(cfg)
        return cfg


class OptunaSearch(Searcher):
    """Adapter for optuna samplers (reference: tune/search/optuna/).

    Optional dependency: raises a clear ImportError at construction when
    optuna isn't installed (it is not part of this image)."""

    def __init__(self, param_space: dict, metric: str = "loss",
                 mode: str = "min", num_samples: int = 64, sampler=None):
        try:
            import optuna  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the 'optuna' package; use the native "
                "TPESearcher for an equivalent built-in sampler"
            ) from e
        import optuna

        _reject_grid(param_space, "OptunaSearch")
        self.param_space = param_space
        self.metric, self.mode = metric, mode
        self.num_samples = num_samples
        self._study = optuna.create_study(
            direction="minimize" if mode == "min" else "maximize",
            sampler=sampler)
        self._trials: dict[str, object] = {}
        self._best: dict[str, float] = {}
        self._emitted = 0

    def _flush_tells(self) -> None:
        """Report each buffered trial's BEST value to the study. Deferred to
        suggestion time because the tuner calls on_trial_complete per report
        and optuna accepts exactly one tell per trial — telling the first
        report would train the sampler on warm-up noise."""
        for tid, best in list(self._best.items()):
            t = self._trials.pop(tid, None)
            if t is not None:
                try:
                    self._study.tell(t, best)
                except Exception:
                    pass
            self._best.pop(tid, None)

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._emitted >= self.num_samples:
            return None
        self._flush_tells()
        self._emitted += 1
        t = self._study.ask()
        cfg = {}
        for k, v in self.param_space.items():
            if isinstance(v, Uniform):
                cfg[k] = t.suggest_float(k, v.low, v.high)
            elif isinstance(v, LogUniform):
                cfg[k] = t.suggest_float(k, v.low, v.high, log=True)
            elif isinstance(v, Randint):
                cfg[k] = t.suggest_int(k, v.low, v.high - 1)
            elif isinstance(v, Choice):
                cfg[k] = t.suggest_categorical(k, v.options)
            else:
                cfg[k] = v
        self._trials[trial_id] = t
        return cfg

    def on_trial_complete(self, trial_id: str, result: dict | None) -> None:
        if trial_id not in self._trials or not result or self.metric not in result:
            return
        v = float(result[self.metric])
        cur = self._best.get(trial_id)
        better = (min if self.mode == "min" else max)
        self._best[trial_id] = v if cur is None else better(cur, v)
