"""User-defined and runtime metrics: Counter / Gauge / Histogram (the
process-local registry of ray_tpu/util/metrics.py, copied).

Every instrument records into this process's registry;
``prometheus_text`` renders it in the Prometheus exposition format. The
reference also ships snapshots between nodes over its ``metrics_push`` wire
op and folds them into per-node rollups; the port runs in one process, so
those have no source and ``node_io_rollup`` returns empty maps.

Hot-path contract: a subsystem that records per event binds its instrument
once via ``bind()``, which precomputes the series key, so recording is a
single locked dict update. Gauges for values that already live somewhere
attach a producer callback and cost nothing until a snapshot.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from collections import defaultdict
from typing import Callable, Iterable, Optional

_registry_lock = threading.Lock()
_registry: dict[str, "Metric"] = {}

DEFAULT_HIST_BOUNDARIES = [0.01, 0.1, 1, 10, 100]


class Metric:
    """Base instrument. Re-registering a name returns the existing
    instrument (extended with any newly declared tag keys); a name
    re-registered as a different kind raises. Construction happens entirely
    inside ``__new__`` under the registry lock, so two threads racing the
    first registration never see a half-built instrument."""

    def __new__(cls, name: str, *args, **kwargs):
        with _registry_lock:
            existing = _registry.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, not {cls.__name__}")
                existing._merge(*args, **kwargs)
                return existing
            inst = super().__new__(cls)
            inst._setup(name, *args, **kwargs)
            _registry[name] = inst
            return inst

    def __init__(self, *args, **kwargs):
        pass  # see __new__: construction is atomic with registration

    def _setup(self, name: str, description: str = "",
               tag_keys: Optional[Iterable[str]] = None) -> None:
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: dict[str, str] = {}
        self._lock = threading.Lock()

    def _merge(self, description: str = "",
               tag_keys: Optional[Iterable[str]] = None) -> None:
        """Duplicate registration: keep the live series, union tag keys."""
        if tag_keys:
            merged = dict.fromkeys(self.tag_keys)
            merged.update(dict.fromkeys(tag_keys))
            self.tag_keys = tuple(merged)
        if description and not self.description:
            self.description = description

    def set_default_tags(self, tags: dict[str, str]) -> "Metric":
        self._check_tags(tags)
        self._default_tags = dict(tags)
        return self

    def _check_tags(self, tags: dict | None) -> None:
        if not tags:
            return
        undeclared = [k for k in tags if k not in self.tag_keys]
        if undeclared:
            raise ValueError(
                f"metric {self.name!r}: tag(s) {undeclared} not declared in "
                f"tag_keys={list(self.tag_keys)} (undeclared tags would "
                "fork silent series; declare them at construction)")

    def _key(self, tags: dict | None) -> tuple:
        self._check_tags(tags)
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))

    def bind(self, tags: dict | None = None):
        """Precompute one series' key: the returned handle records with a
        single locked dict update. A Counter bind exposes only inc(), a
        Gauge only set(), a Histogram only observe()."""
        return self._bound_cls(self, self._key(tags))


class _BoundBase:
    """A (metric, series-key) pair with allocation-free record methods."""

    __slots__ = ("_m", "_k")

    def __init__(self, metric: Metric, key: tuple):
        self._m = metric
        self._k = key


class _BoundCounter(_BoundBase):
    __slots__ = ()

    def inc(self, value: float = 1.0) -> None:
        m = self._m
        with m._lock:
            m._values[self._k] += value


class _BoundGauge(_BoundBase):
    __slots__ = ()

    def set(self, value: float) -> None:
        m = self._m
        with m._lock:
            m._values[self._k] = value


class _BoundHistogram(_BoundBase):
    __slots__ = ()

    def observe(self, value: float) -> None:
        self._m._observe_key(self._k, value)


class Counter(Metric):
    _bound_cls = _BoundCounter

    def _setup(self, *args, **kwargs) -> None:
        super()._setup(*args, **kwargs)
        self._values: dict[tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0, tags: dict | None = None) -> None:
        key = self._key(tags)
        with self._lock:
            self._values[key] += value

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._values)


class Gauge(Metric):
    _bound_cls = _BoundGauge

    def _setup(self, *args, **kwargs) -> None:
        super()._setup(*args, **kwargs)
        self._values: dict[tuple, float] = {}
        self._producers: list[Callable[[], Iterable[tuple[dict, float]]]] = []

    def set(self, value: float, tags: dict | None = None) -> None:
        key = self._key(tags)
        with self._lock:
            self._values[key] = value

    def attach_producer(
            self, fn: "Callable[[], Iterable[tuple[dict, float]]]") -> None:
        """Register a callback yielding ``(tags, value)`` pairs, sampled at
        snapshot time. A producer's error is swallowed: a scrape must never
        take the process down."""
        with self._lock:
            self._producers.append(fn)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._values)
            producers = list(self._producers)
        for fn in producers:
            try:
                for tags, value in fn():
                    out[self._key(tags)] = value
            except Exception:  # noqa: BLE001 - see attach_producer
                pass
        return out


class Histogram(Metric):
    _bound_cls = _BoundHistogram

    def _setup(self, name: str, description: str = "",
               boundaries: Iterable[float] = (), tag_keys=None) -> None:
        super()._setup(name, description, tag_keys)
        self.boundaries = sorted(boundaries) or list(DEFAULT_HIST_BOUNDARIES)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)

    def _merge(self, description: str = "", boundaries: Iterable[float] = (),
               tag_keys=None) -> None:
        # boundaries are fixed at first registration
        super()._merge(description, tag_keys)

    def observe(self, value: float, tags: dict | None = None) -> None:
        self._observe_key(self._key(tags), value)

    def _observe_key(self, key: tuple, value: float) -> None:
        i = bisect_left(self.boundaries, value)
        with self._lock:
            buckets = self._counts.get(key)
            if buckets is None:
                buckets = self._counts[key] = [0] * (len(self.boundaries) + 1)
            buckets[i] += 1
            self._sums[key] += value

    def snapshot(self) -> dict:
        with self._lock:
            return {k: {"buckets": list(v), "sum": self._sums[k],
                        "boundaries": self.boundaries}
                    for k, v in self._counts.items()}


def get_metric(name: str) -> "Metric | None":
    with _registry_lock:
        return _registry.get(name)


def registry_snapshot() -> dict:
    """All metrics, for exposition."""
    with _registry_lock:
        metrics = dict(_registry)
    return {name: m.snapshot() for name, m in metrics.items() if hasattr(m, "snapshot")}


def node_io_rollup() -> dict:
    """The per-node I/O rollup the reference folds from pushed snapshots
    (pull rate and total, bytes in flight, reactor depth, holder-pending
    bytes). One process has no node pushing, so every map is empty."""
    return {"pull_rate": {}, "pull_total": {}, "inflight": {},
            "reactor_depth": {}, "holder_pending": {}}


# ---------------------------------------------------------------- exposition
def _esc_label(v) -> str:
    """Prometheus escaping for label values: backslash, double quote,
    newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(pairs: Iterable[tuple]) -> str:
    tags = ",".join(f'{k}="{_esc_label(v)}"' for k, v in pairs)
    return f"{{{tags}}}" if tags else ""


def _render_series(lines: list, name: str, key, val) -> None:
    safe = name.replace(".", "_").replace("-", "_")
    pairs = list(key)
    if isinstance(val, dict):  # histogram: cumulative le buckets incl. +Inf
        buckets = val["buckets"]
        boundaries = val.get("boundaries") or DEFAULT_HIST_BOUNDARIES
        cum = 0
        for b, n in zip(boundaries, buckets):
            cum += n
            lines.append(
                f"{safe}_bucket{_fmt_labels(pairs + [('le', b)])} {cum}")
        total = cum + (buckets[len(boundaries)]
                       if len(buckets) > len(boundaries) else 0)
        lines.append(
            f"{safe}_bucket{_fmt_labels(pairs + [('le', '+Inf')])} {total}")
        lines.append(f"{safe}_sum{_fmt_labels(pairs)} {val['sum']}")
        lines.append(f"{safe}_count{_fmt_labels(pairs)} {total}")
    else:
        lines.append(f"{safe}{_fmt_labels(pairs)} {val}")


def prometheus_text() -> str:
    """This process's registry in the Prometheus exposition format."""
    lines: list[str] = []
    for name, values in registry_snapshot().items():
        for key, val in values.items():
            _render_series(lines, name, key, val)
    return "\n".join(lines) + ("\n" if lines else "")
