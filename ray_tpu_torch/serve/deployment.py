"""Deployments: the unit of serving (copied from ray_tpu/serve/deployment.py).

The port acts on ``name``, ``num_replicas``, ``max_ongoing_requests``,
``ray_actor_options`` (``num_cpus`` and ``num_gpus``: the in-process
runtime places nothing else), ``autoscaling_config``, ``user_config``,
``route_prefix``, ``health_check_period_s`` (how often the controller
probes each replica), ``request_router`` (``"pow2"`` or ``"kv_aware"``;
another name raises ``ValueError``) and ``slo_ttft_ms`` (the TTFT the
anatomy scoreboard, admission control and the SLO autoscaler hold the
deployment to). ``compiled_dispatch`` is not ported yet: set, it raises
``NotImplementedError`` naming the ROADMAP item that brings it; nothing is
ignored silently.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class AutoscalingConfig:
    """Autoscaling bounds and delays. ``policy="ongoing_requests"``: the
    controller scales on the replicas' mean in-flight requests against
    ``target_ongoing_requests``; ``policy="slo"``: a
    ``serve.autoscale.DeploymentAutoscaler`` scales on predicted TTFT
    against the deployment's ``slo_ttft_ms``."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    policy: str = "ongoing_requests"


@dataclasses.dataclass
class DeploymentConfig:
    name: str
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    ray_actor_options: dict = dataclasses.field(default_factory=dict)
    autoscaling_config: AutoscalingConfig | None = None
    user_config: Any = None
    health_check_period_s: float = 2.0
    route_prefix: str | None = None
    request_router: str = "pow2"
    compiled_dispatch: bool = False
    slo_ttft_ms: float | None = None


# field -> (its default, the ROADMAP item that brings it)
_NOT_PORTED = {
    "compiled_dispatch": (False, "ROADMAP queue 1 item 8 (compiled graphs, which "
                                 "serve's compiled dispatch is built on)"),
}
# the request_router names serve.kv_router.make_router knows
REQUEST_ROUTERS = ("pow2", "kv_aware")


_ACTOR_OPTIONS = {"num_cpus", "num_gpus"}


def _check_ported(cfg: DeploymentConfig) -> None:
    if not cfg.health_check_period_s > 0:
        raise ValueError(f"deployment {cfg.name!r}: health_check_period_s must be > 0, "
                         f"got {cfg.health_check_period_s!r}")
    if cfg.request_router not in REQUEST_ROUTERS:
        raise ValueError(f"deployment {cfg.name!r}: unknown request_router "
                         f"{cfg.request_router!r} (known: {sorted(REQUEST_ROUTERS)})")
    other = sorted(set(cfg.ray_actor_options) - _ACTOR_OPTIONS)
    if other:
        raise NotImplementedError(
            f"deployment {cfg.name!r}: ray_actor_options {other} are not ported to "
            f"ray_tpu_torch yet (replicas are thread actors that take "
            f"{sorted(_ACTOR_OPTIONS)}); process workers and placement wait for ROADMAP "
            f"queue 1 item 4")
    for field, (default, item) in _NOT_PORTED.items():
        if getattr(cfg, field) != default:
            raise NotImplementedError(
                f"deployment {cfg.name!r}: {field}={getattr(cfg, field)!r} is not ported "
                f"to ray_tpu_torch yet; it waits for {item}")


class Deployment:
    """A configured (but not yet running) deployment."""

    def __init__(self, func_or_class, config: DeploymentConfig, init_args=(), init_kwargs=None):
        _check_ported(config)
        self.func_or_class = func_or_class
        self.config = config
        self.init_args = init_args
        self.init_kwargs = init_kwargs or {}

    def options(self, **opts) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        for k, v in opts.items():
            if not hasattr(cfg, k):
                raise ValueError(f"Unknown deployment option: {k}")
            if k == "autoscaling_config" and isinstance(v, dict):
                v = AutoscalingConfig(**v)
            setattr(cfg, k, v)
        return Deployment(self.func_or_class, cfg, self.init_args, self.init_kwargs)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(Deployment(self.func_or_class, self.config, args, kwargs))

    @property
    def name(self) -> str:
        return self.config.name


class Application:
    """A bound deployment, ready for ``serve.run``."""

    def __init__(self, deployment: Deployment):
        self.deployment = deployment


def deployment(_func_or_class=None, *, name: str | None = None, num_replicas: int = 1,
               max_ongoing_requests: int = 100, ray_actor_options: dict | None = None,
               autoscaling_config: AutoscalingConfig | dict | None = None,
               user_config: Any = None, route_prefix: str | None = None,
               request_router: str = "pow2", compiled_dispatch: bool = False,
               slo_ttft_ms: float | None = None):
    """``@serve.deployment`` decorator."""

    def wrap(target):
        auto = autoscaling_config
        if isinstance(auto, dict):
            auto = AutoscalingConfig(**auto)
        cfg = DeploymentConfig(
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options or {},
            autoscaling_config=auto,
            user_config=user_config,
            route_prefix=route_prefix,
            request_router=request_router,
            compiled_dispatch=compiled_dispatch,
            slo_ttft_ms=slo_ttft_ms,
        )
        return Deployment(target, cfg)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
