"""ServeController, replicas, router and handles (the in-process part of
ray_tpu/serve/controller.py).

- ``ReplicaActor`` hosts one replica of the user's callable.
- ``ServeController`` keeps each deployment's target replica count: its
  reconcile loop starts and stops replicas, its health loop replaces a dead
  or failing one. ``deploy`` waits for the new replicas' constructors and
  raises the first one's error, so ``serve.run`` never returns a handle
  without replicas.
- Autoscaling: a deployment with an ``AutoscalingConfig`` starts at
  ``min_replicas``; with the default ``policy="ongoing_requests"`` the
  controller polls its replicas' queue lengths each reconcile pass and the
  routers report their in-flight load, and the mean per replica moves the
  target one step toward the bounds (after ``upscale_delay_s`` /
  ``downscale_delay_s``). ``policy="slo"`` leaves the target to
  ``serve.autoscale.DeploymentAutoscaler`` through ``autoscale_view`` and
  ``set_target_replicas``. A replica a scale-down removes drains: routers
  stop sending to it at once, and it is stopped when its requests have
  returned (within GRACEFUL_SHUTDOWN_TIMEOUT_S); the reference stops it
  at once, failing what it still runs.
- ``Router`` picks a replica per request by the power of two choices on
  the requests it has in flight (``_select``; ``serve.kv_router``'s
  ``KVAwareRouter`` overrides it with prefix affinity on the hint
  ``_routing_hint`` reads from the body), and retries a request that lands
  on a replica already dead; ``DeploymentHandle`` sends calls through the
  router its deployment's ``request_router`` names, and swaps it when a
  redeploy names another.
- Request anatomy: the router stamps its decision and the replica its
  dequeue on the body's ledger (``serve.anatomy``); the controller declares
  each deployment's ``slo_ttft_ms`` and retires a removed replica's
  scoreboard entries.
- Routing epochs: versioned snapshots of the routing state (routes, each
  deployment's replicas, node map, router kind, SLO and service-time hint,
  the ingress registry) published on the retained ``"serve:epochs"``
  channel at deploy, delete, ingress (un)registration, a health drop, and
  from the reconcile loop when the routing fingerprint changed or
  EPOCH_REFRESH_S passed. The front door's ingresses route from them and
  never call the controller on the request path; ``call_counts`` counts
  the calls of each public method, so a run can show it.

Still to port (ROADMAP queue 1 items 4 and 8): the KV checkpoint of the
controller, node probes and drain, and compiled dispatch (an epoch's
``"compiled"`` is always False). In one process the HTTP proxy reads
``serve.api``'s route table, so there is no route publication to
subscribe to, and every replica is on node ``"head"``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import inspect
import logging
import random
import threading
import time

import ray_tpu_torch
from ray_tpu_torch.core.runtime import STREAMING, get_runtime
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError, TaskError
from ray_tpu_torch.serve import anatomy
from ray_tpu_torch.serve.deployment import Deployment, DeploymentConfig
from ray_tpu_torch.serve.multiplex import _set_model_id

logger = logging.getLogger("ray_tpu_torch.serve")

CONTROLLER_NAME = "_serve_controller"
# how long deploy waits for a new replica's constructor (an engine that
# draws Llama-3-8B's weights on the card takes seconds of it)
REPLICA_START_TIMEOUT_S = 300.0


class ReplicaActor:
    """Hosts one replica of the user callable."""

    def __init__(self, func_or_class, init_args, init_kwargs, user_config):
        self._is_function = inspect.isfunction(func_or_class)
        if self._is_function:
            self._callable = func_or_class
        else:
            self._callable = func_or_class(*init_args, **init_kwargs)
            if user_config is not None and hasattr(self._callable, "reconfigure"):
                self._callable.reconfigure(user_config)
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()

    def _method(self, method_name: str):
        if self._is_function:
            return self._callable
        return getattr(self._callable, method_name or "__call__")

    def _dequeue(self, args) -> None:
        """A request left the mailbox: a fresh multiplexed model id (no
        stale id across thread reuse) and the ledger's queue-wait stamp."""
        _set_model_id("")
        if args and isinstance(args[0], dict):
            anatomy.replica_dequeue(args[0])

    def handle_request(self, method_name: str, args, kwargs):
        self._dequeue(args)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            out = self._method(method_name)(*args, **kwargs)
            if inspect.iscoroutine(out):
                import asyncio

                out = asyncio.run(out)
            return out
        finally:
            with self._lock:
                self._ongoing -= 1

    def handle_streaming(self, method_name: str, args, kwargs):
        """Generator entry: the user's generator method, item by item."""
        self._dequeue(args)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            yield from self._method(method_name)(*args, **kwargs)
        finally:
            with self._lock:
                self._ongoing -= 1

    def queue_len(self) -> int:
        with self._lock:
            return self._ongoing

    def reconfigure(self, user_config) -> None:
        if not self._is_function and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    def health_check(self) -> bool:
        if not self._is_function and hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return True

    def metrics(self) -> dict:
        with self._lock:
            return {"ongoing": self._ongoing, "total": self._total}


class _DeploymentState:
    """Target against running replicas of one deployment."""

    def __init__(self, config: DeploymentConfig, deployment: Deployment):
        self.config = config
        self.deployment = deployment
        self.replicas: list = []
        self.target_replicas = _initial_target(config)
        self.version = 0
        self.last_scale_up = 0.0
        self.last_scale_down = 0.0


def _initial_target(config: DeploymentConfig) -> int:
    auto = config.autoscaling_config
    return auto.min_replicas if auto else config.num_replicas


def _retire(name: str, replicas) -> None:
    """Drop removed replicas' scoreboard entries now."""
    if replicas:
        anatomy.retire_replica(name, [r._actor_id.hex() for r in replicas])


def _kill(replica) -> None:
    try:
        ray_tpu_torch.kill(replica)
    except ValueError:  # already gone with its runtime
        pass


def _count_calls(cls):
    """Wrap each public method of ``cls`` so that ``call_counts()`` reports
    how many times it ran, whoever called it."""
    for name, fn in list(vars(cls).items()):
        if name.startswith("_") or name == "call_counts" or not inspect.isfunction(fn):
            continue

        def counted(self, *args, _fn=fn, _name=name, **kwargs):
            with self._calls_lock:
                self._calls[_name] += 1
            return _fn(self, *args, **kwargs)

        setattr(cls, name, functools.wraps(fn)(counted))
    return cls


@_count_calls
class ServeController:
    """The control-plane actor."""

    HEALTH_CHECK_FAILURE_THRESHOLD = 3
    # the health loop's tick; each replica is probed once its deployment's
    # health_check_period_s has passed since its last probe was sent
    HEALTH_CHECK_TICK_S = 0.1
    # generous: a saturated-but-healthy replica answers between requests
    HEALTH_CHECK_TIMEOUT_S = 30.0
    RECONCILE_PERIOD_S = 0.25
    # a replica a scale-down removes takes no new request once every router
    # has refreshed (DRAIN_MIN_S covers two of their refreshes), and is
    # stopped once its last request has returned, or after the timeout
    DRAIN_MIN_S = 1.0
    GRACEFUL_SHUTDOWN_TIMEOUT_S = 20.0
    # routing epochs: the controller owns desired state and pushes versioned
    # snapshots of the routing state; ingresses read them from a local
    # cache. The heartbeat republish refreshes soft hints (the service-time
    # EWMA of the admission predictors) when membership did not change.
    EPOCH_CHANNEL = "serve:epochs"
    EPOCH_REFRESH_S = 5.0

    def __init__(self):
        self._deployments: dict[str, _DeploymentState] = {}
        self._routes: dict[str, str] = {}  # route_prefix -> deployment name
        self._health_failures: dict[str, int] = {}  # replica -> consecutive fails
        self._health_probes: dict[str, tuple] = {}  # replica -> (ref, sent_ts)
        self._health_last: dict[str, float] = {}  # replica -> when its last probe went
        self._draining: list = []  # (deployment, replica, removed at) after a scale-down
        self._ingress: dict[str, tuple] = {}  # ingress key -> (host, port)
        self._lock = threading.Lock()
        self._reconcile_lock = threading.Lock()  # serializes reconcile passes
        self._epoch_lock = threading.Lock()  # serializes epoch build and publish
        # seeded from the wall clock so versions rise across controller
        # generations: the channel retains the last doc, and a new controller
        # counting from 1 would lose the version gate to its predecessor's
        self._epoch_version = int(time.time() * 1000)
        self._epoch_fp = None
        self._epoch_pub_t = 0.0
        self._epoch_last: dict | None = None
        self._calls: collections.Counter = collections.Counter()
        self._calls_lock = threading.Lock()
        self._stop = threading.Event()
        self._runtime = get_runtime()  # the loops end with it
        self._threads = [
            threading.Thread(target=self._loop, args=(self.RECONCILE_PERIOD_S,
                                                      self._reconcile_tick),
                             daemon=True, name="serve-reconcile"),
            threading.Thread(target=self._loop, args=(self.HEALTH_CHECK_TICK_S,
                                                      self._health_check_tick),
                             daemon=True, name="serve-health"),
        ]
        for t in self._threads:
            t.start()

    # ---- API ----
    def deploy(self, deployment: Deployment, route_prefix: str | None = None) -> None:
        """Deploy or redeploy (a version bump replaces every running replica),
        then wait for this version's replicas to be constructed. If one's
        constructor raises, or none is up within REPLICA_START_TIMEOUT_S,
        the deployment is removed and the error raised."""
        name = deployment.config.name
        old_replicas: list = []
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                st = _DeploymentState(deployment.config, deployment)
                self._deployments[name] = st
            else:
                st.config = deployment.config
                st.deployment = deployment
                st.version += 1
                old_replicas, st.replicas = st.replicas, []
            st.target_replicas = _initial_target(deployment.config)
            if route_prefix is not None:
                self._routes[route_prefix] = name
        for r in old_replicas:
            _kill(r)
        _retire(name, old_replicas)
        # declare the deployment's TTFT SLO to the anatomy scoreboard
        anatomy.set_slo(name, deployment.config.slo_ttft_ms)
        self._reconcile_once()
        self._publish_epoch()
        with self._lock:
            replicas = list(st.replicas)
        rt = get_runtime()
        try:
            rt.get([rt.actor_ready(r._actor_id) for r in replicas], REPLICA_START_TIMEOUT_S)
        except TaskError as e:
            self.delete_deployment(name)
            raise e.cause from e  # the replica constructor's own error
        except (GetTimeoutError, ActorDiedError):
            self.delete_deployment(name)
            raise

    def get_routes(self) -> dict[str, str]:
        with self._lock:
            return dict(self._routes)

    def call_counts(self) -> dict:
        """Calls of each public method so far (the front door's request path
        must add none)."""
        with self._calls_lock:
            return dict(self._calls)

    # ---- routing epochs: versioned snapshots over a retained channel.
    # Subscribers ignore fields they do not know and drop versions older
    # than the one they hold; a late subscriber gets the current epoch at
    # once, so an ingress serves from its first request. ----
    def _epoch_doc(self) -> dict:
        with self._lock:
            deployments = {}
            for name, st in self._deployments.items():
                reps = list(st.replicas)
                deployments[name] = {
                    "replicas": reps,
                    "nodes": {r._actor_id.hex(): "head" for r in reps},
                    "router": st.config.request_router,
                    "compiled": False,  # compiled dispatch is not ported
                    "slo_ttft_ms": st.config.slo_ttft_ms,
                    "max_ongoing_requests": st.config.max_ongoing_requests,
                    "version": st.version,
                    "target_replicas": st.target_replicas,
                }
            doc = {
                "routes": dict(self._routes),
                "deployments": deployments,
                "ingress": {k: list(v) for k, v in self._ingress.items()},
                "draining": [],  # no node drains in one process
            }
        # the admission predictor's service-time scale, outside the lock
        for name, ent in doc["deployments"].items():
            ent["service_ewma_s"] = anatomy.service_estimate(name)
        return doc

    @staticmethod
    def _epoch_fingerprint(doc: dict) -> tuple:
        return (
            tuple(sorted(doc["routes"].items())),
            tuple(sorted(
                (n, e["version"], e["target_replicas"], e["router"], e["compiled"],
                 e["slo_ttft_ms"], tuple(sorted(e["nodes"].items())))
                for n, e in doc["deployments"].items())),
            tuple(sorted((k, tuple(v)) for k, v in doc["ingress"].items())),
            tuple(doc["draining"]),
        )

    def _publish_epoch(self, force: bool = True) -> None:
        """Build and publish the next routing epoch. ``force=False`` is the
        reconcile loop's call: publish only when the routing fingerprint
        changed or the heartbeat refresh is due."""
        with self._epoch_lock:
            doc = self._epoch_doc()
            fp = self._epoch_fingerprint(doc)
            now = time.monotonic()
            if (not force and fp == self._epoch_fp
                    and now - self._epoch_pub_t < self.EPOCH_REFRESH_S):
                return
            self._epoch_version += 1
            doc["version"] = self._epoch_version
            self._epoch_fp = fp
            self._epoch_pub_t = now
            self._epoch_last = doc
            self._runtime.publisher.publish(self.EPOCH_CHANNEL, doc, retain=True)

    def get_epoch(self) -> dict:
        """The last published routing epoch (the initial sync of a consumer
        that starts before any publish reaches it)."""
        with self._epoch_lock:
            last = self._epoch_last
        if last is None:
            self._publish_epoch()
            with self._epoch_lock:
                last = self._epoch_last
        return last

    # ---- the ingress registry: the front door registers each ingress it
    # starts; the epoch's "ingress" map is what clients read ----
    def set_ingress(self, key: str, host: str, port: int) -> None:
        with self._lock:
            self._ingress[key] = (host, int(port))
        self._publish_epoch()

    def remove_ingress(self, key: str) -> None:
        with self._lock:
            existed = self._ingress.pop(key, None) is not None
        if existed:
            self._publish_epoch()

    def get_ingress(self) -> dict:
        with self._lock:
            return {k: list(v) for k, v in self._ingress.items()}

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            st = self._deployments.pop(name, None)
            self._routes = {p: n for p, n in self._routes.items() if n != name}
            draining = [r for dep, r, _ in self._draining if dep == name]
            self._draining = [e for e in self._draining if e[0] != name]
        self._publish_epoch()
        for r in draining:
            _kill(r)
        if st:
            for r in st.replicas:
                _kill(r)
            _retire(name, st.replicas)

    def get_replicas(self, name: str) -> list:
        with self._lock:
            st = self._deployments.get(name)
            return list(st.replicas) if st else []

    def get_replica_nodes(self, name: str) -> dict:
        """replica key -> node hex: every replica of one process is on
        ``"head"``."""
        with self._lock:
            st = self._deployments.get(name)
            return {r._actor_id.hex(): "head" for r in (st.replicas if st else [])}

    def get_deployment_names(self) -> list[str]:
        with self._lock:
            return list(self._deployments)

    def get_request_router(self, name: str) -> str:
        with self._lock:
            st = self._deployments.get(name)
            return st.config.request_router if st else "pow2"

    def status(self) -> dict:
        with self._lock:
            return {name: {"target_replicas": st.target_replicas,
                           "running_replicas": len(st.replicas),
                           "version": st.version}
                    for name, st in self._deployments.items()}

    def autoscale_view(self) -> dict:
        """Per-deployment scaling inputs for the SLO autoscaler: bounds and
        delays, target against running, the declared SLO, and the replica
        resource shape for standing demand."""
        out = {}
        with self._lock:
            for name, st in self._deployments.items():
                auto = st.config.autoscaling_config
                opts = st.config.ray_actor_options
                shape = {"CPU": float(opts.get("num_cpus", 1.0))}
                if opts.get("num_gpus"):
                    shape["GPU"] = float(opts["num_gpus"])
                out[name] = {
                    "autoscaling": dataclasses.asdict(auto) if auto else None,
                    "policy": auto.policy if auto else None,
                    "slo_ttft_ms": st.config.slo_ttft_ms,
                    "target_replicas": st.target_replicas,
                    "running_replicas": len(st.replicas),
                    "replica_shape": shape,
                }
        return out

    def set_target_replicas(self, name: str, target: int) -> int:
        """External actuation (serve/autoscale.py): set the desired replica
        count, clamped to the deployment's autoscaling bounds; reconcile
        starts or stops replicas. Returns the clamped target (-1: unknown
        deployment)."""
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return -1
            auto = st.config.autoscaling_config
            lo = auto.min_replicas if auto else 0
            hi = auto.max_replicas if auto else max(1, int(target))
            prev = st.target_replicas
            st.target_replicas = max(lo, min(hi, int(target)))
            now = time.monotonic()
            if st.target_replicas > prev:
                st.last_scale_up = now
            elif st.target_replicas < prev:
                st.last_scale_down = now
            return st.target_replicas

    def record_autoscaling_metrics(self, name: str, ongoing_per_replica: float) -> None:
        """The ``ongoing_requests`` policy: the mean in-flight requests per
        replica above the target scales up one step (after
        ``upscale_delay_s`` since the last step up), below half of it scales
        down one (after ``downscale_delay_s``)."""
        with self._lock:
            st = self._deployments.get(name)
            auto = st.config.autoscaling_config if st else None
            if auto is None or auto.policy == "slo":
                return  # the SLO autoscaler owns an "slo" deployment's target
            now = time.monotonic()
            if ongoing_per_replica > auto.target_ongoing_requests:
                if now - st.last_scale_up > auto.upscale_delay_s:
                    st.target_replicas = min(auto.max_replicas, st.target_replicas + 1)
                    st.last_scale_up = now
            elif ongoing_per_replica < auto.target_ongoing_requests * 0.5:
                if now - st.last_scale_down > auto.downscale_delay_s:
                    st.target_replicas = max(auto.min_replicas, st.target_replicas - 1)
                    st.last_scale_down = now

    def _autoscale_tick(self) -> None:
        """Poll the replicas' queue lengths, so an idle deployment scales
        down with no router traffic."""
        with self._lock:
            states = [(n, list(st.replicas)) for n, st in self._deployments.items()
                      if st.config.autoscaling_config is not None
                      and st.config.autoscaling_config.policy != "slo" and st.replicas]
        for name, replicas in states:
            try:
                qlens = ray_tpu_torch.get([r.queue_len.remote() for r in replicas], timeout=5)
            except Exception:  # noqa: BLE001 - a replica mid-kill: skip this pass
                continue
            self.record_autoscaling_metrics(name, sum(qlens) / max(1, len(qlens)))

    def shutdown(self) -> None:
        self._stop.set()
        for name in self.get_deployment_names():
            self.delete_deployment(name)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10)

    # ---- reconciliation and health ----
    def _loop(self, period: float, tick) -> None:
        while not self._stop.wait(period) and not self._runtime.is_shutdown:
            try:
                tick()
            except Exception:  # noqa: BLE001 - the loop must outlive one bad pass
                if not self._runtime.is_shutdown:
                    logger.exception("serve controller: %s failed", tick.__name__)

    def _reconcile_tick(self) -> None:
        self._reconcile_once()
        self._publish_epoch(force=False)  # when the routing state changed
        self._autoscale_tick()
        self._reap_drained()

    def _reap_drained(self) -> None:
        """Stop each scaled-down replica whose requests have all returned (or
        whose GRACEFUL_SHUTDOWN_TIMEOUT_S ran out), once the routers have
        dropped it."""
        now = time.monotonic()
        with self._lock:
            draining = [e for e in self._draining if now - e[2] >= self.DRAIN_MIN_S]
        done = []
        for entry in draining:
            _, replica, removed = entry
            try:
                idle = ray_tpu_torch.get(replica.queue_len.remote(), timeout=1) == 0
            except ActorDiedError:
                idle = True
            except GetTimeoutError:  # every replica thread busy: not idle
                idle = False
            if idle or time.monotonic() - removed > self.GRACEFUL_SHUTDOWN_TIMEOUT_S:
                _kill(replica)
                done.append(entry)
        if done:
            with self._lock:
                self._draining = [e for e in self._draining if e not in done]

    def _health_check_tick(self) -> None:
        """At most one outstanding probe per constructed replica, sent once
        its deployment's health_check_period_s has passed since the last one
        (or since the replica was first seen constructed): a probe fails
        when it raises or exceeds HEALTH_CHECK_TIMEOUT_S, and a dead replica
        or HEALTH_CHECK_FAILURE_THRESHOLD failures in a row take the replica
        out for reconcile to replace. A replica still in its constructor is
        not probed: deploy waits for it."""
        rt = get_runtime()
        now = time.monotonic()
        with self._lock:
            replicas = [(st, r) for st in self._deployments.values() for r in st.replicas]
        live = {r._actor_id.hex() for _, r in replicas}
        for key in [k for k in self._health_last if k not in live]:
            self._health_last.pop(key)
            self._health_probes.pop(key, None)
        for st, r in replicas:
            key = r._actor_id.hex()
            ready = rt.actor_ready(r._actor_id)
            if not rt.wait([ready], 1, timeout=0)[0]:
                continue  # constructing
            probe = self._health_probes.get(key)
            if probe is None:
                last = self._health_last.setdefault(key, now)
                if now - last < st.config.health_check_period_s:
                    continue
                self._health_last[key] = now
                self._health_probes[key] = probe = (r.health_check.remote(), now)
            ref, sent = probe
            failed: object = False
            if rt.wait([ref], 1, timeout=0)[0]:
                del self._health_probes[key]
                try:
                    rt.get([ref], timeout=0)
                    self._health_failures.pop(key, None)
                    continue
                except ActorDiedError:
                    failed = "dead"  # definitively dead: replace now
                except Exception:  # noqa: BLE001 - check_health raised
                    failed = True
            elif now - sent > self.HEALTH_CHECK_TIMEOUT_S:
                del self._health_probes[key]
                failed = True
            if failed is False:
                continue
            if failed != "dead":
                n = self._health_failures.get(key, 0) + 1
                self._health_failures[key] = n
                if n < self.HEALTH_CHECK_FAILURE_THRESHOLD:
                    continue
            self._health_failures.pop(key, None)
            with self._lock:
                cur = self._deployments.get(st.config.name)
                if cur is None or r not in cur.replicas:
                    continue
                cur.replicas.remove(r)  # reconcile starts its replacement
            self._publish_epoch()  # ingresses stop routing to it now
            _kill(r)
            _retire(st.config.name, [r])

    def _reconcile_once(self) -> None:
        with self._reconcile_lock:
            with self._lock:
                states = list(self._deployments.values())
            for st in states:
                self._reconcile(st)

    def _reconcile(self, st: _DeploymentState) -> None:
        while True:
            # snapshot target/version under the lock; act outside it
            with self._lock:
                if st is not self._deployments.get(st.config.name):
                    return  # deleted concurrently
                version = st.version
                deficit = st.target_replicas - len(st.replicas)
                d, cfg = st.deployment, st.config
                victim = st.replicas.pop() if deficit < 0 else None
            if victim is not None:
                _retire(cfg.name, [victim])
                with self._lock:
                    self._draining.append((cfg.name, victim, time.monotonic()))
                continue
            if deficit <= 0:
                return
            opts = cfg.ray_actor_options
            replica = ray_tpu_torch.remote(
                num_cpus=opts.get("num_cpus", 1.0),
                num_gpus=opts.get("num_gpus", 0.0),
                max_concurrency=max(4, cfg.max_ongoing_requests),
            )(ReplicaActor).remote(d.func_or_class, d.init_args, d.init_kwargs,
                                   cfg.user_config)
            with self._lock:
                # attach only if the deployment wasn't redeployed/deleted meanwhile
                cur = self._deployments.get(cfg.name)
                if cur is st and st.version == version and len(st.replicas) < st.target_replicas:
                    st.replicas.append(replica)
                    replica = None
            if replica is not None:  # stale: discard the just-made replica
                _kill(replica)


class Router:
    """Power-of-two-choices replica selection on the requests this router
    has in flight to each replica. A request retires from the count when
    its result is stored (a callback of the store: no watcher thread).
    ``_routing_hint`` and ``_select`` are the seam a routing policy
    overrides (``serve.kv_router``)."""

    KIND = "pow2"  # the request_router name this class serves
    REFRESH_S = 0.5
    REPORT_EVERY = 10  # requests between two load reports to the controller

    def __init__(self, controller, deployment_name: str):
        self._controller = controller
        self._name = deployment_name
        # set by _refresh when the deployment's request_router no longer
        # names this class; the handle swaps routers on its next call
        self._stale_kind: str | None = None
        self._replicas: list = []
        self._inflight: dict = {}
        self._dead: set = set()  # replicas observed dead; excluded on refresh
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        self._reqs_since_report = 0
        if not hasattr(self, "_replica_nodes"):  # a subclass may have set it
            self._replica_nodes: dict = {}
        # the predicted-TTFT estimator reads this router's in-flight depths
        anatomy.register_router(self)

    @staticmethod
    def _rkey(replica) -> str:
        return replica._actor_id.hex()

    def inflight_snapshot(self) -> dict:
        """Per-replica in-flight depths (the predicted-TTFT queue signal)."""
        with self._lock:
            return dict(self._inflight)

    def _refresh(self) -> None:
        now = time.monotonic()
        if now - self._last_refresh > self.REFRESH_S or not self._replicas:
            reps = ray_tpu_torch.get(self._controller.get_replicas.remote(self._name),
                                     timeout=30)
            kind = ray_tpu_torch.get(
                self._controller.get_request_router.remote(self._name), timeout=30)
            self._stale_kind = kind if kind != type(self).KIND else None
            with self._lock:
                self._replicas = [r for r in reps if self._rkey(r) not in self._dead]
                self._inflight = {self._rkey(r): self._inflight.get(self._rkey(r), 0)
                                  for r in self._replicas}
                self._last_refresh = now

    def pick(self, wait_timeout: float = 30.0, hint=None):
        self._refresh()
        if not self._replicas:
            # replicas may still be starting (a replacement in progress):
            # wait for one rather than failing fast
            deadline = time.monotonic() + wait_timeout
            while time.monotonic() < deadline and not self._replicas:
                if self._name not in ray_tpu_torch.get(
                        self._controller.get_deployment_names.remote(), timeout=30):
                    break  # genuinely absent: fail below
                time.sleep(0.1)
                self._last_refresh = 0.0
                self._refresh()
        with self._lock:
            if not self._replicas:
                raise RuntimeError(f"No replicas for deployment '{self._name}'")
            if len(self._replicas) == 1:
                return self._replicas[0]
            return self._select(hint)

    def _select(self, hint):
        """Pick among >= 2 replicas (called under ``self._lock``). ``hint``
        is the request's routing context (unused by pow-2)."""
        a, b = random.sample(self._replicas, 2)
        if self._inflight.get(self._rkey(a), 0) <= self._inflight.get(self._rkey(b), 0):
            return a
        return b

    def _routing_hint(self, method_name: str, args, kwargs):
        """Request context handed to ``_select`` (None: no context)."""
        return None

    def _track(self, key: str, ref) -> None:
        get_runtime().get_async(ref).add_done_callback(lambda _: self._retire(key))

    def _retire(self, key: str) -> None:
        with self._lock:
            if key in self._inflight:
                self._inflight[key] = max(0, self._inflight[key] - 1)

    def _dispatch(self, method_name: str, args, kwargs, t_route0: float):
        """Pick a replica, count the request in flight to it and stamp the
        routing decision on the body's ledger: (replica, its key)."""
        replica = self.pick(hint=self._routing_hint(method_name, args, kwargs))
        key = self._rkey(replica)
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1
        anatomy.router_stamp(args[0] if args else None, self._name, key, t_route0)
        self._maybe_report()
        return replica, key

    def submit(self, method_name: str, args, kwargs):
        """The request's ref. A replica killed between refreshes fails the
        call at once with ActorDiedError; it is retried on another."""
        rt = get_runtime()
        t_route0 = anatomy.now_wall()
        ref = None
        for _ in range(4):
            replica, key = self._dispatch(method_name, args, kwargs, t_route0)
            ref = replica.handle_request.remote(method_name, args, kwargs)
            if rt.wait([ref], 1, timeout=0)[0]:
                self._retire(key)
                try:
                    rt.get([ref], timeout=0)
                except ActorDiedError:
                    with self._lock:
                        self._dead.add(key)
                        self._replicas = [x for x in self._replicas if x != replica]
                        self._last_refresh = 0.0  # re-pull from the controller
                    continue
                except Exception:  # noqa: BLE001 - an app error: the caller's get raises it
                    pass
                return ref
            self._track(key, ref)
            return ref
        return ref

    def submit_stream(self, method_name: str, args, kwargs):
        """(ObjectRefGenerator, done_cb): the stream counts as in flight until
        the caller's iteration ends or closes (done_cb)."""
        replica, key = self._dispatch(method_name, args, kwargs, anatomy.now_wall())
        gen = replica.handle_streaming.options(num_returns=STREAMING).remote(
            method_name, args, kwargs)
        done = []

        def done_cb():
            if not done:
                done.append(True)
                self._retire(key)

        return gen, done_cb

    def _maybe_report(self) -> None:
        """Every REPORT_EVERY requests, the mean in-flight load per replica
        to the controller's ongoing_requests autoscaling."""
        self._reqs_since_report += 1
        if self._reqs_since_report >= self.REPORT_EVERY:
            self._reqs_since_report = 0
            with self._lock:
                load = sum(self._inflight.values()) / max(1, len(self._replicas))
            self._controller.record_autoscaling_metrics.remote(self._name, load)


class _HandleMethod:
    def __init__(self, handle: "DeploymentHandle", method_name: str):
        self._handle = handle
        self._method_name = method_name

    def remote(self, *args, **kwargs):
        return self._handle._current_router().submit(self._method_name, args, kwargs)


class DeploymentHandle:
    """``.remote()`` (or ``.<method>.remote()``) through the router the
    deployment's ``request_router`` names; the result is an ObjectRef."""

    def __init__(self, controller, deployment_name: str):
        from ray_tpu_torch.serve.kv_router import make_router

        self._controller = controller
        self._name = deployment_name
        kind = ray_tpu_torch.get(controller.get_request_router.remote(deployment_name),
                                 timeout=30)
        self._router = make_router(kind, controller, deployment_name)

    @property
    def deployment_name(self) -> str:
        return self._name

    def _current_router(self) -> Router:
        """Swap the router when a redeploy changed the deployment's
        request_router (seen by Router._refresh)."""
        stale = self._router._stale_kind
        if stale:
            from ray_tpu_torch.serve.kv_router import make_router

            self._router = make_router(stale, self._controller, self._name)
        return self._router

    def remote(self, *args, **kwargs):
        return self._current_router().submit("__call__", args, kwargs)

    def stream(self, *args, method_name: str = "__call__", **kwargs):
        """Iterate a streaming deployment method's yielded values as they arrive."""
        gen, done_cb = self._current_router().submit_stream(method_name, args, kwargs)
        try:
            for ref in gen:
                yield ray_tpu_torch.get(ref)
        finally:
            done_cb()

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return _HandleMethod(self, item)
