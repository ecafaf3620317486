"""ServeController, replicas, router and handles (the in-process part of
ray_tpu/serve/controller.py).

- ``ReplicaActor`` hosts one replica of the user's callable.
- ``ServeController`` keeps each deployment's target replica count: its
  reconcile loop starts and stops replicas, its health loop replaces a dead
  or failing one. ``deploy`` waits for the new replicas' constructors and
  raises the first one's error, so ``serve.run`` never returns a handle
  without replicas.
- ``Router`` picks a replica per request by the power of two choices on the
  requests it has in flight, and retries a request that lands on a replica
  already dead; ``DeploymentHandle`` sends calls through it.

Still to port (ROADMAP queue 1 item 3): the KV checkpoint of the controller,
routing epochs and ingress registration, node probes and drain,
autoscaling, compiled dispatch and the KV-aware router. In one process the
HTTP proxy reads ``serve.api``'s route table, so there is no route
publication to subscribe to.
"""

from __future__ import annotations

import inspect
import logging
import random
import threading
import time

import ray_tpu_torch
from ray_tpu_torch.core.runtime import STREAMING, get_runtime
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError, TaskError
from ray_tpu_torch.serve.deployment import Deployment, DeploymentConfig

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

    def handle_request(self, method_name: str, args, kwargs):
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
        self.target_replicas = config.num_replicas
        self.version = 0


def _kill(replica) -> None:
    try:
        ray_tpu_torch.kill(replica)
    except ValueError:  # already gone with its runtime
        pass


class ServeController:
    """The control-plane actor."""

    HEALTH_CHECK_FAILURE_THRESHOLD = 3
    # the health loop's tick; each replica is probed once its deployment's
    # health_check_period_s has passed since its last probe was sent
    HEALTH_CHECK_TICK_S = 0.1
    # generous: a saturated-but-healthy replica answers between requests
    HEALTH_CHECK_TIMEOUT_S = 30.0
    RECONCILE_PERIOD_S = 0.25

    def __init__(self):
        self._deployments: dict[str, _DeploymentState] = {}
        self._routes: dict[str, str] = {}  # route_prefix -> deployment name
        self._health_failures: dict[str, int] = {}  # replica -> consecutive fails
        self._health_probes: dict[str, tuple] = {}  # replica -> (ref, sent_ts)
        self._health_last: dict[str, float] = {}  # replica -> when its last probe went
        self._lock = threading.Lock()
        self._reconcile_lock = threading.Lock()  # serializes reconcile passes
        self._stop = threading.Event()
        self._runtime = get_runtime()  # the loops end with it
        self._threads = [
            threading.Thread(target=self._loop, args=(self.RECONCILE_PERIOD_S,
                                                      self._reconcile_once),
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
            st.target_replicas = deployment.config.num_replicas
            if route_prefix is not None:
                self._routes[route_prefix] = name
        for r in old_replicas:
            _kill(r)
        self._reconcile_once()
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

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            st = self._deployments.pop(name, None)
            self._routes = {p: n for p, n in self._routes.items() if n != name}
        if st:
            for r in st.replicas:
                _kill(r)

    def get_replicas(self, name: str) -> list:
        with self._lock:
            st = self._deployments.get(name)
            return list(st.replicas) if st else []

    def get_deployment_names(self) -> list[str]:
        with self._lock:
            return list(self._deployments)

    def status(self) -> dict:
        with self._lock:
            return {name: {"target_replicas": st.target_replicas,
                           "running_replicas": len(st.replicas),
                           "version": st.version}
                    for name, st in self._deployments.items()}

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
            _kill(r)

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
                _kill(victim)
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
    its result is stored (a callback of the store: no watcher thread)."""

    REFRESH_S = 0.5

    def __init__(self, controller, deployment_name: str):
        self._controller = controller
        self._name = deployment_name
        self._replicas: list = []
        self._inflight: dict = {}
        self._dead: set = set()  # replicas observed dead; excluded on refresh
        self._lock = threading.Lock()
        self._last_refresh = 0.0

    @staticmethod
    def _rkey(replica) -> str:
        return replica._actor_id.hex()

    def _refresh(self) -> None:
        now = time.monotonic()
        if now - self._last_refresh > self.REFRESH_S or not self._replicas:
            reps = ray_tpu_torch.get(self._controller.get_replicas.remote(self._name),
                                     timeout=30)
            with self._lock:
                self._replicas = [r for r in reps if self._rkey(r) not in self._dead]
                self._inflight = {self._rkey(r): self._inflight.get(self._rkey(r), 0)
                                  for r in self._replicas}
                self._last_refresh = now

    def pick(self, wait_timeout: float = 30.0):
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
            a, b = random.sample(self._replicas, 2)
            if self._inflight.get(self._rkey(a), 0) <= self._inflight.get(self._rkey(b), 0):
                return a
            return b

    def _track(self, key: str, ref) -> None:
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1
        get_runtime().get_async(ref).add_done_callback(lambda _: self._retire(key))

    def _retire(self, key: str) -> None:
        with self._lock:
            if key in self._inflight:
                self._inflight[key] = max(0, self._inflight[key] - 1)

    def submit(self, method_name: str, args, kwargs):
        """The request's ref. A replica killed between refreshes fails the
        call at once with ActorDiedError; it is retried on another."""
        rt = get_runtime()
        ref = None
        for _ in range(4):
            replica = self.pick()
            ref = replica.handle_request.remote(method_name, args, kwargs)
            if rt.wait([ref], 1, timeout=0)[0]:
                try:
                    rt.get([ref], timeout=0)
                except ActorDiedError:
                    with self._lock:
                        self._dead.add(self._rkey(replica))
                        self._replicas = [x for x in self._replicas if x != replica]
                        self._last_refresh = 0.0  # re-pull from the controller
                    continue
                except Exception:  # noqa: BLE001 - an app error: the caller's get raises it
                    pass
                return ref
            self._track(self._rkey(replica), ref)
            return ref
        return ref

    def submit_stream(self, method_name: str, args, kwargs):
        """(ObjectRefGenerator, done_cb): the stream counts as in flight until
        the caller's iteration ends or closes (done_cb)."""
        replica = self.pick()
        key = self._rkey(replica)
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1
        gen = replica.handle_streaming.options(num_returns=STREAMING).remote(
            method_name, args, kwargs)
        done = []

        def done_cb():
            if not done:
                done.append(True)
                self._retire(key)

        return gen, done_cb


class _HandleMethod:
    def __init__(self, handle: "DeploymentHandle", method_name: str):
        self._handle = handle
        self._method_name = method_name

    def remote(self, *args, **kwargs):
        return self._handle._router.submit(self._method_name, args, kwargs)


class DeploymentHandle:
    """``.remote()`` (or ``.<method>.remote()``) through the router; the
    result is an ObjectRef."""

    def __init__(self, controller, deployment_name: str):
        self._controller = controller
        self._name = deployment_name
        self._router = Router(controller, deployment_name)

    @property
    def deployment_name(self) -> str:
        return self._name

    def remote(self, *args, **kwargs):
        return self._router.submit("__call__", args, kwargs)

    def stream(self, *args, method_name: str = "__call__", **kwargs):
        """Iterate a streaming deployment method's yielded values as they arrive."""
        gen, done_cb = self._router.submit_stream(method_name, args, kwargs)
        try:
            for ref in gen:
                yield ray_tpu_torch.get(ref)
        finally:
            done_cb()

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return _HandleMethod(self, item)
