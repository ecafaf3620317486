"""The serving front door: ingresses that route from routing epochs (copied
from ray_tpu/serve/front_door.py, in one process).

Each ``IngressActor`` is a stateless HTTP ingress (the stdlib ``HttpProxy``
of ``serve.api``) that

- consumes ROUTING EPOCHS: versioned, inbound-tolerant snapshots of the
  routing state (routes, replica sets, replica->node map, router kinds, SLO
  config, ingress fleet) that the ``ServeController`` publishes on the
  retained ``"serve:epochs"`` channel (``core/pubsub.py``). Nothing polls
  the controller on the request path;
- routes through ``EpochRouter`` / ``EpochKVRouter``: the stock routers
  with their controller reads replaced by reads of the local epoch cache;
- gates admission (``serve/admission.py``) on an ingress-local predicted
  TTFT (its own in-flight depths x the epoch's service-time hint) before
  ``anatomy.admit``: a breached deployment queues within its budget, then
  sheds with 503.

``FrontDoor`` places one ingress per live node, or a fixed ``count``. The
port's runtime is one process, so "per node" is one ingress, on ``"head"``;
no node registers or dies, so there is no node channel to follow, and the
reference's compiled-dispatch graphs are not ported (an epoch's
``"compiled"`` is False).
"""

from __future__ import annotations

import threading
import time
import uuid

import ray_tpu_torch
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.experimental import pubsub
from ray_tpu_torch.serve.admission import AdmissionGate
from ray_tpu_torch.serve.api import HttpProxy, _get_or_create_controller
from ray_tpu_torch.serve.controller import (CONTROLLER_NAME, DeploymentHandle, Router,
                                            ServeController)
from ray_tpu_torch.serve.kv_router import KVAwareRouter

EPOCH_CHANNEL = ServeController.EPOCH_CHANNEL
_POLL_S = 0.5  # the epoch loop's wait, so it sees a stop or a shutdown


class EpochCache:
    """Latest-routing-epoch holder: versioned (monotonic, stale publishes
    dropped), inbound-tolerant (junk ignored, unknown fields passed
    through), condition-variable waits for consumers."""

    def __init__(self):
        self._cond = threading.Condition()
        self._doc: dict | None = None
        self.version = 0
        self.rejected = 0  # stale or malformed updates seen

    def update(self, doc) -> bool:
        if not isinstance(doc, dict):
            with self._cond:
                self.rejected += 1
            return False
        try:
            ver = int(doc.get("version") or 0)
        except (TypeError, ValueError):
            with self._cond:
                self.rejected += 1
            return False
        with self._cond:
            if ver <= self.version:
                if ver < self.version:
                    self.rejected += 1  # out-of-order replay
                return False
            self._doc = doc
            self.version = ver
            self._cond.notify_all()
            return True

    def get(self) -> dict | None:
        with self._cond:
            return self._doc

    def snapshot(self) -> tuple:
        with self._cond:
            return self.version, self._doc

    def wait_newer(self, version: int, timeout: float) -> bool:
        """Block until an epoch newer than ``version`` lands (True) or the
        timeout expires (False)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self.version <= version:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True


class _EpochRefreshMixin:
    """Replaces a router's controller reads with local epoch-cache reads.

    The request path (``_refresh``/``pick``/``_select``) calls the
    controller zero times: the replica set and the node map come from the
    last applied epoch, and the per-N-requests load report is off."""

    def __init__(self, controller, deployment_name: str, cache: EpochCache):
        self._cache = cache
        self._applied_version = -1
        super().__init__(controller, deployment_name)

    def _refresh(self) -> None:
        ver, doc = self._cache.snapshot()
        if doc is None:
            return
        with self._lock:
            if ver == self._applied_version and self._replicas:
                return
        ent = (doc.get("deployments") or {}).get(self._name) or {}
        reps = list(ent.get("replicas") or [])
        nodes = ent.get("nodes")
        with self._lock:
            reps = [r for r in reps if self._rkey(r) not in self._dead]
            self._replicas = reps
            self._inflight = {self._rkey(r): self._inflight.get(self._rkey(r), 0)
                              for r in reps}
            self._last_refresh = time.monotonic()
            self._applied_version = ver
            if isinstance(nodes, dict):
                self._replica_nodes = dict(nodes)
            self._epoch_applied_locked(frozenset(self._rkey(r) for r in reps))

    def _epoch_applied_locked(self, live: frozenset) -> None:
        """Subclass hook, called under the router lock after an epoch lands."""

    def _maybe_report(self) -> None:
        return  # no per-request controller call

    def pick(self, wait_timeout: float = 30.0, hint=None):
        self._refresh()
        if not self._replicas:
            # replicas still starting: wait on the next epoch, not on the
            # controller
            deadline = time.monotonic() + wait_timeout
            while time.monotonic() < deadline and not self._replicas:
                self._cache.wait_newer(self._applied_version, timeout=0.25)
                self._refresh()
        with self._lock:
            if not self._replicas:
                raise RuntimeError(f"No replicas for deployment '{self._name}'")
            if len(self._replicas) == 1:
                return self._replicas[0]
            return self._select(hint)


class EpochRouter(_EpochRefreshMixin, Router):
    """Power-of-two routing fed by the local routing epoch."""

    KIND = "epoch"


class EpochKVRouter(_EpochRefreshMixin, KVAwareRouter):
    """KV-cache-aware routing fed by the local routing epoch: the replica->
    node map comes from the epoch, not from ``get_replica_nodes``."""

    KIND = "epoch_kv"

    def _epoch_applied_locked(self, live: frozenset) -> None:
        self._prune_stale_owners(live)

    def _fetch_node_map(self):
        return None  # unused: _refresh applies the epoch's node map


class _EpochHandle(DeploymentHandle):
    """A DeploymentHandle whose router is epoch-fed (no controller call at
    construction: the router kind comes from the epoch too)."""

    def __init__(self, controller, deployment_name: str, cache: EpochCache):
        self._controller = controller
        self._name = deployment_name
        self._cache = cache
        self._router = self._make_router()

    def _routing_kind(self) -> str:
        doc = self._cache.get() or {}
        ent = (doc.get("deployments") or {}).get(self._name) or {}
        return ent.get("router") or "pow2"

    def _make_router(self) -> Router:
        kind = self._routing_kind()
        cls = EpochKVRouter if kind == "kv_aware" else EpochRouter
        r = cls(self._controller, self._name, self._cache)
        r._config_kind = kind
        return r

    def _current_router(self) -> Router:
        if self._routing_kind() != self._router._config_kind:
            self._router = self._make_router()  # a redeploy changed the policy
        return self._router


class IngressActor:
    """One stateless ingress (a thread actor): an ``HttpProxy`` whose route
    lookup, replica routing and admission predictor all read the local epoch
    cache. Its only controller calls are one ``get_epoch`` at start (beside
    the retained channel's replay) and none after."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 ingress_key: str | None = None):
        self._key = ingress_key
        self._runtime = get_runtime()
        self._controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        self._cache = EpochCache()
        self._handles: dict[str, _EpochHandle] = {}
        self._handle_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._sub = pubsub.subscribe(EPOCH_CHANNEL)  # the retained epoch arrives first
        try:
            self._cache.update(ray_tpu_torch.get(self._controller.get_epoch.remote(),
                                                 timeout=10))
            self._gate = AdmissionGate(self._predict)
            self._proxy = HttpProxy(host, port, route_lookup=self._lookup,
                                    admission=self._admit)
        except BaseException:
            self._sub.close()
            raise
        self._loop = threading.Thread(target=self._epoch_loop, daemon=True,
                                      name=f"ingress-epochs-{self._proxy.port}")
        self._loop.start()

    def _epoch_loop(self) -> None:
        """Apply each published epoch (version-gated, junk-tolerant) until
        stopped; a runtime shut down under it stops the proxy too."""
        while not self._stop_evt.is_set() and not self._runtime.is_shutdown:
            msg = self._sub.poll(timeout=_POLL_S)
            if msg is not None:
                self._cache.update(msg)
        if not self._stop_evt.is_set():
            self.stop()

    # ------------------------- request path: the local epoch cache only
    def _lookup(self, path: str):
        doc = self._cache.get()
        routes = (doc.get("routes") or {}) if doc else {}
        best = None
        for prefix, name in routes.items():
            if (path == prefix or path.startswith(prefix.rstrip("/") + "/")
                    or prefix == "/"):
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, name)
        if best is None:
            return (None, None)
        return best[0], self._handle(best[1])

    def _admit(self, deployment: str):
        return self._gate.try_admit(deployment)

    def _predict(self, deployment: str):
        """Ingress-local predicted TTFT (ms): this ingress's mean in-flight
        depth per replica (+1 for the arriving request) x the epoch's
        service-time hint. Reads the epoch and its own routers only."""
        doc = self._cache.get()
        ent = ((doc.get("deployments") or {}).get(deployment) or {}) if doc else {}
        slo = ent.get("slo_ttft_ms")
        if slo is None:
            return None, None
        h = self._handles.get(deployment)
        if h is None:
            return None, slo  # nothing in flight here yet: admit
        depths = h._router.inflight_snapshot()
        n = max(1, len(depths))
        svc = ent.get("service_ewma_s") or 0.05
        pred = (sum(depths.values()) / n + 1.0) * float(svc) * 1000.0
        return pred, slo

    # ------------------------------------------------------- slow path
    def _handle(self, name: str) -> _EpochHandle:
        h = self._handles.get(name)
        if h is None:
            with self._handle_lock:
                h = self._handles.get(name)
                if h is None:
                    h = self._handles[name] = _EpochHandle(self._controller, name, self._cache)
        return h

    def address(self) -> tuple:
        return (self._proxy.host, self._proxy.port)

    def epoch_version(self) -> int:
        return self._cache.version

    def epoch(self) -> dict | None:
        """The epoch this ingress routes from."""
        return self._cache.get()

    def shed_counts(self) -> dict:
        return self._gate.shed_counts()

    def router_stats(self) -> dict:
        """Per-deployment routing state of this ingress: the epoch it
        applied, its replicas and in-flight depths."""
        out = {}
        for name, h in list(self._handles.items()):
            r = h._router
            with r._lock:
                out[name] = {"router": type(r).KIND, "epoch_version": r._applied_version,
                             "replicas": len(r._replicas), "inflight": dict(r._inflight)}
        return out

    def ready(self, timeout: float = 30.0) -> bool:
        """True once a routing epoch has landed (start-up ``get_epoch`` or the
        retained replay): an ingress that is up but epoch-less would 404
        every route."""
        return self._cache.wait_newer(0, timeout=timeout)

    def stop(self) -> None:
        """Stop the epoch loop and the HTTP server (its port is free when
        this returns). Idempotent."""
        if self._stop_evt.is_set():
            return
        self._stop_evt.set()
        self._sub.close()
        self._proxy.stop()


class FrontDoor:
    """Places the ingresses and registers each with the controller's
    ingress registry: one per live node (here one, on ``"head"``), or a fixed
    ``count`` of them."""

    def __init__(self, host: str = "127.0.0.1", base_port: int = 0, count: int | None = None):
        self._host = host
        self._base_port = base_port
        self._count = count
        self._controller = None
        self._fleet: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._port_seq = 0

    def start(self) -> "FrontDoor":
        self._controller = _get_or_create_controller()
        keys = ["head"] if self._count is None else [f"ingress-{i}" for i in range(self._count)]
        for key in keys:
            self._spawn(key)
        return self

    def _next_port(self) -> int:
        if not self._base_port:
            return 0
        p = self._base_port + self._port_seq
        self._port_seq += 1
        return p

    def _spawn(self, key: str) -> tuple:
        name = f"SERVE_INGRESS:{uuid.uuid4().hex[:6]}:{key[:8]}"
        actor = ray_tpu_torch.remote(num_cpus=0, max_concurrency=4, name=name)(
            IngressActor).remote(port=self._next_port(), host=self._host, ingress_key=key)
        try:
            if not ray_tpu_torch.get(actor.ready.remote(), timeout=60):
                raise TimeoutError(f"ingress {key} never received a routing epoch")
            addr = tuple(ray_tpu_torch.get(actor.address.remote(), timeout=30))
        except BaseException:
            _stop_ingress(actor)
            raise
        with self._lock:
            self._fleet[key] = {"actor": actor, "addr": addr, "node": "head"}
        ray_tpu_torch.get(self._controller.set_ingress.remote(key, addr[0], addr[1]),
                          timeout=30)
        return addr

    def addresses(self) -> list:
        with self._lock:
            return [ent["addr"] for _, ent in sorted(self._fleet.items())]

    def ingress_actors(self) -> dict:
        """ingress key -> its actor handle."""
        with self._lock:
            return {k: ent["actor"] for k, ent in self._fleet.items()}

    def fleet_view(self) -> dict:
        with self._lock:
            fleet = {k: {"addr": list(ent["addr"]), "node": ent["node"]}
                     for k, ent in self._fleet.items()}
            actors = [(k, ent["actor"]) for k, ent in self._fleet.items()]
        sheds: dict = {}
        for key, actor in actors:
            try:
                sheds[key] = ray_tpu_torch.get(actor.shed_counts.remote(), timeout=2)
            except Exception:  # noqa: BLE001 - an ingress mid-stop
                sheds[key] = None
        return {"ingress": fleet, "shed_counts": sheds}

    def stop(self) -> None:
        with self._lock:
            fleet, self._fleet = self._fleet, {}
        if not ray_tpu_torch.is_initialized():
            return  # each ingress's epoch loop stopped its server with the runtime
        for key, ent in fleet.items():
            try:
                ray_tpu_torch.get(self._controller.remove_ingress.remote(key), timeout=10)
            except Exception:  # noqa: BLE001 - the controller is already gone
                pass
            _stop_ingress(ent["actor"])


def _stop_ingress(actor) -> None:
    """Stop an ingress's server (freeing its port), then kill the actor."""
    try:
        ray_tpu_torch.get(actor.stop.remote(), timeout=10)
    except Exception:  # noqa: BLE001 - already dead: its epoch loop stops the server
        pass
    ray_tpu_torch.kill(actor)


# ------------------------------------------------------------ module API
_fd_lock = threading.Lock()
_fd_state: dict = {"front_door": None, "autoscaler": None}


def start_front_door(host: str = "127.0.0.1", base_port: int = 0,
                     count: int | None = None, autoscale: bool = False) -> list:
    """Start the ingresses (idempotent) and return their addresses.
    ``count=None`` places one per live node (one, in one process); a fixed
    count places that many. ``autoscale=True`` also starts the SLO
    deployment autoscaler (``serve/autoscale.py``)."""
    with _fd_lock:
        if _fd_state["front_door"] is None:
            _fd_state["front_door"] = FrontDoor(host, base_port, count).start()
        if autoscale and _fd_state["autoscaler"] is None:
            from ray_tpu_torch.serve.autoscale import DeploymentAutoscaler

            _fd_state["autoscaler"] = DeploymentAutoscaler(
                _fd_state["front_door"]._controller).start()
        return _fd_state["front_door"].addresses()


def front_door_addresses() -> list:
    with _fd_lock:
        fd = _fd_state["front_door"]
    return fd.addresses() if fd is not None else []


def front_door_view() -> dict:
    """Fleet membership, shed counts and the autoscaler's state."""
    with _fd_lock:
        fd = _fd_state["front_door"]
        sc = _fd_state["autoscaler"]
    out = {"running": fd is not None}
    if fd is not None:
        out.update(fd.fleet_view())
    if sc is not None:
        out["autoscaler"] = sc.view()
    return out


def stop_front_door() -> None:
    """Stop the autoscaler and every ingress; their ports are free when this
    returns."""
    with _fd_lock:
        fd, _fd_state["front_door"] = _fd_state["front_door"], None
        sc, _fd_state["autoscaler"] = _fd_state["autoscaler"], None
    if sc is not None:
        sc.stop()
    if fd is not None:
        fd.stop()
