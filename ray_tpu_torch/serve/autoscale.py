"""SLO-driven deployment autoscaling (copied from ray_tpu/serve/autoscale.py).

The controller's own autoscaling scales on the replicas' queue depth. This
scaler is the alternative for deployments that declared ``slo_ttft_ms``
and opted in with ``AutoscalingConfig(policy="slo")``: each tick it reads
request anatomy's predicted TTFT (the worst replica per deployment) and
compares it to the SLO.

- Sustained breach (predicted > SLO for ``upscale_delay_s``, hysteresis)
  scales the target up one replica, bounded by ``max_replicas``, with
  ``upscale_delay_s`` also the cooldown between steps.
- Sustained clearance (predicted < SLO x DOWNSCALE_FRACTION for
  ``downscale_delay_s``) scales down toward ``min_replicas`` under the same
  cooldown.
- Every scale-up records standing demand for the deployment
  (``view()["standing_demand"]``), cleared once the running replicas catch
  the target. The reference hands the deficit's replica shapes to its
  cluster autoscaler; one process has none, so nothing consumes it yet.

Actuation is one controller call per decision (``set_target_replicas``);
the reconcile loop starts and stops replicas. Listeners (``add_listener``)
fire on every decision. The loop is a daemon thread that waits in slices
of at most 0.5 s; ``stop()``, and ``serve.shutdown()`` for every started
scaler, ends it.
"""

from __future__ import annotations

import os
import threading
import time
import weakref

import ray_tpu_torch

_NEVER = -float("inf")
_WAIT_SLICE_S = 0.5

# every started scaler, so serve.shutdown() can stop their loops
_started: "weakref.WeakSet[DeploymentAutoscaler]" = weakref.WeakSet()
_started_lock = threading.Lock()


def _default_predicted() -> dict:
    from ray_tpu_torch.serve import anatomy

    return anatomy.predicted_ttft_by_deployment()


class DeploymentAutoscaler:
    DOWNSCALE_FRACTION = 0.5  # clear = predicted below this fraction of SLO

    def __init__(self, controller, *, tick_s: float | None = None,
                 predicted_fn=None, view_fn=None, actuate_fn=None,
                 now_fn=time.monotonic):
        self._controller = controller
        if tick_s is None:
            try:
                tick_s = float(os.environ.get(
                    "RAY_TPU_SERVE_AUTOSCALE_TICK_S", 1.0))
            except (TypeError, ValueError):
                tick_s = 1.0
        self.tick_s = tick_s
        # seams (tests inject signals; defaults read the live planes)
        self._predicted = predicted_fn or _default_predicted
        self._view = view_fn or self._controller_view
        self._actuate = actuate_fn or self._controller_actuate
        self._now = now_fn
        self._state: dict[str, dict] = {}
        self._listeners: list = []
        self._demand_keys: set[str] = set()
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- default signal/actuation plumbing (slow path: RPC per tick) ----
    def _controller_view(self) -> dict:
        return ray_tpu_torch.get(self._controller.autoscale_view.remote(),
                                 timeout=5)

    def _controller_actuate(self, dep: str, target: int) -> None:
        ray_tpu_torch.get(self._controller.set_target_replicas.remote(dep, target),
                          timeout=5)

    # ---- listeners (event-driven consumers: tests, dashboards) ----
    def add_listener(self, cb) -> None:
        """cb(deployment, action, target) on every scale decision
        (action: "scale_up" | "scale_down")."""
        with self._lock:
            self._listeners.append(cb)

    def _notify(self, dep: str, action: str, target: int) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for cb in listeners:
            try:
                cb(dep, action, target)
            except Exception:
                pass

    # ---- standing demand (the reference's cluster-autoscaler hook) ----
    def _register_demand(self, dep: str, shape: dict, deficit: int) -> None:
        """Record standing demand for ``dep``. In one process there is no
        cluster autoscaler to hand the deficit's ``shape`` to, so only the
        key stays, readable through ``view()``."""
        if deficit <= 0:
            return
        with self._lock:
            self._demand_keys.add(f"serve:{dep}")

    def _clear_demand(self, dep: str) -> None:
        with self._lock:
            self._demand_keys.discard(f"serve:{dep}")

    # ---- the decision loop ----
    def _dep_state(self, dep: str) -> dict:
        st = self._state.get(dep)
        if st is None:
            st = self._state[dep] = {
                "breach_since": None, "clear_since": None,
                "last_scale": _NEVER, "predicted_ttft_ms": None,
            }
        return st

    def tick(self) -> None:
        try:
            view = self._view()
            pred_map = self._predicted()
        except Exception:
            return  # controller briefly unavailable: skip the tick
        now = self._now()
        for dep, ent in view.items():
            auto = ent.get("autoscaling")
            if not auto or ent.get("policy") != "slo":
                continue
            slo = ent.get("slo_ttft_ms")
            if slo is None:
                continue
            st = self._dep_state(dep)
            pred = pred_map.get(dep)
            st["predicted_ttft_ms"] = pred
            target = ent["target_replicas"]
            running = ent["running_replicas"]
            lo, hi = auto["min_replicas"], auto["max_replicas"]
            breach = pred is not None and pred > float(slo)
            clear = (pred is None
                     or pred < float(slo) * self.DOWNSCALE_FRACTION)
            if breach:
                st["clear_since"] = None
                if st["breach_since"] is None:
                    st["breach_since"] = now
                sustained = now - st["breach_since"] >= auto["upscale_delay_s"]
                cooled = now - st["last_scale"] >= auto["upscale_delay_s"]
                if sustained and cooled and target < hi:
                    new = target + 1
                    try:
                        self._actuate(dep, new)
                    except Exception:
                        continue
                    st["last_scale"] = now
                    st["breach_since"] = now  # re-arm: fresh window per step
                    self._register_demand(dep, ent.get("replica_shape") or {},
                                          new - running)
                    self._notify(dep, "scale_up", new)
                    continue
            elif clear:
                st["breach_since"] = None
                if st["clear_since"] is None:
                    st["clear_since"] = now
                sustained = (now - st["clear_since"]
                             >= auto["downscale_delay_s"])
                cooled = now - st["last_scale"] >= auto["downscale_delay_s"]
                if sustained and cooled and target > lo:
                    new = target - 1
                    try:
                        self._actuate(dep, new)
                    except Exception:
                        continue
                    st["last_scale"] = now
                    st["clear_since"] = now
                    self._notify(dep, "scale_down", new)
            else:
                # between the breach line and the clear line: neither
                # window accumulates (hysteresis band)
                st["breach_since"] = None
                st["clear_since"] = None
            if running >= target:
                self._clear_demand(dep)

    def view(self) -> dict:
        with self._lock:
            demand = sorted(self._demand_keys)
        return {
            "tick_s": self.tick_s,
            "deployments": {d: dict(st) for d, st in self._state.items()},
            "standing_demand": demand,
            "running": self._thread is not None and self._thread.is_alive(),
        }

    # ---- lifecycle ----
    def start(self) -> "DeploymentAutoscaler":
        if self._thread is None or not self._thread.is_alive():
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="serve-slo-autoscaler")
            self._thread.start()
            with _started_lock:
                _started.add(self)
        return self

    def _loop(self) -> None:
        next_tick = time.monotonic() + self.tick_s
        while not self._stop_evt.wait(
                min(_WAIT_SLICE_S, max(0.0, next_tick - time.monotonic()))):
            if time.monotonic() < next_tick:
                continue
            next_tick = time.monotonic() + self.tick_s
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must outlive one bad tick
                pass

    def stop(self) -> None:
        self._stop_evt.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=10)
        for dep in list(self._state):
            self._clear_demand(dep)


def stop_all() -> None:
    """``serve.shutdown()``: stop every started scaler's loop."""
    with _started_lock:
        scalers = list(_started)
    for s in scalers:
        s.stop()
