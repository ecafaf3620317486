"""Autoscaling in the port: the SLO scaler (ray_tpu_torch.serve.autoscale)
against the reference's (ray_tpu.serve.autoscale) on the same stub view,
predictor and clock; the controller's ``ongoing_requests`` policy
(tests/test_serve.py's autoscaling tests); ``policy="slo"`` standing the
controller's own loop down; and the scaler's loop over a live controller,
stopped by ``serve.shutdown()``.

Every test runs under a deadline of its own (SIGALRM) and fails on a
leftover non-daemon thread."""

import signal
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.serve import autoscale as ref_autoscale
from ray_tpu_torch import serve
from ray_tpu_torch.serve import anatomy, autoscale
from ray_tpu_torch.serve.controller import ServeController

DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _guard():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    anatomy.clear()
    try:
        yield
    finally:
        try:
            serve.shutdown()
            rt.shutdown()
            anatomy.clear()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


class _Harness:
    """A scaler of ``mod`` on a stub controller view, predictor and clock
    (tests/test_front_door.py's harness)."""

    def __init__(self, mod, *, min_r=1, max_r=3, up_s=2.0, down_s=3.0, slo=100.0):
        self.now = 0.0
        self.target = self.running = min_r
        self.auto = {"min_replicas": min_r, "max_replicas": max_r,
                     "upscale_delay_s": up_s, "downscale_delay_s": down_s}
        self.slo = slo
        self.pred: dict = {}
        self.events: list = []
        self.sc = mod.DeploymentAutoscaler(
            None, tick_s=3600.0, predicted_fn=lambda: dict(self.pred), view_fn=self._view,
            actuate_fn=self._actuate, now_fn=lambda: self.now)
        self.sc.add_listener(lambda dep, action, target: self.events.append(
            (dep, action, target)))

    def _view(self):
        return {"dep": {"autoscaling": dict(self.auto), "policy": "slo",
                        "slo_ttft_ms": self.slo, "target_replicas": self.target,
                        "running_replicas": self.running, "replica_shape": {"CPU": 1.0}}}

    def _actuate(self, dep, target):
        self.target = target

    def advance(self, dt, pred):
        self.now += dt
        self.pred["dep"] = pred
        self.sc.tick()

    def trace(self) -> tuple:
        st = self.sc.view()["deployments"]["dep"]
        return self.target, list(self.events), st["predicted_ttft_ms"], st["last_scale"]


@pytest.mark.parametrize("seed", range(4))
def test_tick_makes_the_reference_decisions(seed):
    """A seeded walk of predictions, clock steps and replica catch-up gives
    the same targets, events and per-deployment state tick by tick."""
    rng = np.random.default_rng(seed)
    kw = dict(max_r=int(rng.integers(2, 5)), up_s=float(rng.uniform(0.5, 3)),
              down_s=float(rng.uniform(1, 5)))
    port, ref = _Harness(autoscale, **kw), _Harness(ref_autoscale, **kw)
    try:
        for step in range(120):
            dt = float(rng.choice([0.1, 0.5, 1.0, 2.5]))
            # alternating spells of mostly breach and mostly clearance, with
            # the band and the boundaries mixed in
            spell = (10.0, 49.0, 80.0) if (step // 30) % 2 else (100.0, 101.0, 500.0)
            pred = float(rng.choice(spell if rng.random() < 0.8 else (50.0, 51.0, 99.0)))
            for h in (port, ref):
                h.advance(dt, pred)
            assert port.trace() == ref.trace()
            if rng.random() < 0.3:
                port.running = ref.running = port.target
    finally:
        ref.sc.stop()  # clears the reference's standing demand
    assert {e[1] for e in port.events} == {"scale_up", "scale_down"}


def test_scales_up_on_sustained_breach_only():
    h = _Harness(autoscale, up_s=2.0)
    h.advance(0.0, 500.0)
    h.advance(1.0, 500.0)
    assert h.target == 1 and h.events == []
    h.advance(0.5, 50.0)   # clears: the breach window resets
    h.advance(0.5, 500.0)
    h.advance(1.0, 500.0)
    assert h.target == 1
    h.advance(1.5, 500.0)
    assert h.target == 2 and h.events == [("dep", "scale_up", 2)]
    h.advance(0.1, 500.0)  # cooldown
    assert h.target == 2
    h.advance(2.5, 500.0)
    assert h.target == 3


def test_respects_max_and_scales_down_after_cooldown():
    h = _Harness(autoscale, max_r=2, up_s=1.0, down_s=3.0)
    h.advance(0.0, 500.0)
    h.advance(1.5, 500.0)
    assert h.target == 2
    h.advance(2.0, 500.0)
    assert h.target == 2
    h.advance(1.0, 10.0)
    h.advance(2.0, 10.0)
    assert h.target == 2
    h.advance(2.0, 10.0)
    assert h.target == 1 and h.events[-1] == ("dep", "scale_down", 1)
    h.advance(5.0, 80.0)  # the hysteresis band: neither window runs
    h.advance(5.0, 80.0)
    assert h.target == 1


def test_standing_demand_is_kept_for_view_and_nothing_consumes_it():
    """A scale-up records standing demand; one process has no cluster
    autoscaler to hand it to, so it stays in the scaler's view (and in no
    module the port has) until running catches the target."""
    import sys

    h = _Harness(autoscale, up_s=1.0)
    h.advance(0.0, 500.0)
    h.advance(1.5, 500.0)
    assert h.target == 2
    assert h.sc.view()["standing_demand"] == ["serve:dep"]
    assert not [m for m in sys.modules if m.startswith("ray_tpu_torch.autoscaler")]
    h.running = 2
    h.advance(0.1, 50.0)
    assert h.sc.view()["standing_demand"] == []


# ------------------------------------------------------- the controller
def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_ongoing_requests_policy_scales_up_then_down_when_idle():
    """tests/test_serve.py's two autoscaling tests: a burst of slow
    requests raises the target above min_replicas and a replica is
    started; once idle, the target falls back to 1."""
    rt.init(num_cpus=16, num_gpus=0)

    @serve.deployment(autoscaling_config=serve.AutoscalingConfig(
        min_replicas=1, max_replicas=3, target_ongoing_requests=1.0, upscale_delay_s=0.05,
        downscale_delay_s=0.3), max_ongoing_requests=32)
    class Slow:
        def __call__(self, body):
            time.sleep(0.3)
            return 1

    h = serve.run(Slow.bind())
    assert serve.status()["Slow"]["target_replicas"] == 1
    refs = [h.remote({}) for _ in range(30)]
    assert _wait_for(lambda: serve.status()["Slow"]["target_replicas"] > 1)
    assert _wait_for(lambda: serve.status()["Slow"]["running_replicas"] > 1)
    assert rt.get(refs, timeout=50) == [1] * 30
    assert _wait_for(lambda: serve.status()["Slow"]["target_replicas"] == 1)
    assert _wait_for(lambda: serve.status()["Slow"]["running_replicas"] == 1)


def test_slo_policy_stands_the_controller_loop_down():
    """policy="slo": load reports and the queue-length poll leave the
    target alone; set_target_replicas clamps to the bounds."""
    rt.init(num_cpus=8, num_gpus=0)
    ctrl = ServeController()
    try:
        @serve.deployment(name="SloDep", num_replicas=1, slo_ttft_ms=100.0,
                          autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                                              "policy": "slo"})
        class SloDep:
            def __call__(self, body):
                return {"ok": True}

        ctrl.deploy(SloDep.bind().deployment, "/slo")
        for _ in range(10):
            ctrl.record_autoscaling_metrics("SloDep", 99.0)
        ctrl._autoscale_tick()
        view = ctrl.autoscale_view()["SloDep"]
        assert view["target_replicas"] == 1 and view["policy"] == "slo"
        assert view["slo_ttft_ms"] == 100.0 and view["replica_shape"] == {"CPU": 1.0}
        assert ctrl.set_target_replicas("SloDep", 2) == 2
        assert ctrl.set_target_replicas("SloDep", 99) == 3
        assert ctrl.set_target_replicas("SloDep", 0) == 1
        assert ctrl.set_target_replicas("NoSuchDep", 2) == -1
    finally:
        ctrl.shutdown()


def test_slo_scaler_over_a_live_controller_until_serve_shutdown():
    """The scaler's loop reads the controller's view and anatomy's
    prediction, scales a breached deployment up (the controller starts the
    replica) and stops when serve shuts down."""
    rt.init(num_cpus=8, num_gpus=0)

    @serve.deployment(slo_ttft_ms=50.0, autoscaling_config=serve.AutoscalingConfig(
        min_replicas=1, max_replicas=2, upscale_delay_s=0.1, downscale_delay_s=60.0,
        policy="slo"))
    class Breached:
        def __call__(self, body):
            return 1

    serve.run(Breached.bind())
    controller = rt.get_actor("_serve_controller")
    pred = {"Breached": 500.0}
    scaler = serve.DeploymentAutoscaler(controller, tick_s=0.05,
                                        predicted_fn=lambda: dict(pred)).start()
    assert _wait_for(lambda: serve.status()["Breached"]["running_replicas"] == 2)
    assert scaler.view()["running"]
    serve.shutdown()
    assert not scaler.view()["running"]


def test_scale_down_drains_the_removed_replica():
    """The replica a scale-down removes finishes the request it runs, then
    stops; the port drains where the reference would fail that request."""
    from ray_tpu_torch.exceptions import ActorDiedError

    rt.init(num_cpus=8, num_gpus=0)

    @serve.deployment(autoscaling_config=serve.AutoscalingConfig(
        min_replicas=1, max_replicas=2, policy="slo"))
    class Sleepy:
        def __call__(self, body):
            time.sleep(body.get("s", 0))
            return "done"

    serve.run(Sleepy.bind())
    controller = rt.get_actor("_serve_controller")
    assert rt.get(controller.set_target_replicas.remote("Sleepy", 2), timeout=10) == 2
    assert _wait_for(lambda: serve.status()["Sleepy"]["running_replicas"] == 2)
    victim = rt.get(controller.get_replicas.remote("Sleepy"), timeout=10)[-1]
    ref = victim.handle_request.remote("__call__", ({"s": 1.5},), {})
    assert _wait_for(lambda: rt.get(victim.queue_len.remote(), timeout=5) == 1)
    assert rt.get(controller.set_target_replicas.remote("Sleepy", 1), timeout=10) == 1
    assert _wait_for(lambda: serve.status()["Sleepy"]["running_replicas"] == 1)
    assert rt.get(ref, timeout=20) == "done"

    def stopped():
        try:
            rt.get(victim.queue_len.remote(), timeout=5)
            return False
        except ActorDiedError:
            return True

    assert _wait_for(stopped)
