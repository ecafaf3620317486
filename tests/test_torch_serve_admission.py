"""SLO admission control in the port (ray_tpu_torch.serve.admission)
against the reference module (ray_tpu.serve.admission): ``decide`` over
its whole decision table, ``AdmissionGate`` with fixed predictors, the
shed accounting, and the gate on the port's HTTP proxy (503 +
Retry-After before any ledger, so a shed never counts in goodput).

Every test runs under a deadline of its own (SIGALRM), binds port 0 and
fails on a leftover non-daemon thread."""

import itertools
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu.serve import admission as ref_admission
from ray_tpu.serve import anatomy as ref_anatomy
from ray_tpu_torch import serve
from ray_tpu_torch.serve import admission, anatomy
from ray_tpu_torch.util import flight_recorder
from ray_tpu_torch.util.metrics import registry_snapshot

DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _guard():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    anatomy.clear()
    ref_anatomy.clear()
    try:
        yield
    finally:
        try:
            serve.shutdown()
            rt.shutdown()
            anatomy.clear()
            ref_anatomy.clear()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


def _cfg(mod, **kw):
    base = dict(queue_budget=32, queue_wait_s=2.0, headroom=1.0, poll_s=0.005)
    base.update(kw)
    return mod.AdmissionConfig(**base)


# ---------------------------------------------------- decide, both modules
@pytest.mark.parametrize("pred,slo,queued,cfg_kw,action,reason", [
    (None, None, 0, {}, "admit", None),
    (9999.0, None, 0, {}, "admit", None),
    (None, 100.0, 0, {}, "admit", None),
    (99.0, 100.0, 0, {}, "admit", None),
    (100.0, 100.0, 0, {}, "admit", None),
    (149.0, 100.0, 0, {"headroom": 1.5}, "admit", None),
    (151.0, 100.0, 0, {"headroom": 1.5}, "queue", None),
    (101.0, 100.0, 0, {}, "queue", None),
    (101.0, 100.0, 31, {}, "queue", None),
    (101.0, 100.0, 32, {}, "shed", "queue_full"),
    (101.0, 100.0, 33, {}, "shed", "queue_full"),
    (101.0, 100.0, 0, {"queue_budget": 0}, "shed", "predicted_ttft"),
])
def test_admission_decision_table(pred, slo, queued, cfg_kw, action, reason):
    """tests/test_front_door.py's table, held to the port and to the
    reference on the same row."""
    want = ref_admission.decide(pred, slo, queued, _cfg(ref_admission, **cfg_kw))
    assert want == (action, reason)
    assert admission.decide(pred, slo, queued, _cfg(admission, **cfg_kw)) == want


def test_decide_matches_the_reference_over_the_whole_grid():
    preds = (None, 0.0, 50.0, 99.999, 100.0, 100.001, 149.0, 151.0, 1e6)
    slos = (None, 0.0, 100.0)
    for pred, slo, queued, budget, headroom in itertools.product(
            preds, slos, (0, 1, 31, 32, 33), (-1, 0, 1, 32), (0.5, 1.0, 1.5)):
        kw = {"queue_budget": budget, "headroom": headroom}
        assert (admission.decide(pred, slo, queued, _cfg(admission, **kw))
                == ref_admission.decide(pred, slo, queued, _cfg(ref_admission, **kw))), (
            pred, slo, queued, kw)


def test_env_knobs_read_at_config_construction(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_QUEUE_BUDGET", "7")
    monkeypatch.setenv("RAY_TPU_SERVE_QUEUE_WAIT_S", "0.25")
    monkeypatch.setenv("RAY_TPU_SERVE_ADMIT_HEADROOM", "not-a-number")
    got, want = admission.AdmissionConfig(), ref_admission.AdmissionConfig()
    assert (got.queue_budget, got.queue_wait_s, got.headroom, got.poll_s) == (
        want.queue_budget, want.queue_wait_s, want.headroom, want.poll_s) == (7, 0.25, 1.0, 0.05)


# ------------------------------------------------- the gate, both modules
def _gate_runs(mod, predictor, **kw):
    """What a gate does with ``predictor``: its answers, queued count and
    shed counts after the calls."""
    gate = mod.AdmissionGate(predictor, _cfg(mod, **kw))
    answers = [gate.try_admit("d") for _ in range(3)]
    return answers, gate.queued("d"), gate.shed_counts()


@pytest.mark.parametrize("predictor, kw", [
    (lambda dep: (None, None), {}),
    (lambda dep: (50.0, 100.0), {}),
    (lambda dep: (500.0, 100.0), {"queue_budget": 0}),
    (lambda dep: (500.0, 100.0), {"queue_wait_s": 0.05}),
    (lambda dep: (500.0, None), {"queue_budget": 0}),
], ids=["no-slo", "under", "zero-budget", "queue-timeout", "no-slo-breach"])
def test_gate_behaves_as_the_reference_with_a_fixed_predictor(predictor, kw):
    assert _gate_runs(admission, predictor, **kw) == _gate_runs(ref_admission, predictor, **kw)


def test_gate_queued_request_admits_when_prediction_clears():
    state = {"pred": 500.0}
    gate = admission.AdmissionGate(lambda dep: (state["pred"], 100.0),
                                   _cfg(admission, queue_wait_s=10.0))
    t0 = time.monotonic()

    def clear():
        time.sleep(0.05)
        state["pred"] = 50.0

    threading.Thread(target=clear, daemon=True).start()
    assert gate.try_admit("d") == (True, None)
    assert time.monotonic() - t0 < 5.0
    assert gate.queued("d") == 0


def test_gate_queue_budget_boundary():
    gate = admission.AdmissionGate(lambda dep: (500.0, 100.0),
                                   _cfg(admission, queue_budget=2, queue_wait_s=0.5))
    results = []
    threads = [threading.Thread(target=lambda: results.append(gate.try_admit("d")))
               for _ in range(2)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5
    while gate.queued("d") < 2 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert gate.queued("d") == 2
    assert gate.try_admit("d") == (False, "queue_full")
    for t in threads:
        t.join(timeout=10)
    assert results == [(False, "queue_timeout")] * 2
    sc = gate.shed_counts()
    assert sc["d:queue_full"] == 1 and sc["d:queue_timeout"] == 2


def test_shed_metrics_and_flight_ring_rate_limited():
    dep = f"stormdep-{os.getpid()}-{time.monotonic_ns()}"
    gate = admission.AdmissionGate(lambda d: (500.0, 100.0), _cfg(admission, queue_budget=0))
    for _ in range(20):
        gate.try_admit(dep)
    snap = registry_snapshot()
    shed = [(dict(tags), v) for tags, v in snap["ray_tpu_serve_shed_total"].items()
            if dict(tags).get("deployment") == dep]
    assert shed == [({"deployment": dep, "reason": "predicted_ttft"}, 20.0)]
    done = [v for tags, v in snap["ray_tpu_serve_requests_total"].items()
            if dict(tags).get("deployment") == dep and dict(tags).get("outcome") == "shed"]
    assert done == [20.0]
    recs = [r for r in flight_recorder.records("serve")
            if r["event"] == "shed" and r.get("deployment") == dep]
    assert 1 <= len(recs) <= 2


def test_anatomy_predictor_reads_the_estimator_and_the_declared_slo():
    class Stub:
        _name, _replica_nodes = "pdep", {}

        def inflight_snapshot(self):
            return {"a": 2, "b": 0}

    anatomy.set_slo("pdep", 80.0)
    assert admission.anatomy_predictor("pdep") == (None, 80.0)  # no router yet
    stub = Stub()
    anatomy.register_router(stub)
    # no settled request yet: the estimator's 50 ms default service time
    assert admission.anatomy_predictor("pdep") == (pytest.approx(100.0), 80.0)
    assert admission.anatomy_predictor("other") == (None, None)
    del stub


# --------------------------------------------------- the gate on the proxy
def _post(port: int, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/gate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_proxy_sheds_with_503_before_admit_and_goodput_ignores_sheds():
    """Admitted requests get ledgers and score; a shed gets 503 with
    Retry-After: 1, never a ledger, and counts once in the shed series."""
    rt.init(num_cpus=8, num_gpus=0)

    @serve.deployment(slo_ttft_ms=60_000.0)
    class Gated:
        def __call__(self, body):
            anatomy.stamp(anatomy.rid_of(body), "decode_first_token", anatomy.now_wall())
            return {"token_ids": [7]}

    serve.run(Gated.bind(), route_prefix="/gate")
    state = {"shed": False}

    def predictor(dep):
        pred, slo = admission.anatomy_predictor(dep)
        return (1e9 if state["shed"] else pred), slo

    gate = admission.AdmissionGate(predictor, _cfg(admission, queue_budget=0))
    port = serve.start_http_proxy(port=0, admission=gate.try_admit).port
    before = _shed_total("Gated")
    codes = [_post(port, {"i": i})[0] for i in range(3)]
    state["shed"] = True
    shed = [_post(port, {"i": i}) for i in range(4)]
    assert codes == [200] * 3
    assert all(code == 503 and headers.get("Retry-After") == "1"
               and out == {"error": "shed", "reason": "predicted_ttft", "deployment": "Gated"}
               for code, headers, out in shed), shed
    view = anatomy.serve_view()
    rows = [r for r in view["requests"] if r["deployment"] == "Gated"]
    assert len(rows) == 3 and all(r["ok"] for r in rows)
    board = view["deployments"]["Gated"]
    assert board["admitted"] == board["completed"] == 3
    assert board["slo_ok"] + board["slo_breach"] == 3 and board["goodput"] == 1.0
    assert _shed_total("Gated") - before == 4 == gate.shed_counts()["Gated:predicted_ttft"]


def _shed_total(dep: str) -> float:
    return sum(v for tags, v in registry_snapshot().get("ray_tpu_serve_shed_total", {}).items()
               if dict(tags).get("deployment") == dep)
