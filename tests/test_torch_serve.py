"""The port's serve control plane (ray_tpu_torch.serve): the behaviors of
tests/test_serve.py that the in-process port carries, and a replica killed
mid-traffic (tests/test_serve_hardening.py).

Every proxy binds port 0, every request and get has a timeout, and every
test runs under a deadline of its own (SIGALRM: a hang fails that test);
teardown shuts serve and the runtime down and checks that no non-daemon
thread is left."""

import json
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve

DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _guard():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        rt.init(num_cpus=8, num_gpus=0)
        yield
    finally:
        try:
            serve.shutdown()
            rt.shutdown()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


def _post(port: int, path: str, body=None, raw: bytes | None = None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=15) as r:
        if r.headers["Content-Type"].startswith("text/event-stream"):
            return [ln.decode().strip() for ln in r if ln.strip()]
        return json.loads(r.read())


@serve.deployment
class Echo:
    def __call__(self, body):
        return {"echo": body}


@serve.deployment
def double(body):
    return body["x"] * 2


@pytest.mark.parametrize("app, body, want", [
    (Echo, {"a": 1}, {"echo": {"a": 1}}),
    (double, {"x": 21}, 42),
], ids=["class", "function"])
def test_deployment_answers_through_its_handle(app, body, want):
    h = serve.run(app.bind())
    assert rt.get(h.remote(body), timeout=10) == want


def test_num_replicas_and_status():
    @serve.deployment(num_replicas=3)
    class S:
        def __call__(self, body):
            return 1

    serve.run(S.bind())
    # run returns once every replica is constructed
    assert serve.status()["S"] == {"target_replicas": 3, "running_replicas": 3, "version": 0}


def test_requests_spread_across_replicas():
    @serve.deployment(num_replicas=2)
    class WhoAmI:
        def __init__(self):
            self.id = id(self)

        def __call__(self, body):
            time.sleep(0.05)
            return self.id

    h = serve.run(WhoAmI.bind())
    ids = set(rt.get([h.remote({}) for _ in range(20)], timeout=30))
    assert len(ids) == 2  # power-of-two-choices reached both replicas


def test_method_calls_and_user_config():
    @serve.deployment(user_config={"factor": 3})
    class Mult:
        def __init__(self):
            self.factor = 1

        def reconfigure(self, cfg):
            self.factor = cfg["factor"]

        def __call__(self, body):
            return body["x"] * self.factor

        def get_factor(self):
            return self.factor

    h = serve.run(Mult.bind())
    assert rt.get(h.get_factor.remote(), timeout=10) == 3
    assert rt.get(h.remote({"x": 2}), timeout=10) == 6


def test_deployment_error_propagates():
    @serve.deployment
    class Boom:
        def __call__(self, body):
            raise ValueError("serve kaboom")

    h = serve.run(Boom.bind())
    with pytest.raises(Exception, match="serve kaboom"):
        rt.get(h.remote({}), timeout=10)


def test_constructor_error_fails_run():
    @serve.deployment(num_replicas=2)
    class NoStart:
        def __init__(self):
            raise RuntimeError("replica cannot start")

        def __call__(self, body):
            return 1

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="replica cannot start"):
        serve.run(NoStart.bind())
    assert time.monotonic() - t0 < 10
    assert "NoStart" not in serve.status()  # no handle without replicas is left behind


def test_delete_deployment():
    serve.run(Echo.bind(), route_prefix="/echo")
    serve.delete("Echo")
    assert "Echo" not in serve.status()
    with pytest.raises(ValueError, match="not found"):
        serve.get_deployment_handle("Echo")


def test_redeploy_replaces_replicas():
    @serve.deployment(user_config={"tag": "v1"})
    class Versioned:
        def __init__(self):
            self.tag = None

        def reconfigure(self, cfg):
            self.tag = cfg["tag"]

        def __call__(self, body):
            return self.tag

    h = serve.run(Versioned.bind())
    assert rt.get(h.remote({}), timeout=10) == "v1"
    h2 = serve.run(Versioned.options(user_config={"tag": "v2"}).bind())
    assert rt.get(h2.remote({}), timeout=10) == "v2"
    assert serve.status()["Versioned"]["version"] == 1
    assert rt.get(serve.get_deployment_handle("Versioned").remote({}), timeout=10) == "v2"


def test_route_prefix_conflict_rejected():
    @serve.deployment
    class A1:
        def __call__(self, body):
            return 1

    @serve.deployment
    class B1:
        def __call__(self, body):
            return 2

    serve.run(A1.bind(), route_prefix="/same")
    with pytest.raises(ValueError, match="already bound"):
        serve.run(B1.bind(), route_prefix="/same")


@pytest.mark.parametrize("field, value, error, match", [
    ("compiled_dispatch", True, NotImplementedError, "ROADMAP queue 1 item 8"),
    ("ray_actor_options", {"isolate_process": True}, NotImplementedError,
     "ROADMAP queue 1 item 4"),
    ("ray_actor_options", {"resources": {"accelerator_slot": 1}}, NotImplementedError,
     "ROADMAP queue 1 item 4"),
    ("request_router", "nope", ValueError, "unknown request_router"),
])
def test_unported_deployment_options_raise(field, value, error, match):
    with pytest.raises(error, match=match):
        Echo.options(**{field: value})


@pytest.mark.parametrize("period, least, most", [(0.2, 3, 100), (30.0, 0, 0)])
def test_health_check_period_sets_the_probe_rate(period, least, most):
    """The controller probes each replica once its deployment's
    health_check_period_s has passed since the last probe."""
    probes = []

    @serve.deployment
    class Probed:
        def __call__(self, x):
            return x

        def check_health(self):
            probes.append(time.monotonic())

    serve.run(Probed.options(health_check_period_s=period).bind())
    time.sleep(1.5)
    assert least <= len(probes) <= most, probes
    with pytest.raises(ValueError, match="must be > 0"):
        Probed.options(health_check_period_s=0)


def test_http_proxy_roundtrip():
    @serve.deployment
    class Api:
        def __call__(self, body):
            return {"sum": body.get("a", 0) + body.get("b", 0)}

    serve.run(Api.bind(), route_prefix="/api")
    proxy = serve.start_http_proxy(port=0)
    assert proxy.port > 0
    assert _post(proxy.port, "/api", {"a": 2, "b": 3}) == {"result": {"sum": 5}}


@pytest.mark.parametrize("path, raw, code", [
    ("/x", b"{not json", 400),
    ("/nowhere", b"{}", 404),
])
def test_http_errors(path, raw, code):
    serve.run(Echo.bind(), route_prefix="/x")
    port = serve.start_http_proxy(port=0).port
    with pytest.raises(urllib.error.HTTPError) as info:
        _post(port, path, raw=raw)
    assert info.value.code == code


def test_app_error_is_a_500():
    @serve.deployment
    class Boom:
        def __call__(self, body):
            raise ValueError("serve kaboom")

    serve.run(Boom.bind(), route_prefix="/boom")
    port = serve.start_http_proxy(port=0).port
    with pytest.raises(urllib.error.HTTPError) as info:
        _post(port, "/boom", {})
    assert info.value.code == 500 and "serve kaboom" in info.value.read().decode()


def test_proxy_port_released_after_shutdown():
    serve.run(Echo.bind(), route_prefix="/p1")
    port = serve.start_http_proxy(port=0).port
    serve.shutdown()

    @serve.deployment
    class P2:
        def __call__(self, body):
            return 2

    serve.run(P2.bind(), route_prefix="/p2")
    assert serve.start_http_proxy(port=port).port == port  # rebinding the same port works
    assert _post(port, "/p2", {}) == {"result": 2}


def test_handle_streaming_method():
    @serve.deployment
    class Streamer:
        def chunks(self, body):
            for i in range(body["n"]):
                yield {"chunk": i}

    h = serve.run(Streamer.bind())
    assert list(h.stream({"n": 3}, method_name="chunks")) == [
        {"chunk": 0}, {"chunk": 1}, {"chunk": 2}]


def test_sse_streaming_over_http():
    @serve.deployment
    class SSE:
        def stream_tokens(self, body):
            for i in range(3):
                yield i * 11

    serve.run(SSE.bind(), route_prefix="/sse")
    port = serve.start_http_proxy(port=0).port
    assert _post(port, "/sse", {"stream": True}) == [
        "data: 0", "data: 11", "data: 22", "data: [DONE]"]


def test_sse_error_surfaces_as_frame():
    @serve.deployment
    class NoStream:
        def __call__(self, body):
            return 1

    serve.run(NoStream.bind(), route_prefix="/nostream")
    frames = _post(serve.start_http_proxy(port=0).port, "/nostream", {"stream": True})
    assert frames[-1] == "data: [DONE]"
    assert len(frames) == 2 and "stream_tokens" in json.loads(frames[0][6:])["error"]


def test_replica_killed_mid_traffic_is_replaced():
    """Kill a replica: the router retries on the live one, so traffic goes on,
    and the controller's health loop replaces the dead one."""
    @serve.deployment(num_replicas=2)
    class Echo2:
        def __call__(self, x):
            return x

    handle = serve.run(Echo2.bind(), route_prefix="/echo2")
    assert rt.get(handle.remote(1), timeout=10) == 1
    controller = rt.get_actor("_serve_controller")
    replicas = rt.get(controller.get_replicas.remote("Echo2"), timeout=10)
    assert len(replicas) == 2
    rt.kill(replicas[0])
    for i in range(10):
        assert rt.get(handle.remote(i), timeout=10) == i
        time.sleep(0.05)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        live = rt.get(controller.get_replicas.remote("Echo2"), timeout=10)
        if len(live) == 2 and replicas[0] not in live:
            break
        time.sleep(0.1)
    else:
        pytest.fail("dead replica was not replaced")
    assert serve.status()["Echo2"]["running_replicas"] == 2
